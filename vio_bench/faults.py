"""Faults planted in the program's timed path, each of which the check must
call not correct: a solve that returns its state unchanged, half of the
features left out of the solve, half of the tracks dropped in the front
end's step, half of the features left out of the solve's packed upload,
and an answer altered where it is produced (a bearing in the front end, a
pose in the trajectory). One card, so no exchange between cards exists to
leave out.

``plant(name, setattr)`` patches the port through ``setattr(obj, attr,
value)`` (pytest's ``monkeypatch.setattr`` in the tests) before the program
is built, so that the front end's and the estimator's device programs
capture the fault. ``python3 -m vio_bench.readings --fault <name>`` reads
the check's numbers with a fault planted at a cell's own size."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _state_unchanged(patch):
    import lfvio_tpu_torch.runtime.estimator as est_mod

    real = est_mod.lm_solve

    def lm_solve(state, *a, **kw):
        out = real(state, *a, **kw)
        return (state,) + tuple(out[1:])

    patch(est_mod, "lm_solve", lm_solve)


def _half_the_features(patch):
    import lfvio_tpu_torch.runtime.estimator as est_mod

    real = est_mod.lm_solve

    def lm_solve(state, grid, *a, **kw):
        half = torch.arange(grid.used.shape[0], device=grid.used.device) < grid.used.shape[0] // 2
        return real(state, dataclasses.replace(grid, used=grid.used & half), *a, **kw)

    patch(est_mod, "lm_solve", lm_solve)


def _half_the_tracks(patch):
    import lfvio_tpu_torch.runtime.tracker as tracker_mod

    klt = tracker_mod.klt_cuda
    real = klt.pyramidal_lk

    def pyramidal_lk(*a, **kw):
        pts, ok = real(*a, **kw)
        return pts, ok & (torch.arange(ok.shape[0], device=ok.device) % 2 == 0)

    patch(klt, "pyramidal_lk", pyramidal_lk)


def _half_packed(patch):
    import lfvio_tpu_torch.runtime.estimator as est_mod

    real = est_mod.Estimator._pack_solve_buffer

    def pack(self, *a, **kw):
        buf = real(self, *a, **kw)
        for name in ("g_valid", "g_used"):
            off, shape = self._pack_layout[name]
            view = buf[off:off + int(np.prod(shape))].reshape(shape)
            view[1::2] = 0
        return buf

    patch(est_mod.Estimator, "_pack_solve_buffer", pack)


def _bearing_altered(patch):
    import lfvio_tpu_torch.runtime.tracker as tracker_mod

    real = tracker_mod.FrontEnd._lift

    def lift(self, pts):
        b = real(self, pts)
        b = b + 1e-3 * torch.stack([b[:, 1], -b[:, 0], torch.zeros_like(b[:, 0])], dim=1)
        return b / torch.linalg.norm(b, dim=-1, keepdim=True)

    patch(tracker_mod.FrontEnd, "_lift", lift)


def _pose_altered(patch):
    import lfvio_tpu_torch.runtime.estimator as est_mod

    real = est_mod.Estimator.finalize_solve

    def finalize_solve(self):
        n = len(self.traj_p)
        real(self)
        if len(self.traj_p) > n:
            self.traj_p[-1] = self.traj_p[-1] + np.array([0.01, 0.0, 0.0])

    patch(est_mod.Estimator, "finalize_solve", finalize_solve)


# name -> (planter, the number that must catch it)
FAULTS = {
    "state_unchanged": (_state_unchanged, "solve_gap"),
    "half_the_features": (_half_the_features, "solve_gap"),
    "half_the_tracks": (_half_the_tracks, "status_gap"),
    "half_packed": (_half_packed, "pack_gap"),
    "bearing_altered": (_bearing_altered, "bearing_gap_rad"),
    "pose_altered": (_pose_altered, "traj_gap"),
}


def plant(name, patch=setattr):
    FAULTS[name][0](patch)
