"""Estimator checkpoint / resume.

Port of ``lfvio_tpu.runtime.checkpoint``: the full estimator state (window
arrays, feature table, prior, IMU buffers) in one .npz, with the same keys,
so a file written by either package loads into the other's Estimator of the
same configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend.state import PriorFactor

PRIOR_FIELDS = (
    "J", "r0", "x0_p", "x0_q", "x0_v", "x0_ba", "x0_bg",
    "x0_tic", "x0_qic", "x0_td", "valid",
)


def save_checkpoint(path: str, est):
    """Snapshot an Estimator to ``path`` (.npz). Pending solves are
    finalized first."""
    while est.pending_count():
        est.finalize_solve()
    fm = est.fm
    data = dict(
        Ps=est.Ps, Qs=est.Qs, Vs=est.Vs, Bas=est.Bas, Bgs=est.Bgs,
        tic=est.tic, qic=est.qic, td=np.float64(est.td),
        frame_count=np.int64(est.frame_count),
        solver_flag=np.int64(est.solver_flag),
        headers=est.headers,
        acc_0=est.acc_0, gyr_0=est.gyr_0,
        first_imu=np.bool_(est.first_imu),
        fm_bearing=fm.bearing, fm_velocity=fm.velocity, fm_td=fm.td_obs,
        fm_valid=fm.valid, fm_anchor=fm.anchor, fm_id=fm.feature_id,
        fm_depth=fm.depth, fm_cam=fm.cam,
        gravity=np.asarray(est.gravity if est.gravity is not None else np.zeros(3)),
        has_gravity=np.bool_(est.gravity is not None),
    )
    # IMU interval buffers (ragged -> flattened with counts).
    counts = np.asarray([len(b) for b in est.imu_buf], np.int64)
    if counts.sum() > 0:
        flat = np.concatenate(
            [np.asarray([(d, *a, *g) for (d, a, g) in b]).reshape(-1, 7)
             for b in est.imu_buf if b]
        )
    else:
        flat = np.zeros((0, 7))
    data["imu_counts"] = counts
    data["imu_flat"] = flat
    # The padded mirrors, with the interval-start samples, which the ragged
    # lists alone do not give back.
    data["imu_dts"] = est._imu_dts
    data["imu_accs"] = est._imu_accs
    data["imu_gyrs"] = est._imu_gyrs
    data["imu_n"] = est._imu_n
    data["imu_sumdt"] = est._imu_sumdt
    data["imu_a0"] = est._imu_a0
    data["imu_g0"] = est._imu_g0
    if est.prior is not None:
        for f in PRIOR_FIELDS:
            data[f"prior_{f}"] = getattr(est.prior, f).cpu().numpy()
    np.savez_compressed(path, **data)


def load_checkpoint(path: str, est):
    """Restore a saved snapshot into an Estimator of the same configuration;
    the prior goes to the estimator's device in its solver dtype."""
    z = np.load(path, allow_pickle=False)
    est.Ps[:] = z["Ps"]
    est.Qs[:] = z["Qs"]
    est.Vs[:] = z["Vs"]
    est.Bas[:] = z["Bas"]
    est.Bgs[:] = z["Bgs"]
    est.tic = z["tic"].copy()
    est.qic = z["qic"].copy()
    est.td = float(z["td"])
    est.frame_count = int(z["frame_count"])
    est.solver_flag = int(z["solver_flag"])
    est.headers[:] = z["headers"]
    est.acc_0 = z["acc_0"].copy()
    est.gyr_0 = z["gyr_0"].copy()
    est.first_imu = bool(z["first_imu"])
    est.gravity = z["gravity"].copy() if bool(z["has_gravity"]) else None
    fm = est.fm
    fm.bearing[:] = z["fm_bearing"]
    fm.velocity[:] = z["fm_velocity"]
    fm.td_obs[:] = z["fm_td"]
    fm.valid[:] = z["fm_valid"]
    fm.anchor[:] = z["fm_anchor"]
    fm.feature_id[:] = z["fm_id"]
    fm.depth[:] = z["fm_depth"]
    # Per-observation camera ids; absent in older files: camera 0.
    fm.cam[:] = z["fm_cam"] if "fm_cam" in z.files else 0
    fm._id2slot = {int(fid): int(s) for s, fid in enumerate(fm.feature_id) if fid >= 0}
    flat = z["imu_flat"]
    est.imu_buf = []
    k = 0
    for c in z["imu_counts"]:
        rows = flat[k:k + int(c)]
        k += int(c)
        est.imu_buf.append([(float(r[0]), r[1:4].copy(), r[4:7].copy()) for r in rows])
    est._imu_dts[:] = z["imu_dts"]
    est._imu_accs[:] = z["imu_accs"]
    est._imu_gyrs[:] = z["imu_gyrs"]
    est._imu_n[:] = z["imu_n"]
    est._imu_sumdt[:] = z["imu_sumdt"]
    est._imu_a0[:] = z["imu_a0"]
    est._imu_g0[:] = z["imu_g0"]
    if "prior_J" in z.files:
        est.prior = PriorFactor(*[
            torch.as_tensor(z[f"prior_{f}"], device=est.device,
                            dtype=torch.bool if f == "valid" else est.cfg.solver_dtype)
            for f in PRIOR_FIELDS
        ])
    else:
        est.prior = None
    return est
