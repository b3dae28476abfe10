"""One rank of the port's feature-sharded frame step, for tests/test_torch_dist.py.

    python tests/_torch_dist_child.py RANK WORLD INIT_FILE OUT.npz CASE

Joins a gloo group through ``file://INIT_FILE`` (60 s timeout), runs
``vio_frame_step_sharded`` on ``problem()`` and writes this rank's outputs
to OUT.npz. CASE is "old" (MARGIN_OLD), "new" (MARGIN_SECOND_NEW) or
"old-mixed" (MARGIN_OLD on ``problem(mixed=True)``). Imports torch and the
port only.
"""

import dataclasses
import datetime
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from lfvio_tpu_torch import dist as tdist  # noqa: E402
from lfvio_tpu_torch.backend import lm_solve, marginalize_old_qr, marginalize_second_new_qr  # noqa: E402
from lfvio_tpu_torch.backend.gauge import yaw_gauge_fix  # noqa: E402
from lfvio_tpu_torch.backend.triangulate import triangulate_grid  # noqa: E402
from lfvio_tpu_torch.imu import preintegrate, whiten_covariance  # noqa: E402
from lfvio_tpu_torch.runtime.profiling import make_window_problem  # noqa: E402

N_FEAT = 32  # splits evenly over 2 and 4 ranks


def problem(dtype=torch.float64, device="cpu", mixed=False):
    """A 32-feature window with 5-frame tracks, td and extrinsics estimated,
    positions perturbed by 2 cm and an informative prior with a non-zero
    residual; half the features already carry a depth. ``mixed`` anchors
    feature 1 at frame 0 as well, beside features that are not: a grid on
    which the single-device QR marginalization drops information (its
    all-zero depth columns' pivot rows fall in feature 1's rows)."""
    pb = make_window_problem(N_FEAT, dtype, n_obs_frames=5, imu_samples=8, max_iterations=4,
                             device=device)
    rng = np.random.default_rng(3)
    s = pb["state"]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    pb["state"] = s.replace(p=s.p + t(0.02 * rng.standard_normal(tuple(s.p.shape))),
                            td=t(0.002))
    pb["prior"] = dataclasses.replace(pb["prior"],
                                      r0=t(0.1 * rng.standard_normal(pb["prior"].r0.shape[0])))
    if mixed:
        g = pb["grid"]
        anchor, valid = g.anchor.clone(), g.valid.clone()
        anchor[1] = 0
        valid[1] = torch.arange(valid.shape[1], device=device) < 5
        pb["grid"] = g.replace(anchor=anchor, valid=valid)
    pb["has_depth"] = torch.arange(N_FEAT, device=device) % 2 == 0
    pb["imu"] = [t(pb[k]) for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pb["imu_valid"] = torch.as_tensor(pb["imu_valid"], device=device)
    return pb


def origin(pb):
    return pb["state"].p[0], pb["state"].q[0]


def single_device_step(pb, marg_old=True):
    """The port's single-device chain: preintegrate → triangulate → lm_solve
    → gauge → marginalize."""
    state, grid, prior, gravity, cfg = (pb[k] for k in ("state", "grid", "prior", "gravity", "cfg"))
    dts, accs, gyrs, a0, g0 = pb["imu"]
    pre = preintegrate(dts, accs, gyrs, a0, g0, state.ba[:-1], state.bg[:-1], pb["noise"])
    si, ok = whiten_covariance(pre.covariance, pb["imu_valid"])
    state = state.replace(inv_depth=triangulate_grid(state, grid, pb["has_depth"]))
    out, c0, c1, _ = lm_solve(state, grid, pre, si, ok, prior, gravity, cfg)
    out = yaw_gauge_fix(out, *origin(pb))
    if marg_old:
        new_prior = marginalize_old_qr(out, grid, pre, si, ok, prior, gravity, cfg)
    else:
        new_prior = marginalize_second_new_qr(out, prior, cfg)
    return out, new_prior, c0, c1


def sharded_step(pb, mesh, marg_old=True):
    """``vio_frame_step_sharded`` on this rank's slice of ``pb``."""
    state = pb["state"]
    state = state.replace(inv_depth=tdist.shard_features(state.inv_depth, mesh))
    return tdist.vio_frame_step_sharded(
        mesh, state, tdist.shard_grid(pb["grid"], mesh), *pb["imu"], pb["imu_valid"],
        pb["prior"], tdist.shard_features(pb["has_depth"], mesh), *origin(pb), pb["noise"],
        pb["cfg"], marg_old=marg_old)


def outputs(out, prior, c0, c1, mesh):
    """The step's outputs as numpy, inverse depths gathered from every rank."""
    n = lambda x: x.detach().cpu().numpy()
    return dict(p=n(out.p), q=n(out.q), v=n(out.v), ba=n(out.ba), bg=n(out.bg), tic=n(out.tic),
                qic=n(out.qic), td=n(out.td),
                inv_depth=n(tdist.gather_features(out.inv_depth, mesh)),
                H=n(prior.J.T @ prior.J), b=n(prior.J.T @ prior.r0), valid=n(prior.valid),
                x0_p=n(prior.x0_p), c0=n(c0), c1=n(c1))


def main(rank, world, init_file, out_path, case):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = tdist.make_feature_mesh()
        pb = problem(mixed=case == "old-mixed")
        res = outputs(*sharded_step(pb, mesh, marg_old=case != "new"), mesh)
        np.savez(out_path, **res)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
