"""One rank of the port's keyframe-axis solve, for tests/test_torch_kf_axis.py.

    python tests/_torch_kf_child.py RANK WORLD INIT_FILE OUT.npz CASE [PROBLEM.npz]

Joins a gloo group through ``file://INIT_FILE`` (60 s timeouts), lays the
ranks out as the case's kf × f grid, runs ``segmented_trajectory_solve`` and
writes what it returns (the same on every rank) to OUT.npz. The problem is
PROBLEM.npz (arrays named ``states.p``, ``grids.bearing``, ``priors.J``,
``dts``, ...: the JAX package's problem, carried over with ``convert``) or,
without it, the port's own ``make_segmented_problem``. Imports torch and the
port only.
"""

import datetime
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from lfvio_tpu_torch import convert  # noqa: E402
from lfvio_tpu_torch import dist as tdist  # noqa: E402
from lfvio_tpu_torch.backend import SolverConfig  # noqa: E402
from lfvio_tpu_torch.dist.synthetic_traj import G_NORM, make_segmented_problem  # noqa: E402
from lfvio_tpu_torch.imu import ImuNoise  # noqa: E402

NOISE = ImuNoise(0.02, 0.01, 0.04, 0.001)
TIMEOUT = datetime.timedelta(seconds=60)
BEARING_NOISE = 0.3 / 160.0
# name: (S, n_f, Wseg, Fseg, LM iterations, outer rounds). "small" is the
# tier-1 problem (3 LM iterations, 3 rounds); "gate" is
# tests/test_kf_axis.py's (6 iterations, 2 + 3S rounds).
CASES = {
    "small-3x1": (3, 1, 5, 8, 3, 3),
    "small-2x2": (2, 2, 5, 8, 3, 3),
    "small-2x1": (2, 1, 5, 8, 3, 3),
    "gate-2x2": (2, 2, 5, 16, 6, 8),
    "gate-4x1": (4, 1, 5, 16, 6, 14),
}
OUT_KEYS = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")


def solver_config(iters):
    return SolverConfig(max_iterations=iters, estimate_td=False, estimate_extrinsic=False,
                        cost_tol=0.0)


def problem(case, path=None):
    """The case's batched problem (float64, CPU)."""
    S, _, Wseg, Fseg, _, _ = CASES[case]
    if path is None:
        return make_segmented_problem(S, Wseg, Fseg, noise=BEARING_NOISE, device="cpu")
    a = np.load(path)
    part = lambda tag: {k.split(".", 1)[1]: a[k] for k in a.files if k.startswith(tag + ".")}
    pb = dict(states=convert.window_state(part("states"), device="cpu"),
              grids=convert.feature_grid(part("grids"), device="cpu"),
              priors=convert.prior_factor(part("priors"), device="cpu"))
    for k in ("dts", "accs", "gyrs", "a0", "g0"):
        pb[k] = torch.as_tensor(a[k], dtype=torch.float64)
    pb["imu_valid"] = torch.as_tensor(a["imu_valid"], dtype=torch.bool)
    return pb


def solve(mesh, pb, case):
    _, _, _, _, iters, n_outer = CASES[case]
    return tdist.segmented_trajectory_solve(
        mesh, pb["states"], pb["grids"], pb["dts"], pb["accs"], pb["gyrs"], pb["a0"], pb["g0"],
        pb["imu_valid"], pb["priors"], NOISE, solver_config(iters), g_norm=G_NORM,
        n_outer=n_outer)


def main(rank, world, init_file, out_path, case, path=None):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        S, n_f = CASES[case][:2]
        mesh = tdist.make_kf_mesh(S, n_f, timeout=TIMEOUT)
        states, gap, costs, hist = solve(mesh, problem(case, path), case)
        np.savez(out_path, gap=gap.numpy(), costs=costs.numpy(), hist=hist.numpy(),
                 **{k: getattr(states, k).numpy() for k in OUT_KEYS})
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
         *sys.argv[6:])
