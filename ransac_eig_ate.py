"""The e2e gate's stream with RANSAC's eigensolves on each path, on one CUDA
card: does the gate's ATE depend on which eigensolver RANSAC uses?

    python3 ransac_eig_ate.py [n_seeds]     (beside chip_smoke.py)

``chip_smoke.py`` phase 5's configuration (``tests/test_e2e.py``: 512x384
synthetic PAL stream, 7 s, f32 tracker with 160 slots, f64 solver) runs once
per RANSAC seed (the FrontEnd's generator, 0 .. n_seeds - 1; 4 by default)
with the eigensolves of ``frontend/ransac.py::_solve_E`` through the kernel
(``geom/eigh_cuda.py::sym_eig``, the main path) and through the library
(``torch.linalg.eigh``, which waits for the card), and prints each run's
solves, first solve time and ATE, then the ATE of each path over the seeds.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import chip_smoke
from lfvio_tpu_torch.frontend import ransac
from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, FrontEnd, VioPipeline
from lfvio_tpu_torch.runtime.synthetic import (
    SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)


def main(argv):
    if not torch.cuda.is_available():
        print("ransac_eig_ate: no CUDA device", file=sys.stderr)
        return 2
    n_seeds = int(argv[0]) if argv else 4
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi_line(), flush=True)
    world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=torch.float64),
                           dtype=torch.float64, device=dev)
    stream = world.generate(7.0, 15.0, 200.0)
    paths = {"kernel": ransac.sym_eig, "library": torch.linalg.eigh}
    ates = {name: [] for name in paths}
    try:
        for seed in range(n_seeds):
            for name, eig in paths.items():
                ransac.sym_eig = eig
                fe = FrontEnd(world.camera, (world.height, world.width), max_cnt=120,
                              min_dist=15, n_slots=160, equalize=False, dtype=torch.float32,
                              device=dev, seed=seed,
                              annulus=(world.width / 2, world.height / 2, SYN_MAX_R, SYN_MIN_R))
                est = Estimator(EstimatorConfig(n_feature_slots=256, solver_dtype=torch.float64,
                                                device=dev))
                times, _, _ = VioPipeline(fe, est, depth=1).run(stream, world.render)
                ate, _ = chip_smoke.trajectory_ate(world, est)
                ates[name].append(ate)
                print(f"seed {seed}, eigensolves through the {name}: {len(times)} solves, first "
                      f"at t = {times[0]:.4f} s, ATE {ate:.4f} m", flush=True)
    finally:
        ransac.sym_eig = paths["kernel"]
    for name, vals in ates.items():
        print(f"{name}: ATE over seeds 0-{n_seeds - 1}: {', '.join(f'{a:.4f}' for a in vals)}; "
              f"mean {np.mean(vals):.4f} m, largest {max(vals):.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
