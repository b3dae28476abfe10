"""Trajectory file IO (TUM format) — reference visualization.cpp:173-179.

A copy of ``lfvio_tpu.runtime.trajectory_io`` (pure numpy), kept here
because that package's import chain reaches JAX.
"""

from __future__ import annotations

import numpy as np


def write_tum(path, times, positions, quats_wxyz):
    """TUM: 'time tx ty tz qx qy qz qw' per line."""
    with open(path, "w") as f:
        for t, p, q in zip(times, positions, quats_wxyz):
            f.write(
                f"{t:.9f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )


def read_tum(path):
    data = np.loadtxt(path)
    t = data[:, 0]
    p = data[:, 1:4]
    q_xyzw = data[:, 4:8]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=1)
    return t, p, q_wxyz
