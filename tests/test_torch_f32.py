"""The port's f32 operating point (the counterpart of ``tests/test_f32.py``):
the solver runs in float32 on the card, while every parity test holds it in
float64. The same bearing stream as the JAX test (48 landmarks, 64 slots,
6 s at 20 Hz, exact IMU through the pipeline's alignment path) runs through
the port's estimator on the CPU in f64 and in f32; the f32 ATE must stay
within max(2 x the f64 ATE, 0.05 m), the JAX test's bound. ``chip_smoke.py``
phase 7 holds the same bound on the card, where the f32 solver runs as CUDA
graphs. Imports no JAX.
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke


@pytest.mark.slow
def test_f32_e2e_ate_matches_f64():
    (ate64, n64), (ate32, n32) = chip_smoke.f32_stream_ates("cpu")
    assert np.isfinite(ate64) and n64 >= 30 and n32 >= 30
    assert ate32 < max(2.0 * ate64, 0.05), (ate32, ate64)
