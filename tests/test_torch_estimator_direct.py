"""The estimator driven directly, with no pipeline, as a ROS-style node or a
caller checkpointing between frames drives it: process_imu, then
process_image_arrays or the dict interface process_image, against the JAX
package's estimator after every call (CPU, f64). Unless the caller passes
defer_solve=True, a frame's solve is finalized before the call returns.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_bearing_harness import (
    F64,
    BearingFrontEnd,
    JConfig,
    JEstimator,
    eigh_marginalizing,
    make_landmarks,
    make_worlds,
)

from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig

# Both sides in f64 on the same calls: the parity streams' bound.
POSE_M = 1e-6


def _state(est):
    return len(est.traj_p), est.solver_flag, est.frame_count, est.pending_count()


def test_direct_calls_match_jax():
    """A 1.5 s bearing stream (48 landmarks, 20 Hz frames, 200 Hz IMU):
    each frame by process_image_arrays, process_image(dict) or
    process_image_arrays(defer_solve=True) in turn. After every call the
    trajectory's length, solver flag, frame count and pending solves equal
    JAX's and Ps[WIN] is within POSE_M; a deferred solve stays pending (on
    both) until finalize_solve."""
    jw, tw = make_worlds()
    pts = make_landmarks()
    jest = eigh_marginalizing(JEstimator(JConfig(n_feature_slots=64, solver_dtype=jnp.float64)))
    test = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=F64, device="cpu"))
    fe = BearingFrontEnd(tw, pts)
    imu_rate, per_frame = 200.0, 10
    ts = np.arange(int(1.5 * imu_rate) + 1) / imu_rate
    acc, om = tw.imu_batch(ts)
    deferred = 0
    for k, t in enumerate(ts):
        for est in (jest, test):
            est.process_imu(0.0 if k == 0 else 1.0 / imu_rate, acc[k], om[k])
        if k % per_frame:
            continue
        ids, b, vel, rows, mask = fe.process_arrays(None, t)
        way = (k // per_frame) % 3
        for est in (jest, test):
            if way == 0:
                est.process_image_arrays(ids, b, vel, rows, mask, float(t))
            elif way == 1:
                est.process_image({int(i): (b[i], vel[i], rows[i]) for i in ids}, float(t))
            else:
                est.process_image_arrays(ids, b, vel, rows, mask, float(t), defer_solve=True)
        assert _state(test) == _state(jest)
        np.testing.assert_allclose(test.Ps[test.WIN], jest.Ps[jest.WIN], atol=POSE_M, rtol=0)
        if test.solver_flag == test.NON_LINEAR:
            if way == 2:
                deferred += 1
                assert test.pending_count() == 1
                n = len(test.traj_p)
                for est in (jest, test):
                    est.finalize_solve()
                assert _state(test) == _state(jest) and len(test.traj_p) == n + 1
            assert test.pending_count() == 0
            np.testing.assert_allclose(test.traj_p[-1], jest.traj_p[-1], atol=POSE_M, rtol=0)
            np.testing.assert_allclose(test.Ps[test.WIN], jest.Ps[jest.WIN], atol=POSE_M, rtol=0)
    assert test.solver_flag == test.NON_LINEAR and len(test.traj_p) > 15 and deferred >= 5
    np.testing.assert_array_equal(test.times, jest.times)
    assert np.abs(np.asarray(test.traj_p) - np.asarray(jest.traj_p)).max() <= POSE_M
