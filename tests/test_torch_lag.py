"""The lagged pipeline of the port against the JAX package, on the CPU in
f64: one bearing-harness stream through both pipelines at solve lag 2 with
the device chain, lag 2 from the host mirrors, lag 3 (stacked slides), and
through the dispatch / finalize path at depth 3 with the publish throttle
(in-flight and deferred frame queues)."""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_bearing_harness import make_worlds, run_both

KEYS = ["lag2_chain", "lag2_mirrors", "lag3", "depth3_throttled"]


@pytest.fixture(scope="module")
def worlds():
    return make_worlds()


@pytest.mark.parametrize("key", KEYS)
def test_lagged_stream_matches_jax(worlds, key):
    """The same initialization frame, the same solve times, trajectories
    within 1e-6 m (48 landmarks, 64 slots, 20 Hz; 1.5 s, or 2.6 s at the
    10 Hz publish throttle)."""
    jest, test, jp, tp, *_ = run_both(key, worlds)
    assert test.solver_flag == test.NON_LINEAR == jest.solver_flag
    assert len(test.times) == len(jest.times) >= (5 if "throttled" in key else 15)
    np.testing.assert_array_equal(test.times, jest.times)
    assert np.abs(np.asarray(test.traj_p) - np.asarray(jest.traj_p)).max() <= 1e-6
    assert np.abs(np.asarray(test.traj_q) - np.asarray(jest.traj_q)).max() <= 1e-6
    for name in ("Ps", "Vs", "Bas", "Bgs"):
        assert np.abs(getattr(test, name) - getattr(jest, name)).max() <= 1e-6, name
    np.testing.assert_array_equal(test.fm.feature_id, jest.fm.feature_id)
    assert len(tp.high_rate) == len(jp.high_rate) > 50
    assert test.pending_count() == 0 and not tp._fe_inflight and not tp._fe_deferred


def test_lag_changes_the_numerics(worlds):
    """The lagged configurations are not one run re-labelled: the LM starts
    from propagated (or chained) states, so the chained, the mirror-seeded
    and the lag-3 trajectories differ from each other, by little."""
    p = {k: np.asarray(run_both(k, worlds)[1].traj_p) for k in KEYS[:3]}
    for a, b in (("lag2_chain", "lag2_mirrors"), ("lag2_chain", "lag3")):
        d = np.abs(p[a] - p[b]).max()
        assert 0.0 < d < 0.05, (a, b, d)
