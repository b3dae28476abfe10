"""The metric arithmetic on made-up readings: the whole-window rate, the
95th percentile, card time a call from spans, the idle share, kernels a
frame and the LK roofline share from a synthetic trace."""

import numpy as np
import pytest

from vio_bench import roofline, trace
from vio_bench.cell import reader

from conftest import REPO


def _read(name, run):
    return reader(REPO, name).read(run)


def _run(**kw):
    run = dict(window=dict(frames=300, wall_s=2.5, latencies_s=list(np.arange(1, 101) * 1e-3),
                           slice={}), setup_s=12.5, lm_runs=[(8, 8, False), (6, 5, False)],
               cfg={"n_slots": 256}, shapes=roofline.level_shapes(960, 1280))
    run.update(kw)
    return run


def test_end_to_end_arithmetic():
    run = _run()
    assert _read("frames_per_s", run) == pytest.approx(120.0)
    assert _read("pose_latency_p95_ms", run) == pytest.approx(95.05)
    assert _read("setup_s", run) == 12.5
    assert _read("lm_iters_per_solve", run) == pytest.approx(7.0)
    assert _read("pose_latency_p95_ms", _run(window=dict(frames=1, wall_s=1, latencies_s=[],
                                                       slice={}))) is None


def test_span_arithmetic():
    run = _run(spans_ms={"frontend_published": [2.0, 2.0], "frontend_unpublished": [1.0],
                         "solve": [7.0, 6.0], "marg_old": [1.0], "marg_new": [0.5]})
    assert _read("frontend_card_ms", run) == pytest.approx(5.0 / 3)
    assert _read("solve_card_ms", run) == pytest.approx(6.5)
    assert _read("marg_card_ms", run) == pytest.approx(0.75)
    assert _read("solve_card_ms", _run()) is None  # an untraced run has no spans


def test_trace_reduction_and_device_metrics():
    ev = [{"ph": "X", "name": trace.SLICE, "ts": 0.0, "dur": 1000.0, "cat": "user_annotation"},
          {"ph": "X", "name": "vio::feed_imu", "ts": 100.0, "dur": 500.0},
          {"ph": "X", "name": "vio::solve", "ts": 200.0, "dur": 100.0},
          {"ph": "X", "name": "lk_pyramid_kernel", "ts": 0.0, "dur": 100.0, "cat": "kernel"},
          {"ph": "X", "name": "lk_pyramid_kernel", "ts": 50.0, "dur": 100.0, "cat": "kernel"},
          {"ph": "X", "name": "other", "ts": 400.0, "dur": 200.0, "cat": "kernel"},
          {"ph": "X", "name": "copy", "ts": 900.0, "dur": 200.0, "cat": "gpu_memcpy"},
          {"ph": "X", "name": "late", "ts": 2000.0, "dur": 5.0, "cat": "kernel"}]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(450e-6)  # [0,150) + [400,600) + [900,1000)
    assert s["kernels"] == 3
    assert s["count"]["lk_pyramid_kernel"] == 2
    # gaps [150,400) mid 275 in solve; [600,900) mid 750 outside any range
    assert s["idle_by_host"]["vio::solve"] == pytest.approx(250e-6)
    assert s["idle_by_host"]["vio::outside_calls"] == pytest.approx(300e-6)
    s.update(frames=3, n_valid=[200, 200])
    run = _run(window=dict(frames=10, wall_s=1.0, latencies_s=[], slice=s))
    assert _read("device_idle_pct", run) == pytest.approx(55.0)
    assert _read("kernels_per_frame", run) == pytest.approx(1.0)
    bound = roofline.lk_bound_s(run["shapes"], 256, 200)
    assert _read("lk_roofline_pct", run) == pytest.approx(100 * bound / 100e-6)
    assert _read("lk_roofline_pct", _run()) is None


def test_lk_bytes_follow_chip_smoke():
    """The bound's bytes: every slot's points in and out, then per level the
    smaller of the image and the features' patches."""
    shapes = roofline.level_shapes(960, 1280)
    assert shapes == [(960, 1280), (480, 640), (240, 320), (120, 160)]
    n = 200
    want = 256 * 9 * 2 + sum(min(4 * h * w, 4 * n * 45**2) + min(4 * h * w, 4 * n * 54**2)
                             for h, w in shapes)
    assert roofline.lk_bytes(shapes, 256, n) == want
