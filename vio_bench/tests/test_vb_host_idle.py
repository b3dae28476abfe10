"""The host-idle readers' arithmetic on a made-up slice: each sums the idle
seconds charged to its layer's spans (by name prefix) over the slice's
frames, in ms; 0.0 where no gap fell under its prefix; None without a
slice."""

import pytest

from vio_bench import trace
from vio_bench.cell import reader

from conftest import REPO

READERS = {"pipeline_idle_ms": "vio::pipe.", "frontend_host_idle_ms": "vio::fe.",
           "estimator_host_idle_ms": "vio::est.", "call_idle_ms": "vio::prog."}


def _read(name, sl):
    return reader(REPO, name).read(dict(window=dict(frames=30, wall_s=1.0, slice=sl)))


def test_prefix_sums():
    idle = {"vio::pipe.advance": 0.010, "vio::pipe.predict": 0.002, "vio::fe.wait": 0.004,
            "vio::est.wait": 0.020, "vio::est.pack": 0.001, "vio::est.features": 0.003,
            "vio::prog.solve.copy_in": 0.006, "vio::prog.solve.replay": 0.001,
            "vio::prog.frontend_published.replay": 0.0005,
            # the harness's own ranges: no layer's
            "vio::feed_imu": 0.1, "vio::solve": 0.05, "vio::outside_calls": 0.01}
    sl = dict(frames=4, window_s=0.5, busy_s=0.2, idle_by_host=idle)
    want = {"pipeline_idle_ms": 3.0, "frontend_host_idle_ms": 1.0,
            "estimator_host_idle_ms": 6.0, "call_idle_ms": 1.875}
    for name, ms in want.items():
        assert _read(name, sl) == pytest.approx(ms)


def test_no_program_span_reads_zero():
    sl = dict(frames=30, window_s=0.5, busy_s=0.1,
              idle_by_host={"vio::feed_imu": 0.3, "vio::solve": 0.1})
    for name in READERS:
        assert _read(name, sl) == 0.0


def test_no_slice_reads_none():
    for name in READERS:
        assert _read(name, {}) is None
        assert _read(name, dict(frames=0, idle_by_host={"vio::pipe.frame": 1.0})) is None


def test_innermost_program_span_takes_the_gap():
    """Through trace.summarize: a gap inside a program span inside the
    harness's range goes to the program span, one beside it to the range."""
    ev = [{"ph": "X", "name": trace.SLICE, "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "name": "vio::feed_imu", "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "name": "vio::pipe.advance", "ts": 100.0, "dur": 600.0, "cat": "cpu_op"},
          {"ph": "X", "name": "vio::est.wait", "ts": 200.0, "dur": 200.0, "cat": "cpu_op"},
          {"ph": "X", "name": "k", "ts": 0.0, "dur": 150.0, "cat": "kernel"},
          {"ph": "X", "name": "k", "ts": 450.0, "dur": 50.0, "cat": "kernel"},
          {"ph": "X", "name": "k", "ts": 650.0, "dur": 300.0, "cat": "kernel"}]
    sl = trace.summarize(ev)
    sl["frames"] = 2
    # gaps [150, 450) mid 300 in est.wait; [500, 650) mid 575 in pipe.advance;
    # [950, 1000) mid 975 in feed_imu
    assert _read("estimator_host_idle_ms", sl) == pytest.approx(0.15)
    assert _read("pipeline_idle_ms", sl) == pytest.approx(0.075)
    assert sl["idle_by_host"]["vio::feed_imu"] == pytest.approx(50e-6)
