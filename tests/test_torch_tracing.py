"""The port's spans (``lfvio_tpu_torch/tracing.py``) on the CPU: nothing
opened without a recording profile; under one, a short ``VioPipeline`` run's
Chrome trace holds only the documented spans, each with its frame, nested
on the one host thread, covering the host's time inside the calls into the
pipeline. ``DeviceProgram`` opens its span and calls its function as
before. The card's program spans (capture, copy_in, replay) are
``tests/test_torch_cuda.py``'s.
"""

import contextlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lfvio_tpu_torch import tracing
from lfvio_tpu_torch.device import DeviceProgram
from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, FrontEnd, VioPipeline
from lfvio_tpu_torch.runtime.synthetic import (
    MINDVISION_POLY,
    SyntheticWorld,
    fit_inverse_poly,
    scaramuzza_camera,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
W, H, SLOTS = 320, 240, 48
DURATION = 1.6  # s: 24 frames, enough to initialize the estimator and finalize 3+ solves
HARNESS = ("vio::feed_imu", "vio::feed_frame", "vio::flush")  # the caller's own ranges
COVERED = 0.95  # share of the host's time in the caller's ranges under a program span
# PERF.md §3's table of the port's spans: one row a span, its name first.
DOCUMENTED = re.compile(r"^\| `vio::([a-z_.<>]+)` \|", re.M)


@pytest.fixture(scope="module")
def rig():
    """A stream of the mindvision PAL rig scaled to 320x240 (the polynomial
    rescaled as vio_bench's tiny cell does) and a maker of the pipeline in
    the main path's form: depth 3, solve lag 2, publish 10 Hz, window 4."""
    s = W / 1280
    poly = np.asarray(MINDVISION_POLY) / s ** np.arange(5)
    cam = scaramuzza_camera(poly, fit_inverse_poly(poly, max_rho=130.0), W, H,
                            dtype=torch.float32)
    world = SyntheticWorld(camera=cam, width=W, height=H, traj_freq=0.5, device="cpu")
    stream = world.generate(DURATION, 15.0, 200.0)
    frames = {e[1]: world.render_u8(e[1]) for e in stream if e[0] == "frame"}

    def make():
        fe = FrontEnd(cam, (H, W), max_cnt=SLOTS, min_dist=10, n_slots=SLOTS,
                      annulus=(W / 2, H / 2, 475 * s, 160 * s), device="cpu")
        est = Estimator(EstimatorConfig(n_feature_slots=SLOTS, window=4,
                                        solver_dtype=torch.float32, solve_lag=2,
                                        max_imu_per_interval=64, device="cpu"))
        return est, VioPipeline(fe, est, freq=10.0, depth=3)

    return stream, frames, make


def _feed(pipe, stream, frames, ranges):
    """The stream into ``pipe`` as vio_bench's window feeds it, each call
    inside the caller's own range when ``ranges``."""
    rf = torch.profiler.record_function if ranges else (lambda name: contextlib.nullcontext())
    for e in stream:
        if e[0] == "imu":
            with rf("vio::feed_imu"):
                pipe.feed_imu(e[1], e[2], e[3])
        else:
            with rf("vio::feed_frame"):
                pipe.feed_frame(e[1], frames[e[1]])
    with rf("vio::flush"):
        pipe.flush()


@pytest.fixture(scope="module")
def traced(rig, tmp_path_factory):
    """The vio:: events of one profiled run (shapes recorded, so the
    spans' keyword arguments reach the trace) and its estimator."""
    stream, frames, make = rig
    est, pipe = make()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        _feed(pipe, stream, frames, ranges=True)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and str(e.get("name")).startswith("vio::")]
    return spans, est


def _program_spans(spans):
    return [e for e in spans if e["name"] not in HARNESS]


def test_no_profiler_no_range(rig, monkeypatch):
    """Without a recording profile span() and region() return one shared
    no-op, and a whole pipeline run, solves included, opens no range."""
    assert tracing.span("pipe.frame", 1.0) is tracing.span("est.wait") is tracing._OFF
    assert tracing.region("marg_old::qr") is tracing._OFF

    def refuse(*a, **k):
        raise AssertionError("a range was opened without a recording profile")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    stream, frames, make = rig
    est, pipe = make()
    _feed(pipe, stream, frames, ranges=False)
    assert len(est.times) >= 3


def test_spans_are_the_documented_ones(traced):
    """Every span of the run is one PERF.md's table lists, and the run
    reached every span there but the card's program spans."""
    spans, est = traced
    assert len(est.times) >= 3
    names = {e["name"][len(tracing.PREFIX):] for e in _program_spans(spans)}
    table = DOCUMENTED.findall((REPO / "PERF.md").read_text())
    fixed = {n for n in table if "<program>" not in n}
    programs = re.compile("|".join(re.escape(n).replace("<program>", "[A-Za-z0-9_]+")
                                   for n in table if "<program>" in n))
    assert programs.pattern and len(fixed) >= 20
    for n in names:
        assert n in fixed or programs.fullmatch(n), n
    assert fixed <= names
    assert {"prog.solve.eager", "prog.marg_old.eager", "prog.frontend_published.eager",
            "prog.frontend_unpublished.eager"} <= names


def test_every_span_carries_its_frame(traced):
    """Each program span carries a frame's stream time; a span nested in
    another without a frame of its own carries the outer one's."""
    spans, _ = traced
    prog = _program_spans(spans)
    assert prog
    for e in prog:
        assert isinstance(e.get("args", {}).get("frame"), float), e["name"]
    adv = [e for e in prog if e["name"] == "vio::pipe.advance"]
    for e in prog:
        if e["name"] == "vio::fe.wait":
            outer = [a for a in prog if a["name"] == "vio::fe.finalize"
                     and a["ts"] <= e["ts"] and e["ts"] + e["dur"] <= a["ts"] + a["dur"]]
            assert outer and outer[0]["args"]["frame"] == e["args"]["frame"]
    assert len({e["args"]["frame"] for e in adv}) == len(adv)


def test_spans_nest(traced):
    """On the one host thread any two spans are disjoint or one holds the
    other (the trace's times are whole nanoseconds)."""
    spans, _ = traced
    assert len({(e["pid"], e["tid"]) for e in spans}) == 1
    eps = 1e-3
    stack = []
    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        s, end = e["ts"], e["ts"] + e["dur"]
        while stack and stack[-1][1] <= s + eps:
            stack.pop()
        assert not stack or end <= stack[-1][1] + eps, (e["name"], stack[-1][2])
        stack.append((s, end, e["name"]))


def test_spans_cover_the_calls(traced):
    """Inside the caller's vio::feed_imu / feed_frame / flush ranges the
    program's spans cover at least COVERED of the host's time."""
    spans, _ = traced
    outer = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] in HARNESS)
    inner = sorted((e["ts"], e["ts"] + e["dur"]) for e in _program_spans(spans))
    covered, j = 0.0, 0
    for a, b in outer:
        while j < len(inner) and inner[j][1] <= a:
            j += 1
        t, k = a, j
        while k < len(inner) and inner[k][0] < b:
            s, e = max(inner[k][0], t), min(inner[k][1], b)
            if e > s:
                covered += e - s
                t = e
            k += 1
    total = sum(b - a for a, b in outer)
    assert covered / total >= COVERED, covered / total


def test_device_program_on_the_cpu():
    """On CPU tensors a DeviceProgram calls its function as it is, inside
    its one span when a profile records, and inside none otherwise."""
    calls = []

    def fn(x, y):
        calls.append(1)
        return x * 2 + y

    prog = DeviceProgram(fn, name="twice")
    x, y = torch.arange(4.0), torch.ones(4)
    assert torch.equal(prog(x, y), fn(x, y))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = prog(x, y)
    assert torch.equal(out, x * 2 + y) and len(calls) == 3
    names = [e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert names == ["vio::prog.twice.eager"]
    assert prog.graph is None and prog.replays == 0


def test_chip_smoke_skips_every_range():
    """Every record_function range the port opens starts with one of
    chip_smoke's RANGES, whose device copies its census skips as
    non-kernels, and relocalization's is its own."""
    import chip_smoke

    src = "\n".join(p.read_text() for p in (REPO / "lfvio_tpu_torch").rglob("*.py"))
    opened = set(re.findall(r'region\(f?"([a-z_]+::)', src))
    assert opened >= {"proj_factor::", "imu_factor::", "relo_factor::", "marg_qr::",
                      "marg_old::"}
    for name in opened:
        assert name.startswith(chip_smoke.RANGES), name
    assert "relo_factor::" in chip_smoke.WRAPPER_RANGES
