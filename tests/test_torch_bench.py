"""The port's bench (``lfvio_tpu_torch/bench.py``) against the repository
root's ``bench.py`` on the CPU, at a small size: its knobs, its workload
against a JAX world built as ``bench.py:58-69`` builds it, and its run and
JSON line. On the card it runs through ``chip_smoke.py`` (phase 15).
"""

import dataclasses
import functools
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvio_tpu.cam import ScaramuzzaCamera as JScaramuzza
from lfvio_tpu.runtime.synthetic import SyntheticWorld as JWorld, fit_inverse_poly as j_fit
from lfvio_tpu.runtime.tracker import FrontEnd as JFrontEnd

from lfvio_tpu_torch import bench

torch.set_num_threads(2)

W, H = 320, 240
HIGH_RATE = {"LFVIO_BENCH_FRAME_RATE": "30", "LFVIO_BENCH_MAX_CNT": "300",
             "LFVIO_BENCH_WINDOW": "20", "LFVIO_BENCH_SLOTS": "384"}


@pytest.mark.parametrize("environ, expected", [
    # bench.py:73-78's defaults.
    ({}, dict(frame_rate=15.0, max_cnt=200, window=10, n_slots=256, duration=6.0)),
    # bench.py:71-72's high-rate configuration (BASELINE.json configs[3]).
    (HIGH_RATE, dict(frame_rate=30.0, max_cnt=300, window=20, n_slots=384, duration=6.0)),
], ids=["defaults", "high_rate"])
def test_config_from_env(environ, expected):
    cfg = bench.config_from_env(environ)
    assert dataclasses.asdict(cfg) == expected
    assert isinstance(cfg.max_cnt, int) and isinstance(cfg.frame_rate, float)


def _jax_bench_world(W, H):
    """The camera and world of bench.py:58-69 at (W, H)."""
    base = np.array([-2.445239e2, 0.0, 1.748610e-3, -1.757770e-6, 4.475965e-9])
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    cam = JScaramuzza(poly=f32(base), inv_poly=f32(j_fit(base, max_rho=510.0)), C=f32(1.0),
                      D=f32(0.0), E=f32(0.0), cx=f32(W / 2.0), cy=f32(H / 2.0))
    return cam, JWorld(camera=cam, width=W, height=H)


# The JAX world renders in float64 under the tests' x64, the port's in
# float32 (bench.py's precision): a pixel whose value lies within float32's
# error of .5 rounds to the next uint8. Seen: at most 5 of 76,800 pixels
# differ, by 1.
U8_MAX_DIFF = 1
U8_MAX_SHARE = 1e-3


def test_workload_matches_bench_py():
    """bench.workload at 320x240 against bench.py's JAX world at the same
    size: the same events (kinds and times; IMU samples to 1e-9), the same
    uint8 frames at three times (to U8_MAX_DIFF on at most U8_MAX_SHARE of
    the pixels), and the FrontEnd / Estimator / VioPipeline that bench.py
    builds (bench.py:105-119)."""
    cfg = bench.config_from_env({})
    wl = bench.workload(cfg, device="cpu", width=W, height=H)
    jcam, jw = _jax_bench_world(W, H)
    js = jw.generate(cfg.duration, cfg.frame_rate, 200.0)
    assert [(e[0], e[1]) for e in wl.stream] == [(e[0], e[1]) for e in js]
    for a, b in zip(wl.stream, js):
        if a[0] == "imu":
            np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-9)
            np.testing.assert_allclose(a[3], b[3], rtol=0, atol=1e-9)
    ts = sorted(wl.frames)
    assert len(ts) == int(cfg.duration * cfg.frame_rate)
    for t in (ts[0], ts[len(ts) // 2], ts[-1]):
        img = wl.frames[t]
        assert img.dtype == torch.uint8 and img.shape == (H, W) and img.device.type == "cpu"
        d = np.abs(img.numpy().astype(np.int32) - jw.render_u8(t).astype(np.int32))
        assert d.max() <= U8_MAX_DIFF and (d > 0).mean() <= U8_MAX_SHARE, (t, d.max(),
                                                                          (d > 0).sum())

    fe, est, pipe = wl.make()
    jfe = JFrontEnd(jcam, (H, W), max_cnt=200, min_dist=20, n_slots=256,
                    annulus=(W / 2.0, H / 2.0, 500.0 * 0.95, 160.0), equalize=True,
                    dtype=jnp.float32)
    assert (fe.H, fe.W, fe.max_cnt, fe.min_dist, fe.N, fe.equalize, fe.use_pallas) == (
        jfe.H, jfe.W, jfe.max_cnt, jfe.min_dist, jfe.N, jfe.equalize, jfe.use_pallas)
    assert fe.dtype == torch.float32
    np.testing.assert_array_equal(fe.static_mask.numpy(), np.asarray(jfe.static_mask))
    c = est.cfg
    assert (c.n_feature_slots, c.window, c.solver_dtype, c.solve_lag, c.max_imu_per_interval,
            c.device_chain) == (256, 10, torch.float32, 2, 64, True)
    assert (pipe.freq, pipe.depth, pipe.fe, pipe.est) == (10.0, 3, fe, est)
    # The high-rate knobs reach the same objects.
    hi = dataclasses.replace(bench.config_from_env(HIGH_RATE), duration=0.2)
    fe, est, _ = bench.workload(hi, "cpu", W, H).make()
    assert (fe.max_cnt, fe.N, est.cfg.n_feature_slots, est.WIN) == (300, 384, 384, 20)


SHORT = dict(duration=1.0)  # 15 frames: 9 of warm-up (t <= 0.6 s), 6 timed


def test_run_on_the_cpu():
    """run() at 320x240 on a 1 s stream: a finite positive frames/s over
    the frames after the split; no kernel launch on the CPU."""
    cfg = dataclasses.replace(bench.config_from_env({}), **SHORT)
    fig = bench.run(cfg, device="cpu", width=W, height=H)
    assert fig["frames_timed"] == 6 and fig["frames_warmup"] == 9
    assert math.isfinite(fig["frames_per_s"]) and fig["frames_per_s"] > 0
    assert fig["lk_launches"] == fig["sym_eig_launches"] == 0
    assert fig["lk_launches_run"] == fig["sym_eig_launches_run"] == 0
    assert fig["peak_memory_bytes"] is None and fig["device"] == "cpu"
    # The front end's programs run op by op on the CPU: nothing captured.
    assert fig["frontend_graphs"] == fig["frontend_replays"] == fig["graphs_captured_timed"] == 0
    json.dumps(fig)  # main logs it as one JSON line


def test_make_frontend_is_the_workloads_tracker():
    """bench.make_frontend builds the FrontEnd the workload's make builds,
    for any configuration, and takes FrontEnd arguments over its own."""
    hi = dataclasses.replace(bench.config_from_env(HIGH_RATE), duration=0.2)
    wl = bench.workload(hi, "cpu", W, H)
    fe, _, _ = wl.make()
    made = bench.make_frontend(hi, wl.world.camera, "cpu", W, H)
    assert (made.max_cnt, made.N, made.min_dist, made.equalize, made.H, made.W) == (
        fe.max_cnt, fe.N, fe.min_dist, fe.equalize, fe.H, fe.W) == (300, 384, 20, True, H, W)
    assert torch.equal(made.static_mask, fe.static_mask)
    other = bench.make_frontend(hi, wl.world.camera, "cpu", W, H, use_pallas=True, max_cnt=7)
    assert other.use_pallas and other.max_cnt == 7 and not fe.use_pallas


class _Recorder:
    """A pipeline that records what it is fed."""

    def __init__(self):
        self.calls = []

    def feed_imu(self, t, acc, gyr):
        self.calls.append(("imu", t))

    def feed_frame(self, t, img):
        self.calls.append(("frame", t))

    def flush(self):
        self.calls.append(("flush", None))


def test_timed_window_splits_the_stream():
    """timed_window feeds every event at t <= t_split, then calls on_split,
    then feeds the rest and flushes, and counts the frames of each part."""
    frames = {t: torch.zeros(2, 2, dtype=torch.uint8) for t in (0.1, 0.2, 0.3, 0.4)}
    stream = [("imu", 0.05, None, None), ("frame", 0.1, None), ("frame", 0.2, None),
              ("imu", 0.25, None, None), ("frame", 0.3, None), ("frame", 0.4, None)]
    wl = bench.Workload(world=None, stream=stream, frames=frames, make=None)
    pipe = _Recorder()
    win = bench.timed_window(pipe, wl, 0.2, on_split=lambda: pipe.calls.append(("split", None)))
    assert pipe.calls == [("imu", 0.05), ("frame", 0.1), ("frame", 0.2), ("split", None),
                          ("imu", 0.25), ("frame", 0.3), ("frame", 0.4), ("flush", None)]
    assert (win.frames_warmup, win.frames_timed) == (2, 2)
    assert win.warmup_s >= 0 and win.seconds > 0


def test_main_prints_one_json_line(monkeypatch, capsys):
    """main prints exactly one stdout line, with bench.py's four keys and
    the port's metric name; its figures go to stderr."""
    for name in bench.KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("LFVIO_BENCH_DURATION", str(SHORT["duration"]))
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, width=W, height=H))
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    res = json.loads(lines[0])
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    assert res["metric"] == "vio_frames_per_s_torch_1gpu" and res["unit"] == "frames/s"
    assert math.isfinite(res["value"]) and res["value"] > 0
    assert res["vs_baseline"] == pytest.approx(res["value"] / 10.0)
    fig = json.loads(err.split("figures ", 1)[1].splitlines()[0])
    assert fig["frames_per_s"] == res["value"] and fig["duration"] == SHORT["duration"]


def test_bench_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a card the bench raises unless --device cpu is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
