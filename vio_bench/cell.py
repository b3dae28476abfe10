"""One run of one cell: set-up, the measured window, the per-layer readings
and the check of what the window produced.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs/<name>.json``, through BENCHMARK.json's ``file``) and a traffic
mix (``traffic/<name>.json``); its limits are ``limits/<cell>.json`` and
each metric is read by ``metrics/<metric>.py``. Nothing here names a cell.

The program is the port, ``lfvio_tpu_torch``, built through its public
constructors (FrontEnd, Estimator, VioPipeline). The harness observes it
from outside: calls into the pipeline, the front end's ``dispatch`` and the
device programs' calls (``DeviceProgram.__call__``), around which it keeps
its own spans (CUDA events and ``record_function`` ranges, traced runs
only), its counters, and the inputs and outputs of a sample of frames and
solves drawn from the seed for the check.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import check, roofline, trace
from .traffic import Replay

PACKAGE = "vio_bench"  # the benchmark's folder in a checkout
DTYPES = {"float32": torch.float32, "float64": torch.float64}  # a configuration's precision
SLICE_FRAMES = 30  # frames in the traced run's profiler slice
SLICE_AT = 0.4  # the slice starts this far into the window
WARMUP_PERIODS = 1.0  # periods of the steady traffic run in set-up after initialization
SAMPLE_FRAMES = 6  # tracked frames of the window that the check follows
SAMPLE_SOLVES = 4  # solves (with their marginalizations) of the window that the check follows
PUBLISHED_KEPT = 16  # the front end's newest published frames kept for the check's packing


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload's entries, configuration, traffic and limits, found by name."""

    def __init__(self, root: Path, workload: str):
        bench = load_json(root / "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = entries[workload]
        self.name = workload
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.cfg = load_json(root / cfgs[self.entry["config"]]["file"])
        self.traffic = load_json(root / PACKAGE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(root / PACKAGE / "limits" / f"{workload}.json")
        self.root = root
        self.chips = int(self.entry["chips"])
        self.end_to_end = bench["end_to_end"]
        self.per_layer = bench["per_layer"]


class Reservoir:
    """A uniform sample of k of the candidates offered, drawn from ``rng``:
    ``offer`` says at once whether the i-th candidate is taken (and so
    whether to copy it), ``put`` stores it in the slot offer returned."""

    def __init__(self, k, rng):
        self.k, self.rng, self.n, self.items = k, rng, 0, {}

    def offer(self):
        self.n += 1
        if self.n <= self.k:
            return self.n - 1
        j = int(self.rng.integers(self.n))
        return j if j < self.k else None

    def put(self, slot, item):
        self.items[slot] = item

    def values(self):
        return [self.items[k] for k in sorted(self.items)]


def build(cell: Cell, seed: int, device):
    """The replay and the port's front end, estimator and pipeline for the
    cell's configuration."""
    from lfvio_tpu_torch.cam import ScaramuzzaCamera
    from lfvio_tpu_torch.imu import ImuNoise
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, FrontEnd, VioPipeline

    from .world import fit_inverse_poly

    cfg = cell.cfg
    dtype = DTYPES[cfg["precision"]]
    replay = Replay(cfg, cell.traffic, seed, device)
    cam = cfg["camera"]
    if cam["model"] != "scaramuzza":
        raise ValueError(f"camera model {cam['model']!r}: the harness builds Scaramuzza cameras only")
    W, H = int(cam["width"]), int(cam["height"])
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    camera = ScaramuzzaCamera(
        poly=t(np.asarray(cam["poly"])), inv_poly=t(fit_inverse_poly(cam["poly"],
                                                                      cam["inv_poly_max_rho"])),
        C=t(1.0), D=t(0.0), E=t(0.0), cx=t(W / 2.0), cy=t(H / 2.0))
    max_r, min_r = cfg["annulus"]
    fe = FrontEnd(camera, (H, W), max_cnt=cfg["max_cnt"], min_dist=cfg["min_dist"],
                  n_slots=cfg["n_slots"], equalize=cfg["equalize"],
                  annulus=(W / 2.0, H / 2.0, max_r, min_r), dtype=dtype,
                  seed=seed % 2**63, device=device)
    n = cfg["imu_noise"]
    est = Estimator(EstimatorConfig(
        n_feature_slots=cfg["n_slots"], window=cfg["window"], solver_dtype=dtype,
        solve_lag=cfg["solve_lag"], max_imu_per_interval=cfg["max_imu_per_interval"],
        min_parallax=cfg["min_parallax"], g_norm=cfg["g_norm"],
        max_iterations=cfg["max_iterations"], max_solver_time=cfg["max_solver_time"],
        imu_noise=ImuNoise(n["acc_n"], n["gyr_n"], n["acc_w"], n["gyr_w"]), device=device))
    pipe = VioPipeline(fe, est, freq=cfg["freq"], depth=cfg["depth"])
    return replay, fe, est, pipe


class Observer:
    """The harness's view of the program: counts of each device program's
    calls, CUDA-event spans around them (traced runs), and the sampled
    frames' and solves' inputs and outputs."""

    def __init__(self, fe, est, replay, seed, spans):
        self.fe, self.est, self.replay = fe, est, replay
        self.calls = {}
        self.spans = spans  # name -> [(start event, end event)] when tracing
        self.recording = False
        self.ranges = False
        rng = np.random.default_rng([seed % 2**63, 7])
        self.frames = Reservoir(SAMPLE_FRAMES, rng)
        self.solves = Reservoir(SAMPLE_SOLVES, rng)
        self._solve_slot = None
        self.handles = []  # the slice's front-end handles (traced runs)
        self.keep_handles = False
        self.published = set()  # times of the window's frames the throttle publishes
        self.pub_handles = {}  # time -> handle of the newest published frames

    def install(self):
        from lfvio_tpu_torch.device import DeviceProgram

        obs = self
        orig = DeviceProgram.__call__
        self._restore = lambda: setattr(DeviceProgram, "__call__", orig)

        def call(prog, *args):
            name = prog.name
            if not obs.recording:
                return orig(prog, *args)
            obs.calls[name] = obs.calls.get(name, 0) + 1
            before = obs.before(name, args)
            rng = (torch.profiler.record_function("vio::" + name) if obs.ranges
                   else contextlib.nullcontext())
            ev = None
            if obs.spans is not None:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with rng:
                out = orig(prog, *args)
            if ev is not None:
                ev[1].record()
                obs.spans.setdefault(name, []).append(ev)
            obs.after(name, args, out, before)
            return out

        DeviceProgram.__call__ = call
        fe_dispatch = self.fe.dispatch

        def dispatch(img, t, publish=True):
            slot = None
            if obs.recording:
                if publish:
                    obs.published.add(t)
                if obs.fe._dev_pos is not None:
                    slot = obs.frames.offer()
                if slot is not None:
                    inputs = (obs.fe._dev_pos.clone(), obs.fe._dev_valid.clone())
            handle = fe_dispatch(img, t, publish=publish)
            if publish:
                # Kept from set-up on: a solve early in the window packs a
                # frame dispatched before it.
                obs.pub_handles[t] = handle
                while len(obs.pub_handles) > PUBLISHED_KEPT:
                    del obs.pub_handles[min(obs.pub_handles)]
            if slot is not None:
                obs.frames.put(slot, dict(k=obs.replay.frame_of(t), publish=publish,
                                          pos=inputs[0], valid=inputs[1], handle=handle))
            if obs.recording and obs.keep_handles and handle[0] == "step":
                obs.handles.append(handle)
            return handle

        self.fe.dispatch = dispatch

    def uninstall(self):
        self._restore()
        del self.fe.dispatch

    def before(self, name, args):
        if name == "solve":
            slot = self.solves.offer()
            self._solve_slot = slot
            return slot
        return None

    def after(self, name, args, out, slot):
        from lfvio_tpu_torch.device import clone_tree

        if name == "solve" and slot is not None:
            res, _ = out
            t = float(self.est.headers[self.est.WIN])
            self.solves.put(slot, dict(
                t=t, packed=args[0], prior=args[1], chain=args[2], out=clone_tree(res["out"]),
                marg=None, published=self.published_features(t)))
        elif name in ("marg_old", "marg_new") and self._solve_slot is not None:
            self.solves.items[self._solve_slot]["marg"] = (name, clone_tree(out))
            self._solve_slot = None


    def published_features(self, t):
        """The front end's output for the frame at ``t`` that the estimator
        was handed, (status, bearings) as fetched, or None if the frame was
        not dispatched in the window as a published tracked frame."""
        handle = self.pub_handles.get(t)
        if handle is None or handle[0] != "step":
            return None
        status, _, _, bear = handle[1].numpy()
        return np.array(status, copy=True), np.array(bear, copy=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device=None, log=print,
        t_start=None, control=False):
    """Set up, measure for ``seconds``, read and check. Returns the run's
    readings, the window's and the check's; set-up counts from ``t_start``
    (the process's start; default: now). ``control`` adds the control's
    readings on the same samples (``check.readings``)."""
    from lfvio_tpu_torch.runtime import ate_rmse

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    replay, fe, est, pipe = build(cell, seed, device)
    obs = Observer(fe, est, replay, seed, {} if traced else None)
    obs.install()
    try:
        events = replay.events()
        # Set-up: until the estimator is initialized and a whole period of
        # the steady traffic has run after it, so that every program the
        # periodic traffic uses has been captured and warmed.
        t_init = None
        period = replay.traj.period * WARMUP_PERIODS
        while True:
            ev = next(events)
            _feed(pipe, replay, ev)
            if t_init is None and est.solver_flag == est.NON_LINEAR:
                t_init = ev[1]
            if t_init is not None and ev[0] == "frame" and \
                    ev[1] >= max(t_init, replay.traj.steady_from) + period:
                break
        _sync(device)
        # Set-up's objects leave the collector's generations, so that a full
        # collection in the window walks only what the window makes.
        gc.collect()
        gc.freeze()
        graphs_setup = est.graph_stats()[0] + fe.graph_stats()[0]
        n_restarts0, n_lm0 = pipe.n_restarts, len(est.lm_runs)
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s: initialized at stream t = {t_init:.3f} s, "
            f"{graphs_setup} graphs captured, warm-up to t = {ev[1]:.3f} s")
        win = window(pipe, est, fe, replay, events, obs, seconds, traced, device, log)
        _sync(device)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        graphs_window = est.graph_stats()[0] + fe.graph_stats()[0] - graphs_setup
        lm = est.lm_runs[n_lm0:]
        times, traj_p = np.asarray(est.times), np.asarray(est.traj_p)
        ate_m = ate_rmse(times, traj_p, times, replay.traj.pose(times)[0])[0] if len(times) else None
        res = dict(
            setup_s=setup_s, window=win, memory_peak_bytes=int(peak), calls=dict(obs.calls),
            lm_runs=lm, restarts=pipe.n_restarts - n_restarts0, graphs_window=graphs_window,
            initialized=est.solver_flag == est.NON_LINEAR,
            ate_m=ate_m, cfg=cell.cfg,
            shapes=roofline.level_shapes(cell.cfg["camera"]["height"],
                                         cell.cfg["camera"]["width"]))
        if traced:
            res["spans_ms"] = {k: [a.elapsed_time(b) for a, b in v] for k, v in obs.spans.items()}
        frames, solves = obs.frames.values(), obs.solves.values()
        samples = dict(frames=frames, solves=solves, times=times, traj_p=traj_p,
                       images={i: replay.images[replay.image_index(i)].clone()
                               for f in frames for i in (f["k"] - 1, f["k"])})
    finally:
        obs.uninstall()
        gc.unfreeze()
    # The program's state is freed before the reference runs, so that the
    # reference sets no peak and finds the memory it needs.
    del pipe, est, fe, replay, obs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["check"] = check.judge(samples, cell.cfg, cell.limits, device)
    res["check_s"] = time.perf_counter() - t0
    if control:
        res["control"] = check.readings(samples, cell.cfg, device, control=True)
    return res


def _feed(pipe, replay, ev):
    if ev[0] == "imu":
        pipe.feed_imu(ev[1], ev[2], ev[3])
    else:
        pipe.feed_frame(ev[1], replay.images[replay.image_index(ev[2])])


def window(pipe, est, fe, replay, events, obs, seconds, traced, device, log):
    """The measured window: every event handed to the pipeline as soon as the
    previous call returns, for ``seconds``, then ``flush`` and a wait for the
    card. A frame's pose latency runs from its hand-over to the return of the
    first call after which the trajectory holds its pose."""
    handed, lat, in_window = {}, [], []
    n_traj, n_frames = len(est.times), 0
    rf = torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())
    prof = slice_start = None
    sliced = None  # (the stopped profiler, the slice's frames)
    obs.recording = True
    t0 = time.perf_counter()
    deadline = t0 + seconds
    slice_at = t0 + SLICE_AT * seconds
    while True:
        ev = next(events)
        if ev[0] == "imu":
            with rf("vio::feed_imu"):
                pipe.feed_imu(ev[1], ev[2], ev[3])
        else:
            handed[ev[1]] = time.perf_counter()
            in_window.append(ev[1])
            with rf("vio::feed_frame"):
                pipe.feed_frame(ev[1], replay.images[replay.image_index(ev[2])])
            n_frames += 1
            if traced and prof is None and slice_start is None and time.perf_counter() >= slice_at:
                prof, slice_start = _start_slice(obs, device), n_frames
            elif prof is not None and n_frames - slice_start >= SLICE_FRAMES:
                _end_slice(prof, obs, device)
                sliced, prof = (prof, n_frames - slice_start), None
        if len(est.times) > n_traj:
            now = time.perf_counter()
            for t in est.times[n_traj:]:
                if t in handed:
                    lat.append(now - handed.pop(t))
            n_traj = len(est.times)
        if time.perf_counter() >= deadline and prof is None:
            break
    with rf("vio::flush"):
        pipe.flush()
    now = time.perf_counter()
    for t in est.times[n_traj:]:
        if t in handed:
            lat.append(now - handed.pop(t))
    _sync(device)
    wall = time.perf_counter() - t0
    obs.recording = False
    landed = set(est.times)
    failed = sum(1 for t in in_window if t in obs.published and t not in landed)
    log(f"window: {n_frames} frames in {wall:.4f} s, {len(lat)} poses published, "
        f"{failed} published frames without a pose")
    slice_info = _read_slice(sliced[0], obs, sliced[1]) if sliced else {}
    return dict(frames=n_frames, wall_s=wall, latencies_s=lat, failed=failed, slice=slice_info)


def _start_slice(obs, device):
    obs.ranges, obs.keep_handles = True, True
    obs.handles = []
    _sync(device)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    prof._slice = torch.profiler.record_function(trace.SLICE)
    prof._slice.__enter__()
    return prof


def _end_slice(prof, obs, device):
    """Stop the slice's profiler; its trace is read once the window has closed."""
    _sync(device)
    prof._slice.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    obs.ranges, obs.keep_handles = False, False


def _read_slice(prof, obs, n_frames):
    """The slice's numbers from its trace (``trace.summarize``), with its
    frames and the slots each of its LK launches tracked."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = trace.summarize(trace.load(path))
    finally:
        os.unlink(path)
    if summary is None:
        return {}
    summary["frames"] = n_frames
    summary["n_valid"] = _valid_counts(obs.handles)
    return summary


def _valid_counts(handles):
    """The valid slots each tracked frame's LK ran on: the slot chain that
    the frame before it left (its status, and on a published frame its
    refills), from the fetched outputs."""
    counts = []
    for h in handles[:-1]:
        status, new_src = h[1].numpy()[:2]
        valid = status | (new_src >= 0) if h[3] else status
        counts.append(int(np.count_nonzero(valid)))
    return counts


def reader(root: Path, name: str):
    """The module ``<root>/vio_bench/metrics/<name>.py``."""
    path = root / PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(cell: Cell, res, traced):
    """Every metric of the run's kind (end-to-end untraced, per-layer traced)
    that applies to the cell, each from ``metrics/<name>.py``; a reader that
    finds nothing to read gives None and the metric is left out."""
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(cell.root, m["name"]).read(res)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
