"""Steady-state VIO throughput (frames/s) of the port on one CUDA card.

    python -m lfvio_tpu_torch.bench [--device D]

The port's counterpart of the repository root's ``bench.py`` (the JAX
package's), with its workload, its knobs and its JSON line.

Workload (``bench.py:58-119``): the full-scale synthetic PAL stream
(1280×960 mindvision polynomial, 200 Hz IMU) driven through the complete
pipeline: the tracker with CLAHE on (``equalize=True``; the JAX script's
docstring says "CLAHE-off", its code runs CLAHE), pyramid, the fused LK
kernel with its 15-px refine pass, spherical RANSAC, Shi-Tomasi refill; the
sliding-window estimator in float32 at solve lag 2 with the device state
chain; ``VioPipeline(freq=10, depth=3)``. Every frame is rendered to uint8
on the device before the clock starts. The first 60% of the stream (t ≤
0.6 · duration) is the warm-up (kernel loads, graph captures, the
estimator's initialization); frames/s is measured over the rest.

Knobs (environment, with ``bench.py:71-78``'s defaults):
``LFVIO_BENCH_FRAME_RATE`` 15.0, ``LFVIO_BENCH_MAX_CNT`` 200,
``LFVIO_BENCH_WINDOW`` 10, ``LFVIO_BENCH_SLOTS`` 256,
``LFVIO_BENCH_DURATION`` 6.0. The high-rate configuration is
``LFVIO_BENCH_FRAME_RATE=30 LFVIO_BENCH_MAX_CNT=300 LFVIO_BENCH_WINDOW=20
LFVIO_BENCH_SLOTS=384``. The JAX script's ``LFVIO_JAX_CACHE`` (a JAX
compile cache) has no counterpart: the port's kernels are built once per
source and cached by a hash of the source (``lfvio_tpu_torch/build``).

One deliberate difference: the card is synchronized at the split, and the
timed window ends after ``pipe.flush()`` and ``torch.cuda.synchronize``.
The JAX script stops its clock with up to ``depth`` frames and
``solve_lag`` solves still queued; on the card that would close the window
before the work is done.

Prints ONE JSON line on stdout, ``{"metric": "vio_frames_per_s_torch_1gpu",
"value", "unit": "frames/s", "vs_baseline": fps / 10}`` (the reference runs
in real time at its 10 Hz publish rate); progress, the card's name and power
limit, and every other figure (a ``figures {...}`` JSON line) go to stderr.
The device defaults to the CUDA card, and the bench raises without one
unless ``--device cpu`` is given; a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .backend import imu_cuda, marg_cuda, proj_cuda, relo_cuda
from .device import collect_launches, resolve_device
from .frontend import klt_cuda
from .geom.eigh_cuda import sym_eig

METRIC = "vio_frames_per_s_torch_1gpu"
IMU_RATE = 200.0
BASELINE_FPS = 10.0  # the reference's publish rate (bench.py:11-13)
WARMUP_SHARE = 0.6  # bench.py:122


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    frame_rate: float = 15.0
    max_cnt: int = 200
    window: int = 10
    n_slots: int = 256
    duration: float = 6.0


# Environment knob -> (field, type), bench.py:71-78.
KNOBS = {
    "LFVIO_BENCH_FRAME_RATE": ("frame_rate", float),
    "LFVIO_BENCH_MAX_CNT": ("max_cnt", int),
    "LFVIO_BENCH_WINDOW": ("window", int),
    "LFVIO_BENCH_SLOTS": ("n_slots", int),
    "LFVIO_BENCH_DURATION": ("duration", float),
}


def config_from_env(environ=None) -> BenchConfig:
    """The bench's configuration from ``environ`` (default ``os.environ``);
    a knob that is not set keeps bench.py's default."""
    environ = os.environ if environ is None else environ
    return BenchConfig(**{field: kind(environ[name]) for name, (field, kind) in KNOBS.items()
                          if name in environ})


class Workload(NamedTuple):
    world: object  # its .camera is the bench's camera
    stream: list  # ('imu', t, acc, gyr) / ('frame', t, None), in time order
    frames: dict  # t -> uint8 [H, W] on the device
    make: Callable  # make(solve_lag=2, depth=3, **fe_kw) -> (FrontEnd, Estimator, VioPipeline)


def workload(cfg: BenchConfig, device=None, width=1280, height=960) -> Workload:
    """What ``bench.py:58-119`` builds: the mindvision camera at (width,
    height) with a centred principal point, the synthetic world (its default
    seed), the stream of ``cfg.duration`` s, every frame rendered to uint8
    on the device, and a maker of fresh (FrontEnd, Estimator, VioPipeline)
    triples in bench.py's configuration; ``make``'s arguments override the
    solve lag, the pipeline depth and FrontEnd arguments."""
    from .runtime import Estimator, EstimatorConfig, VioPipeline
    from .runtime.synthetic import (
        MINDVISION_POLY, SyntheticWorld, fit_inverse_poly, scaramuzza_camera)

    dev = resolve_device(device)
    W, H = width, height
    cam = scaramuzza_camera(MINDVISION_POLY, fit_inverse_poly(MINDVISION_POLY, max_rho=510.0),
                            W, H, dtype=torch.float32)
    world = SyntheticWorld(camera=cam, width=W, height=H, dtype=torch.float32, device=dev)
    stream = world.generate(cfg.duration, cfg.frame_rate, IMU_RATE)
    frames = {e[1]: world.render_u8(e[1]) for e in stream if e[0] == "frame"}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    def make(solve_lag=2, depth=3, **fe_kw):
        fe = make_frontend(cfg, cam, dev, W, H, **fe_kw)
        est = Estimator(EstimatorConfig(n_feature_slots=cfg.n_slots, window=cfg.window,
                                        solver_dtype=torch.float32, solve_lag=solve_lag,
                                        max_imu_per_interval=64, device=dev))
        return fe, est, VioPipeline(fe, est, freq=10.0, depth=depth)

    return Workload(world, stream, frames, make)


def make_frontend(cfg: BenchConfig, camera, device, width=1280, height=960, **fe_kw):
    """The bench's FrontEnd (``bench.py:58-119``'s tracker) for ``cfg``:
    CLAHE, the PAL annulus, ``cfg.max_cnt`` and ``cfg.n_slots``; ``fe_kw``
    adds or overrides FrontEnd arguments."""
    from .runtime import FrontEnd

    W, H = width, height
    kw = dict(max_cnt=cfg.max_cnt, min_dist=20, n_slots=cfg.n_slots,
              annulus=(W / 2.0, H / 2.0, 500.0 * 0.95, 160.0), equalize=True,
              dtype=torch.float32, device=device)
    return FrontEnd(camera, (H, W), **{**kw, **fe_kw})


def feed(pipe, items, frames):
    """Feed stream events to the pipeline, each frame's image from ``frames``."""
    for it in items:
        if it[0] == "imu":
            pipe.feed_imu(it[1], it[2], it[3])
        else:
            pipe.feed_frame(it[1], frames[it[1]])


_T0 = time.perf_counter()


def log(msg):
    print(f"[bench +{time.perf_counter() - _T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


# The solver's factor kernels: the projection's, the IMU's, the
# relocalization rows' (these launch only in a solve with an armed loop
# closure, which the bench's stream has not) and the marginalizations' QR
# (marg_depth in each MARGIN_OLD, marg_qr in each MARGIN_OLD and SECOND_NEW).
FACTOR_KERNELS = {"proj_rows": proj_cuda.proj_rows, "proj_normal": proj_cuda.proj_normal,
                  "proj_cost": proj_cuda.proj_cost, "imu_rows": imu_cuda.imu_rows,
                  "imu_normal": imu_cuda.imu_normal, "imu_cost": imu_cuda.imu_cost,
                  "relo_normal": relo_cuda.relo_normal, "relo_cost": relo_cuda.relo_cost,
                  "marg_depth": marg_cuda.marg_depth, "marg_qr": marg_cuda.marg_qr}


def reset_launches():
    """Set every kernel wrapper's launch count to 0 (the launches that the
    graphs' conditional bodies ran before are collected first and dropped)."""
    collect_launches()
    klt_cuda.lk_pyramid.launches = klt_cuda.lk_level.launches = sym_eig.launches = 0
    klt_cuda.pyramidal_lk_pallas.launches = 0
    for k in FACTOR_KERNELS.values():
        k.launches = 0


def _launches():
    collect_launches()
    return dict(lk=klt_cuda.lk_pyramid.launches,
                lk_other=klt_cuda.pyramidal_lk_pallas.launches + klt_cuda.lk_level.launches,
                sym_eig=sym_eig.launches, **{k: v.launches for k, v in FACTOR_KERNELS.items()})


def lm_means(runs):
    """(mean LM iterations run, mean linearizations run) over ``runs``
    (``Estimator.lm_runs`` entries), or (None, None) without any."""
    if not runs:
        return None, None
    return tuple(float(np.mean([r[i] for r in runs])) for i in (0, 1))


class Window(NamedTuple):
    warmup_s: float
    seconds: float  # the timed window's wall time
    frames_warmup: int
    frames_timed: int


def timed_window(pipe, wl: Workload, t_split, on_split=None) -> Window:
    """The bench's yardstick (``bench.py:122-149``, ended as the module's
    docstring says): feed ``pipe`` the events at t ≤ ``t_split`` (the
    warm-up) and wait for the card; call ``on_split()``; then time feeding
    the rest, ``pipe.flush()`` and the wait for the card."""
    dev = next(iter(wl.frames.values())).device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    warm = [it for it in wl.stream if it[1] <= t_split]
    rest = [it for it in wl.stream if it[1] > t_split]
    t0 = time.perf_counter()
    feed(pipe, warm, wl.frames)
    sync()
    warmup_s = time.perf_counter() - t0
    if on_split is not None:
        on_split()
    t1 = time.perf_counter()
    feed(pipe, rest, wl.frames)
    pipe.flush()
    sync()
    n_frames = lambda items: sum(1 for it in items if it[0] == "frame")
    return Window(warmup_s, time.perf_counter() - t1, n_frames(warm), n_frames(rest))


def _finite_or_none(x):
    return x if x is not None and math.isfinite(x) else None


def run(cfg: BenchConfig, device=None, width=1280, height=960) -> dict:
    """Build the workload, warm up on the events at t ≤ 0.6 · duration and
    time the rest (``timed_window``). Returns the figures: frames/s, the
    frames of each part, solves, the estimator's initialization and first
    solve against the split, the kernel launches of the whole run (every
    count set to 0 just before the first event) and of the timed window,
    the estimator's and the front end's graphs (the latter's replays: every
    tracked frame after the first of its kind), the graphs captured in the
    timed window, the ATE against the world's trajectory and the card's
    peak memory."""
    from .runtime.evaluation import ate_rmse

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    wl = workload(cfg, dev, width, height)
    log(f"{cfg}; {width}x{height} on {dev}: {len(wl.stream)} events, {len(wl.frames)} frames "
        f"rendered on the device in {time.perf_counter() - t0:.2f} s")
    fe, est, pipe = wl.make()
    t_split = cfg.duration * WARMUP_SHARE
    at_split = {}

    def on_split():
        at_split.update(init=est.solver_flag == est.NON_LINEAR,
                        graphs=est.graph_stats()[0] + fe.graph_stats()[0],
                        restarts=pipe.n_restarts, launches=_launches(),
                        lm_runs=len(est.lm_runs))
        log(f"warm-up done: use_pallas={fe.use_pallas}, "
            f"init={'ok' if at_split['init'] else 'NOT DONE'}, graphs captured "
            f"{at_split['graphs']}")

    reset_launches()
    win = timed_window(pipe, wl, t_split, on_split)
    run_launches = _launches()
    launches = {k: v - at_split["launches"][k] for k, v in run_launches.items()}
    fps = win.frames_timed / win.seconds

    times, traj = np.asarray(est.times), np.asarray(est.traj_p)
    first_solve = float(times[0]) if len(times) else None
    graphs, capture_s = est.graph_stats()
    fe_graphs, fe_capture_s = fe.graph_stats()
    ate = n_ate = None
    if len(times):
        ate, n_ate = ate_rmse(times, traj, times, wl.world.pose_batch(times)[0])
    figures = dict(
        device=str(dev), device_name=torch.cuda.get_device_name(dev) if on_card else "cpu",
        width=width, height=height, **dataclasses.asdict(cfg),
        frames_per_s=fps, seconds_timed=win.seconds, seconds_warmup=win.warmup_s,
        frames_warmup=win.frames_warmup, frames_timed=win.frames_timed, t_split=t_split,
        solves=len(times), solves_timed=int((times > t_split).sum()),
        initialized=est.solver_flag == est.NON_LINEAR, initialized_in_warmup=at_split["init"],
        first_solve_t=first_solve,
        first_solve_in_timed_window=first_solve is not None and first_solve > t_split,
        lk_launches=launches["lk"], lk_other_launches=launches["lk_other"],
        sym_eig_launches=launches["sym_eig"],
        lk_launches_run=run_launches["lk"], lk_other_launches_run=run_launches["lk_other"],
        sym_eig_launches_run=run_launches["sym_eig"],
        factor_launches={k: launches[k] for k in FACTOR_KERNELS},
        factor_launches_run={k: run_launches[k] for k in FACTOR_KERNELS},
        lm_iterations_mean=lm_means(est.lm_runs[at_split["lm_runs"]:])[0],
        lm_linearizations_mean=lm_means(est.lm_runs[at_split["lm_runs"]:])[1],
        lm_iterations_mean_run=lm_means(est.lm_runs)[0],
        lm_linearizations_mean_run=lm_means(est.lm_runs)[1],
        graphs=graphs, capture_s=capture_s, frontend_graphs=fe_graphs,
        frontend_capture_s=fe_capture_s,
        frontend_replays=sum(p.replays for p in fe._programs.values()),
        graphs_captured_timed=graphs + fe_graphs - at_split["graphs"],
        restarts_timed=pipe.n_restarts - at_split["restarts"],
        trajectory_finite=bool(np.isfinite(traj).all()),
        ate_m=_finite_or_none(ate), ate_poses=n_ate,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if on_card else None,
    )
    log(f"warm-up: {win.frames_warmup} frames in {win.warmup_s:.2f} s; timed: "
        f"{win.frames_timed} frames in {win.seconds:.3f} s = {fps:.3f} frames/s; solves "
        f"{len(times)} ({figures['solves_timed']} timed); first solve at t = {first_solve} "
        f"(split {t_split:.2f} s); LK launches {launches['lk']} timed, {run_launches['lk']} in "
        f"the run; sym_eig launches {launches['sym_eig']} timed, {run_launches['sym_eig']} in "
        f"the run; factor kernels' launches {figures['factor_launches']} timed, "
        f"{figures['factor_launches_run']} in the run; LM iterations / linearizations run a "
        f"solve {figures['lm_iterations_mean']} / {figures['lm_linearizations_mean']} timed, "
        f"{figures['lm_iterations_mean_run']} / {figures['lm_linearizations_mean_run']} in the "
        f"run; ATE {ate} m over {n_ate} poses")
    if figures["first_solve_in_timed_window"] or figures["graphs_captured_timed"]:
        log(f"NOTE: inside the timed window: first solve {figures['first_solve_in_timed_window']}, "
            f"graphs captured {figures['graphs_captured_timed']}")
    return figures


def smi_line():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # A float32 convolution or matmul must not round through TF32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        log(f"card: {smi_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    fig = run(config_from_env(), dev)
    log("figures " + json.dumps(fig))
    fps = fig["frames_per_s"]
    print(json.dumps({"metric": METRIC, "value": fps, "unit": "frames/s",
                      "vs_baseline": fps / BASELINE_FPS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
