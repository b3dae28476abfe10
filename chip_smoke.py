#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lfvio_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

``--profile`` adds CUDA-synchronized stage timers (FrontEnd per published
and unpublished frame, Estimator solve) and a torch.profiler trace of one
solve to phase 4. Phases, each printing its lines; any failure ends the run with a non-zero
exit code:

  1. environment: the card's name and power limit (nvidia-smi), torch, nvcc;
  2. build the LK level kernel (csrc/lk_level.cu) from the checkout;
  3. the kernel against its plain PyTorch version on the card, at the main
     path's shapes (1280x960 pyramids, 256 features, win 41 / 20 iterations
     and the win 15 / 10 refine pass), with CUDA-event times of both;
  4. the main path at full width: VioPipeline(FrontEnd, Estimator) fed the
     bench.py configuration (1280x960, CLAHE, 256 slots, max_cnt 200,
     15 Hz frames, 200 Hz IMU, window 10, publish 10 Hz) over a 6 s
     synthetic stream, on the card; frames/s over the post-warm-up 40%;
  5. the accuracy gate of tests/test_e2e.py::test_e2e_vio_ate on the card
     (512x384, f32 tracker, f64 solver, 7 s): ATE < 0.25 m.

Prints one JSON line with each kernel's numbers, then the card's line, and
last {"ok": true, "device": {...}}. Imports nothing of JAX; the only import
from the JAX package is its pure-numpy bootstrap, lfvio_tpu.vinit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

REPLACES = "lfvio_tpu/frontend/klt_pallas.py:86 (_lk_level_kernel)"
SOURCE = "lfvio_tpu_torch/csrc/lk_level.cu"
# Beside the loose bounds (ok on >= 99%, 0.05 px): the largest kernel-vs-plain
# error seen on an H100 is 1.2e-4 px, so 2e-3 px still passes float32 sums in
# another order but catches a kernel that mishandles a few taps; at a single
# level step, ok must also be identical.
TIGHT_PX = 2e-3


def log(msg):
    print(msg, flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, n=20, warmup=3):
    """Median of n CUDA-event-timed calls, after warm-up, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def textured(H, W, seed=0):
    """Blocky random texture, box-smoothed (tests/test_klt_pallas.py)."""
    rng = np.random.default_rng(seed)
    img = np.kron(rng.random((H // 8, W // 8)), np.ones((8, 8)))
    k = 5
    pad = np.pad(img, k // 2, mode="constant")
    c = np.cumsum(np.cumsum(pad, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0)))
    box = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)
    return (box * 255.0).astype(np.float32)


def shifted(img, dx, dy):
    """Bilinear shift by (dx, dy)."""
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xs = np.clip(xx + dx, 0, W - 1.001)
    ys = np.clip(yy + dy, 0, H - 1.001)
    x0, y0 = xs.astype(int), ys.astype(int)
    fx, fy = xs - x0, ys - y0
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x0 + 1] * fy * fx
            ).astype(np.float32)


def phase_kernel_vs_plain(dev):
    """Kernel vs plain on the same inputs at the main path's shapes."""
    import torch
    from lfvio_tpu_torch.frontend import gaussian_pyramid, klt, klt_cuda

    H, W, N = 960, 1280, 256
    dx, dy = 3.3, -2.6
    img0 = textured(H, W)
    img1 = shifted(img0, -dx, -dy)  # features move by (+dx, +dy)
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(60, W - 60, N), rng.uniform(60, H - 60, N)], -1)
    c = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    pyr0 = gaussian_pyramid(c(img0), 3)
    pyr1 = gaussian_pyramid(c(img1), 3)
    pts_t = c(pts)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    valid[-4:] = False

    kp, kok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts_t, valid, 3, refine_win=15)
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts_t, valid, 3, refine_win=15)
    torch.cuda.synchronize()
    agree = (kok == pok).float().mean().item()
    both = kok & pok
    max_err = (kp[both] - pp[both]).abs().max().item()
    truth = pts_t + torch.tensor([dx, dy], device=dev)
    med_true = torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item()
    log(f"[3] pyramid+refine: ok agree {agree:.4f} (>= 0.99), both ok {int(both.sum())}/{N}, "
        f"max |kernel - plain| {max_err:.3g} px (< 0.05; tight < {TIGHT_PX}), "
        f"median |kernel - truth| {med_true:.3f} px (< 0.35)")
    if agree < 0.99 or max_err >= 0.05 or med_true >= 0.35 or int(both.sum()) < N - 16:
        raise AssertionError("kernel disagrees with the plain version")
    if max_err >= TIGHT_PX:
        raise AssertionError("kernel exceeds the tight bound against the plain version")

    # One level step at each window, same guess for both versions.
    g0 = torch.zeros_like(pts_t)
    level_err = {}
    for win, iters in ((klt.WIN, klt.N_ITERS), (15, klt.REFINE_ITERS)):
        kg, ko = klt_cuda.lk_level(pyr0[0], pyr1[0], pts_t, g0, valid, win, iters)
        pg, po = klt.track_level(pyr0[0], pyr1[0], pts_t, g0, valid, win, iters)
        b = ko & po
        level_err[win] = (kg[b] - pg[b]).abs().max().item()
        log(f"[3] level 0, win {win}/{iters} it: ok agree {(ko == po).float().mean().item():.4f}, "
            f"max |kernel - plain| {level_err[win]:.3g} px")
        if (ko == po).float().mean().item() < 0.99 or level_err[win] >= 0.05:
            raise AssertionError(f"kernel level step disagrees at win {win}")
        if not torch.equal(ko, po) or level_err[win] >= TIGHT_PX:
            raise AssertionError(f"kernel level step exceeds the tight bound at win {win}")

    ms = cuda_ms(lambda: klt_cuda.pyramidal_lk(pyr0, pyr1, pts_t, valid, 3, refine_win=15))
    plain_ms = cuda_ms(lambda: klt.pyramidal_lk(pyr0, pyr1, pts_t, valid, 3, refine_win=15))
    lvl_ms = cuda_ms(lambda: klt_cuda.lk_level(pyr0[0], pyr1[0], pts_t, g0, valid))
    lvl_plain_ms = cuda_ms(lambda: klt.track_level(pyr0[0], pyr1[0], pts_t, g0, valid))
    log(f"[3] per frame (4 levels + refine, N={N}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
        f"level 0 win 41 alone: kernel {lvl_ms:.3f} ms, plain {lvl_plain_ms:.3f} ms "
        f"(medians of 20 CUDA-event-timed runs)")
    return dict(max_abs_err=max(max_err, *level_err.values()), ms=ms, plain_ms=plain_ms)


def count_plain_lk():
    """Wrap the plain LK entry points with call counters."""
    from lfvio_tpu_torch.frontend import klt

    calls = {"n": 0}
    for name in ("track_level", "pyramidal_lk"):
        fn = getattr(klt, name)

        def counted(*a, _fn=fn, **k):
            calls["n"] += 1
            return _fn(*a, **k)

        setattr(klt, name, counted)
    return calls


def add_stage_timers(fe, est, profile_solve=5):
    """--profile: wrap the FrontEnd's and the Estimator's per-frame entry
    points with CUDA-synchronized host timers, and trace one solve with
    torch.profiler. Returns the dict the timers fill (ms per call)."""
    import torch

    rec = {}

    def wrap(obj, name, key_of):
        fn = getattr(obj, name)

        def timed(*a, **k):
            key = key_of(a, k)
            if key == f"solve {profile_solve}":
                return traced(fn, a, k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec.setdefault(key, []).append(1e3 * (time.perf_counter() - t0))
            return out

        setattr(obj, name, timed)

    def traced(fn, a, k):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            out = fn(*a, **k)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        dev_us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in ka)
        top = sorted(ka, key=lambda e: -e.count)[:5]
        log(f"[4p] traced solve {profile_solve}: self device time {dev_us / 1e3:.3f} ms; "
            f"most called ops: " + ", ".join(f"{e.key} x{e.count}" for e in top))
        return out

    n_solves = [0]

    def solve_key(a, k):
        if est.frame_count < est.WIN:
            return "solve skipped (window not full)"
        n_solves[0] += 1
        return "solve first" if n_solves[0] == 1 else f"solve {n_solves[0]}"

    wrap(fe, "process_arrays",
         lambda a, k: "frontend published" if k.get("publish", True) else "frontend unpublished")
    wrap(est, "_dispatch_solve", solve_key)
    return rec


def log_stage_timers(rec):
    solves = [v for key, vals in rec.items() if key.startswith("solve ") and key[6:].isdigit()
              for v in vals]
    rows = {k: v for k, v in rec.items() if not (k.startswith("solve ") and k[6:].isdigit())}
    rows["solve (after the first, untraced)"] = solves
    for key, vals in rows.items():
        if vals:
            log(f"[4p] {key}: n {len(vals)}, min {min(vals):.3f} ms, median "
                f"{float(np.median(vals)):.3f} ms, max {max(vals):.3f} ms")


def phase_full_scale(dev, plain_calls, profile=False):
    """bench.py's configuration through the port's pipeline on the card.
    ``profile`` times the stages (the timers synchronize the card, so the
    frames/s of such a run are not the cell's)."""
    import torch
    from lfvio_tpu_torch.frontend import klt_cuda
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, FrontEnd, VioPipeline
    from lfvio_tpu_torch.runtime.evaluation import ate_rmse
    from lfvio_tpu_torch.runtime.synthetic import (
        MINDVISION_POLY, SyntheticWorld, fit_inverse_poly, scaramuzza_camera)

    W, H = 1280, 960
    cam = scaramuzza_camera(MINDVISION_POLY, fit_inverse_poly(MINDVISION_POLY, max_rho=510.0),
                            W, H, dtype=torch.float32)
    world = SyntheticWorld(camera=cam, width=W, height=H, dtype=torch.float32, device=dev)
    duration = 6.0
    stream = world.generate(duration, 15.0, 200.0)
    frames = {e[1]: world.render_u8(e[1]) for e in stream if e[0] == "frame"}
    torch.cuda.synchronize()
    log(f"[4] stream: {len(stream)} events, {len(frames)} frames rendered on the card")

    fe = FrontEnd(cam, (H, W), max_cnt=200, min_dist=20, n_slots=256,
                  annulus=(W / 2.0, H / 2.0, 500.0 * 0.95, 160.0), equalize=True,
                  dtype=torch.float32, device=dev)
    est = Estimator(EstimatorConfig(n_feature_slots=256, solver_dtype=torch.float32,
                                    max_imu_per_interval=64, device=dev))
    pipe = VioPipeline(fe, est, freq=10.0)
    stages = add_stage_timers(fe, est) if profile else None

    def feed(items):
        for it in items:
            if it[0] == "imu":
                pipe.feed_imu(it[1], it[2], it[3])
            else:
                pipe.feed_frame(it[1], frames[it[1]])

    klt_cuda.lk_level.launches = 0
    plain_calls["n"] = 0
    t_split = duration * 0.6
    warm = [it for it in stream if it[1] <= t_split]
    rest = [it for it in stream if it[1] > t_split]
    t0 = time.perf_counter()
    feed(warm)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    feed(rest)
    pipe.flush()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = klt_cuda.lk_level.launches
    n_timed = sum(1 for it in rest if it[0] == "frame")
    fps = n_timed / (t2 - t1)
    times = np.asarray(est.times)
    traj = np.asarray(est.traj_p)
    log(f"[4] warm-up {t1 - t0:.2f} s; timed {n_timed} frames in {t2 - t1:.3f} s = "
        f"{fps:.3f} frames/s; solves {len(times)}; LK launches {launches}; "
        f"plain LK calls {plain_calls['n']}")
    if stages is not None:
        log_stage_timers(stages)
    if est.solver_flag != est.NON_LINEAR:
        raise AssertionError("full-scale run did not initialize")
    if not (len(traj) and np.isfinite(traj).all()):
        raise AssertionError("non-finite or empty trajectory")
    if launches == 0 or plain_calls["n"] != 0:
        raise AssertionError("the main path did not run through the LK kernel only")
    gt = np.stack([world.pose(tt)[0] for tt in times])
    ate, n = ate_rmse(times, traj, times, gt)
    log(f"[4] ATE {ate:.4f} m over {n} poses")
    return launches, fps, ate


def phase_e2e_gate(dev):
    """tests/test_e2e.py::test_e2e_vio_ate's configuration on the card."""
    import torch
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, FrontEnd, VioPipeline
    from lfvio_tpu_torch.runtime.evaluation import ate_rmse
    from lfvio_tpu_torch.runtime.synthetic import (
        SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)

    world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=torch.float64),
                           dtype=torch.float64, device=dev)
    fe = FrontEnd(world.camera, (world.height, world.width), max_cnt=120, min_dist=15,
                  n_slots=160, equalize=False, dtype=torch.float32, device=dev,
                  annulus=(world.width / 2, world.height / 2, SYN_MAX_R, SYN_MIN_R))
    est = Estimator(EstimatorConfig(n_feature_slots=256, solver_dtype=torch.float64,
                                    device=dev))
    t0 = time.perf_counter()
    times, traj, _ = VioPipeline(fe, est).run(
        world.generate(7.0, 15.0, 200.0), lambda tt: world.render(tt))
    gt = np.stack([world.pose(tt)[0] for tt in times])
    ate, n = ate_rmse(times, traj, times, gt)
    log(f"[5] e2e gate: {len(times)} solves in {time.perf_counter() - t0:.1f} s, "
        f"ATE {ate:.4f} m (< 0.25)")
    if est.solver_flag != est.NON_LINEAR or len(times) <= 35 or not ate < 0.25:
        raise AssertionError("e2e accuracy gate failed")
    return ate


def main(argv):
    import torch

    profile = argv == ["--profile"]
    if argv and not profile:
        print(f"usage: {sys.argv[0]} [--profile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # A float32 convolution or matmul must not round through TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from lfvio_tpu_torch.frontend import klt_cuda

    smi = smi_line()
    nvcc = subprocess.run([klt_cuda.nvcc_path(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    log(f"[1] {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; {nvcc[-1] if nvcc else 'nvcc ?'}")

    t0 = time.perf_counter()
    lib = klt_cuda.build(verbose=True)
    log(f"[2] built {lib.name} in {time.perf_counter() - t0:.2f} s")

    k = phase_kernel_vs_plain(dev)
    plain_calls = count_plain_lk()
    launches, fps, ate_full = phase_full_scale(dev, plain_calls, profile)
    phase_e2e_gate(dev)

    print(json.dumps({"kernels": [{
        "name": "lk_level", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
