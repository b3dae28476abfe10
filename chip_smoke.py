#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lfvio_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

``--profile`` adds CUDA-synchronized stage timers (FrontEnd per published
and unpublished frame, its LK stage alone, Estimator solve) and a
torch.profiler trace of one solve to phase 4. Phases, each printing its
lines; any failure ends the run with a non-zero exit code:

  1. environment: the card's name and power limit (nvidia-smi), torch, nvcc;
  2. build the LK kernel (csrc/lk_pyramid.cu) from the checkout, printing
     what ``-Xptxas -v`` reports for it;
  3. the kernel's two wrappers against the plain PyTorch version on the card,
     at the main path's shapes (1280x960 pyramids, 256 features): the fused
     launch over the whole pyramid with the refine pass, one level step (a
     one-pass launch) at win 41 / 20 iterations and win 15 / 10, the host
     level loop over that step, border and corner points at 1280x960 and
     512x384, a shift that loses tracks, a bit-identical repeat, and
     CUDA-event times in turns with the roofline bound of this run's work;
  4. the main path at full width: VioPipeline(FrontEnd, Estimator) fed the
     bench.py configuration (1280x960, CLAHE, 256 slots, max_cnt 200,
     15 Hz frames, 200 Hz IMU, window 10, publish 10 Hz) over a 6 s
     synthetic stream, on the card; frames/s over the post-warm-up 40%;
     exactly one fused LK launch per tracked frame; then a few frames of the
     same FrontEnd with the level loop on the host over the one-level
     wrapper (five launches per frame);
  5. the accuracy gate of tests/test_e2e.py::test_e2e_vio_ate on the card
     (512x384, f32 tracker, f64 solver, 7 s): ATE < 0.25 m.

Prints one JSON line with each kernel's numbers, then the card's line, and
last {"ok": true, "device": {...}}. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

REPLACES = "lfvio_tpu/frontend/klt_pallas.py:86 (_lk_level_kernel)"
SOURCES = {"lk_pyramid": "lfvio_tpu_torch/csrc/lk_pyramid.cu",
           "lk_level": "lfvio_tpu_torch/csrc/lk_pyramid.cu"}
# Beside the loose bounds (ok on >= 99%, 0.05 px): the largest kernel-vs-plain
# error seen on an H100 is 1.2e-4 px, so 2e-3 px still passes float32 sums in
# another order but catches a kernel that mishandles a few taps; at a single
# level step, and in the border and lost-track cases, ok must also be identical.
TIGHT_PX = 2e-3
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and float32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def log(msg):
    print(msg, flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_times(fn, n=20, warmup=3, reps=1, blocker=None):
    """n CUDA-event-timed samples after warm-up, in ms per call of ``fn``;
    a sample is ``reps`` calls between two events. ``blocker`` is enqueued
    ahead of each sample's first event and keeps the card busy while the
    host enqueues the sample, so that the events see the card's time only
    and not the host's launch cost."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if blocker is not None:
            blocker()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return times


def cuda_ms(fn, **kw):
    """Median of ``cuda_times``."""
    return float(np.median(cuda_times(fn, **kw)))


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


def smooth_textured(H, W, seed=0):
    """Long waves (160-400 px) under a little of the blocky texture: the
    coarse pyramid levels see a smooth image, on which LK follows a flow of
    several pixels per level instead of wandering."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.zeros((H, W))
    for _ in range(12):
        lam, th, ph = rng.uniform(160, 400), rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi)
        img += np.sin(2 * np.pi * (xx * np.cos(th) + yy * np.sin(th)) / lam + ph)
    img = (img - img.min()) / (img.max() - img.min())
    return (0.85 * 255.0 * img + 0.15 * textured(H, W, seed)).astype(np.float32)


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


def border_points(H, W, rng, n=64, depth=30.0):
    """n points within ``depth`` px of the image's borders: a quarter of
    them in the four corners, the rest spread over the four sides."""
    near = lambda size, k: np.where(rng.random(k) < 0.5, rng.uniform(0, depth, k),
                                    size - 1 - rng.uniform(0, depth, k))
    k = n // 4
    corners = np.stack([near(W, k), near(H, k)], -1)
    m = (n - k) // 2
    rows = np.stack([rng.uniform(0, W - 1, m), near(H, m)], -1)  # top and bottom
    cols = np.stack([near(W, n - k - m), rng.uniform(0, H - 1, n - k - m)], -1)
    return np.concatenate([corners, rows, cols])


def lk_case(dev, H, W, N, shift, n_border=0, smooth=False, seed=1):
    """Pyramids of a texture and of its shift (features move by +shift),
    N points (n_border of them at the borders, the rest at least 60 px
    inside) and their validity (the last 4 invalid)."""
    import torch
    from lfvio_tpu_torch.frontend import gaussian_pyramid

    img0 = (smooth_textured if smooth else textured)(H, W)
    img1 = shifted(img0, -shift[0], -shift[1])
    rng = np.random.default_rng(seed)
    n_in = N - n_border
    pts = np.stack([rng.uniform(60, W - 60, n_in), rng.uniform(60, H - 60, n_in)], -1)
    if n_border:
        pts = np.concatenate([border_points(H, W, rng, n_border), pts])
    c = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    valid[-4:] = False
    return gaussian_pyramid(c(img0), 3), gaussian_pyramid(c(img1), 3), c(pts), valid


def lk_bound_ms(level_shapes, N, iters, passes):
    """The least time the card could take for the pyramidal LK of this run:
    the larger of bytes / memory rate and operations / float32 rate.

    Bytes: every input once and every output once. Of each level image the
    function must read the smaller of the whole image and the patches cut
    from it for the features that ran there: (win+4)^2 floats from the
    previous pyramid's level, (win+13)^2 from the next one's. The refine
    pass's patches lie inside the level-0 pass's, so a level counts its
    largest pass, not the sum. Overlaps between features' patches are not
    subtracted. Points and validity in, points and ok out.
    Operations, from the iterations these inputs took (``iters`` [N, passes],
    -1 where a pass did not run): per pass that ran, the (win+2)^2 template
    sample at 9 operations and the gradients and structure tensor at 10 per
    window tap; per iteration 12 per window tap (a 4-tap bilinear sample,
    the residual, two accumulations)."""
    ran = iters >= 0
    ops = 0.0
    template = [0.0] * len(level_shapes)  # patch bytes per level, largest pass
    search = [0.0] * len(level_shapes)
    for k, (lvl, win, _, _) in enumerate(passes):
        n_ran = int(ran[:, k].sum())
        template[lvl] = max(template[lvl], 4.0 * n_ran * (win + 4) ** 2)
        search[lvl] = max(search[lvl], 4.0 * n_ran * (win + 13) ** 2)
        ops += n_ran * (9.0 * (win + 2) ** 2 + 10.0 * win * win)
        ops += 12.0 * win * win * float(iters[:, k].clip(min=0).sum())
    nbytes = N * (8 + 1) + N * (8 + 1)
    for (h, w), t, s in zip(level_shapes, template, search):
        nbytes += min(4.0 * h * w, t) + min(4.0 * h * w, s)
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, ops


def compare_lk(name, kernel, plain, n_valid, identical_ok, tag="[3]"):
    """Hold a kernel's (pts, ok) against the plain version's under the loose
    bounds (ok alike on >= 99%, 0.05 px) and the tight one (TIGHT_PX, and ok
    identical where asked). Returns the largest position error."""
    import torch

    (kp, kok), (pp, pok) = kernel, plain
    agree = (kok == pok).float().mean().item()
    both = kok & pok
    err = (kp[both] - pp[both]).abs().max().item() if bool(both.any()) else 0.0
    log(f"{tag} {name}: ok agree {agree:.4f}, kernel ok {int(kok.sum())}, plain ok "
        f"{int(pok.sum())} of {n_valid} valid, max |kernel - plain| {err:.3g} px")
    if agree < 0.99 or err >= 0.05:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    if err >= TIGHT_PX or (identical_ok and not torch.equal(kok, pok)):
        raise AssertionError(f"{name}: kernel exceeds the tight bound against the plain version")
    return err


def phase_kernel_vs_plain(dev):
    """The kernel's wrappers vs plain on the same inputs at the main path's shapes."""
    import torch
    from lfvio_tpu_torch.frontend import klt, klt_cuda

    fused = lambda case: klt_cuda.pyramidal_lk(*case, 3, refine_win=15)
    plain = lambda case: klt.pyramidal_lk(*case, 3, refine_win=15)
    # The level loop on the host over the one-level wrapper: five launches.
    levels = lambda case: klt.lk_pyramid(klt_cuda.lk_level, *case, 3, 15)
    errs = []

    # Main case: the whole pyramid with the refine pass, and the true shift.
    H, W, N = 960, 1280, 256
    shift = (3.3, -2.6)
    case = lk_case(dev, H, W, N, shift)
    pyr0, pyr1, pts_t, valid = case
    kp, kok, iters = klt_cuda.lk_pyramid(*case, 3, refine_win=15, return_iters=True)
    torch.cuda.synchronize()
    errs.append(compare_lk("pyramid+refine 1280x960", (kp, kok), plain(case), N - 4, False))
    truth = pts_t + torch.tensor(shift, device=dev)
    med_true = torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item()
    log(f"[3] pyramid+refine 1280x960: median |kernel - truth| {med_true:.3f} px (< 0.35)")
    if med_true >= 0.35 or int(kok.sum()) < N - 16:
        raise AssertionError("the fused kernel does not recover the shift")

    # Repeat: the same launch on the same inputs is bit-identical.
    kp2, kok2 = fused(case)
    if not (torch.equal(kp, kp2) and torch.equal(kok, kok2)):
        raise AssertionError("the fused kernel does not repeat bit for bit")
    log("[3] repeat: bit-identical")

    # Border and corner points, where the edge replication and the patch
    # clamps work, at the full-scale size and at the e2e gate's.
    for h, w in ((960, 1280), (384, 512)):
        bcase = lk_case(dev, h, w, N, shift, n_border=64)
        errs.append(compare_lk(f"border {w}x{h}", fused(bcase), plain(bcase), N - 4, True))

    # Lost tracks: 5.6 px of flow at level 3 leaves the search patch for a
    # part of the features, and border points leave the image.
    lcase = lk_case(dev, H, W, N, (44.8, -41.6), n_border=32, smooth=True)
    lk_out, lp_out = fused(lcase), plain(lcase)
    errs.append(compare_lk("lost tracks", lk_out, lp_out, N - 4, True))
    n_ok = int(lk_out[1].sum())
    if not 16 <= n_ok <= N - 4 - 16:
        raise AssertionError(f"the lost-track case loses {N - 4 - n_ok} of {N - 4}: not a mix")

    # One level step (a one-pass launch of the kernel) at each window, same guess.
    g0 = torch.zeros_like(pts_t)
    for win, n_it in ((klt.WIN, klt.N_ITERS), (15, klt.REFINE_ITERS)):
        errs.append(compare_lk(
            f"lk_level, level 0, win {win}/{n_it} it",
            klt_cuda.lk_level(pyr0[0], pyr1[0], pts_t, g0, valid, win, n_it),
            klt.track_level(pyr0[0], pyr1[0], pts_t, g0, valid, win, n_it), N - 4, True))
    lout = levels(case)
    lerr = compare_lk("level loop on the host, five launches", lout, plain(case), N - 4, False)
    if not torch.equal(lout[1], kok) or (lout[0] - kp)[kok].abs().max().item() >= TIGHT_PX:
        raise AssertionError("five one-pass launches disagree with the fused launch")
    log(f"[3] five one-pass launches vs the fused launch: ok identical, positions "
        f"{'bit-identical' if torch.equal(lout[0][kok], kp[kok]) else 'within the tight bound'}")

    # Times in turns inside this call: plain, five launches, fused, fused,
    # plain. "Launched alone" is one call between two events on an idle card,
    # the host's launch cost included, as a frame pays it; "on the card" is
    # 10 calls enqueued behind a blocker (256 MB of writes, 12 times, which also
    # empties the 50 MB L2), the card's own time; "L2 cold" is one call right
    # behind the blocker.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    block = lambda: [flush.zero_() for _ in range(12)]
    plain_a = cuda_ms(lambda: plain(case))
    levels_alone = cuda_ms(lambda: levels(case))
    levels_ms = cuda_ms(lambda: levels(case), reps=10, blocker=block)
    fused_t = (cuda_times(lambda: fused(case), reps=10, blocker=block)
               + cuda_times(lambda: fused(case), reps=10, blocker=block))
    fused_alone = cuda_ms(lambda: fused(case))
    fused_cold = cuda_ms(lambda: fused(case), blocker=block)
    plain_b = cuda_ms(lambda: plain(case))
    # The same launch with every pass cut to 0 iterations (the wrapper reads
    # the module's limits at each call): what is left is launch, staging,
    # template work and the sums of the structure tensor.
    none_valid = torch.zeros_like(valid)
    fused_exit = cuda_ms(lambda: klt_cuda.pyramidal_lk(pyr0, pyr1, pts_t, none_valid, 3,
                                                       refine_win=15), reps=10, blocker=block)
    limits = klt.N_ITERS, klt.REFINE_ITERS
    klt.N_ITERS = klt.REFINE_ITERS = 0
    try:
        fused_setup = cuda_ms(lambda: fused(case), reps=10, blocker=block)
    finally:
        klt.N_ITERS, klt.REFINE_ITERS = limits
    fused_ms, plain_ms = float(np.median(fused_t)), 0.5 * (plain_a + plain_b)

    passes = klt_cuda._pass_table([tuple(l.shape) for l in pyr0], 3, klt.WIN, klt.N_ITERS,
                                  15, klt.REFINE_ITERS)
    it = iters.cpu().numpy()
    bound, by, nbytes, ops = lk_bound_ms([tuple(l.shape) for l in pyr0], N, it, passes)
    per_feature = it.clip(min=0).sum(1)[valid.cpu().numpy()]
    log(f"[3] iterations per valid feature over the 5 passes: mean {per_feature.mean():.2f}, "
        f"max {int(per_feature.max())} of {sum(p[2] for p in passes)}; per pass mean "
        + ", ".join(f"{m:.2f}" for m in it.clip(min=0)[valid.cpu().numpy()].mean(0)))
    log(f"[3] per frame (4 levels + refine, N={N}, {W}x{H}), on the card: fused {fused_ms:.4f} ms "
        f"(min {min(fused_t):.4f}; L2 cold {fused_cold:.4f}), five launches {levels_ms:.4f} ms; "
        f"launched alone, host cost included: fused {fused_alone:.4f} ms, five launches "
        f"{levels_alone:.4f} ms; plain {plain_a:.3f} / {plain_b:.3f} ms (medians of 20 "
        f"CUDA-event-timed samples, in turns: plain, five launches, fused, fused, plain)")
    log(f"[3] bound {bound:.5f} ms by {by}: {nbytes / 1e6:.3f} MB at {PEAK_BYTES_S / 1e12} TB/s = "
        f"{1e3 * nbytes / PEAK_BYTES_S:.5f} ms, {ops / 1e9:.4f} GFLOP at "
        f"{PEAK_F32_FLOPS / 1e12} TFLOP/s = {1e3 * ops / PEAK_F32_FLOPS:.5f} ms; the fused "
        f"launch is at {100 * bound / fused_ms:.1f}% of it")
    chain = int(per_feature.max())
    per_it = (fused_ms - fused_setup) / chain
    log(f"[3] latency floor: with no valid feature the launch takes {fused_exit:.4f} ms (launch "
        f"and exit), with 0 iterations {fused_setup:.4f} ms (launch, staging, template work); "
        f"the rest over the longest chain of {chain} iterations is {1e3 * per_it:.3f} us per "
        f"iteration, so the iterations alone set a floor of "
        f"{chain * per_it:.4f} ms")
    common = dict(plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
    return {"lk_pyramid": dict(max_abs_err=max(errs[:4]), ms=fused_ms, ms_l2_cold=fused_cold,
                               ms_launched_alone=fused_alone, ms_zero_iterations=fused_setup,
                               **common),
            "lk_level": dict(max_abs_err=max(lerr, *errs[4:]), ms=levels_ms,
                             ms_launched_alone=levels_alone, **common)}


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


def count_calls(obj, name):
    """Wrap ``obj.name`` with a call counter."""
    calls = {"n": 0}
    fn = getattr(obj, name)

    def counted(*a, **k):
        calls["n"] += 1
        return fn(*a, **k)

    setattr(obj, name, counted)
    return calls


def count_level_pads():
    """Count ``F.pad`` calls that pad an image by the LK's edge pad, as the
    plain version does with every level image."""
    import torch.nn.functional as F
    from lfvio_tpu_torch.frontend import klt

    calls = {"n": 0}
    pad = F.pad

    def counted(x, p, *a, **k):
        calls["n"] += tuple(p) == (klt.PAD,) * 4
        return pad(x, p, *a, **k)

    F.pad = counted
    return calls


def timed_call(fn, rec, key):
    """``fn`` with a CUDA-synchronized host timer that appends ms to rec[key]."""
    import torch

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        rec.setdefault(key, []).append(1e3 * (time.perf_counter() - t0))
        return out

    return timed


def add_stage_timers(fe, est, profile_solve=5):
    """--profile: wrap the FrontEnd's and the Estimator's per-frame entry
    points, and the LK call the FrontEnd makes (``klt_cuda.pyramidal_lk``),
    with CUDA-synchronized host timers, and trace one solve with
    torch.profiler. Returns the dict the timers fill (ms per call)."""
    import torch
    from lfvio_tpu_torch.frontend import klt_cuda

    rec = {}

    def wrap(obj, name, key_of):
        fn = getattr(obj, name)

        def timed(*a, **k):
            key = key_of(a, k)
            if key == f"solve {profile_solve}":
                return traced(fn, a, k)
            return timed_call(fn, rec, key)(*a, **k)

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
    wrap(klt_cuda, "pyramidal_lk", lambda a, k: "frontend LK stage (inside the frames above)")
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


FULL_SCALE_SECONDS = 6.0


def full_scale_rig(dev):
    """bench.py's configuration on the card: the synthetic world, its event
    stream with the frames rendered, and a maker of fresh (FrontEnd,
    Estimator, VioPipeline) triples."""
    import torch
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, FrontEnd, VioPipeline
    from lfvio_tpu_torch.runtime.synthetic import (
        MINDVISION_POLY, SyntheticWorld, fit_inverse_poly, scaramuzza_camera)

    W, H = 1280, 960
    cam = scaramuzza_camera(MINDVISION_POLY, fit_inverse_poly(MINDVISION_POLY, max_rho=510.0),
                            W, H, dtype=torch.float32)
    world = SyntheticWorld(camera=cam, width=W, height=H, dtype=torch.float32, device=dev)
    stream = world.generate(FULL_SCALE_SECONDS, 15.0, 200.0)
    frames = {e[1]: world.render_u8(e[1]) for e in stream if e[0] == "frame"}
    torch.cuda.synchronize()

    def make():
        fe = FrontEnd(cam, (H, W), max_cnt=200, min_dist=20, n_slots=256,
                      annulus=(W / 2.0, H / 2.0, 500.0 * 0.95, 160.0), equalize=True,
                      dtype=torch.float32, device=dev)
        est = Estimator(EstimatorConfig(n_feature_slots=256, solver_dtype=torch.float32,
                                        max_imu_per_interval=64, device=dev))
        return fe, est, VioPipeline(fe, est, freq=10.0)

    return world, stream, frames, make


def feed(pipe, items, frames):
    for it in items:
        if it[0] == "imu":
            pipe.feed_imu(it[1], it[2], it[3])
        else:
            pipe.feed_frame(it[1], frames[it[1]])


def trajectory_ate(world, est):
    """(ATE in m, poses) of the estimator's trajectory against the world's."""
    from lfvio_tpu_torch.runtime.evaluation import ate_rmse

    times = np.asarray(est.times)
    gt = np.stack([world.pose(tt)[0] for tt in times])
    return ate_rmse(times, np.asarray(est.traj_p), times, gt)


def phase_full_scale(dev, plain_calls, profile=False):
    """bench.py's configuration through the port's pipeline on the card.
    ``profile`` times the stages (the timers synchronize the card, so the
    frames/s of such a run are not the cell's)."""
    import torch
    from lfvio_tpu_torch.frontend import klt_cuda

    world, stream, frames, make = full_scale_rig(dev)
    log(f"[4] stream: {len(stream)} events, {len(frames)} frames rendered on the card")
    fe, est, pipe = make()
    stages = add_stage_timers(fe, est) if profile else None

    tracked = count_calls(fe, "_step_impl")
    padded = count_level_pads()
    klt_cuda.lk_pyramid.launches = klt_cuda.lk_level.launches = 0
    plain_calls["n"] = 0
    t_split = FULL_SCALE_SECONDS * 0.6
    warm = [it for it in stream if it[1] <= t_split]
    rest = [it for it in stream if it[1] > t_split]
    t0 = time.perf_counter()
    feed(pipe, warm, frames)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    feed(pipe, rest, frames)
    pipe.flush()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = klt_cuda.lk_pyramid.launches
    n_timed = sum(1 for it in rest if it[0] == "frame")
    fps = n_timed / (t2 - t1)
    times = np.asarray(est.times)
    traj = np.asarray(est.traj_p)
    log(f"[4] warm-up {t1 - t0:.2f} s; timed {n_timed} frames in {t2 - t1:.3f} s = "
        f"{fps:.3f} frames/s; solves {len(times)}; tracked frames {tracked['n']}; fused LK "
        f"launches {launches}; one-level launches {klt_cuda.lk_level.launches}; plain LK calls "
        f"{plain_calls['n']}; level images padded {padded['n']}")
    if est.solver_flag != est.NON_LINEAR:
        raise AssertionError("full-scale run did not initialize")
    if not (len(traj) and np.isfinite(traj).all()):
        raise AssertionError("non-finite or empty trajectory")
    if (launches == 0 or launches != tracked["n"] or klt_cuda.lk_level.launches != 0
            or plain_calls["n"] != 0 or padded["n"] != 0):
        raise AssertionError("the main path's LK is not one fused launch per tracked frame")
    ate, n = trajectory_ate(world, est)
    log(f"[4] ATE {ate:.4f} m over {n} poses")
    level_launches = phase_five_launch_path(fe, frames, stages)
    if stages is not None:
        log_stage_timers(stages)
    return launches, level_launches, fps, ate


def phase_five_launch_path(fe, frames, stages):
    """A few frames through the same FrontEnd with its LK stage as the level
    loop on the host over the one-level wrapper (five launches per frame),
    which the fused launch replaced on the main path. On each of these real
    frames the fused launch and the plain version run beside it on the same
    inputs, and both wrappers are held against the plain version."""
    import torch
    from lfvio_tpu_torch.frontend import klt, klt_cuda

    levels = lambda *a, **k: klt.lk_pyramid(klt_cuda.lk_level, *a, k["refine_win"])
    if stages is not None:  # time it as the fused stage is timed
        levels = timed_call(levels, stages, "frontend LK stage, five-launch path")
    errs = []

    def track(*a, **k):
        out = levels(*a, **k)
        plain = klt.pyramidal_lk(*a, **k)
        n_valid = int(a[3].sum())
        errs.append(compare_lk("real frame, five launches", out, plain, n_valid, False, "[4]"))
        errs.append(compare_lk("real frame, fused", klt_cuda.lk_pyramid(*a, **k), plain,
                               n_valid, False, "[4]"))
        return out

    fe.reset()
    # The FrontEnd looks its LK call up in klt_cuda at every frame.
    fused_track, klt_cuda.pyramidal_lk = klt_cuda.pyramidal_lk, track
    try:
        klt_cuda.lk_pyramid.launches = klt_cuda.lk_level.launches = 0
        ts = sorted(frames)[:6]
        for t in ts:
            out = fe.process_arrays(frames[t], t)
        torch.cuda.synchronize()
    finally:
        klt_cuda.pyramidal_lk = fused_track
    n_level, n_pub = klt_cuda.lk_level.launches, int(out[4].sum())
    log(f"[4] five-launch path: {len(ts) - 1} tracked frames, one-level launches {n_level}, "
        f"published features {n_pub}, max |kernel - plain| on these frames {max(errs):.3g} px")
    if n_level != 5 * (len(ts) - 1) or n_pub < 60:
        raise AssertionError("the five-launch path did not run through the one-level wrapper")
    return n_level


def phase_e2e_gate(dev):
    """tests/test_e2e.py::test_e2e_vio_ate's configuration on the card."""
    import torch
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, FrontEnd, VioPipeline
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
    times, _, _ = VioPipeline(fe, est).run(
        world.generate(7.0, 15.0, 200.0), lambda tt: world.render(tt))
    ate, _ = trajectory_ate(world, est)
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
    log(f"[2] built {lib.name} from {', '.join(sorted(set(SOURCES.values())))} in "
        f"{time.perf_counter() - t0:.2f} s")

    kernels = phase_kernel_vs_plain(dev)
    plain_calls = count_plain_lk()
    launches, level_launches, fps, ate_full = phase_full_scale(dev, plain_calls, profile)
    phase_e2e_gate(dev)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES,
         "launches": n, **kernels[name]}
        for name, n in (("lk_pyramid", launches), ("lk_level", level_launches))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
