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
  4. the main path at full width, synchronous (solve lag 1, depth 1):
     VioPipeline(FrontEnd, Estimator) fed the bench.py configuration
     (1280x960, CLAHE, 256 slots, max_cnt 200, 15 Hz frames, 200 Hz IMU,
     window 10, publish 10 Hz) over a 6 s synthetic stream, on the card;
     frames/s over the post-warm-up 40%; the estimator's solve and
     marginalization as CUDA graph replays; exactly one fused LK launch per
     tracked frame and the eigensolver kernel (csrc/sym_eig.cu) launched in
     RANSAC and triangulation; every FrontEnd.dispatch and
     Estimator._dispatch_solve after the warm-up under
     torch.cuda.set_sync_debug_mode("error") (none may wait for the card),
     with the host's ms per call; then a few frames of the same FrontEnd
     with the level loop on the host over the one-level wrapper (five
     launches per frame);
  5. the accuracy gate of tests/test_e2e.py::test_e2e_vio_ate on the card
     (512x384, f32 tracker, f64 solver, 7 s): ATE < 0.25 m;
  6. bench.py's configuration as bench.py runs it: the stream of phase 4 at
     solve lag 2 with the device state chain and depth 3; one fused LK
     launch per tracked frame, as many poses as solves, ATE < 0.5 m;
     frames/s beside phase 4's;
  7. the estimator's capabilities on the card, bearing-level (a stub front
     end serves analytic bearings; 64 slots, f64 solver): td recovery,
     online extrinsic rotation, relocalization, window 20, solve lag 3, the
     solver's wall budget (the bounds of tests/test_capabilities.py), and
     the f32 operating point (tests/test_f32.py's 6 s stream: the f32 ATE
     at most max(2 x the f64 ATE, 0.05 m));
  8. a rendered dual-PAL rig: DualFrontEnd of two 512x384 trackers with one
     id space, n_cams = 2, 4.5 s: both cameras in the window, ATE < 0.25 m,
     two fused LK launches per tracked frame;
  9. a EuRoC-layout directory written from phase 4's stream (8-bit greyscale
     PNGs with all five row filters, 200 Hz IMU and ground-truth CSVs), read
     back exactly and driven through euroc_stream + run_sequence at bench.py's
     configuration: ATE < 0.5 m, one fused LK launch per tracked frame;
 10. the tools on the card: the 1024x256 panorama of a full-scale frame, an
     AR overlay, chessboard detection, pinhole / Mei / Kannala-Brandt
     calibration (the bounds of tests/test_calib.py), the native IO runtime
     built with g++, and the eigh marginalization against the QR one in f64;
 11. runtime/profiling.py's stage tables (CUDA events) of the solve at 256
     slots and of the front end at 1280x960;
 12. the feature-sharded frame step on two ranks on the one card (gloo on
     CUDA tensors) in f64 and f32, against the single-device chain;
 13. the keyframe-axis solve (dist/kf_axis.py) on kf x f grids of ranks on
     the one card: f64 on 2x2 ranks with tests/test_kf_axis.py's bounds
     against the monolithic lm_solve, and equal to the same ranks on the
     CPU; f32 at the main path's window (11 keyframes, 256 slots a segment)
     through the scaling bench's rows at 1x1, 2x1 and 2x2;
 14. the estimator's device programs: the eigensolver kernel against
     torch.linalg.eigh on the main path's inputs (the [256, 4, 4] DLT
     matrices of a triangulation, RANSAC's [100, 9, 9] / [1, 9, 9] and
     [100, 3, 3] / [1, 3, 3]), with CUDA-event times and the bound; each
     program's graph replay against the same function run eagerly on the
     same inputs in f64 (solve, relocalization solve, both
     marginalizations: within 1e-9 of the scale); phase 4's stream once
     more with the programs run eagerly (the f32 ATE within 1 mm of the
     graph run's); the card's ms per replay, the graphs captured and their
     capture seconds; whether the QR marginalization drops information
     (ROADMAP queue 3) on the parity streams and phases 4 and 6: each
     MARGIN_OLD's QR prior against the eigh one in f64, measured only.

Prints one JSON line with each kernel's numbers, then the card's line, and
last {"ok": true, "device": {...}}. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import datetime
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPLACES = {"lk_pyramid": "lfvio_tpu/frontend/klt_pallas.py:86 (_lk_level_kernel)",
            "lk_level": "lfvio_tpu/frontend/klt_pallas.py:86 (_lk_level_kernel)",
            "sym_eig": "lfvio_tpu/frontend/ransac.py:36 (jnp.linalg.eigh; also :40 svd, "
                       "backend/triangulate.py:69 eigh; XLA, no Pallas kernel)"}
SOURCES = {"lk_pyramid": "lfvio_tpu_torch/csrc/lk_pyramid.cu",
           "lk_level": "lfvio_tpu_torch/csrc/lk_pyramid.cu",
           "sym_eig": "lfvio_tpu_torch/csrc/sym_eig.cu"}
# Beside the loose bounds (ok on >= 99%, 0.05 px): the largest kernel-vs-plain
# error seen on an H100 is 1.2e-4 px, so 2e-3 px still passes float32 sums in
# another order but catches a kernel that mishandles a few taps; at a single
# level step, and in the border and lost-track cases, ok must also be identical.
TIGHT_PX = 2e-3
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and float32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# The sync debug mode the steady-state dispatch runs under (phase 4).
SYNC_CHECK = "error"


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

    # The dual-PAL rig's shape: 512x384 and 128 slots per tracker, half the
    # blocks of the launches above. Interior points, then border points.
    for n_border in (0, 32):
        dcase = lk_case(dev, 384, 512, 128, shift, n_border=n_border, seed=2)
        errs.append(compare_lk(f"dual-PAL shape 512x384, N=128, {n_border} at the borders",
                               fused(dcase), plain(dcase), 124, True))

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
    return {"lk_pyramid": dict(max_abs_err=max(errs[:6]), ms=fused_ms, ms_l2_cold=fused_cold,
                               ms_launched_alone=fused_alone, ms_zero_iterations=fused_setup,
                               **common),
            "lk_level": dict(max_abs_err=max(lerr, *errs[6:]), ms=levels_ms,
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
    points (``dispatch``, ``_dispatch_solve``), and the LK call the FrontEnd
    makes (``klt_cuda.pyramidal_lk``),
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
            f"most called ops: " + ", ".join(f"{e.key[:60]} x{e.count}" for e in top))
        return out

    n_solves = [0]

    def solve_key(a, k):
        if est.frame_count < est.WIN:
            return "solve skipped (window not full)"
        n_solves[0] += 1
        return "solve first" if n_solves[0] == 1 else f"solve {n_solves[0]}"

    wrap(fe, "dispatch", lambda a, k: "frontend dispatch, published" if k.get(
        "publish", a[2] if len(a) > 2 else True) else "frontend dispatch, unpublished")
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

    def make(solve_lag=1, depth=1):
        fe = FrontEnd(cam, (H, W), max_cnt=200, min_dist=20, n_slots=256,
                      annulus=(W / 2.0, H / 2.0, 500.0 * 0.95, 160.0), equalize=True,
                      dtype=torch.float32, device=dev)
        est = Estimator(EstimatorConfig(n_feature_slots=256, solver_dtype=torch.float32,
                                        max_imu_per_interval=64, solve_lag=solve_lag,
                                        device_chain=True, device=dev))
        return fe, est, VioPipeline(fe, est, freq=10.0, depth=depth)

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


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from lfvio_tpu_torch.frontend import klt_cuda
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    klt_cuda.lk_pyramid.launches = klt_cuda.lk_level.launches = sym_eig.launches = 0


def sync_checked(fn, rec, key):
    """``fn`` run under torch.cuda.set_sync_debug_mode(SYNC_CHECK), so that
    any wait for the card inside it raises; appends the host's ms per call
    (no synchronize) to rec[key]."""
    import torch

    def run(*a, **k):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode(SYNC_CHECK)
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            rec.setdefault(key, []).append(1e3 * (time.perf_counter() - t0))

    return run


def run_full_scale(tag, rig, plain_calls, solve_lag, depth, profile=False, sync_check=False,
                   graphs=True, marg_record=None):
    """The full-scale stream through a fresh pipeline at (solve_lag, depth):
    warm-up on the first 60%, frames/s over the rest, the launch counts of
    the run (set to 0 just before it), the trajectory checks. With
    ``sync_check`` every FrontEnd.dispatch and Estimator._dispatch_solve
    after the warm-up runs under the sync debug mode "error", timed on the
    host. ``graphs=False`` runs the estimator's programs eagerly.
    ``marg_record`` (a list) collects each MARGIN_OLD's QR-against-eigh
    information difference (record_marg_information). Returns
    dict(fe, est, stages, launches, sym_launches, fps, ate, host_ms)."""
    import torch
    from lfvio_tpu_torch.frontend import klt_cuda
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    world, stream, frames, make = rig
    fe, est, pipe = make(solve_lag, depth)
    est.use_graphs = graphs
    if marg_record is not None:
        record_marg_information(est, marg_record)
    stages = add_stage_timers(fe, est) if profile else None

    tracked = count_calls(fe, "_step_impl")
    padded = count_level_pads()
    reset_launches()
    plain_calls["n"] = 0
    t_split = FULL_SCALE_SECONDS * 0.6
    warm = [it for it in stream if it[1] <= t_split]
    rest = [it for it in stream if it[1] > t_split]
    t0 = time.perf_counter()
    feed(pipe, warm, frames)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host_ms = {}
    if sync_check:
        fe.dispatch = sync_checked(fe.dispatch, host_ms, "FrontEnd.dispatch")
        est._dispatch_solve = sync_checked(est._dispatch_solve, host_ms,
                                           "Estimator._dispatch_solve")
    feed(pipe, rest, frames)
    pipe.flush()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if sync_check:  # what runs on these objects later may wait
        del fe.dispatch, est._dispatch_solve
    launches, sym_launches = klt_cuda.lk_pyramid.launches, sym_eig.launches
    n_timed = sum(1 for it in rest if it[0] == "frame")
    fps = n_timed / (t2 - t1)
    times = np.asarray(est.times)
    traj = np.asarray(est.traj_p)
    n_graphs, capture_s = est.graph_stats()
    log(f"{tag} solve lag {solve_lag}, depth {depth}, programs "
        f"{'as CUDA graphs' if graphs else 'eager'}: warm-up {t1 - t0:.2f} s; timed {n_timed} "
        f"frames in {t2 - t1:.3f} s = "
        f"{fps:.3f} frames/s; solves {len(times)}; tracked frames {tracked['n']}; fused LK "
        f"launches {launches}; one-level launches {klt_cuda.lk_level.launches}; plain LK calls "
        f"{plain_calls['n']}; level images padded {padded['n']}; sym_eig launches {sym_launches}; "
        f"graphs captured {n_graphs} in {capture_s:.2f} s")
    for key, vals in host_ms.items():
        log(f"{tag} {key} after the warm-up, under set_sync_debug_mode({SYNC_CHECK!r}): n "
            f"{len(vals)}, host ms per call min {min(vals):.3f}, median "
            f"{float(np.median(vals)):.3f}, max {max(vals):.3f}")
    if est.solver_flag != est.NON_LINEAR:
        raise AssertionError("full-scale run did not initialize")
    if not (len(traj) and np.isfinite(traj).all()) or est.pending_count():
        raise AssertionError("non-finite or empty trajectory, or a solve left pending")
    if (launches == 0 or launches != tracked["n"] or klt_cuda.lk_level.launches != 0
            or plain_calls["n"] != 0 or padded["n"] != 0):
        raise AssertionError("the main path's LK is not one fused launch per tracked frame")
    if sym_launches == 0:
        raise AssertionError("the main path did not launch the eigensolver kernel")
    if graphs and n_graphs == 0:
        raise AssertionError("the estimator's programs were not captured as CUDA graphs")
    if sync_check and len(host_ms.get("Estimator._dispatch_solve", [])) < 5:
        raise AssertionError("too few steady-state solves under the sync check")
    ate, n = trajectory_ate(world, est)
    log(f"{tag} ATE {ate:.4f} m over {n} poses; first solve at t = {times[0]:.4f} s")
    if n != len(times):
        raise AssertionError("not as many trajectory poses as solves")
    return dict(fe=fe, est=est, stages=stages, launches=launches, sym_launches=sym_launches,
                fps=fps, ate=ate, host_ms=host_ms)


def phase_full_scale(rig, plain_calls, profile=False):
    """bench.py's configuration through the port's synchronous pipeline
    (solve lag 1, depth 1) on the card. ``profile`` times the stages (the
    timers synchronize the card, so the frames/s of such a run are not the
    cell's)."""
    log(f"[4] stream: {len(rig[1])} events, {len(rig[2])} frames rendered on the card")
    run = run_full_scale("[4]", rig, plain_calls, 1, 1, profile, sync_check=not profile)
    run["level_launches"] = phase_five_launch_path(run["fe"], rig[2], run["stages"])
    if run["stages"] is not None:
        log_stage_timers(run["stages"])
    return run


def phase_bench_configuration(rig, plain_calls, run4):
    """bench.py's configuration as bench.py runs it (bench.py:116-119):
    solve lag 2 with the device state chain, depth 3."""
    run = run_full_scale("[6]", rig, plain_calls, 2, 3)
    fps, ate = run["fps"], run["ate"]
    log(f"[6] frames/s at lag 2 / depth 3: {fps:.3f}, beside phase 4's lag 1 / depth 1: "
        f"{run4['fps']:.3f} (ratio {fps / run4['fps']:.3f}); ATE {ate:.4f} m beside "
        f"{run4['ate']:.4f} m")
    if not ate < 0.5:
        raise AssertionError("lag-2 / depth-3 ATE is not below 0.5 m")
    if abs(float(run["est"].times[0]) - float(run4["est"].times[0])) > 1e-9:
        raise AssertionError("lag 2 / depth 3 initialized on another frame than lag 1 / depth 1")
    return run


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
    times, _, _ = VioPipeline(fe, est, depth=1).run(
        world.generate(7.0, 15.0, 200.0), lambda tt: world.render(tt))
    ate, _ = trajectory_ate(world, est)
    log(f"[5] e2e gate: {len(times)} solves in {time.perf_counter() - t0:.1f} s, "
        f"ATE {ate:.4f} m (< 0.25)")
    if est.solver_flag != est.NON_LINEAR or len(times) <= 35 or not ate < 0.25:
        raise AssertionError("e2e accuracy gate failed")
    return ate


# ------------------------------------------------ bearing-level harness
def make_landmarks(n=48, seed=3, radius=5.5, half_height=2.5):
    """Points on the synthetic room's cylinder wall + floor/ceiling rings."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-half_height, half_height, n)
    r = np.where(rng.random(n) < 0.8, radius, rng.uniform(2.0, radius, n))
    return np.stack([r * np.cos(ang), r * np.sin(ang), z], -1)


def cam_bearings(world, t, pts_w, ric, tic):
    """Unit bearings of world points in the camera at capture time t."""
    from lfvio_tpu_torch.geom import host as hg

    p, q = world.pose(t)
    x_cam = ((pts_w - p) @ hg.quat_to_mat(q) - tic) @ ric
    return x_cam / np.linalg.norm(x_cam, axis=-1, keepdims=True)


class BearingFrontEnd:
    """Stub front end: 'tracks' by projecting known landmarks. Frames are
    stamped at t and observed at t + td_true (a planted camera delay)."""

    def __init__(self, world, pts_w, ric=None, tic=None, td_true=0.0, vel_eps=5e-4):
        self.world, self.pts_w, self.td_true, self.vel_eps = world, pts_w, td_true, vel_eps
        self.ric = np.eye(3) if ric is None else np.asarray(ric, np.float64)
        self.tic = np.zeros(3) if tic is None else np.asarray(tic, np.float64)
        self.n_resets = 0

    def process_arrays(self, img, t, publish=True):
        if not publish:
            return None
        t_obs = float(t) + self.td_true
        b = cam_bearings(self.world, t_obs, self.pts_w, self.ric, self.tic)
        b2 = cam_bearings(self.world, t_obs + self.vel_eps, self.pts_w, self.ric, self.tic)
        n = len(self.pts_w)
        return np.arange(n), b, (b2 - b) / self.vel_eps, np.zeros(n), np.ones(n, bool)

    def reset(self):
        self.n_resets += 1


def run_bearing_stream(pipe, world, duration, frame_rate=20.0, imu_rate=200.0, t0=0.0):
    """Exact IMU and frame events over [t0, t0 + duration] through a pipeline:
    the real measurement-alignment path (live-td pairing, boundary
    interpolation)."""
    per_frame = int(round(imu_rate / frame_rate))
    k0 = int(round(t0 * imu_rate)) + (1 if t0 > 0 else 0)
    ks = np.arange(k0, int(round((t0 + duration) * imu_rate)) + 1)
    acc, om = world.imu_batch(ks / imu_rate)
    for i, k in enumerate(ks):
        if k % per_frame == 0:
            pipe.feed_frame(float(k / imu_rate), k / imu_rate)
        pipe.feed_imu(float(k / imu_rate), acc[i], om[i])
    pipe.flush()
    return pipe


def phase_capabilities(dev):
    """The bounds of tests/test_capabilities.py on the card."""
    import torch
    from lfvio_tpu_torch.geom import host as hg
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, VioPipeline
    from lfvio_tpu_torch.runtime.synthetic import SyntheticWorld, make_synthetic_pal_camera

    cam = make_synthetic_pal_camera(dtype=torch.float64)
    pts = make_landmarks()
    mk_world = lambda **kw: SyntheticWorld(camera=cam, dtype=torch.float64, device=dev, **kw)
    mk_est = lambda **kw: Estimator(EstimatorConfig(
        n_feature_slots=64, solver_dtype=torch.float64, device=dev, **kw))
    out = {}

    def stream(name, est, world, duration, check, **fe_kw):
        t0 = time.perf_counter()
        frame_rate = fe_kw.pop("frame_rate", 20.0)
        pipe = VioPipeline(BearingFrontEnd(world, pts, **fe_kw), est)
        run_bearing_stream(pipe, world, duration, frame_rate)
        if est.solver_flag != est.NON_LINEAR:
            raise AssertionError(f"{name}: did not initialize")
        msg = check(est, pipe, world)
        log(f"[7] {name}: {msg}; {len(est.times)} solves in {time.perf_counter() - t0:.1f} s")

    def ate_of(est, world):
        ate, n = trajectory_ate(world, est)
        if not (n >= 30 and ate < 0.25):
            raise AssertionError(f"ATE {ate} over {n} poses")
        return f"ATE {ate:.4f} m over {n} poses (< 0.25)"

    def check_td(est, pipe, world):
        if not abs(est.td - 0.005) < 5e-4:
            raise AssertionError(f"td {est.td}")
        out["td"] = est.td
        return f"td {est.td:.6f} s against the planted 0.005 (within 5e-4)"

    stream("td recovery", mk_est(estimate_td=True), mk_world(traj_freq=0.8), 3.0, check_td,
           td_true=0.005)

    ric_true = hg.ypr_deg_to_R([25.0, 8.0, -12.0])

    def check_ex(est, pipe, world):
        R_est = hg.quat_to_mat(est.qic)
        ang = np.degrees(np.arccos(np.clip((np.trace(R_est.T @ ric_true) - 1) / 2, -1, 1)))
        if not (est.extrinsic_calibrated and ang < 3.0):
            raise AssertionError(f"extrinsic rotation error {ang} deg")
        out["ex_deg"] = ang
        return f"online extrinsic rotation error {ang:.3f} deg (< 3)"

    stream("extrinsic rotation", mk_est(estimate_extrinsic=True, calib_extrinsic_rotation=True),
           mk_world(traj_freq=1.5), 3.5, check_ex, ric=ric_true, frame_rate=10.0)

    def check_relo(est, pipe, world):
        solves = {}
        est._dispatch_solve = timed_call(est._dispatch_solve, solves, "ms")
        t_loop = float(est.headers[est.WIN - 2])
        rng = np.random.default_rng(7)
        b = cam_bearings(world, t_loop, pts, np.eye(3), np.zeros(3))
        b = b + 4e-3 * rng.standard_normal(b.shape)
        b /= np.linalg.norm(b, axis=-1, keepdims=True)
        p_true, q_true = world.pose(t_loop)
        if not est.set_relo_frame(t_loop, np.arange(len(pts)), b, p_true, q_true):
            raise AssertionError("set_relo_frame refused the match")
        pnp_err = float(np.linalg.norm(est.relo_relative_t))
        run_bearing_stream(pipe, world, 0.4, t0=2.0)
        refined = float(np.linalg.norm(est.relo_relative_t))
        if not (refined < pnp_err and refined < 0.1 and est._relo_active is None):
            raise AssertionError(f"relo: refined {refined} against PnP {pnp_err}")
        ms = solves["ms"]
        out["relo_solve_ms"], out["plain_solve_ms"] = ms[0], float(np.median(ms[1:]))
        return (f"relocalization refined error {refined:.4f} m < PnP seed's {pnp_err:.4f} m; the "
                f"solve with the relo block {ms[0]:.1f} ms beside {out['plain_solve_ms']:.1f} ms "
                f"(median of the {len(ms) - 1} plain solves after it)")

    stream("relocalization", mk_est(), mk_world(), 2.0, check_relo)
    stream("window 20", mk_est(window=20), mk_world(), 2.6, lambda e, p, w: ate_of(e, w))

    seqs = []

    def check_lag3(est, pipe, world):
        stacked = [s for s in seqs if len(s) >= 2]
        if not stacked:
            raise AssertionError("no solve finalized across two slides")
        return ate_of(est, world) + f"; {len(stacked)} write-backs across stacked slides"

    est3 = mk_est(solve_lag=3, min_parallax=30.0 / 160.0)
    orig = est3._write_back_lagged
    est3._write_back_lagged = lambda pend, host: (seqs.append(tuple(pend["slides"])),
                                                  orig(pend, host))[1]
    stream("solve lag 3", est3, mk_world(traj_freq=0.5), 2.2, check_lag3)

    def check_budget(est, pipe, world):
        est.marg_old = False
        if not (est._iter_time and est._iter_time > 0 and est._iterations_allowed() == 1):
            raise AssertionError(f"budget: _iter_time {est._iter_time}")
        out["iter_time"] = est._iter_time
        return (f"max_solver_time 1e-7: _iter_time {est._iter_time:.5f} s per LM iteration, "
                f"_iterations_allowed() 1; a budget of 0.04 s would allow "
                f"{int(np.clip(0.04 / est._iter_time, 1, 8))}")

    stream("wall budget", mk_est(max_solver_time=1e-7), mk_world(), 1.5, check_budget)

    t0 = time.perf_counter()
    (ate64, n64), (ate32, n32) = f32_stream_ates(dev)
    out["ate_f64"], out["ate_f32"] = ate64, ate32
    log(f"[7] f32 operating point (tests/test_f32.py's stream, 6 s at 20 Hz, 48 landmarks): "
        f"f32 ATE {ate32:.4f} m over {n32} poses, f64 {ate64:.4f} m over {n64} (bound "
        f"max(2 x f64, 0.05) = {max(2 * ate64, 0.05):.4f} m); {time.perf_counter() - t0:.1f} s")
    if not (np.isfinite(ate32) and ate32 <= max(2.0 * ate64, 0.05) and n32 >= 30):
        raise AssertionError("the f32 solver is not within its bound of the f64 one")
    return out


def f32_stream_ates(device):
    """tests/test_f32.py's scenario: the bearing stream of 48 landmarks, 6 s
    at 20 Hz, through the estimator (64 slots) with the solver in f64 and in
    f32 on ``device``. Returns ((ATE, poses) f64, (ATE, poses) f32)."""
    import torch
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, VioPipeline
    from lfvio_tpu_torch.runtime.synthetic import SyntheticWorld, make_synthetic_pal_camera

    pts = make_landmarks(n=48)
    res = []
    for sd in (torch.float64, torch.float32):
        world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=torch.float64),
                               dtype=torch.float64, device=device)
        est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=sd, device=device))
        run_bearing_stream(VioPipeline(BearingFrontEnd(world, pts), est), world, 6.0)
        if est.solver_flag != est.NON_LINEAR:
            raise AssertionError(f"the {sd} stream did not initialize")
        res.append(trajectory_ate(world, est))
    return res


# The JAX test's stream is 6 s; 4.5 s keeps the whole run inside its time
# limit with phase 13 added and still holds every bound (on the CPU: 56
# solves, both cameras in the window, ATE 0.057 m; 0.064 m on the card at 6 s).
DUAL_PAL_SECONDS = 4.5


def phase_dual_pal(dev, plain_calls):
    """tests/test_multicam.py::test_dual_pal_rendered_image_pipeline on the
    card: two rendered PAL streams (up and down cameras) through a
    DualFrontEnd and the n_cams = 2 estimator."""
    import torch
    from lfvio_tpu_torch.frontend import klt_cuda
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, FrontEnd, VioPipeline
    from lfvio_tpu_torch.runtime.synthetic import (
        SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)
    from lfvio_tpu_torch.runtime.tracker import DualFrontEnd

    tics = np.array([[0.0, 0.0, 0.05], [0.0, 0.0, -0.05]])
    rics = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0])])
    world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=torch.float64),
                           dtype=torch.float64, device=dev)
    H, W = world.height, world.width
    kw = dict(max_cnt=90, min_dist=15, n_slots=128, equalize=False, dtype=torch.float32,
              annulus=(W / 2, H / 2, SYN_MAX_R, SYN_MIN_R), device=dev)
    fes = [FrontEnd(world.camera, (H, W), seed=c, **kw) for c in range(2)]
    fe = DualFrontEnd(*fes)
    est = Estimator(EstimatorConfig(n_feature_slots=256, n_cams=2, tic=tics, ric=rics,
                                    solver_dtype=torch.float64, device=dev))
    solves = {}
    est._dispatch_solve = timed_call(est._dispatch_solve, solves, "ms")
    tracked = [count_calls(f, "_step_impl") for f in fes]
    reset_launches()
    plain_calls["n"] = 0
    stream = world.generate(DUAL_PAL_SECONDS, 15.0, 200.0)
    n_frames = sum(1 for e in stream if e[0] == "frame")
    t0 = time.perf_counter()
    times, _, _ = VioPipeline(fe, est).run(
        stream, lambda tt: tuple(world.render_rig(tt, rics[c], tics[c]) for c in range(2)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, sym_launches = klt_cuda.lk_pyramid.launches, sym_eig.launches
    ate, n = trajectory_ate(world, est)
    cams = est.fm.cam[est.fm.valid]
    ms = [m for m in solves["ms"] if m > 0.01]
    log(f"[8] dual-PAL: {n_frames} frame pairs in {dt:.1f} s = {n_frames / dt:.3f} frames/s "
        f"(rendering and a synchronize around each solve included); {len(times)} solves, median "
        f"{float(np.median(ms[1:])):.1f} ms with n_cams = 2 (D = 178); tracked frames "
        f"{tracked[0]['n']} + {tracked[1]['n']}; fused LK launches {launches}; sym_eig launches "
        f"{sym_launches}; plain LK calls "
        f"{plain_calls['n']}; observations in the window from camera 0: {int((cams == 0).sum())}, "
        f"camera 1: {int((cams == 1).sum())}; ATE {ate:.4f} m over {n} poses (< 0.25)")
    if est.solver_flag != est.NON_LINEAR or len(times) <= 30:
        raise AssertionError("dual-PAL run did not initialize")
    if not ((cams == 0).any() and (cams == 1).any()):
        raise AssertionError("the window does not hold both cameras")
    if (launches != tracked[0]["n"] + tracked[1]["n"] or launches != 2 * tracked[0]["n"]
            or launches == 0 or plain_calls["n"] != 0 or klt_cuda.lk_level.launches != 0):
        raise AssertionError("dual-PAL: not two fused LK launches per tracked frame")
    if sym_launches == 0:
        raise AssertionError("dual-PAL: the eigensolver kernel was not launched")
    if not (np.isfinite(ate) and ate < 0.25):
        raise AssertionError("dual-PAL accuracy gate failed")
    return dict(launches=launches, sym_launches=sym_launches, fps=n_frames / dt, ate=ate,
                solve_ms=float(np.median(ms[1:])))


# ------------------------------------------------ phase 9: EuRoC directory
def png_gray(img):
    """An 8-bit greyscale PNG of img [H, W] uint8; row r uses row filter
    r % 5 (None, Sub, Up, Average, Paeth), so a reader meets all five."""
    H, W = img.shape
    x = img.astype(np.int16)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]  # up
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    ftype = np.arange(H) % 5
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])[ftype[:, None], np.arange(H)[:, None],
                                                                  np.arange(W)[None, :]]
    raw = np.concatenate([ftype[:, None], (x - pred) & 0xFF], axis=1).astype(np.uint8)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def write_euroc(root, world, stream, frames):
    """A EuRoC-layout directory (mav0/) of the full-scale stream: the IMU
    samples, one PNG per frame, the ground truth at 50 Hz. Returns (mav0,
    frames as uint8 in time order, ground truth (t, p, q))."""
    mav0 = os.path.join(root, "mav0")
    for sub in ("imu0", "cam0/data", "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(mav0, sub))
    num = lambda v: ",".join(repr(float(x)) for x in v)
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for e in stream:
            if e[0] == "imu":
                f.write(f"{round(e[1] * 1e9)},{num(e[3])},{num(e[2])}\n")
    images = []
    with open(os.path.join(mav0, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t in sorted(frames):
            tns = round(t * 1e9)
            img = frames[t].cpu().numpy()
            with open(os.path.join(mav0, "cam0", "data", f"{tns}.png"), "wb") as g:
                g.write(png_gray(img))
            f.write(f"{tns},{tns}.png\n")
            images.append(img)
    gt_t = np.arange(0, FULL_SCALE_SECONDS, 0.02)
    gt_p, gt_q = world.pose_batch(gt_t)
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for k in range(len(gt_t)):
            f.write(f"{round(gt_t[k] * 1e9)},{num(gt_p[k])},{num(gt_q[k])}\n")
    return mav0, images, (gt_t, gt_p, gt_q)


def phase_euroc(rig, plain_calls):
    """Phase 4's world written as a EuRoC directory, read back and run at
    bench.py's configuration (solve lag 2, device chain, depth 3) through
    euroc_stream + run_sequence."""
    import torch
    from lfvio_tpu_torch.frontend import klt_cuda
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig
    from lfvio_tpu_torch.runtime.datasets import euroc_stream, read_euroc_groundtruth, run_sequence
    from lfvio_tpu_torch.runtime.evaluation import ate_rmse

    world, stream, frames, make = rig
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mav0, images, (gt_t, gt_p, gt_q) = write_euroc(tmp, world, stream, frames)
        t_write = time.perf_counter() - t0
        rt, rp, rq = read_euroc_groundtruth(os.path.join(mav0, "state_groundtruth_estimate0",
                                                          "data.csv"))
        gt_err = max(np.abs(rt - gt_t).max(), np.abs(rp - gt_p).max(), np.abs(rq - gt_q).max())
        if not (len(rt) == len(gt_t) and gt_err <= 1e-9):
            raise AssertionError(f"ground truth does not read back: {gt_err}")

        items = list(euroc_stream(mav0))
        decode = {"s": 0.0, "n": 0}

        def checked(load, k):
            def run():
                t = time.perf_counter()
                img = load()
                decode["s"] += time.perf_counter() - t
                if not np.array_equal(img, images[k]):  # float32 of the same bytes
                    raise AssertionError(f"frame {k} does not read back bit for bit")
                decode["n"] += 1
                return img
            return run

        k = 0
        for i, it in enumerate(items):
            if it[0] == "frame":
                items[i] = ("frame", it[1], checked(it[2], k))
                k += 1
        fe, est, pipe = make(2, 3)
        tracked = count_calls(fe, "_step_impl")
        padded = count_level_pads()
        reset_launches()
        plain_calls["n"] = 0
        t_split = FULL_SCALE_SECONDS * 0.6
        t0 = time.perf_counter()
        run_sequence(pipe, [it for it in items if it[1] <= t_split])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec_warm = decode["s"]
        rest = [it for it in items if it[1] > t_split]
        run_sequence(pipe, rest)
        pipe.flush()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches, sym_launches = klt_cuda.lk_pyramid.launches, sym_eig.launches
    n_timed = sum(1 for it in rest if it[0] == "frame")
    fps = n_timed / (t2 - t1)
    times, traj = np.asarray(est.times), np.asarray(est.traj_p)
    ate, n = ate_rmse(times, traj, rt, rp)
    log(f"[9] EuRoC directory: {len(images)} PNGs ({images[0].shape[1]}x{images[0].shape[0]}, row "
        f"filters 0-4) and the CSVs written "
        f"in {t_write:.2f} s; ground truth read back within {gt_err:.3g}; {decode['n']} frames "
        f"decoded bit-identical, {1e3 * decode['s'] / decode['n']:.1f} ms per frame")
    log(f"[9] euroc_stream + run_sequence, solve lag 2 / depth 3: warm-up {t1 - t0:.2f} s; timed "
        f"{n_timed} frames in {t2 - t1:.3f} s = {fps:.3f} frames/s (decoding included, "
        f"{1e3 * (decode['s'] - dec_warm) / n_timed:.1f} ms of it per frame); first solve at t = "
        f"{times[0]:.4f} s; poses {len(times)}; ATE {ate:.4f} m over {n} poses against the "
        f"ground-truth CSV; tracked frames {tracked['n']}; fused LK launches {launches}; "
        f"one-level launches {klt_cuda.lk_level.launches}; plain LK calls {plain_calls['n']}; "
        f"level images padded {padded['n']}; sym_eig launches {sym_launches}")
    if est.solver_flag != est.NON_LINEAR or len(times) <= 25 or n != len(times):
        raise AssertionError("EuRoC run did not initialize, or too few poses")
    if not (np.isfinite(traj).all() and ate < 0.5):
        raise AssertionError("EuRoC ATE is not below 0.5 m")
    if (launches == 0 or launches != tracked["n"] or klt_cuda.lk_level.launches != 0
            or plain_calls["n"] != 0 or padded["n"] != 0):
        raise AssertionError("the EuRoC path's LK is not one fused launch per tracked frame")
    if sym_launches == 0:
        raise AssertionError("the EuRoC path did not launch the eigensolver kernel")
    return dict(launches=launches, sym_launches=sym_launches, fps=fps, ate=ate)


# ------------------------------------------------ phase 10: tools
def board_image(Hm, rows=5, cols=7, sq=36, shape=(480, 640), seed=0):
    """A projectively warped chessboard (tests/test_calib.py's) and its inner
    corners in row-major order."""
    H, W = shape
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    Hi = np.linalg.inv(Hm)
    den = Hi[2, 0] * xx + Hi[2, 1] * yy + Hi[2, 2]
    bx = (Hi[0, 0] * xx + Hi[0, 1] * yy + Hi[0, 2]) / den
    by = (Hi[1, 0] * xx + Hi[1, 1] * yy + Hi[1, 2]) / den
    cx, cy = np.floor(bx / sq).astype(int), np.floor(by / sq).astype(int)
    inside = (bx >= 0) & (by >= 0) & (bx < (cols + 1) * sq) & (by < (rows + 1) * sq)
    img = np.where(inside & (((cx + cy) % 2) == 0), 230.0, 25.0)
    img = np.where(inside, img, 128.0) + np.random.default_rng(seed).normal(0, 2.0, (H, W))
    uv = np.array([[i * sq, j * sq, 1.0] for j in range(1, rows + 1) for i in range(1, cols + 1)])
    g = uv @ Hm.T
    return img, g[:, :2] / g[:, 2:]


def phase_tools(rig, dev):
    """Panorama, AR, chessboard detection, calibration, native IO and the
    eigh marginalization on the card."""
    import torch
    from lfvio_tpu_torch import calib, native
    from lfvio_tpu_torch.calib import chessboard
    from lfvio_tpu_torch.cam import KannalaBrandtCamera, MeiCamera, PinholeCamera
    from lfvio_tpu_torch.geom import host as hg
    from lfvio_tpu_torch.runtime.ar_demo import ArRenderer
    from lfvio_tpu_torch.runtime.panorama import PanoramaRemapper
    from lfvio_tpu_torch.runtime.trajectory_io import read_tum

    world, _, frames, _ = rig
    cam = world.camera
    img = frames[sorted(frames)[10]]
    H, W = img.shape
    pano = PanoramaRemapper(cam, (H, W), device=dev)
    out = pano.remap(img)
    ms = cuda_ms(lambda: pano.remap(img), reps=10)
    plain = PanoramaRemapper(cam, (H, W), device="cpu").remap(img.cpu())
    err = (out.cpu() - plain).abs().max().item()
    nz = (out > 0).float().mean().item()
    log(f"[10] panorama 1024x256 of a {W}x{H} frame: {ms:.4f} ms on the card (CUDA events, 10 "
        f"calls a sample); non-zero pixels {100 * nz:.1f}%; max |card - CPU| {err:.3g}")
    if tuple(out.shape) != (256, 1024) or nz < 0.9 or err > 1e-3:
        raise AssertionError("panorama")

    ar = ArRenderer(cam, W, H, samples_per_edge=32)
    ar.add_cube([2.0, 0.5, 0.0], 0.8)
    ar.add_axes([0.0, 2.0, -0.5], 1.0)
    p, q = world.pose(1.0)
    R = hg.quat_to_mat(q)
    t0 = time.perf_counter()
    proj = ar.project(R, p)
    drawn = ar.render(img.cpu().numpy(), R, p, thickness=2)
    t_ar = time.perf_counter() - t0
    pix, ok, _ = proj[0]
    pc = (ar.objects[0][0][0, 0] - p) @ R  # the first sample in the camera frame
    ref = cam.to(device="cpu", dtype=torch.float64).space_to_plane(torch.as_tensor(pc)).numpy()
    changed = int((drawn != np.repeat(img.cpu().numpy()[..., None], 3, -1)).any(-1).sum())
    log(f"[10] AR: {sum(int(o.sum()) for _, o, _ in proj)} drawable samples of "
        f"{sum(o.size for _, o, _ in proj)}, {changed} pixels drawn, {t_ar:.3f} s; first sample "
        f"{np.abs(pix[0, 0] - ref).max():.2g} px from the camera's f64 projection")
    if not (ok.any() and changed > 100 and np.abs(pix[0, 0] - ref).max() < 1e-2):
        raise AssertionError("AR overlay")

    Hm = np.array([[0.95, 0.08, 120.0], [-0.05, 1.02, 90.0], [1.2e-4, -8e-5, 1.0]])
    board, gt = board_image(Hm)
    corners, found = chessboard.find_chessboard_corners(board, (5, 7), device=dev)
    c_cpu, f_cpu = chessboard.find_chessboard_corners(board, (5, 7), device="cpu")
    x = torch.as_tensor(board, dtype=torch.float32, device=dev)
    det_ms = cuda_ms(lambda: chessboard._detect_candidates(x, k=140), reps=10)
    d = np.linalg.norm(corners[:, None] - gt[None], axis=-1).min(1) if found else [np.inf]
    log(f"[10] chessboard 5x7 on 640x480: found {found} (CPU {f_cpu}); worst corner "
        f"{max(d):.3f} px from the truth (< 1.5); max |card - CPU| "
        f"{np.abs(corners - c_cpu).max():.3g} px; response + peaks + top-k {det_ms:.4f} ms")
    if not (found and f_cpu and max(d) < 1.5 and np.abs(corners - c_cpu).max() < 1e-3):
        raise AssertionError("chessboard detection")

    f64 = lambda **kw: {k: torch.tensor(v, dtype=torch.float64) for k, v in kw.items()}
    kb_dirs = [[np.sin(a) * np.cos(b), np.sin(a) * np.sin(b), np.cos(a)]
               for a in np.radians([8.0, 20.0, 35.0]) for b in np.radians([0, 120, 240])]
    cases = [
        ("pinhole", PinholeCamera(**f64(fx=460.0, fy=455.0, cx=376.0, cy=240.0, k1=-0.28,
                                        k2=0.07, p1=2e-4, p2=1.5e-4)),
         dict(n_views=8, seed=3), calib.calibrate_pinhole, dict(fx=460.0, fy=455.0, cx=376.0,
                                                                cy=240.0), 1.0),
        ("Mei", MeiCamera(**f64(xi=0.9, k1=-0.15, k2=0.03, p1=3e-4, p2=-2e-4, gamma1=430.0,
                                gamma2=425.0, u0=376.0, v0=240.0)),
         dict(n_views=10, seed=5), calib.calibrate_mei, dict(u0=376.0, v0=240.0), 1.0),
        ("Kannala-Brandt", KannalaBrandtCamera(**f64(mu=405.0, mv=400.0, u0=376.0, v0=240.0,
                                                     k2=-0.02, k3=0.004, k4=-0.001, k5=0.0002)),
         dict(n_views=9, seed=6, directions=kb_dirs), calib.calibrate_kannala_brandt,
         dict(mu=405.0, mv=400.0, u0=376.0, v0=240.0), 2.0),
    ]
    for name, model, kw, solve, truth, bound in cases:
        t0 = time.perf_counter()
        obj, pts, _ = calib.synth_chessboard_views(model, depth=0.8, **kw)
        params, _, rms = solve(obj, pts, (752, 480))
        worst = max(abs(params[k] - v) for k, v in truth.items())
        log(f"[10] calibrate {name}: rms {rms:.2e} px (< 0.05), worst of "
            f"{', '.join(truth)} {worst:.3g} px from the truth (< {bound}), "
            f"{time.perf_counter() - t0:.1f} s")
        if not (rms < 0.05 and worst < bound):
            raise AssertionError(f"calibration of {name}")
    log("[10] calibrate_scaramuzza: not run here (86 s on the CPU; its test is slow-marked)")

    t0 = time.perf_counter()
    lib = native.build()
    sync = native.NativeSynchronizer(td=0.0)
    for k in range(10):
        sync.push_imu(k * 0.01, [1.0 + k, 0, 0], [0, 0.1 * k, 0])
    pending = sync.push_frame(0.095, 7) is False and sync.pop() is None
    sync.push_imu(0.10, [11.0, 0, 0], [0, 1.0, 0])
    ft, fid, dts, accs, gyrs = sync.pop()
    sync.close()
    with tempfile.TemporaryDirectory() as tmp:
        with native.NativeTumWriter(os.path.join(tmp, "traj.txt")) as w:
            w.write(1.5, [1, 2, 3], [1, 0, 0, 0])
            w.write(2.5, [4, 5, 6], [0.7071, 0.7071, 0, 0])
        tt, tp, tq = read_tum(os.path.join(tmp, "traj.txt"))
    ok_sync = (pending and fid == 7 and abs(ft - 0.095) < 1e-12 and np.allclose(dts[:-1], 0.01)
               and abs(dts[-1] - 0.005) < 1e-12 and abs(accs[-1, 0] - 10.5) < 1e-9
               and abs(gyrs[-1, 1] - 0.95) < 1e-9)
    ok_tum = np.allclose(tt, [1.5, 2.5]) and np.allclose(tp[1], [4, 5, 6]) and np.allclose(
        tq[1], [0.7071, 0.7071, 0, 0])
    log(f"[10] native IO: {lib.name} built with g++ and used in {time.perf_counter() - t0:.2f} s; "
        f"synchronizer pairing and boundary interpolation {'right' if ok_sync else 'WRONG'} "
        f"(acc 10.5 at t = 0.095); TUM writer {'right' if ok_tum else 'WRONG'}")
    if not (ok_sync and ok_tum):
        raise AssertionError("native IO runtime")

    phase_eigh(dev)


def phase_eigh(dev):
    """The eigh marginalization against the QR one, f64, 256 slots, on the card."""
    import torch
    from lfvio_tpu_torch.backend import marginalize as marg
    from lfvio_tpu_torch.imu import preintegrate, whiten_covariance
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    pb = make_window_problem(256, torch.float64, device=dev)
    state, grid, prior, g, cfg = (pb[k] for k in ("state", "grid", "prior", "gravity", "cfg"))
    imu = [torch.as_tensor(pb[k], dtype=torch.float64, device=dev)
           for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pre = preintegrate(*imu, state.ba[:-1], state.bg[:-1], pb["noise"])
    si, iv = whiten_covariance(pre.covariance, torch.as_tensor(pb["imu_valid"], device=dev))
    moved = state.replace(p=state.p + 0.01)

    def info_err(a, b):
        Ha, Hb = a.J.T @ a.J, b.J.T @ b.J
        ba, bb = a.J.T @ a.r0, b.J.T @ b.r0
        return max(((Ha - Hb).abs().max() / Hb.abs().max().clamp(min=1)).item(),
                   ((ba - bb).abs().max() / bb.abs().max().clamp(min=1)).item())

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    e_old, ms_e = timed(lambda: marg.marginalize_old(state, grid, pre, si, iv, prior, g, cfg))
    q_old, ms_q = timed(lambda: marg.marginalize_old_qr(state, grid, pre, si, iv, prior, g, cfg))
    e_new, ms_en = timed(lambda: marg.marginalize_second_new(moved, prior, cfg))
    q_new, ms_qn = timed(lambda: marg.marginalize_second_new_qr(moved, prior, cfg))
    err_old, err_new = info_err(e_old, q_old), info_err(e_new, q_new)
    log(f"[10] eigh vs QR marginalization, f64, 256 slots: MARGIN_OLD JᵀJ/Jᵀr within "
        f"{err_old:.2e} of the scale, SECOND_NEW {err_new:.2e} (bound 2e-6, tests/test_marg_qr.py);"
        f" eigh {ms_e:.1f} / {ms_en:.1f} ms, QR {ms_q:.1f} / {ms_qn:.1f} ms (host timers around "
        f"a synchronized call)")
    if not (err_old < 2e-6 and err_new < 2e-6 and bool(e_old.valid) and e_old.J.is_cuda):
        raise AssertionError("eigh marginalization disagrees with QR")


# ------------------------------------------------ phase 11: profiling
def phase_profiling(dev):
    from lfvio_tpu_torch.runtime import profiling

    t0 = time.perf_counter()
    rows = profiling.profile_solve(256, 8, n=10, device=dev)
    rows += profiling.profile_frontend(n=10, device=dev)
    log(f"[11] profiling.profile_solve(256) and profile_frontend() on the card, "
        f"{time.perf_counter() - t0:.1f} s (ms per call between CUDA events):")
    profiling.print_table(rows)
    if not all(np.isfinite(r.ms) and r.ms > 0 for r in rows):
        raise AssertionError("profiling rows")
    return rows


# ------------------------------------------------ phase 12: dist
DIST_TIMEOUT = datetime.timedelta(seconds=60)


def dist_rank(rank, world, init_file, out_path, dtype_name, device, n_slots):
    """One rank of phase 12 (run in a spawned process): the sharded frame
    step on make_window_problem(n_slots), twice (the second timed); rank 0
    then runs the single-device chain in the same process, twice."""
    import torch
    import torch.distributed as dist
    from lfvio_tpu_torch import dist as tdist
    from lfvio_tpu_torch.backend import lm_solve, marginalize_old_qr
    from lfvio_tpu_torch.backend.gauge import yaw_gauge_fix
    from lfvio_tpu_torch.backend.triangulate import triangulate_grid
    from lfvio_tpu_torch.imu import preintegrate, whiten_covariance
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dtype = getattr(torch, dtype_name)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=DIST_TIMEOUT)
    try:
        mesh = tdist.make_feature_mesh()
        pb = make_window_problem(n_slots, dtype, device=dev)
        st = pb["state"]
        st = st.replace(p=st.p + torch.as_tensor(
            0.02 * np.random.default_rng(3).standard_normal((st.p.shape[0], 3)), dtype=dtype,
            device=dev))
        grid, prior, g, cfg, noise = (pb[k] for k in ("grid", "prior", "gravity", "cfg", "noise"))
        imu = [torch.as_tensor(pb[k], dtype=dtype, device=dev)
               for k in ("dts", "accs", "gyrs", "a0", "g0")]
        iv = torch.as_tensor(pb["imu_valid"], device=dev)
        has_depth = torch.arange(n_slots, device=dev) % 2 == 0

        def sharded():
            s = st.replace(inv_depth=tdist.shard_features(st.inv_depth, mesh))
            out, new_prior, c0, c1 = tdist.vio_frame_step_sharded(
                mesh, s, tdist.shard_grid(grid, mesh), *imu, iv, prior,
                tdist.shard_features(has_depth, mesh), st.p[0], st.q[0], noise, cfg)
            return out.replace(inv_depth=tdist.gather_features(out.inv_depth, mesh)), new_prior, c1

        def single():
            pre = preintegrate(*imu, st.ba[:-1], st.bg[:-1], noise)
            si, ok = whiten_covariance(pre.covariance, iv)
            s = st.replace(inv_depth=triangulate_grid(st, grid, has_depth))
            out, _, c1, _ = lm_solve(s, grid, pre, si, ok, prior, g, cfg)
            out = yaw_gauge_fix(out, st.p[0], st.q[0])
            return out, marginalize_old_qr(out, grid, pre, si, ok, prior, g, cfg), c1

        def timed(fn):
            sync()
            t0 = time.perf_counter()
            res = fn()
            sync()
            return res, time.perf_counter() - t0

        _, first_s = timed(sharded)
        (out, pr, c1), step_s = timed(sharded)
        res = dict(first_s=first_s, step_s=step_s)
        if rank == 0:
            _, single_first_s = timed(single)
            (ref, rpr, rc1), single_s = timed(single)
            n = lambda x: x.detach().double().cpu().numpy()
            res.update(single_first_s=single_first_s, single_s=single_s, c1=n(c1), ref_c1=n(rc1))
            for k in DIST_STATES:
                res[k], res["ref_" + k] = n(getattr(out, k)), n(getattr(ref, k))
            for tag, q in (("", pr), ("ref_", rpr)):
                res[tag + "H"], res[tag + "b"] = n(q.J.T @ q.J), n(q.J.T @ q.r0)
            res["valid"] = bool(pr.valid)
        dist.barrier()
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


DIST_STATES = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")
# Bounds of the sharded step against the single-device chain, relative to
# each quantity's largest magnitude (at least 1). f64: the two differ only in
# summation order (1e-13 on the CPU): 1e-9 for the states, 1e-8 for the
# prior's information. f32: the LM steps of this unconverged problem follow
# the order of the sums (reversing the feature slots alone moves the
# single-device chain's states by 2.5e-3 on the CPU), so the f32 sharded
# step is held against the f64 single-device result instead: its error may
# be at most DIST_F32_FACTOR times the f32 single-device chain's (floor 1e-4).
DIST_F64_BOUNDS = (1e-9, 1e-8)
DIST_F32_FACTOR = 3.0


def phase_dist(device="cuda:0", n_slots=256):
    """Two ranks on the one card (gloo on CUDA tensors), f64 then f32."""
    from lfvio_tpu_torch.dist.scaling_bench import spawn_ranks

    runs = {}
    for dtype_name in ("float64", "float32"):
        t0 = time.perf_counter()
        runs[dtype_name] = spawn_ranks(dist_rank, 2, (dtype_name, device, n_slots))
        r0, r1 = runs[dtype_name]
        log(f"[12] sharded frame step, 2 ranks on {device} (gloo), {dtype_name}, {n_slots} slots: "
            f"final cost {float(r0['c1']):.6g} vs {float(r0['ref_c1']):.6g} single-device; one step "
            f"{float(r0['step_s']):.3f} s (rank 1 {float(r1['step_s']):.3f} s; first "
            f"{float(r0['first_s']):.2f} s) beside the single-device step {float(r0['single_s']):.3f}"
            f" s (first {float(r0['single_first_s']):.2f} s) in the same process; "
            f"{time.perf_counter() - t0:.1f} s with start-up")
        if not bool(r0["valid"]):
            raise AssertionError(f"dist {dtype_name}: the sharded prior is not valid")

    def rel(a, b):
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

    def errs(run, tag, ref):
        return (max(rel(run[tag + k], ref["ref_" + k]) for k in DIST_STATES),
                max(rel(run[tag + k], ref["ref_" + k]) for k in ("H", "b")))

    r64, r32 = runs["float64"][0], runs["float32"][0]
    e64 = errs(r64, "", r64)
    log(f"[12] float64: sharded vs single-device states within {e64[0]:.2e} (bound "
        f"{DIST_F64_BOUNDS[0]}), prior JᵀJ/Jᵀr within {e64[1]:.2e} (bound {DIST_F64_BOUNDS[1]})")
    e32, e32_single = errs(r32, "", r64), errs(r32, "ref_", r64)
    b32 = [max(DIST_F32_FACTOR * e, 1e-4) for e in e32_single]
    log(f"[12] float32 against the float64 single-device result: sharded states {e32[0]:.2e}, "
        f"prior {e32[1]:.2e}; single-device states {e32_single[0]:.2e}, prior {e32_single[1]:.2e} "
        f"(bounds {b32[0]:.2e}, {b32[1]:.2e})")
    if not (e64[0] <= DIST_F64_BOUNDS[0] and e64[1] <= DIST_F64_BOUNDS[1]):
        raise AssertionError("dist float64: the sharded step disagrees with the single device")
    if not (e32[0] <= b32[0] and e32[1] <= b32[1]):
        raise AssertionError("dist float32: the sharded step is further from float64 than the "
                             "single device")
    return {k: dict(step_s=float(v[0]["step_s"]), single_s=float(v[0]["single_s"]))
            for k, v in runs.items()}


# ------------------------------------------------ phase 13: keyframe axis
# tests/test_kf_axis.py's problem and bounds: 2 segments of 5 intervals, 16
# landmarks each, 0.3 px bearing noise, seed 3; 6 LM iterations a round,
# cost_tol 0, 2 + 3S rounds; the monolithic reference 40 iterations.
KF_GATE = dict(wseg=5, reps=0, n_outer=2 + 3 * 2, noise=0.3 / 160.0, cost_tol=0.0)
KF_GAP_M = 5e-3
KF_MONO_M = 0.01
# f64 on the card against f64 on the CPU: only the rounding of the two
# devices' kernels differs, amplified over 48 LM iterations (3.1e-9 seen).
KF_CARD_CPU = 1e-8
KF_FULL_SHAPES = ((1, 1), (2, 1), (2, 2))


def kf_position_error(p, ref):
    """Largest distance of segmented positions p [S, W1, 3] from a whole
    trajectory's ref [S·(W1−1)+1, 3] (segment s's keyframe j is s·(W1−1)+j)."""
    S, W1 = p.shape[:2]
    return max(np.linalg.norm(p[s, j] - ref[s * (W1 - 1) + j]) for s in range(S)
               for j in range(W1))


def kf_truth_errors(row):
    """The solve's largest position error to the truth, and the initial
    perturbation's largest."""
    return (kf_position_error(row["p"], row["p_truth"]),
            float(np.linalg.norm(row["p_init"] - row["p_truth"], axis=-1).max()))


def phase_kf_axis(device="cuda:0"):
    """(a) f64 on four ranks of the card (2 segments × 2 feature shards, gloo
    on CUDA tensors) with tests/test_kf_axis.py's bounds against the port's
    monolithic lm_solve on the card, then the same four ranks on the CPU;
    (b) f32 at the main path's window (11 keyframes a segment, 256 slots a
    segment), 4 rounds, through the scaling bench's kf rows at 1x1, 2x1,
    2x2 (1 timed call after the first)."""
    import torch
    from lfvio_tpu_torch.backend.state import NFRAMES, SolverConfig
    from lfvio_tpu_torch.dist.scaling_bench import IMU_NOISE, STATE_KEYS, kf_rows
    from lfvio_tpu_torch.dist.synthetic_traj import make_segmented_problem, solve_joint

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # the card's ranks, the CPU's and the monolithic solve
        runs = {d: pool.submit(kf_rows, [(2, 2)], lambda S, n_f: 16, device=d,
                               dtype=torch.float64, **KF_GATE) for d in (device, "cpu")}
        pb = make_segmented_problem(2, KF_GATE["wseg"], 16, torch.float64,
                                    noise=KF_GATE["noise"], device=device)
        mono, c0, c1 = solve_joint(pb, IMU_NOISE, SolverConfig(
            max_iterations=40, estimate_td=False, estimate_extrinsic=False, cost_tol=0.0))
        t_mono = time.perf_counter() - t0
        card, cpu = (runs[d].result()[(2, 2)] for d in (device, "cpu"))
    to_mono = kf_position_error(card["p"], mono.p.cpu().numpy())
    err, init = kf_truth_errors(card)
    rel = {k: float(np.abs(card[k] - cpu[k]).max() / max(1.0, np.abs(cpu[k]).max()))
           for k in (*STATE_KEYS, "gap", "costs", "hist")}
    worst = max(rel, key=rel.get)
    card_cpu = rel[worst]
    log(f"[13] (a) float64, 2x2 ranks on {device} (gloo), {KF_GATE['n_outer']} rounds: boundary "
        f"gaps {card['gap'].max():.3e} m (bound {KF_GAP_M}); poses within {to_mono:.3e} m of the "
        f"monolithic lm_solve on {device} (bound {KF_MONO_M}; its cost {float(c0):.6g} -> "
        f"{float(c1):.6g}, {t_mono:.1f} s beside the ranks); largest error to the truth "
        f"{err:.4f} m beside the initial {init:.4f} m (bound half); card = CPU within "
        f"{card_cpu:.2e} of the scale, at {worst} (bound {KF_CARD_CPU}; states "
        f"{max(rel[k] for k in STATE_KEYS):.2e}); first call {card['first_s'].max():.1f} s on "
        f"the card, {cpu['first_s'].max():.1f} s on the CPU; {time.perf_counter() - t0:.1f} s "
        f"with start-up")
    if not (np.isfinite(card["p"]).all() and card["gap"].max() < KF_GAP_M
            and to_mono < KF_MONO_M and err < 0.5 * init and card_cpu <= KF_CARD_CPU):
        raise AssertionError("kf axis float64: a bound of tests/test_kf_axis.py failed on the card")

    full = {}
    for shape in KF_FULL_SHAPES:
        for n_outer in (4, 2 + 3 * shape[0]):
            t0 = time.perf_counter()
            row = kf_rows([shape], lambda S, n_f: 256, wseg=NFRAMES - 1, reps=1, n_outer=n_outer,
                          device=device, dtype=torch.float32, noise=0.0)[shape]
            err, init = kf_truth_errors(row)
            ok = bool(all(np.isfinite(row[k]).all() for k in STATE_KEYS)
                      and row["gap"].max() < KF_GAP_M and err < 0.5 * init)
            log(f"[13] (b) float32, {shape[0]}x{shape[1]} ranks, {NFRAMES} keyframes and 256 slots "
                f"a segment, {n_outer} rounds: "
                f"{', '.join(f'{x:.3f}' for x in row['round_s'])} s a round (rank by rank); first "
                f"call {', '.join(f'{x:.1f}' for x in row['first_s'])} s; gaps "
                f"{row['gap'].max():.3e} m; largest error to the truth {err:.4f} m beside the "
                f"initial {init:.4f} m; {'within' if ok else 'OUTSIDE'} the bounds; "
                f"{time.perf_counter() - t0:.1f} s with start-up")
            full[shape + (n_outer,)] = dict(round_s=row["round_s"], first_s=row["first_s"],
                                            gap=float(row["gap"].max()), err=err, ok=ok)
            if ok:
                break
        if not ok:
            raise AssertionError(f"kf axis float32 {shape}: outside the bounds at "
                                 f"{n_outer} rounds too")
    return full

# ------------------------------------------------ phase 14: device programs
# sym_eig against torch.linalg.eigh on the same inputs. Each pair (f32, the
# main path's type; f64): eigenvalues within the first bound of the largest
# |eigenvalue|; residuals |A v - w v| and |VᵀV - I| within the second of it
# (a backward-stable solver's are a few roundings); the smallest
# eigenvector, which every caller uses, within the third after matching
# its sign wherever it is well posed, i.e. the second eigenvalue is at least
# the fourth times the largest: there two solvers may differ by about a
# rounding over that gap (1.2e-7 / 1e-2 in f32). RANSAC's 8-point matrices
# are rank 8 and mostly not well posed at 1e-2 in f32 (the residual holds
# them).
EIG_BOUNDS = {"float32": (1e-5, 1e-5, 1e-3, 1e-2), "float64": (1e-12, 1e-12, 1e-9, 1e-6)}
# A graph replay against the same program run eagerly on the same inputs
# (f64): the same kernels in the same order, up to the order of atomic sums.
GRAPH_F64 = 1e-9
# The phase-4 stream with the programs eager against as graphs (f32): ATE
# within 1 mm.
GRAPH_ATE_M = 1e-3


def main_path_eig_inputs(dev):
    """The symmetric matrices the main path hands the eigensolver, recorded
    from the calls themselves: a triangulation of make_window_problem(256)
    (the full-scale window, f32) and one RANSAC (100 hypotheses and the refit
    over 256 slots of bearings seen all around the rig, 40 outliers)."""
    import torch
    from lfvio_tpu_torch.backend import triangulate as tri
    from lfvio_tpu_torch.frontend import ransac
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    seen = []

    def record(A):
        seen.append(A.clone())
        return torch.linalg.eigh(A)

    pb = make_window_problem(256, torch.float32, device=dev)
    rng = np.random.default_rng(5)
    N = 256
    X = rng.standard_normal((N, 3))
    X *= rng.uniform(2.0, 8.0, (N, 1)) / np.linalg.norm(X, axis=-1, keepdims=True)
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    R *= np.linalg.det(R)
    X2 = X @ R.T + [0.2, -0.1, 0.05]
    X2[:40] = rng.standard_normal((40, 3))  # outliers
    tt = lambda a: torch.as_tensor(a / np.linalg.norm(a, axis=-1, keepdims=True),
                                   dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.random(N) < 0.85, device=dev)
    uni = torch.as_tensor(rng.random((ransac.N_HYPOTHESES, N)), dtype=torch.float32, device=dev)
    saved = tri.sym_eig, ransac.sym_eig
    tri.sym_eig = ransac.sym_eig = record
    try:
        tri.triangulate_grid(pb["state"], pb["grid"],
                             torch.zeros(256, dtype=torch.bool, device=dev))
        ransac.spherical_ransac_e(uni, tt(X), tt(X2), valid)
    finally:
        tri.sym_eig, ransac.sym_eig = saved
    return seen  # [256,4,4], [100,9,9], [100,3,3], [1,9,9], [1,3,3]


def eig_errors(A, w, V, w_ref, V_ref, posed_gap):
    """(eigenvalue error, residual |A v - w v| and |VᵀV - I|, both relative
    to the largest |eigenvalue|; the smallest eigenvector's largest error
    after matching its sign, over the well-posed matrices; their share)."""
    import torch

    n = A.shape[-1]
    A, w, V = A.reshape(-1, n, n), w.reshape(-1, n), V.reshape(-1, n, n)
    w_ref, V_ref = w_ref.reshape(-1, n), V_ref.reshape(-1, n, n)
    scale = w_ref.abs().amax(-1).clamp(min=1e-30)
    ew = float(((w - w_ref).abs().amax(-1) / scale).max())
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    res = (A @ V - V * w[:, None, :]).abs().amax((-1, -2)) / scale
    orth = (V.transpose(-1, -2) @ V - eye).abs().amax((-1, -2))
    er = float(torch.maximum(res, orth).max())
    v, vr = V[..., :, 0], V_ref[..., :, 0]
    v = v * torch.sign((v * vr).sum(-1, keepdim=True))
    posed = (w_ref[:, 1] - w_ref[:, 0]) >= posed_gap * scale
    ev = float((v - vr).abs().amax(-1)[posed].max()) if bool(posed.any()) else 0.0
    return ew, er, ev, float(posed.float().mean())


def eig_bound_ms(inputs):
    """The least time for these decompositions on an H100: each input read
    once and each output (eigenvalues, eigenvectors) written once at 3.35
    TB/s, against 9 n^3 operations a matrix (the classic count of a
    symmetric eigendecomposition with vectors) at the float32 rate."""
    nbytes = sum(A.numel() * A.element_size() * 2 + A.shape[0] * A.shape[-1] * A.element_size()
                 for A in inputs)
    ops = sum(9 * A.shape[0] * A.shape[-1] ** 3 for A in inputs)
    t_b, t_o = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * ops / PEAK_F32_FLOPS
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, ops


def phase_sym_eig(dev):
    """The eigensolver kernel against its plain version (torch.linalg.eigh)
    on the main path's inputs, in f32 and f64, and its times."""
    import torch
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    inputs = main_path_eig_inputs(dev)
    shapes = [tuple(A.shape) for A in inputs]
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        ew_b, er_b, ev_b, gap = EIG_BOUNDS[str(dtype).split(".")[-1]]
        for A in inputs:
            A = A.to(dtype)
            w, V = sym_eig(A)
            w_ref, V_ref = torch.linalg.eigh(A)
            torch.cuda.synchronize()
            ew, er, ev, share = eig_errors(A, w, V, w_ref, V_ref, gap)
            log(f"[14] sym_eig {dtype} {tuple(A.shape)} against torch.linalg.eigh: eigenvalues "
                f"within {ew:.2e} of the largest (bound {ew_b}); residuals |Av - wv|, |VᵀV - I| "
                f"{er:.2e} (bound {er_b}); smallest eigenvector within {ev:.2e} (bound {ev_b}) "
                f"on the {100 * share:.0f}% well posed at {gap}")
            if not (ew <= ew_b and er <= er_b and ev <= ev_b):
                raise AssertionError(f"sym_eig disagrees with torch.linalg.eigh at {A.shape}")
            if dtype == torch.float32:
                worst = max(worst, ew, ev)
    bad = torch.zeros((2, 10, 10), device=dev)
    try:
        sym_eig(bad)
        raise AssertionError("sym_eig took a 10 x 10 matrix")
    except ValueError:
        pass
    # A published frame's launches (RANSAC's four, the solve's triangulation)
    # behind a full queue, and the library's eigh on the same five inputs,
    # its wait for the card included.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    block = lambda: [flush.zero_() for _ in range(12)]

    def frame():
        for A in inputs:
            sym_eig(A)

    def library():
        for A in inputs:
            torch.linalg.eigh(A)
        torch.cuda.synchronize()

    per_shape = [cuda_ms(lambda A=A: sym_eig(A), reps=10, blocker=block) for A in inputs]
    ms = cuda_ms(frame, reps=10, blocker=block)
    alone = cuda_ms(frame)
    lib = []
    for _ in range(10):
        t0 = time.perf_counter()
        library()
        lib.append(1e3 * (time.perf_counter() - t0))
    lib_ms = float(np.median(lib))
    bound, by, nbytes, ops = eig_bound_ms(inputs)
    log(f"[14] sym_eig per published frame ({', '.join(map(str, shapes))}; f32): "
        f"{ms:.4f} ms on the card behind a full queue (per shape "
        + ", ".join(f"{t:.4f}" for t in per_shape)
        + f"), {alone:.4f} ms launched alone, host cost included; torch.linalg.eigh on the same "
        f"inputs {lib_ms:.4f} ms with its wait (median of 10 host-timed); bound {bound:.6f} ms "
        f"by {by} ({nbytes} B, {ops / 1e6:.3f} MFLOP)")
    return dict(max_abs_err=worst, ms=ms, ms_launched_alone=alone, plain_ms=lib_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)


def info_err(a, b):
    """Largest difference of two priors' JᵀJ, Jᵀr (and r0ᵀr0) relative to
    the scale of b's."""
    Ha, Hb = a.J.T @ a.J, b.J.T @ b.J
    ba, bb = a.J.T @ a.r0, b.J.T @ b.r0
    return max(float((Ha - Hb).abs().max() / Hb.abs().max().clamp(min=1)),
               float((ba - bb).abs().max() / bb.abs().max().clamp(min=1)),
               float((a.r0 @ a.r0 - b.r0 @ b.r0).abs() / (b.r0 @ b.r0).clamp(min=1)))


def state_err(a, b, fields=("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")):
    return max(float((getattr(a, f) - getattr(b, f)).abs().max()
                     / getattr(b, f).abs().max().clamp(min=1)) for f in fields)


def phase_graphs_f64(dev):
    """Each program's graph replay against the same function run eagerly on
    the same inputs, f64, on an estimator a bearing stream initialized (64
    slots): the solve, the relocalization solve, both marginalizations."""
    import torch
    from lfvio_tpu_torch.device import clone_tree
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, VioPipeline
    from lfvio_tpu_torch.runtime.synthetic import SyntheticWorld, make_synthetic_pal_camera

    world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=torch.float64),
                           dtype=torch.float64, device=dev)
    pts = make_landmarks()
    est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=torch.float64, device=dev))
    run_bearing_stream(VioPipeline(BearingFrontEnd(world, pts), est), world, 1.5)
    if est.solver_flag != est.NON_LINEAR:
        raise AssertionError("the f64 stream did not initialize")
    cap = est.cfg.max_iterations
    prior = est.prior if est.prior is not None else est._empty_prior()
    chain = est._zero_chain()
    packed = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0]))
    g_res, g_grid = clone_tree(est._program(("solve", cap))(packed, prior, chain))
    e_res, e_grid = est._solve_packed_impl(packed, prior, chain, max_iter=cap)
    errs = {"solve": state_err(g_res["out"], e_res["out"])}
    args = (e_res["out"], e_grid, e_res["pre"], e_res["sqrt_info"], e_res["imu_ok"], prior)
    errs["marg_old"] = info_err(clone_tree(est._program(("marg_old",))(*args)),
                                est._marg_old_impl(*args))
    errs["marg_new"] = info_err(clone_tree(est._program(("marg_new",))(e_res["out"], prior)),
                                est._marg_new_impl(e_res["out"], prior))
    t_loop = float(est.headers[est.WIN - 2])
    b = cam_bearings(world, t_loop, pts, np.eye(3), np.zeros(3))
    p_true, q_true = world.pose(t_loop)
    if not est.set_relo_frame(t_loop, np.arange(len(pts)), b, p_true, q_true):
        raise AssertionError("set_relo_frame refused the match")
    packed_r = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0], relo=est._relo_active))
    g_res, _ = clone_tree(est._program(("relo", cap))(packed_r, prior))
    e_res, _ = est._solve_relo_packed_impl(packed_r, prior, max_iter=cap)
    errs["relo"] = max(state_err(g_res["out"], e_res["out"]),
                       float((g_res["relo_p"] - e_res["relo_p"]).abs().max()),
                       float((g_res["relo_q"] - e_res["relo_q"]).abs().max()))
    torch.cuda.synchronize()
    n, cap_s = est.graph_stats()
    log(f"[14] f64 graph replay against eager on the same inputs (64 slots, cap {cap}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" of the scale (bound {GRAPH_F64}); {n} graphs captured in {cap_s:.2f} s")
    if not all(v <= GRAPH_F64 for v in errs.values()):
        raise AssertionError("a graph replay disagrees with the eager program")
    return errs


# ROADMAP queue 3 item 1: the QR marginalization drops information when an
# all-zero depth column's pivot row belongs to a frame-0 feature. A
# MARGIN_OLD "hits" it when its QR prior's JᵀJ / Jᵀr differ from the eigh
# prior's (marginalize_old, the reference's own H-space elimination) by more
# than tests/test_marg_qr.py's bound between the two, relative to the scale;
# both are computed in f64 from the program's inputs. A measurement only:
# the estimator keeps the QR prior, as the JAX package does.
QR_EIGH_BOUND = 2e-6


def record_marg_information(est, rec):
    """Wrap ``est``'s MARGIN_OLD program so that each call also computes the
    QR and the eigh prior of its inputs in f64 and appends their relative
    information difference to ``rec``."""
    import torch
    from lfvio_tpu_torch.backend.marginalize import marginalize_old, marginalize_old_qr

    def f64(x):
        if x is None:
            return x
        if isinstance(x, torch.Tensor):
            return x.double() if x.is_floating_point() else x
        if isinstance(x, tuple):
            return tuple(f64(y) for y in x)
        return type(x)(**{k: f64(v) for k, v in vars(x).items()})

    make = est._program

    def program(key):
        prog = make(key)
        if key[0] != "marg_old":
            return prog

        def run(*args):
            out = prog(*args)
            a = f64(args) + (est._gravity_t.double(), est.scfg)
            rec.append(info_err(marginalize_old_qr(*a), marginalize_old(*a)))
            return out

        return run

    est._program = program


def log_marg_information(tag, name, rec):
    hits = sum(e > QR_EIGH_BOUND for e in rec)
    log(f"{tag} QR against eigh marginalization, {name}: {len(rec)} MARGIN_OLD, information "
        f"differs by at most {max(rec, default=0.0):.2e} of the scale, {hits} above "
        f"{QR_EIGH_BOUND} (the fault)")
    return dict(n=len(rec), max=max(rec, default=0.0), hits=hits)


def phase_qr_information(dev):
    """The parity streams of tests/test_torch_estimator.py and
    tests/test_torch_lag.py (the bearing harness, 64 slots, f64, 1.5 s) on
    the card, each MARGIN_OLD's QR information against the eigh one."""
    import torch
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, VioPipeline
    from lfvio_tpu_torch.runtime.synthetic import SyntheticWorld, make_synthetic_pal_camera

    pts = make_landmarks()
    out = {}
    for name, cfg, fe_kw, world_kw in (
            ("lag1", dict(solve_lag=1), {}, {}),
            ("lag2_chain", dict(solve_lag=2, device_chain=True), {}, {}),
            ("lag3", dict(solve_lag=3), {}, {}),
            ("td", dict(solve_lag=1, estimate_td=True), dict(td_true=0.005),
             dict(traj_freq=0.8))):
        world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=torch.float64),
                               dtype=torch.float64, device=dev, **world_kw)
        est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=torch.float64,
                                        device=dev, **cfg))
        rec = []
        record_marg_information(est, rec)
        run_bearing_stream(VioPipeline(BearingFrontEnd(world, pts, **fe_kw), est), world, 1.5)
        out[name] = log_marg_information("[14]", f"parity stream {name}", rec)
    return out


def phase_programs(dev, rig, plain_calls, run4):
    """The eigensolver kernel, f64 graph replays against eager, phase 4's
    stream with eager programs, and the card's time per replay."""
    import torch

    t0 = time.perf_counter()
    eig = phase_sym_eig(dev)
    phase_graphs_f64(dev)
    est = run4["est"]
    prior = est.prior
    chain = est._zero_chain()
    packed = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0]))
    cap = est.cfg.max_iterations
    solve = est._program(("solve", cap))
    res, grid = solve(packed, prior, chain)
    marg_args = (res["out"], grid, res["pre"], res["sqrt_info"], res["imu_ok"], prior)
    times = {
        f"solve (cap {cap})": cuda_ms(lambda: solve(packed, prior, chain), n=5, warmup=1),
        "marg_old": cuda_ms(lambda: est._program(("marg_old",))(*marg_args), n=5, warmup=1),
        "marg_new": cuda_ms(lambda: est._program(("marg_new",))(res["out"], prior), n=5,
                            warmup=1),
        f"solve (cap {cap}), eager": cuda_ms(
            lambda: est._solve_packed_impl(packed, prior, chain, max_iter=cap), n=3, warmup=1),
    }
    n, cap_s = est.graph_stats()
    log(f"[14] phase 4's estimator (f32, 256 slots), ms per call between CUDA events (a replay "
        f"includes copying its inputs in): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; {n} graphs captured in {cap_s:.2f} s in all ("
        + ", ".join(f"{k} {p.capture_s:.2f} s" for k, p in est._programs.items()
                    if hasattr(p, "capture_s")) + ")")
    qr = phase_qr_information(dev)
    rec4, rec6 = [], []
    eager = run_full_scale("[14]", rig, plain_calls, 1, 1, graphs=False,
                           marg_record=rec4)
    qr["phase 4"] = log_marg_information("[14]", "phase 4's stream", rec4)
    run_full_scale("[14]", rig, plain_calls, 2, 3, marg_record=rec6)
    qr["phase 6"] = log_marg_information("[14]", "phase 6's stream", rec6)
    d_ate = abs(eager["ate"] - run4["ate"])
    log(f"[14] phase 4's stream with the programs eager: {eager['fps']:.3f} frames/s beside "
        f"{run4['fps']:.3f} as graphs; ATE {eager['ate']:.6f} m beside {run4['ate']:.6f} m "
        f"(difference {d_ate:.2e}, bound {GRAPH_ATE_M}); phase 14 took "
        f"{time.perf_counter() - t0:.1f} s")
    if d_ate > GRAPH_ATE_M or abs(float(eager["est"].times[0])
                                  - float(run4["est"].times[0])) > 1e-9:
        raise AssertionError("the graph path's ATE is not within 1 mm of the eager path's")
    return eig, times, qr



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
    libs = klt_cuda.build(verbose=True)
    log(f"[2] built {', '.join(p.name for p in libs.values())} from "
        f"{', '.join(sorted(set(SOURCES.values())))} (one nvcc per source, in parallel) in "
        f"{time.perf_counter() - t0:.2f} s")

    t_run = time.perf_counter()
    kernels = phase_kernel_vs_plain(dev)
    plain_calls = count_plain_lk()
    rig = full_scale_rig(dev)
    run4 = phase_full_scale(rig, plain_calls, profile)
    phase_e2e_gate(dev)
    run6 = phase_bench_configuration(rig, plain_calls, run4)
    phase_capabilities(dev)
    dual = phase_dual_pal(dev, plain_calls)
    euroc = phase_euroc(rig, plain_calls)
    phase_tools(rig, dev)
    phase_profiling(dev)
    phase_dist()
    phase_kf_axis()
    kernels["sym_eig"], _, _ = phase_programs(dev, rig, plain_calls, run4)
    del rig
    paths = (run4, run6, dual, euroc)
    launches = {"lk_pyramid": sum(r["launches"] for r in paths),
                "lk_level": run4["level_launches"],
                "sym_eig": sum(r["sym_launches"] for r in paths)}
    log(f"[end] launches on the main paths (phases 4, 6, 8, 9): lk_pyramid "
        + ", ".join(str(r["launches"]) for r in paths) + "; sym_eig "
        + ", ".join(str(r["sym_launches"]) for r in paths)
        + f"; whole run {time.perf_counter() - t_run + 0.0:.1f} s after the build")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], **kernels[name]}
        for name in ("lk_pyramid", "lk_level", "sym_eig")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
