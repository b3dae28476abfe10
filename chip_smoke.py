#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lfvio_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

``--profile`` adds CUDA-synchronized stage timers (FrontEnd per published
and unpublished frame, run op by op, its LK stage alone, Estimator solve) and a
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
     512x384, the high-rate configuration's 384 features at 1280x960
     (interior, then with border points), a shift that loses tracks, a bit-identical repeat, and
     CUDA-event times in turns with the roofline bound of this run's work;
     then the kernel's Pallas-geometry mode (klt.pyramidal_lk_pallas, the
     function of the JAX package's Pallas kernel, which FrontEnd(use_pallas=
     True) runs) against its plain version at 1280x960 / N = 256 and
     512x384 / N = 128 with border points and at level 0 alone with shifts
     of 9.3 and 14.6 px (the latter carries windows out of the band of the
     search window the mode stages, so that it stages the band again), a
     bit-identical repeat, a histogram of the band's restages, and its
     times, latency floor and bound;
  4. the main path at full width, synchronous (solve lag 1, depth 1):
     VioPipeline(FrontEnd, Estimator) fed the bench.py configuration
     (1280x960, CLAHE, 256 slots, max_cnt 200, 15 Hz frames, 200 Hz IMU,
     window 10, publish 10 Hz) over a 6 s synthetic stream, on the card,
     every piece built by lfvio_tpu_torch.bench.workload;
     frames/s over the post-warm-up 40%; the estimator's solve and
     marginalization as CUDA graph replays; exactly one fused LK launch per
     tracked frame and the eigensolver kernel (csrc/sym_eig.cu) launched in
     RANSAC and triangulation; every FrontEnd.dispatch and
     Estimator._dispatch_solve after the warm-up under
     torch.cuda.set_sync_debug_mode("error") (none may wait for the card),
     with the host's ms per call, and no solve finalized inside
     Estimator.process_image_arrays (the pipeline defers it); then a few
     frames of the same FrontEnd, run op by op,
     with the level loop on the host over the one-level wrapper (five
     launches per frame). Every tracked frame of phases 4, 6, 6p, 8, 9 and
     15 after the first of its kind is one replay of the FrontEnd's
     published or unpublished CUDA graph (counted at dispatch; each program
     logged with its warm-up and capture seconds). Then (4e) phase 4's run
     with the FrontEnd op by op (use_graphs off), its dispatch host ms
     beside the graphs', ATE within 1 mm of phase 4's, and (4g) the graphs
     against the eager step at full width, frame by frame in turns over 16
     frames with a reset before frame 8: 1280x960 at 256 slots (15 Hz
     published at 10 Hz) in both LK geometries and at 384 slots in the
     high-rate configuration (30 Hz published at 10 Hz): status, new_src,
     positions, bearings and the finalized frames bit-identical, launches
     equal, the graphs' kernel nodes, and each dispatch host ms under the
     sync check;
  5. the accuracy gate of tests/test_e2e.py::test_e2e_vio_ate on the card
     (512x384, f32 tracker, f64 solver, 7 s): ATE < 0.25 m;
  6. bench.py's configuration as bench.py runs it: the stream of phase 4 at
     solve lag 2 with the device state chain and depth 3, under the sync
     check of phase 4; one fused LK launch per tracked frame, as many poses
     as solves, ATE < 0.5 m; frames/s beside phase 4's; then phase 4's
     configuration and stream with FrontEnd(use_pallas=True) (6p): one
     launch of the Pallas-geometry mode per tracked frame, ATE < 0.1 m,
     frames/s beside phase 4's; then relocalization at full width (6r):
     phase 6's configuration and stream with one loop closure armed
     through Estimator.set_relo_frame once 5 solves are finalized (window
     frame WIN - 2 seen again, the pose graph carrying it with a drift of
     yaw 12 deg and (0.4, -0.3, 0.1) m): |relo_relative_t| < 0.25 m,
     |relo_relative_yaw| < 5 deg, the drift correction's yaw within 5 deg
     of the planted one (plus the VIO world's yaw against the truth), the
     match consumed, ATE < 0.5 m, both relo kernels launched; the relo
     graph captured at the first solve (its warm-up, capture and
     max_memory_allocated before and after), the first relo solve within
     50 ms of wall time, the relo and solve replays' card ms and nodes (at
     most 4,596 kernel nodes in the relo graph and its conditional bodies,
     its LM iterations conditional nodes), and a relo_normal launch a
     linearization and a relo_cost launch a cost a relo replay runs; phases
     4, 6, 6p and 6r print the LM iterations and linearizations each solve
     ran;
  7. the estimator's capabilities on the card, bearing-level (a stub front
     end serves analytic bearings; 64 slots, f64 solver): td recovery,
     online extrinsic rotation, relocalization, window 20, solve lag 3, the
     solver's wall budget (the bounds of tests/test_capabilities.py; no
     graph captured after the first solve though the cap falls to 1), and
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
 14. the estimator's device programs: graph against eager in f64 (the
     solve at the packed caps 8, 1 and 3 and at an early plateau, each
     running the same LM iterations both ways); the census of the captured
     graphs (nodes of the solve, MARGIN_OLD and SECOND_NEW graphs, and of
     the f64 estimator's four, relocalization included, conditional bodies
     apart; the card's ms per replay at bench.py's window 10 / 256 slots
     (a) and window 20 / 384 slots (b), the solve's also with every LM
     iteration forced and at the packed caps 1 and 3; one eager solve's
     device time split by solver function; a normal-equation launch a
     linearization and a cost launch a cost of the projection kernels and
     of the IMU kernels and no rows launch a solve replay, one rows launch
     of each a MARGIN_OLD; the launches and card time of csrc/graph_cond.cu's
     set_condition_kernel in one solve replay, and in 6r's relo replay);
     the projection kernels (csrc/proj_factor.cu: rows, normal equations,
     cost) against their plain versions at (a)'s and (b)'s solve inputs
     (f32) and on a dual-camera window (f64), a bit-identical repeat, each
     kernel's times behind a full queue and launched alone beside its plain
     version's and its bound ([14p] lines); the same for the IMU kernels
     (csrc/imu_factor.cu: rows, normal equations, cost) at (a)'s and (b)'s
     solve inputs, each also with its biases moved after the
     preintegration, and on a two-camera f64 window whose biases lie off the
     preintegration's linearization point, each cost output also against
     Σ r_w² of the rows, and planted faults (a zero cost, a dropped
     interval, r_q's sign flipped) that the check must reject, and each
     IMU launch's latency floor (an empty kernel with its grid, block and
     launch path) beside its times ([14i] lines); the relocalization
     launches (csrc/proj_factor.cu: relo_normal, relo_cost) against their
     plain versions at phase 6r's inputs (f32) and on a two-camera window
     (f64 and f32), a bit-identical repeat, planted faults (a zero cost, a
     dropped match, the loop side's extrinsic block in the anchor camera's
     columns) rejected, and each launch's times, latency floor, plain
     version's time and bound at phase 6r's inputs and on the two-camera
     f32 window ([14r] lines); the
     eigensolver kernel against
     torch.linalg.eigh on the main path's inputs at 256 and 384 slots (the
     [256, 4, 4] and [384, 4, 4] DLT matrices of a triangulation, RANSAC's
     [100, 9, 9] / [1, 9, 9] and [100, 3, 3] / [1, 3, 3] over 256 and 384
     slots), with CUDA-event times beside the shared-
     memory kernel's, the
     bound and a histogram of the Jacobi sweeps each matrix took; each
     program's graph replay against the same function run eagerly on the
     same inputs in f64 (solve, relocalization solve, both
     marginalizations: within 1e-9 of the scale); phase 4's stream once
     more with the programs run eagerly (the f32 ATE within 1 mm of the
     graph run's); the card's ms per replay, the graphs captured and their
     capture seconds; each MARGIN_OLD's and SECOND_NEW's QR prior against
     the eigh one in f64 on the parity streams and phases 4 and 6 (JᵀJ and
     Jᵀr within 2e-6 of the scale, or the run fails);
 15. the bench, ``python -m lfvio_tpu_torch.bench`` in a process of its own
     from the repository root, in bench.py's default configuration (a) and
     its high-rate one (b: 30 Hz, max_cnt 300, window 20, 384 slots;
     bench.py:71-72): each exits 0 with one JSON line on stdout (the metric's
     name, a finite positive frames/s), one fused LK launch per tracked frame
     and eigensolver launches in its timed window, ATE < 0.5 m, its figures
     logged; (a) initializes during its warm-up; (b) is run once more over
     12 s if it did not initialize within its 6 s, and must then initialize.

The kernels line's launches add up the whole runs of phases 4, 6, 8, 9 and
15, each counted from 0 (the factor kernels' too; in each run every IMU
kernel launches as often as its projection counterpart); the relocalization
kernels' are phase 6r's run, counted from 0.

Prints one JSON line with each kernel's numbers, then the card's line, and
last {"ok": true, "device": {...}}. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import collections
import datetime
import gc
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

from lfvio_tpu_torch import bench

REPO = os.path.dirname(os.path.abspath(__file__))
REPLACES = {"lk_pyramid": "lfvio_tpu/frontend/klt_pallas.py:86 (_lk_level_kernel)",
            "lk_level": "lfvio_tpu/frontend/klt_pallas.py:86 (_lk_level_kernel)",
            "lk_pyramid_pallas": "lfvio_tpu/frontend/klt_pallas.py:86 (_lk_level_kernel; its "
                                 "level loop pyramidal_lk_pallas :234)",
            "sym_eig": "lfvio_tpu/frontend/ransac.py:36 (jnp.linalg.eigh; also :40 svd, "
                       "backend/triangulate.py:69 eigh; XLA, no Pallas kernel)"}
SOURCES = {"lk_pyramid": "lfvio_tpu_torch/csrc/lk_pyramid.cu",
           "lk_level": "lfvio_tpu_torch/csrc/lk_pyramid.cu",
           "lk_pyramid_pallas": "lfvio_tpu_torch/csrc/lk_pyramid.cu",
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


smi_line = bench.smi_line


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


# A spin of the card (about 10 ms at the H100's clock) after the blocker's
# writes: longer than a slow host takes to enqueue a sample's calls (50 calls
# of the eigensolver's wrapper took more than the writes alone on one host).
SPIN_CYCLES = 20_000_000


def make_blocker(dev):
    """The ``blocker`` of ``cuda_times``: 256 MB of writes, 12 times (which
    also empties the 50 MB L2), then SPIN_CYCLES of the card."""
    import torch

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def block():
        for _ in range(12):
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)

    return block


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


def lk_bound_ms(level_shapes, N, iters, passes, pallas=False):
    """The least time the card could take for the pyramidal LK of this run:
    the larger of bytes / memory rate and operations / float32 rate.

    Bytes: every input once and every output once. Of each level image the
    function must read the smaller of the whole image and the patches cut
    from it for the features that ran there: (win+4)^2 floats from the
    previous pyramid's level, (win+13)^2 from the next one's; with
    ``pallas`` (the Pallas geometry) the same (win+4)^2 for the template,
    whose bilinear taps are all the function reads there, and SROWS x LANES
    (64 x 256) for the search window its offsets can reach. The refine
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
    from lfvio_tpu_torch.frontend import klt

    for k, (lvl, win, _, _) in enumerate(passes):
        n_ran = int(ran[:, k].sum())
        t_win, s_win = (win + 4) ** 2, (klt.SROWS * klt.LANES if pallas else (win + 13) ** 2)
        template[lvl] = max(template[lvl], 4.0 * n_ran * t_win)
        search[lvl] = max(search[lvl], 4.0 * n_ran * s_win)
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

    # The high-rate configuration's shape (bench.py:71-72): 384 slots, 384
    # blocks. Interior points, then border and corner points among them.
    for n_border in (0, 64):
        hcase = lk_case(dev, H, W, 384, shift, n_border=n_border, seed=3)
        errs.append(compare_lk(f"high-rate shape 1280x960, N=384, {n_border} at the borders",
                               fused(hcase), plain(hcase), 380, n_border > 0))

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
    level_errs = []
    for win, n_it in ((klt.WIN, klt.N_ITERS), (15, klt.REFINE_ITERS)):
        level_errs.append(compare_lk(
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
    # 10 calls enqueued behind a blocker (make_blocker: writes that empty the
    # 50 MB L2, then a spin), the card's own time; "L2 cold" is one call right
    # behind the blocker.
    block = make_blocker(dev)
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
    return {"lk_pyramid": dict(max_abs_err=max(errs), ms=fused_ms, ms_l2_cold=fused_cold,
                               ms_launched_alone=fused_alone, ms_zero_iterations=fused_setup,
                               **common),
            "lk_level": dict(max_abs_err=max(lerr, *level_errs), ms=levels_ms,
                             ms_launched_alone=levels_alone, **common)}


# The Pallas mode's times before it staged a band (each iteration read its
# taps from the level images through L1), on an NVIDIA H100 80GB HBM3 at
# 700 W with this phase's inputs: ms a frame behind a full queue, ms with 0
# iterations, us an iteration over the longest chain.
PALLAS_L1_DESIGN = dict(ms=0.0376, ms_zero_iterations=0.0178, us_per_iteration=1.161)


def restage_histogram(restages):
    """{restages: feature-passes} over the passes that ran."""
    r = restages[restages >= 0].cpu().numpy()
    return {int(v): int((r == v).sum()) for v in np.unique(r)}


def phase_pallas_mode(dev):
    """The kernel's Pallas-geometry mode against its plain version on the
    same inputs, at the shapes FrontEnd(use_pallas=True) gives it, with
    times in turns (plain, kernel, kernel, plain), its latency floor and
    its bound."""
    import torch
    from lfvio_tpu_torch.frontend import klt, klt_cuda

    kernel = lambda case: klt_cuda.pyramidal_lk_pallas(*case, 3)
    plain = lambda case: klt.pyramidal_lk_pallas(*case, 3)
    errs = []
    H, W, N = 960, 1280, 256
    shift = (3.3, -2.6)
    case = lk_case(dev, H, W, N, shift)
    kp, kok, iters, restages = klt_cuda.pyramidal_lk_pallas(*case, 3, return_iters=True,
                                                            return_restages=True)
    torch.cuda.synchronize()
    errs.append(compare_lk("Pallas mode 1280x960", (kp, kok), plain(case), N - 4, True))
    truth = case[2] + torch.tensor(shift, device=dev)
    med_true = torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item()
    log(f"[3] Pallas mode 1280x960: median |kernel - truth| {med_true:.3f} px (< 0.35); band "
        f"restages per feature and level {restage_histogram(restages)}")
    if med_true >= 0.35 or int(kok.sum()) < N - 16:
        raise AssertionError("the Pallas mode does not recover the shift")
    again = kernel(case)
    if not (torch.equal(kp, again[0]) and torch.equal(kok, again[1])):
        raise AssertionError("the Pallas mode does not repeat bit for bit")
    log("[3] Pallas mode repeat: bit-identical")
    for h, w, n, n_border in ((960, 1280, N, 64), (384, 512, 128, 0), (384, 512, 128, 32)):
        bcase = lk_case(dev, h, w, n, shift, n_border=n_border, seed=2)
        errs.append(compare_lk(f"Pallas mode {w}x{h}, N={n}, {n_border} at the borders",
                               kernel(bcase), plain(bcase), n - 4, True))
    # A shift that klt.py's [0, 12] offsets lose at level 0 and the Pallas
    # geometry's [0, 22] x [0, 214] keep.
    fcase = lk_case(dev, H, W, N, (9.3, 3.4))
    fout = klt_cuda.pyramidal_lk_pallas(*fcase, 0)
    errs.append(compare_lk("Pallas mode, 9.3 px at level 0 alone", fout,
                           klt.pyramidal_lk_pallas(*fcase, 0), N - 4, True))
    if int(fout[1].sum()) < N - 16:
        raise AssertionError("the Pallas mode loses the far shift at level 0")
    # A shift that carries windows out of the band the kernel stages around
    # a pass's first offset, so that it stages the band again. LK past ~9 px
    # finds wrong minima on this texture: recovery is not asserted.
    wcase = lk_case(dev, H, W, N, (14.6, 2.2))
    wp, wok, wrest = klt_cuda.pyramidal_lk_pallas(*wcase, 0, return_restages=True)
    errs.append(compare_lk("Pallas mode, 14.6 px at level 0 alone (wander)", (wp, wok),
                           klt.pyramidal_lk_pallas(*wcase, 0), N - 4, True))
    wagain = klt_cuda.pyramidal_lk_pallas(*wcase, 0, return_restages=True)
    if not all(torch.equal(a, b) for a, b in zip((wp, wok, wrest), wagain)):
        raise AssertionError("the Pallas mode does not repeat bit for bit in the wander case")
    log(f"[3] Pallas mode wander: repeat bit-identical; band restages per feature "
        f"{restage_histogram(wrest)}")
    if not bool((wrest > 0).any()):
        raise AssertionError("the wander case never restages the Pallas mode's band")

    block = make_blocker(dev)
    plain_a = cuda_ms(lambda: plain(case))
    k_t = (cuda_times(lambda: kernel(case), reps=10, blocker=block)
           + cuda_times(lambda: kernel(case), reps=10, blocker=block))
    k_alone = cuda_ms(lambda: kernel(case))
    k_cold = cuda_ms(lambda: kernel(case), blocker=block)
    plain_b = cuda_ms(lambda: plain(case))
    k_ms, plain_ms = float(np.median(k_t)), 0.5 * (plain_a + plain_b)
    none_valid = torch.zeros_like(case[3])
    k_exit = cuda_ms(lambda: klt_cuda.pyramidal_lk_pallas(*case[:3], none_valid, 3), reps=10,
                     blocker=block)
    limit, klt.N_ITERS = klt.N_ITERS, 0  # the wrapper reads it at each call
    try:
        k_setup = cuda_ms(lambda: kernel(case), reps=10, blocker=block)
    finally:
        klt.N_ITERS = limit
    shapes = [tuple(l.shape) for l in case[0]]
    passes = klt_cuda._pass_table(shapes, 3, klt.WIN, klt.N_ITERS, 0, 0)
    it = iters.cpu().numpy()
    bound, by, nbytes, ops = lk_bound_ms(shapes, N, it, passes, pallas=True)
    per_feature = it.clip(min=0).sum(1)[case[3].cpu().numpy()]
    log(f"[3] Pallas mode, iterations per valid feature over the 4 levels: mean "
        f"{per_feature.mean():.2f}, max {int(per_feature.max())} of {sum(p[2] for p in passes)}")
    old = PALLAS_L1_DESIGN
    log(f"[3] Pallas mode per frame (4 levels, N={N}, {W}x{H}), on the card: {k_ms:.4f} ms (min "
        f"{min(k_t):.4f}; L2 cold {k_cold:.4f}); launched alone, host cost included: "
        f"{k_alone:.4f} ms; plain {plain_a:.3f} / {plain_b:.3f} ms (medians of 20 "
        f"CUDA-event-timed samples, in turns: plain, kernel, kernel, plain); before the band "
        f"(taps through L1, H100 80GB HBM3, 700 W): {old['ms']:.4f} ms")
    log(f"[3] Pallas mode bound {bound:.5f} ms by {by}: {nbytes / 1e6:.3f} MB, "
        f"{ops / 1e9:.4f} GFLOP; the launch is at {100 * bound / k_ms:.1f}% of it")
    chain = int(per_feature.max())
    per_it = (k_ms - k_setup) / chain
    log(f"[3] Pallas mode latency floor: with no valid feature the launch takes {k_exit:.4f} ms "
        f"(launch and exit), with 0 iterations {k_setup:.4f} ms (launch, staging, template "
        f"work); the rest over the longest chain of {chain} iterations is "
        f"{1e3 * per_it:.3f} us per iteration, so the iterations alone set a floor of "
        f"{chain * per_it:.4f} ms; before the band {old['ms_zero_iterations']:.4f} ms with 0 "
        f"iterations and {old['us_per_iteration']:.3f} us per iteration")
    return dict(max_abs_err=max(errs), ms=k_ms, ms_l2_cold=k_cold, ms_launched_alone=k_alone,
                ms_zero_iterations=k_setup, ms_no_valid_feature=k_exit, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def count_plain_lk():
    """Wrap the plain LK entry points with call counters."""
    from lfvio_tpu_torch.frontend import klt

    calls = {"n": 0}
    for name in ("track_level", "pyramidal_lk", "pyramidal_lk_pallas"):
        fn = getattr(klt, name)

        def counted(*a, _fn=fn, **k):
            calls["n"] += 1
            return _fn(*a, **k)

        setattr(klt, name, counted)
    return calls


def count_tracked(fe):
    """Count the tracked frames (every frame after a stream's first) a
    FrontEnd dispatches, by kind: {"n": all, True: published, False:
    unpublished}. Counted at ``dispatch``: under the graphs ``_step_impl``
    runs only at a program's warm-up and capture."""
    calls = {"n": 0, True: 0, False: 0}
    dispatch = fe.dispatch

    def counted(img, t, publish=True):
        if fe._dev_pos is not None:
            calls["n"] += 1
            calls[bool(publish)] += 1
        return dispatch(img, t, publish=publish)

    fe.dispatch = counted
    return calls


def check_frontend_programs(tag, fe, tracked):
    """Log a FrontEnd's step programs (warm-up, capture, replays) and raise
    unless, with its graphs on, each kind of tracked frame captured its
    graph once and replayed it at every later frame of its kind, or, with
    them off, no program was made. Returns {kind: (warm-up s, capture s,
    replays)}."""
    progs = {("published" if k else "unpublished"): p for k, p in fe._programs.items()}
    log(f"{tag} front-end programs ({'CUDA graphs' if fe.use_graphs else 'eager'}): "
        + (", ".join(f"{k} warm-up {p.warmup_s:.3f} s, capture {p.capture_s:.3f} s, replays "
                     f"{p.replays}" for k, p in progs.items()) or "none")
        + f"; tracked frames {tracked[True]} published + {tracked[False]} unpublished")
    want = {k for k in (True, False) if tracked[k]} if fe.use_graphs else set()
    if set(fe._programs) != want or any(
            p.graph is None or p.replays != tracked[k] - 1 for k, p in fe._programs.items()):
        raise AssertionError(f"{tag} not every tracked frame after the first of its kind was a "
                             f"replay of the front end's graph of its kind")
    return {k: (p.warmup_s, p.capture_s, p.replays) for k, p in progs.items()}


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
    torch.profiler. Returns the dict the timers fill (ms per call). The
    FrontEnd must run eagerly (``use_graphs`` off): a graph records its LK
    call once, at the capture, which cannot hold a synchronize."""
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


FULL_SCALE = bench.config_from_env({})  # bench.py's default configuration
FULL_SCALE_SECONDS = FULL_SCALE.duration
# The ATE bound of bench.py's configurations as bench.py runs them (phases 6
# and 15) and of the EuRoC run (phase 9).
FULL_SCALE_ATE_M = 0.5


def full_scale_rig(dev):
    """bench.py's configuration on the card, from bench.workload: the
    synthetic world, its event stream with the frames rendered, and a maker
    of fresh (FrontEnd, Estimator, VioPipeline) triples,
    ``make(solve_lag, depth, **fe_kw)``: (world, stream, frames, make)."""
    return bench.workload(FULL_SCALE, dev)


def trajectory_ate(world, est):
    """(ATE in m, poses) of the estimator's trajectory against the world's."""
    from lfvio_tpu_torch.runtime.evaluation import ate_rmse

    times = np.asarray(est.times)
    gt = np.stack([world.pose(tt)[0] for tt in times])
    return ate_rmse(times, np.asarray(est.traj_p), times, gt)


reset_launches = bench.reset_launches
# Each IMU kernel launches where its projection counterpart does: the solve's
# linearization and cost, MARGIN_OLD's rows.
FACTOR_PAIRS = {"imu_normal": "proj_normal", "imu_cost": "proj_cost", "imu_rows": "proj_rows"}
# The relocalization kernels launch only in a solve with an armed loop
# closure (phase 6r), so the runs without one count them apart.
RELO_KERNELS = ("relo_normal", "relo_cost")


def factor_launches():
    """The factor kernels' (bench.FACTOR_KERNELS) launch counts, the
    graphs' conditional bodies' runs collected first."""
    from lfvio_tpu_torch.device import collect_launches

    collect_launches()
    return {k: w.launches for k, w in bench.FACTOR_KERNELS.items()}


def check_factor_launches(counts, what):
    """Raise unless every factor kernel but the relocalization ones launched
    and each IMU kernel as often as its projection counterpart."""
    if not all(v for k, v in counts.items() if k not in RELO_KERNELS):
        raise AssertionError(f"{what}: not every factor kernel launched: {counts}")
    if any(counts[i] != counts[p] for i, p in FACTOR_PAIRS.items()):
        raise AssertionError(f"{what}: the IMU kernels' launches differ from the projection "
                             f"kernels': {counts}")


def sync_checked(fn, rec, key):
    """``fn`` run under torch.cuda.set_sync_debug_mode(SYNC_CHECK), so that
    any wait for the card inside it raises; appends the host's ms per call
    (no synchronize) to rec[key] (``key`` may be a function of the call's
    arguments). Calls may nest."""
    import torch

    def run(*a, **k):
        key_ = key(*a, **k) if callable(key) else key
        t0 = time.perf_counter()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(SYNC_CHECK)
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            rec.setdefault(key_, []).append(1e3 * (time.perf_counter() - t0))

    return run


def finalizes_inside(est):
    """Count the solves Estimator.finalize_solve completes while
    Estimator.process_image_arrays runs (the pipeline defers them all)."""
    count, inside = {"n": 0}, [False]
    process, finalize = est.process_image_arrays, est.finalize_solve

    def counted_finalize(*a, **k):
        count["n"] += inside[0]
        return finalize(*a, **k)

    def flagged_process(*a, **k):
        inside[0] = True
        try:
            return process(*a, **k)
        finally:
            inside[0] = False

    est.finalize_solve, est.process_image_arrays = counted_finalize, flagged_process
    return count


def dispatch_key(img, t, publish=True):
    """The sync check's key of a FrontEnd.dispatch call."""
    return f"FrontEnd.dispatch, {'published' if publish else 'unpublished'}"


def run_full_scale(tag, rig, plain_calls, solve_lag, depth, profile=False, sync_check=False,
                   graphs=True, marg_record=None, fe_kw=None, fe_graphs=True):
    """The full-scale stream through a fresh pipeline at (solve_lag,
    depth), the FrontEnd built with ``fe_kw``, timed by bench.timed_window:
    warm-up on the first 60%, frames/s over the rest, the launch counts of
    the run (set to 0 just before it), the trajectory checks. With
    ``sync_check`` every FrontEnd.dispatch, Estimator.process_image_arrays
    and Estimator._dispatch_solve after the warm-up runs under the sync
    debug mode "error", timed on the host, and no solve may be finalized
    inside process_image_arrays. ``graphs=False`` runs the estimator's
    programs eagerly, ``fe_graphs=False`` the FrontEnd's step (with
    ``profile`` it always runs eagerly: its LK stage timer synchronizes, which
    a capture cannot hold). ``marg_record`` (a dict) collects each
    marginalization's QR-against-eigh information difference
    (record_marg_information). Returns dict(fe, est, stages, launches,
    sym_launches, fps, ate, host_ms)."""
    from lfvio_tpu_torch.frontend import klt_cuda
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    fe_kw = fe_kw or {}
    fe, est, pipe = rig.make(solve_lag, depth, **fe_kw)
    # The FrontEnd's LK wrapper, and the other two, which it must not use.
    lk, *others = ((klt_cuda.pyramidal_lk_pallas, klt_cuda.lk_pyramid, klt_cuda.lk_level)
                   if fe_kw.get("use_pallas") else
                   (klt_cuda.lk_pyramid, klt_cuda.pyramidal_lk_pallas, klt_cuda.lk_level))
    est.use_graphs = graphs
    fe.use_graphs = fe_graphs and not profile
    if marg_record is not None:
        record_marg_information(est, marg_record)
    stages = add_stage_timers(fe, est) if profile else None

    tracked = count_tracked(fe)
    padded = count_level_pads()
    host_ms, inner = {}, {}

    def install_sync_checks():
        fe.dispatch = sync_checked(fe.dispatch, host_ms, dispatch_key)
        est._dispatch_solve = sync_checked(est._dispatch_solve, host_ms,
                                           "Estimator._dispatch_solve")
        inner["count"] = finalizes_inside(est)
        est.process_image_arrays = sync_checked(est.process_image_arrays, host_ms,
                                                "Estimator.process_image_arrays")

    reset_launches()
    plain_calls["n"] = 0
    win = bench.timed_window(pipe, rig, FULL_SCALE_SECONDS * bench.WARMUP_SHARE,
                             install_sync_checks if sync_check else None)
    if sync_check:  # what runs on these objects later may wait
        del fe.dispatch, est._dispatch_solve, est.process_image_arrays, est.finalize_solve
        log(f"{tag} solves finalized inside Estimator.process_image_arrays after the warm-up: "
            f"{inner['count']['n']}")
        if inner["count"]["n"]:
            raise AssertionError("the pipeline's process_image_arrays finalized a solve")
    launches, sym_launches = lk.launches, sym_eig.launches
    factors = factor_launches()
    n_timed = win.frames_timed
    fps = n_timed / win.seconds
    times = np.asarray(est.times)
    traj = np.asarray(est.traj_p)
    n_graphs, capture_s = est.graph_stats()
    log(f"{tag} solve lag {solve_lag}, depth {depth}, estimator programs "
        f"{'as CUDA graphs' if graphs else 'eager'}, front end "
        f"{'as CUDA graphs' if fe.use_graphs else 'eager'}: warm-up {win.warmup_s:.2f} s; timed "
        f"{n_timed} frames in {win.seconds:.3f} s = "
        f"{fps:.3f} frames/s; solves {len(times)}; tracked frames {tracked['n']}; fused LK "
        f"launches {klt_cuda.lk_pyramid.launches}; Pallas-mode launches "
        f"{klt_cuda.pyramidal_lk_pallas.launches}; one-level launches "
        f"{klt_cuda.lk_level.launches}; plain LK calls "
        f"{plain_calls['n']}; level images padded {padded['n']}; sym_eig launches {sym_launches}; "
        f"factor kernels' launches {factors}; graphs captured {n_graphs} in {capture_s:.2f} s; "
        f"{lm_run_counts(est.lm_runs)}")
    for key, vals in host_ms.items():
        log(f"{tag} {key} after the warm-up, under set_sync_debug_mode({SYNC_CHECK!r}): n "
            f"{len(vals)}, host ms per call min {min(vals):.3f}, median "
            f"{float(np.median(vals)):.3f}, max {max(vals):.3f}")
    if est.solver_flag != est.NON_LINEAR:
        raise AssertionError("full-scale run did not initialize")
    if not (len(traj) and np.isfinite(traj).all()) or est.pending_count():
        raise AssertionError("non-finite or empty trajectory, or a solve left pending")
    if (launches == 0 or launches != tracked["n"] or any(w.launches for w in others)
            or plain_calls["n"] != 0 or padded["n"] != 0):
        raise AssertionError("the main path's LK is not one fused launch per tracked frame")
    if sym_launches == 0:
        raise AssertionError("the main path did not launch the eigensolver kernel")
    check_factor_launches(factors, f"{tag} the main path")
    if graphs and n_graphs == 0:
        raise AssertionError("the estimator's programs were not captured as CUDA graphs")
    if sync_check and len(host_ms.get("Estimator._dispatch_solve", [])) < 5:
        raise AssertionError("too few steady-state solves under the sync check")
    fe_programs = check_frontend_programs(tag, fe, tracked)
    ate, n = trajectory_ate(rig.world, est)
    log(f"{tag} ATE {ate:.4f} m over {n} poses; first solve at t = {times[0]:.4f} s")
    if n != len(times):
        raise AssertionError("not as many trajectory poses as solves")
    return dict(fe=fe, est=est, stages=stages, launches=launches, sym_launches=sym_launches,
                factors=factors, fps=fps, ate=ate, host_ms=host_ms, fe_programs=fe_programs)


def phase_full_scale(rig, plain_calls, profile=False):
    """bench.py's configuration through the port's synchronous pipeline
    (solve lag 1, depth 1) on the card. ``profile`` times the stages (the
    timers synchronize the card, so the frames/s of such a run are not the
    cell's)."""
    from lfvio_tpu_torch.frontend import klt_cuda

    log(f"[4] stream: {len(rig[1])} events, {len(rig[2])} frames rendered on the card")
    lk = klt_cuda.pyramidal_lk
    run = run_full_scale("[4]", rig, plain_calls, 1, 1, profile, sync_check=not profile)
    run["level_launches"] = phase_five_launch_path(run["fe"], rig[2], run["stages"])
    # The stage timer's LK wrapper synchronizes: no later capture may record it.
    klt_cuda.pyramidal_lk = lk
    if run["stages"] is not None:
        log_stage_timers(run["stages"])
    return run


# Phase 4g: the front end's step programs at full width against the step
# run op by op (FrontEnd.use_graphs off) on the same frames: FE_GRAPH_FRAMES
# frames, a reset of both before frame FE_GRAPH_RESET (FE_GRAPH_FRAMES - 2
# tracked frames).
FE_GRAPH_FRAMES = 16
FE_GRAPH_RESET = 8


def throttled(times, freq=10.0):
    """The publish decisions VioPipeline makes for frames at ``times`` at its
    publish rate ``freq`` (VioPipeline._process_frame)."""
    out, last = [], -1e18
    for t in times:
        out.append(t - last >= 1.0 / freq - 1e-9)
        last = t if out[-1] else last
    return out


def fetched(handle):
    """The device outputs a FrontEnd's (or a DualFrontEnd's) dispatch handle
    fetched, as numpy arrays."""
    if handle[0] == "dual":
        return [x for sub in handle[1] for x in fetched(sub)]
    return handle[1].numpy()


def frontend_graphs_vs_eager(tag, fe_g, fe_e, frames, publish, reset_at=FE_GRAPH_RESET):
    """Drive a graphed front end (a FrontEnd or a DualFrontEnd) and its
    eager twin (use_graphs off) over the same (t, image) frames in turns,
    frame by frame, both reset before frame ``reset_at``. Each dispatch of a
    tracked frame but a capture's runs under the sync check, timed on the
    host. Raises unless the fetched device outputs (status, new_src,
    positions, bearings) and the finalized frames (ids, bearings,
    velocities, rows, publish masks) agree bit for bit, every kernel's
    launches of each frame are equal, and every tracked frame after the
    first of its kind replayed the graph of its kind (each camera's own).
    Returns dict(tracked, host_ms {(path, kind): [ms]}, nodes and programs:
    a list over cameras of {kind: kernel nodes} and of
    check_frontend_programs' record)."""
    from lfvio_tpu_torch.frontend import klt_cuda
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    kernels = (klt_cuda.lk_pyramid, klt_cuda.pyramidal_lk_pallas, klt_cuda.lk_level, sym_eig)
    counts = lambda: [k.launches for k in kernels]
    cams_g, cams_e = (getattr(fe, "fes", (fe,)) for fe in (fe_g, fe_e))
    for fe in cams_e:
        fe.use_graphs = False
    tracked, host_ms, seen = {"n": 0, True: 0, False: 0}, {}, set()
    for k, (t, img) in enumerate(frames):
        if k == reset_at:
            fe_g.reset()
            fe_e.reset()
        first = cams_g[0]._dev_pos is None
        kind = "published" if publish[k] else "unpublished"
        handles, deltas = [], []
        for path, fe in (("graphs", fe_g), ("eager", fe_e)):
            c0 = counts()
            capture = path == "graphs" and not first and publish[k] not in seen
            call = (fe.dispatch if first or capture else
                    sync_checked(fe.dispatch, host_ms, (path, kind)))
            handles.append(call(img, t, publish=publish[k]))
            deltas.append([b - a for a, b in zip(c0, counts())])
        if deltas[0] != deltas[1]:
            raise AssertionError(f"{tag} frame {k}: launches {deltas[0]} with the graphs, "
                                 f"{deltas[1]} eager")
        if not all(np.array_equal(x, y) for x, y in zip(*map(fetched, handles))):
            raise AssertionError(f"{tag} frame {k}: the graphs' device outputs differ from "
                                 f"the eager step's")
        outs = [fe_g.finalize(handles[0]), fe_e.finalize(handles[1])]
        if (outs[0] is None) != (outs[1] is None) or not all(
                np.array_equal(x, y) for x, y in zip(outs[0] or (), outs[1] or ())):
            raise AssertionError(f"{tag} frame {k}: the finalized frames differ")
        if not first:
            seen.add(publish[k])
            tracked["n"] += 1
            tracked[publish[k]] += 1
    label = lambda c: tag if len(cams_g) == 1 else f"{tag} camera {c}:"
    programs = [check_frontend_programs(label(c), fe, tracked) for c, fe in enumerate(cams_g)]
    nodes = [{("published" if pub else "unpublished"): graph_nodes(p)
              for pub, p in fe._programs.items()} for fe in cams_g]
    log(f"{tag} graphs against eager over {len(frames)} frames (reset before frame "
        f"{reset_at}), {tracked['n']} tracked: status, new_src, positions, bearings and the "
        f"finalized frames bit-identical; launches equal frame by frame; nodes "
        + "; ".join(("" if len(nodes) == 1 else f"camera {c} ") + f"{k} "
                    + ", ".join(f"{n} {v}" for n, v in kinds.items())
                    for c, cam in enumerate(nodes) for k, kinds in cam.items()))
    for key, vals in sorted(host_ms.items()):
        log(f"{tag} FrontEnd.dispatch, {key[0]}, {key[1]}, host ms under "
            f"set_sync_debug_mode({SYNC_CHECK!r}): n {len(vals)}, min {min(vals):.3f}, median "
            f"{float(np.median(vals)):.3f}, max {max(vals):.3f}")
    return dict(tracked=tracked, host_ms=host_ms, nodes=nodes, programs=programs)


def phase_frontend_graphs(rig, plain_calls, run4):
    """The front end's programs: phase 4's configuration and stream with the
    FrontEnd run op by op (4e: its dispatch host ms under the sync check
    beside phase 4's graphs, frames/s, ATE within GRAPH_ATE_M of phase 4's),
    then the graphs held against the eager step at full width (4g):
    1280x960 at 256 slots on phase 4's frames (15 Hz published at 10 Hz),
    in both LK geometries, and at 384 slots in the high-rate configuration
    (30 Hz frames published at 10 Hz: 2 of 3 unpublished)."""
    dev = next(iter(rig.frames.values())).device
    eager = run_full_scale("[4e]", rig, plain_calls, 1, 1, sync_check=True, fe_graphs=False)
    d_ate = abs(eager["ate"] - run4["ate"])
    log(f"[4e] phase 4's stream with the front end eager: {eager['fps']:.3f} frames/s beside "
        f"{run4['fps']:.3f} with its graphs; ATE {eager['ate']:.6f} m beside {run4['ate']:.6f} m "
        f"(difference {d_ate:.2e})")
    if d_ate > GRAPH_ATE_M or abs(float(eager["est"].times[0])
                                  - float(run4["est"].times[0])) > 1e-9:
        raise AssertionError("the front end's graphs moved the trajectory")
    cam = rig.world.camera
    ts = sorted(rig.frames)[:FE_GRAPH_FRAMES]
    frames15 = [(t, rig.frames[t]) for t in ts]
    high = bench.config_from_env(BENCH_HIGH_RATE)
    ts30 = [k / high.frame_rate for k in range(FE_GRAPH_FRAMES)]
    frames30 = [(t, rig.world.render_u8(t)) for t in ts30]
    out = {}
    for key, cfg, frames, kw in (("256", FULL_SCALE, frames15, {}),
                                 ("256 pallas", FULL_SCALE, frames15, dict(use_pallas=True)),
                                 ("384", high, frames30, {})):
        make = lambda: bench.make_frontend(cfg, cam, dev, **kw)
        publish = throttled([t for t, _ in frames])
        out[key] = frontend_graphs_vs_eager(f"[4g] {key} slots:", make(), make(), frames,
                                            publish)
    out["eager_run"] = eager
    return out


def phase_bench_configuration(rig, plain_calls, run4):
    """bench.py's configuration as bench.py runs it (bench.py:116-119):
    solve lag 2 with the device state chain, depth 3."""
    run = run_full_scale("[6]", rig, plain_calls, 2, 3, sync_check=True)
    fps, ate = run["fps"], run["ate"]
    log(f"[6] frames/s at lag 2 / depth 3: {fps:.3f}, beside phase 4's lag 1 / depth 1: "
        f"{run4['fps']:.3f} (ratio {fps / run4['fps']:.3f}); ATE {ate:.4f} m beside "
        f"{run4['ate']:.4f} m")
    if not ate < FULL_SCALE_ATE_M:
        raise AssertionError(f"lag-2 / depth-3 ATE is not below {FULL_SCALE_ATE_M} m")
    if abs(float(run["est"].times[0]) - float(run4["est"].times[0])) > 1e-9:
        raise AssertionError("lag 2 / depth 3 initialized on another frame than lag 1 / depth 1")
    return run


# The Pallas geometry has no refine pass, so its tracks keep the PAL bias
# that the refine pass removes: phase 6p's ATE bound is looser than phase 4's
# 0.0136 m, and tighter than phase 6's 0.5 m.
PALLAS_ATE_M = 0.1


def phase_pallas_frontend(rig, plain_calls, run4):
    """Phase 4's configuration and stream with FrontEnd(use_pallas=True):
    every tracked frame one launch of the kernel's Pallas-geometry mode,
    frames/s over the same window as phase 4's, ATE < PALLAS_ATE_M."""
    run = run_full_scale("[6p]", rig, plain_calls, 1, 1, fe_kw=dict(use_pallas=True))
    log(f"[6p] FrontEnd(use_pallas=True): {run['fps']:.3f} frames/s, ATE {run['ate']:.4f} m "
        f"(< {PALLAS_ATE_M}), Pallas-mode launches {run['launches']}; beside phase 4's "
        f"{run4['fps']:.3f} frames/s and {run4['ate']:.4f} m")
    if not run["ate"] < PALLAS_ATE_M:
        raise AssertionError(f"use_pallas=True ATE is not below {PALLAS_ATE_M} m")
    return run


# Phase 6r: one loop closure on bench.py's configuration, planted as
# tests/test_capabilities.py::test_relocalization_drift_estimate plants it:
# the pose graph carries the loop frame with a drift of yaw 12° and
# (0.4, -0.3, 0.1) m, which the drift correction must recover. The drift
# correction maps the VIO world into the pose graph's; the bearing harness's
# VIO world has the true world's yaw, this stream's does not (its
# initialization fixes another gauge), so the yaw it must recover is the
# planted one plus the VIO world's yaw against the truth, which the
# trajectory's alignment to the ground truth (Umeyama, as ATE's) measures.
RELO_DRIFT_YPR_DEG = (12.0, 0.0, 0.0)
RELO_DRIFT_T = (0.4, -0.3, 0.1)
RELO_REL_T_M = 0.25
RELO_REL_YAW_DEG = 5.0
RELO_DRIFT_YAW_DEG = 5.0
# Solves the estimator finalizes before the loop closure is armed.
RELO_ARM_SOLVES = 5
# The first relo solve's wall time around its synchronized dispatch: its
# graph is captured at the first solve, so the loop closure replays it
# (captured at the loop closure instead, it took 304.4 ms on an H100).
RELO_FIRST_WALL_MS = 50.0
# The relo graph's kernel nodes at full width (its conditional bodies'
# included): 8 relo_normal and 9 relo_cost launches a replay at most beside
# the solve's, as they have always been.
RELO_MAX_NODES = 4596


def _wrap_deg(a):
    return (a + 180.0) % 360.0 - 180.0


def vio_gauge_yaw(world, est):
    """The yaw (deg) of the rotation that aligns the estimator's trajectory
    to the ground truth (runtime/evaluation.py's Umeyama, as ATE's): the
    VIO world's yaw against the true world's."""
    from lfvio_tpu_torch.geom import host as hg
    from lfvio_tpu_torch.runtime.evaluation import align_umeyama

    gt = np.stack([world.pose(tt)[0] for tt in est.times])
    _, R, _ = align_umeyama(np.asarray(est.traj_p), gt)
    return float(hg.R_to_ypr_deg(R)[0])


def arm_loop_closure(est, world):
    """Arm one loop closure on ``est`` (initialized): window frame WIN - 2
    seen again (every slot with an observation at that frame, with its
    bearing there), its true pose carried by the pose graph with the planted
    drift (RELO_DRIFT_YPR_DEG, RELO_DRIFT_T). Returns (t_loop, matches,
    |relo_relative_t| and relo_relative_yaw of set_relo_frame's PnP seed);
    raises if set_relo_frame refuses the match."""
    from lfvio_tpu_torch.geom import host as hg

    idx = est.WIN - 2
    t_loop = float(est.headers[idx])
    fm = est.fm
    slots = np.nonzero(fm.valid[:, idx] & (fm.feature_id >= 0))[0]
    p_true, q_true = world.pose(t_loop)
    R = hg.ypr_deg_to_R(list(RELO_DRIFT_YPR_DEG))
    prev_p = R @ np.asarray(p_true) + np.asarray(RELO_DRIFT_T)
    prev_q = hg.mat_to_quat(R @ hg.quat_to_mat(np.asarray(q_true)))
    if not est.set_relo_frame(t_loop, fm.feature_id[slots], fm.bearing[slots, idx], prev_p,
                              prev_q):
        raise AssertionError(f"set_relo_frame refused the loop frame at t = {t_loop}")
    return t_loop, len(slots), float(np.linalg.norm(est.relo_relative_t)), est.relo_relative_yaw


def phase_relo_full_scale(rig, plain_calls):
    """Relocalization at full width: phase 6's configuration and stream
    (bench.py's: 1280x960, 256 slots, window 10, f32, solve lag 2, device
    chain, depth 3) through a fresh pipeline, with one loop closure armed
    (arm_loop_closure) once the estimator has initialized and finalized
    RELO_ARM_SOLVES solves; the following frames run the relo solve (chain
    off) and finalize it in the frame loop. The launch counts are set to 0
    just before the stream and read just after it. Passes only with
    |relo_relative_t| < RELO_REL_T_M, |relo_relative_yaw| <
    RELO_REL_YAW_DEG, the drift correction's yaw within RELO_DRIFT_YAW_DEG
    of the planted one, the loop match consumed, ATE < FULL_SCALE_ATE_M,
    both relo kernels launched, and, armed once more on the final window,
    one replay of the relo graph launching a relo_normal a linearization
    it ran and a relo_cost a cost (1 + its LM iterations), as many as the
    projection's and the IMU's normal and cost launches, its LM iterations
    as conditional nodes, at most RELO_MAX_NODES kernel nodes in its graph
    and its conditional bodies, that graph
    captured at the first solve's dispatch (Estimator._capture_relo) and
    the first relo solve within RELO_FIRST_WALL_MS of wall time
    (synchronized around its dispatch). Logs that first solve's dispatch
    with the relo program's warm-up, capture and max_memory_allocated
    before and after it, the first relo solve's wall ms, the relo and solve
    replays' card ms and their graphs' nodes. Returns dict(launches, args:
    the relo program's (state, grid, cfg, relo) inputs on the final window,
    and the numbers logged)."""
    import torch
    from lfvio_tpu_torch.geom import host as hg

    fe, est, pipe = rig.make(2, 3)
    first, first_solve, early = {}, {}, {}
    dispatch, capture_relo = est._dispatch_solve, est._capture_relo

    def timed_dispatch(*a, **k):
        rec = (first_solve if not first_solve else
               first if est._relo_active is not None and not first else None)
        if rec is None:
            return dispatch(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dispatch(*a, **k)
        torch.cuda.synchronize()
        rec.update(wall_ms=1e3 * (time.perf_counter() - t0), t=float(a[0]))
        return out

    def timed_capture(packed, prior):
        if ("relo",) in est._programs:
            return capture_relo(packed, prior)
        torch.cuda.synchronize()
        mem0 = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
        capture_relo(packed, prior)
        torch.cuda.synchronize()
        early.update(first_solve=not first_solve, prog=est._programs.get(("relo",)),
                     mem_before=mem0, mem_after=(torch.cuda.memory_allocated(),
                                                 torch.cuda.max_memory_allocated()))

    est._dispatch_solve, est._capture_relo = timed_dispatch, timed_capture
    reset_launches()
    plain_calls["n"] = 0
    armed = None
    t0 = time.perf_counter()
    for it in rig.stream:
        bench.feed(pipe, [it], rig.frames)
        if (armed is None and it[0] == "frame" and est.solver_flag == est.NON_LINEAR
                and len(est.times) >= RELO_ARM_SOLVES):
            armed = arm_loop_closure(est, rig.world)
    pipe.flush()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    del est._dispatch_solve, est._capture_relo
    launches = factor_launches()
    if armed is None or not first:
        raise AssertionError("[6r] the loop closure was not armed, or its solve did not run")
    t_loop, n_match, pnp_t, pnp_yaw = armed
    rel_t = float(np.linalg.norm(est.relo_relative_t))
    rel_yaw = float(est.relo_relative_yaw)
    drift_yaw = float(hg.R_to_ypr_deg(est.drift_correct_r)[0])
    ate, n = trajectory_ate(rig.world, est)
    gauge_yaw = vio_gauge_yaw(rig.world, est)
    want_yaw = RELO_DRIFT_YPR_DEG[0] + gauge_yaw
    log(f"[6r] loop closure armed after {RELO_ARM_SOLVES} solves: loop frame t = {t_loop:.4f} s "
        f"(window frame {est.WIN - 2}), {n_match} matched slots, planted drift yaw "
        f"{RELO_DRIFT_YPR_DEG[0]} deg and {RELO_DRIFT_T} m; PnP seed |relo_relative_t| "
        f"{pnp_t:.4f} m, relo_relative_yaw {pnp_yaw:.3f} deg")
    log(f"[6r] after the relo solve of the frame at t = {first['t']:.4f} s: |relo_relative_t| "
        f"{rel_t:.4f} m (< {RELO_REL_T_M}), relo_relative_yaw {rel_yaw:.3f} deg (|.| < "
        f"{RELO_REL_YAW_DEG}), drift correction yaw {drift_yaw:.3f} deg (the planted "
        f"{RELO_DRIFT_YPR_DEG[0]} + the VIO world's yaw against the truth {gauge_yaw:.3f} = "
        f"{want_yaw:.3f}, within {RELO_DRIFT_YAW_DEG}); loop match consumed "
        f"{est._relo_active is None}; ATE {ate:.4f} m over {n} poses (< {FULL_SCALE_ATE_M}); "
        f"{len(est.times)} solves, stream {wall_s:.1f} s; factor kernels' launches {launches}; "
        f"{lm_run_counts(est.lm_runs)}; the relo solve's "
        f"{[r[:2] for r in est.lm_runs if r[2]]}")
    if not (rel_t < RELO_REL_T_M and abs(rel_yaw) < RELO_REL_YAW_DEG
            and abs(_wrap_deg(drift_yaw - want_yaw)) < RELO_DRIFT_YAW_DEG
            and est._relo_active is None and ate < FULL_SCALE_ATE_M and n == len(est.times)):
        raise AssertionError("[6r] relocalization at full width missed a bound")
    if not (launches["relo_normal"] and launches["relo_cost"]):
        raise AssertionError("[6r] the relo solve did not launch both relo kernels")
    check_factor_launches(launches, "[6r] the main path")
    if plain_calls["n"]:
        raise AssertionError("[6r] the front end ran the plain LK")

    prog = est._programs[("relo",)]
    warm_ms, capture_ms = 1e3 * prog.warmup_s, 1e3 * (prog.capture_s - prog.warmup_s)
    mib = lambda b: b / 2**20
    if not early:
        raise AssertionError("[6r] the relo program was not captured before the loop closure")
    (m0, p0), (m1, p1) = early["mem_before"], early["mem_after"]
    log(f"[6r] the relo program captured at the first solve's dispatch "
        f"(t = {first_solve['t']:.4f} s): its eager warm-up {warm_ms:.1f} "
        f"ms, its capture {capture_ms:.1f} ms; that dispatch {first_solve['wall_ms']:.1f} ms of "
        f"wall time (synchronized; its solve's and marginalization's captures too); "
        f"max_memory_allocated {mib(p0):.1f} MiB before the relo capture, {mib(p1):.1f} MiB "
        f"after; memory_allocated {mib(m0):.1f} -> {mib(m1):.1f} MiB")
    if not (early["first_solve"] and early["prog"] is prog and prog.graph is not None):
        raise AssertionError("[6r] the relo graph the loop closure replayed was not captured at "
                             "the first solve")
    # Armed once more on the final window: the relo program's inputs.
    arm_loop_closure(est, rig.world)
    relo = dict(est._relo_active,
                mask=est._relo_active["mask"] & (est.fm.feature_id == est._relo_active["snap_ids"]))
    est._relo_active = None
    prior = est.prior if est.prior is not None else est._empty_prior()
    packed_r = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0], relo=relo))
    packed = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0]))
    chain = est._zero_chain()
    solve = est._program(("solve",))
    per_replay, (res_r, _) = launches_of(lambda: prog(packed_r, prior))
    ran = tuple(int(x) for x in res_r["lm_runs"])
    ms = {"relo": cuda_ms(lambda: prog(packed_r, prior), n=5, warmup=1),
          "solve": cuda_ms(lambda: solve(packed, prior, chain), n=5, warmup=1)}
    nodes = {"relo": graph_nodes(prog), "solve": graph_nodes(solve)}
    log_condition_kernel("[6r]", "relo solve", lambda: prog(packed_r, prior))
    log(f"[6r] the first relo solve: {first['wall_ms']:.1f} ms of wall time around "
        f"its synchronized dispatch (pack, upload, a replay of the relo graph captured at the "
        f"first solve, the marginalization's replay, the fetch; bound {RELO_FIRST_WALL_MS} ms); "
        f"a replay {ms['relo']:.3f} ms on the card")
    log(f"[6r] relo solve replay ({ran[0]} LM iterations, {ran[1]} linearizations run) "
        f"{ms['relo']:.3f} ms on the card beside the solve "
        f"replay's {ms['solve']:.3f} ms; nodes relo " + ", ".join(
            f"{k} {v}" for k, v in nodes["relo"].items()) + "; solve " + ", ".join(
            f"{k} {v}" for k, v in nodes["solve"].items())
        + "; factor kernels' launches per relo replay " + ", ".join(
            f"{k} {v}" for k, v in per_replay.items()))
    want = replay_launches(*ran, relo=True)
    if per_replay != want:
        raise AssertionError(f"[6r] a relo replay that ran {ran} iterations and linearizations "
                             f"did not launch {want}")
    if not nodes["relo"].get("conditional"):
        raise AssertionError("[6r] the relo graph holds no conditional node")
    if kernel_nodes(nodes["relo"]) > RELO_MAX_NODES:
        raise AssertionError(f"[6r] the relo graph has more than {RELO_MAX_NODES} kernel nodes")
    if first["wall_ms"] > RELO_FIRST_WALL_MS:
        raise AssertionError(f"[6r] the first relo solve took {first['wall_ms']:.1f} ms of wall "
                             f"time, above {RELO_FIRST_WALL_MS}")
    state, grid, _, _, relo_t = est._unpack(packed_r.clone())[:5]
    return dict(launches=launches, args=(state, grid, est.scfg, relo_t), first=first,
                first_solve=first_solve, warm_ms=warm_ms, capture_ms=capture_ms,
                mem_mib=(mib(p0), mib(p1)), ms=ms, nodes=nodes, rel_t=rel_t, rel_yaw=rel_yaw,
                drift_yaw=drift_yaw, want_yaw=want_yaw, ate=ate)


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
    # The FrontEnd, run eagerly, looks its LK call up in klt_cuda at every
    # frame (its graphs hold the fused launch they captured).
    fe.use_graphs = False
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

    graphs_at = []

    def check_budget(est, pipe, world):
        est.marg_old = False
        if not (est._iter_time and est._iter_time > 0 and est._iterations_allowed() == 1):
            raise AssertionError(f"budget: _iter_time {est._iter_time}")
        graphs = est.graph_stats()[0]
        if graphs != graphs_at[0] or est.lm_runs[-1][0] != 1:
            raise AssertionError(f"budget: {graphs} graphs at the end against {graphs_at[0]} "
                                 f"after the first solve ({sorted(est._programs)}), or the last "
                                 f"solve not at cap 1: {est.lm_runs}")
        out["iter_time"] = est._iter_time
        return (f"max_solver_time 1e-7: _iter_time {est._iter_time:.5f} s per LM iteration, "
                f"_iterations_allowed() 1; a budget of 0.04 s would allow "
                f"{int(np.clip(0.04 / est._iter_time, 1, 8))}; graphs {graphs} after the first "
                f"solve and at the end; {lm_run_counts(est.lm_runs)}")

    est_b = mk_est(max_solver_time=1e-7)
    dispatch_b = est_b._dispatch_solve

    def counted_dispatch(*a, **k):
        out_ = dispatch_b(*a, **k)
        if est_b._programs and not graphs_at:  # the first solve's
            graphs_at.append(est_b.graph_stats()[0])
        return out_

    est_b._dispatch_solve = counted_dispatch
    stream("wall budget", est_b, mk_world(), 1.5, check_budget)

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
    tracked = [count_tracked(f) for f in fes]
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
    factors = factor_launches()
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
    for c, (f, n) in enumerate(zip(fes, tracked)):
        check_frontend_programs(f"[8] camera {c}:", f, n)
    if fes[0]._programs[True] is fes[1]._programs[True]:
        raise AssertionError("dual-PAL: the cameras share a front-end program")
    if not (np.isfinite(ate) and ate < 0.25):
        raise AssertionError("dual-PAL accuracy gate failed")
    check_factor_launches(factors, "dual-PAL")
    return dict(launches=launches, sym_launches=sym_launches, factors=factors, fps=n_frames / dt,
                ate=ate, solve_ms=float(np.median(ms[1:])))


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
        tracked = count_tracked(fe)
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
    factors = factor_launches()
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
    if not (np.isfinite(traj).all() and ate < FULL_SCALE_ATE_M):
        raise AssertionError(f"EuRoC ATE is not below {FULL_SCALE_ATE_M} m")
    if (launches == 0 or launches != tracked["n"] or klt_cuda.lk_level.launches != 0
            or plain_calls["n"] != 0 or padded["n"] != 0):
        raise AssertionError("the EuRoC path's LK is not one fused launch per tracked frame")
    if sym_launches == 0:
        raise AssertionError("the EuRoC path did not launch the eigensolver kernel")
    check_frontend_programs("[9]", fe, tracked)
    check_factor_launches(factors, "EuRoC")
    return dict(launches=launches, sym_launches=sym_launches, factors=factors, fps=fps, ate=ate)


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


def main_path_eig_inputs(dev, N=256):
    """The symmetric matrices the main path hands the eigensolver, recorded
    from the calls themselves: a triangulation of make_window_problem(N)
    (the full-scale window, f32) and one RANSAC (100 hypotheses and the refit
    over N slots of bearings seen all around the rig, 40 outliers). N = 256
    is bench.py's default configuration, 384 its high-rate one."""
    import torch
    from lfvio_tpu_torch.backend import triangulate as tri
    from lfvio_tpu_torch.frontend import ransac
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    seen = []

    def record(A):
        seen.append(A.clone())
        return torch.linalg.eigh(A)

    pb = make_window_problem(N, torch.float32, device=dev)
    rng = np.random.default_rng(5)
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
                             torch.zeros(N, dtype=torch.bool, device=dev))
        ransac.spherical_ransac_e(uni, tt(X), tt(X2), valid)
    finally:
        tri.sym_eig, ransac.sym_eig = saved
    return seen  # [N,4,4], [100,9,9], [100,3,3], [1,9,9], [1,3,3]


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


def log_sweeps(inputs, label):
    """Each main-path input's histogram of Jacobi sweeps a matrix (f32), and
    how many matrices stopped at the cap."""
    from lfvio_tpu_torch.geom.eigh_cuda import MAX_SWEEPS, sym_eig

    for A in inputs:
        counts = sym_eig(A, sweeps=True)[2].reshape(-1).cpu().numpy()
        hist = dict(zip(*np.unique(counts, return_counts=True)))
        log(f"[14] sym_eig sweeps a matrix at {tuple(A.shape)} ({label}, f32): "
            + ", ".join(f"{int(k)}: {int(v)}" for k, v in sorted(hist.items()))
            + f"; {int((counts >= MAX_SWEEPS).sum())} of {len(counts)} at the cap of {MAX_SWEEPS}")


def phase_sym_eig(dev):
    """The eigensolver kernel against its plain version (torch.linalg.eigh)
    on the main path's inputs at 256 and 384 slots, in f32 and f64, and its
    times at 256 slots (with the [384, 4, 4] launch's beside them)."""
    import torch
    from lfvio_tpu_torch.geom import eigh_cuda
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    inputs = main_path_eig_inputs(dev)
    inputs384 = main_path_eig_inputs(dev, 384)
    shapes = [tuple(A.shape) for A in inputs]
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        ew_b, er_b, ev_b, gap = EIG_BOUNDS[str(dtype).split(".")[-1]]
        for slots, A in [(256, A) for A in inputs] + [(384, A) for A in inputs384]:
            A = A.to(dtype)
            w, V = sym_eig(A)
            w_ref, V_ref = torch.linalg.eigh(A)
            torch.cuda.synchronize()
            ew, er, ev, share = eig_errors(A, w, V, w_ref, V_ref, gap)
            log(f"[14] sym_eig {dtype} {tuple(A.shape)} ({slots} slots) against "
                f"torch.linalg.eigh: eigenvalues "
                f"within {ew:.2e} of the largest (bound {ew_b}); residuals |Av - wv|, |VᵀV - I| "
                f"{er:.2e} (bound {er_b}); smallest eigenvector within {ev:.2e} (bound {ev_b}) "
                f"on the {100 * share:.0f}% well posed at {gap}")
            if not (ew <= ew_b and er <= er_b and ev <= ev_b):
                raise AssertionError(f"sym_eig disagrees with torch.linalg.eigh at {A.shape}")
            if dtype == torch.float32:
                worst = max(worst, ew, ev)
    log_sweeps(inputs, "256 slots")
    log_sweeps(inputs384, "384 slots")
    bad = torch.zeros((2, 10, 10), device=dev)
    try:
        sym_eig(bad)
        raise AssertionError("sym_eig took a 10 x 10 matrix")
    except ValueError:
        pass
    # A published frame's launches (RANSAC's four, the solve's triangulation)
    # behind a full queue, and the library's eigh on the same five inputs,
    # its wait for the card included; then each input's launch (and the
    # high-rate configuration's triangulation) beside its latency floor, its
    # bound and the library's call.
    block = make_blocker(dev)

    def frame():
        for A in inputs:
            sym_eig(A)

    def host_ms(fn, reps=10):
        """Median host ms of fn() and a synchronize (the library's eigh waits
        for the card in any case)."""
        t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(t))

    ms = cuda_ms(frame, reps=10, blocker=block)
    alone = cuda_ms(frame)
    lib_ms = host_ms(lambda: [torch.linalg.eigh(A) for A in inputs])
    per_shape, floors = [], []
    for A in inputs + inputs384[:1]:
        t = cuda_ms(lambda: sym_eig(A), reps=10, blocker=block)
        empty = lambda: eigh_cuda.latency_floor(A)
        fl = cuda_ms(empty, reps=10, blocker=block)
        b, by_s = eig_bound_ms([A])[:2]
        log(f"[14] sym_eig {tuple(A.shape)} f32: {t:.4f} ms behind a full queue, "
            f"{cuda_ms(lambda: sym_eig(A)):.4f} ms launched alone; latency floor (the empty "
            f"kernel, same grid, block and launch path) {fl:.4f} ms behind a full queue, "
            f"{cuda_ms(empty):.4f} ms alone; bound {b:.7f} ms by {by_s}; torch.linalg.eigh "
            f"{host_ms(lambda: torch.linalg.eigh(A)):.4f} ms with its wait")
        if len(per_shape) < len(inputs):
            per_shape.append(t)
            floors.append(fl)
    bound, by, nbytes, ops = eig_bound_ms(inputs)
    log(f"[14] sym_eig per published frame ({', '.join(map(str, shapes))}; f32): "
        f"{ms:.4f} ms on the card behind a full queue (per shape "
        + ", ".join(f"{t:.4f}" for t in per_shape)
        + f"; their floors {sum(floors):.4f}), {alone:.4f} ms launched alone, host cost "
        f"included; torch.linalg.eigh on the same inputs {lib_ms:.4f} ms with its wait (median "
        f"of 10 host-timed); bound {bound:.6f} ms by {by} ({nbytes} B, {ops / 1e6:.3f} MFLOP)")
    return dict(max_abs_err=worst, ms=ms, ms_launched_alone=alone, floor_ms=sum(floors),
                plain_ms=lib_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms)


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


def packed_at(est, max_iter=None, perturb=None, scale=0.05):
    """The estimator's packed solve buffer from its mirrors, on the card,
    with the LM's cap ``max_iter`` in place of its own and the window
    positions moved by N(0, scale) m drawn from the seed ``perturb``."""
    buf = est._pack_solve_buffer(est.Ps[0], est.Qs[0])
    if max_iter is not None:
        buf[est._pack_layout["max_iter"][0]] = max_iter
    if perturb is not None:
        off, shape = est._pack_layout["p"]
        n = int(np.prod(shape))
        buf[off:off + n] += np.random.default_rng(perturb).normal(0.0, scale, n)
    return est._upload(buf)


def lm_run_counts(runs):
    """The histograms of LM iterations and linearizations run a solve over
    ``runs`` (Estimator.lm_runs entries), as text."""
    hist = lambda i: dict(sorted(collections.Counter(r[i] for r in runs).items()))
    return (f"LM iterations run a solve {hist(0)}, linearizations {hist(1)} "
            f"({len(runs)} solves)")


# Phase 14's graph-against-eager inputs of the solve: the stream's window
# with its positions moved (so that every iteration has work: on the CPU in
# f64 no accepted step improves the cost by less than cost_tol before the
# 8th) under the packed caps 8, 1 and 3, and a window whose solve ends on
# the cost plateau before the cap: the first of PLATEAU_WINDOWS (seed,
# scale: the window as the stream left it, then moved by N(0, 1e-6) m) whose
# eager solve does. The stream has no noise, so its converged window's cost
# lies at the rounding floor, and whether the LM's first step there lowers
# it (a step is taken only on a strict decrease) is drawn by the last bits
# of the arithmetic before it: on the CPU 2 iterations with the plain QR of
# the marginalizations, 4 with the kernel's blocked order; on an H100 with
# the pipelined kernel every step was rejected (8 iterations, 1 linearization).
GRAPH_SOLVE_CASES = (("cap 8", 8, 1), ("cap 1", 1, 1), ("cap 3", 3, 1), ("plateau", 8, None))
PLATEAU_WINDOWS = ((None, 0.0), (1, 1e-6), (2, 1e-6), (3, 1e-6), (4, 1e-6))


def plateau_window(est, prior, chain, cap):
    """The packed buffer of the first of PLATEAU_WINDOWS whose eager solve
    runs 1 <= iterations < cap (it ends on the cost plateau); raises if
    none does (the plateau exit never ran)."""
    tried = []
    for seed, scale in PLATEAU_WINDOWS:
        packed = packed_at(est, cap, seed, scale)
        runs = tuple(int(x) for x in est._solve_packed_impl(packed, prior, chain)[0]["lm_runs"])
        if 1 <= runs[0] < cap:
            return packed
        tried.append(((seed, scale), runs))
    raise AssertionError(f"[14] no window of PLATEAU_WINDOWS ends its solve on the cost plateau "
                         f"before the cap {cap}: {tried}")


def phase_graphs_f64(dev):
    """Each program's graph replay against the same function run eagerly on
    the same inputs, f64, on an estimator a bearing stream initialized (64
    slots): the solve (at GRAPH_SOLVE_CASES: caps 8, 1, 3 in the packed
    buffer and an early plateau, each running its own iterations and
    linearizations), the relocalization solve, both marginalizations."""
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
    errs, ran = {}, {}
    for name, max_iter, perturb in GRAPH_SOLVE_CASES:
        packed = (plateau_window(est, prior, chain, max_iter) if name == "plateau"
                  else packed_at(est, max_iter, perturb))
        g_res, _ = clone_tree(est._program(("solve",))(packed, prior, chain))
        e_res, e_grid = est._solve_packed_impl(packed, prior, chain)
        errs[f"solve {name}"] = state_err(g_res["out"], e_res["out"])
        ran[name] = tuple(int(x) for x in g_res["lm_runs"])
        if ran[name] != tuple(int(x) for x in e_res["lm_runs"]):
            raise AssertionError(f"[14] solve {name}: the graph ran {ran[name]} iterations and "
                                 f"linearizations, the eager program {e_res['lm_runs']}")
    if not (ran["cap 8"][0] == cap and ran["cap 1"][0] == 1 and ran["cap 3"][0] == 3
            and 1 <= ran["plateau"][0] < cap):
        raise AssertionError(f"[14] the solve's iterations run do not follow the packed cap and "
                             f"the plateau: {ran}")
    errs["solve"] = errs.pop("solve plateau")  # the marginalizations' inputs below
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
    g_res, _ = clone_tree(est._program(("relo",))(packed_r, prior))
    e_res, _ = est._solve_relo_packed_impl(packed_r, prior)
    errs["relo"] = max(state_err(g_res["out"], e_res["out"]),
                       float((g_res["relo_p"] - e_res["relo_p"]).abs().max()),
                       float((g_res["relo_q"] - e_res["relo_q"]).abs().max()))
    torch.cuda.synchronize()
    n, cap_s = est.graph_stats()
    log(f"[14] census, the f64 estimator (64 slots, window 10): nodes "
        + "; ".join(f"{key[0]} " + ", ".join(
            f"{k} {c}" for k, c in graph_nodes(p).items())
                    for key, p in est._programs.items() if getattr(p, "graph", None) is not None))
    log(f"[14] f64 graph replay against eager on the same inputs (64 slots): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" of the scale (bound {GRAPH_F64}); the solve's LM iterations and linearizations "
        f"run (graph = eager) " + ", ".join(f"{k} {v}" for k, v in ran.items())
        + f"; {n} graphs captured in {cap_s:.2f} s")
    if not all(v <= GRAPH_F64 for v in errs.values()):
        raise AssertionError("a graph replay disagrees with the eager program")
    return errs


# The QR marginalizations against the eigh ones (marginalize_old /
# marginalize_second_new, the reference's own H-space elimination), both in
# f64 from each program call's inputs, within tests/test_marg_qr.py's bound
# between the two forms, relative to the scale: JᵀJ, and Jᵀr within the
# eigenspace the eigh prior keeps. Its square root J = S^{1/2} Vᵀ zeroes the
# eigenvalues below 1e-10 of the largest, so its Jᵀr has no component along
# their eigenvectors while the QR's keeps one (on phase 4's stream run on
# the CPU: JᵀJ within 3e-12, Jᵀr within 5.6e-8, projected within 1.6e-11).
# r0ᵀr0 is a constant of the cost and is not compared. Before the unit rows
# in each empty dropped column (backend/marginalize.py) every MARGIN_OLD
# missed the bound by up to 6.98 of the scale; a miss now fails the run.
QR_EIGH_BOUND = 2e-6


def marg_info_err(qr, eigh):
    """(compared, unprojected): the QR prior's JᵀJ and Jᵀr against the eigh
    prior's, relative to the eigh prior's scale, with the QR's Jᵀr projected
    on the range of the eigh prior's JᵀJ, and without that projection."""
    import torch

    Hq, He = qr.J.T @ qr.J, eigh.J.T @ eigh.J
    bq, be = qr.J.T @ qr.r0, eigh.J.T @ eigh.r0
    w, V = torch.linalg.eigh(He)
    Vk = V[:, w > w.max() * 1e-12]
    rel = lambda x, y: float((x - y).abs().max() / y.abs().max().clamp(min=1))
    eh = rel(Hq, He)
    return max(eh, rel(Vk @ (Vk.T @ bq), be)), max(eh, rel(bq, be))


def record_marg_information(est, rec):
    """Wrap ``est``'s marginalization programs so that each call also
    computes the QR and the eigh prior of its inputs in f64 and appends
    their information difference (``marg_info_err``) to ``rec["old"]`` or
    ``rec["new"]``."""
    from lfvio_tpu_torch.backend.marginalize import (marginalize_old, marginalize_old_qr,
                                                     marginalize_second_new,
                                                     marginalize_second_new_qr)

    make = est._program
    forms = {"marg_old": ("old", marginalize_old_qr, marginalize_old),
             "marg_new": ("new", marginalize_second_new_qr, marginalize_second_new)}

    def program(key):
        prog = make(key)
        if key[0] not in forms:
            return prog
        kind, qr, eigh = forms[key[0]]

        def run(*args):
            out = prog(*args)
            a = to_f64(args) + ((est._gravity_t.double(),) if kind == "old" else ()) + (est.scfg,)
            rec.setdefault(kind, []).append(marg_info_err(qr(*a), eigh(*a)))
            return out

        return run

    est._program = program


def log_marg_information(tag, name, rec):
    """Log the QR-against-eigh records of one run; raise on any miss."""
    out = {}
    for kind, label in (("old", "MARGIN_OLD"), ("new", "SECOND_NEW")):
        errs = rec.get(kind, [])
        worst = max((e for e, _ in errs), default=0.0)
        raw = max((r for _, r in errs), default=0.0)
        hits = sum(e > QR_EIGH_BOUND for e, _ in errs)
        log(f"{tag} QR against eigh marginalization, {name}: {len(errs)} {label}, JᵀJ and Jᵀr "
            f"(on the eigh prior's range) differ by at most {worst:.2e} of the scale, {hits} "
            f"above {QR_EIGH_BOUND}; Jᵀr unprojected {raw:.2e}")
        out[kind] = dict(n=len(errs), max=worst, unprojected=raw, hits=hits)
    if any(v["hits"] for v in out.values()):
        raise AssertionError(f"a QR marginalization of {name} drops information")
    return out


def phase_qr_information(dev):
    """The parity streams of tests/test_torch_estimator.py and
    tests/test_torch_lag.py (the bearing harness, 64 slots, f64, 1.5 s) and
    phase 7's lag-3 stream (30 px of parallax, so SECOND_NEW marginalizations
    too; 2.2 s) on the card, each marginalization's QR information (the
    kernels of csrc/marg_qr.cu in f64) against the eigh one."""
    import torch
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, VioPipeline
    from lfvio_tpu_torch.runtime.synthetic import SyntheticWorld, make_synthetic_pal_camera

    pts = make_landmarks()
    out = {}
    for name, cfg, fe_kw, world_kw, duration in (
            ("lag1", dict(solve_lag=1), {}, {}, 1.5),
            ("lag2_chain", dict(solve_lag=2, device_chain=True), {}, {}, 1.5),
            ("lag3", dict(solve_lag=3), {}, {}, 1.5),
            ("td", dict(solve_lag=1, estimate_td=True), dict(td_true=0.005),
             dict(traj_freq=0.8), 1.5),
            ("phase 7's solve lag 3", dict(solve_lag=3, min_parallax=30.0 / 160.0), {},
             dict(traj_freq=0.5), 2.2)):
        world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=torch.float64),
                               dtype=torch.float64, device=dev, **world_kw)
        est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=torch.float64,
                                        device=dev, **cfg))
        rec = {}
        record_marg_information(est, rec)
        run_bearing_stream(VioPipeline(BearingFrontEnd(world, pts, **fe_kw), est), world,
                           duration)
        out[name] = log_marg_information("[14]", f"parity stream {name}", rec)
    if not out["phase 7's solve lag 3"]["new"]["n"]:
        raise AssertionError("phase 7's lag-3 stream took no SECOND_NEW")
    return out


# ------------------------------------------------ phase 14: the census of the graphs
# cuda.h's CUgraphNodeType values the census names; others count as "other".
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 13: "conditional"}


def graph_nodes(prog):
    """The nodes of a DeviceProgram's CUDA graph by kind: its function
    captured once more on its static inputs (through ``device.capture``,
    so its ``cond`` blocks are IF nodes again), into a graph of the
    census's own that keeps its cudaGraph_t (``raw_cuda_graph()``) and is
    never replayed, read with cuGraphGetNodes and cuGraphNodeGetType
    through libcuda. The top level's kinds, with their total under "all",
    then the conditional nodes' body graphs' (read through
    ``device.IF_BODIES``, nested bodies included) under "body <kind>" and
    "body all". The launches the capture adds to the wrappers' counts are
    taken off again."""
    import ctypes

    import torch
    from lfvio_tpu_torch.device import IF_BODIES, KERNELS, capture

    before = [k.launches for k in KERNELS]
    debug = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    gc_on = gc.isenabled()
    gc.disable()  # as DeviceProgram captures: no graph destroyed mid-capture
    try:
        with capture(graph):
            prog.fn(*prog.static_in)
    finally:
        if gc_on:
            gc.enable()
        torch.cuda.set_sync_debug_mode(debug)
        for k, b in zip(KERNELS, before):
            k.launches = b
    cu = ctypes.CDLL("libcuda.so.1")

    def nodes_of(g):
        n = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(ctypes.c_void_p(g), None, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        if n.value and cu.cuGraphGetNodes(ctypes.c_void_p(g), nodes, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        return list(nodes)

    def count(g, kinds, prefix, bodies):
        t = ctypes.c_int(0)
        for node in nodes_of(g):
            if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
                raise RuntimeError("cuGraphNodeGetType failed")
            name = prefix + NODE_KINDS.get(t.value, "other")
            kinds[name] = kinds.get(name, 0) + 1
            kinds[prefix + "all"] = kinds.get(prefix + "all", 0) + 1
            if t.value == 13:
                bodies.append(IF_BODIES[node])

    try:
        kinds, bodies = {"all": 0}, []
        count(graph.raw_cuda_graph(), kinds, "", bodies)
        while bodies:
            count(bodies.pop(), kinds, "body ", bodies)
    finally:
        graph.reset()
    return kinds


def kernel_nodes(nodes):
    """The kernel nodes of a graph_nodes census, its bodies' included."""
    return nodes.get("kernel", 0) + nodes.get("body kernel", 0)


# The parts of a solve. For a traced solve the functions of
# backend/solver.py that make up the LM (and the estimator's lm_solve) are
# wrapped in torch.profiler.record_function ranges named "solve::<name>";
# an op's device time goes to the part of the innermost ranges above it.
# Ops that assemble_normal_equations launches itself are the projection's
# before its call of imu_normal starts, and the IMU's and the prior's from
# then on.
SOLVE_FUNCTIONS = ("assemble_normal_equations", "linearize_projection", "linearize_proj_rows",
                   "proj_rows", "proj_normal", "proj_cost", "linearize_imu_rows", "imu_normal",
                   "prior_residual", "total_cost", "_schur_solve")
PROJECTION = ("linearize_projection", "linearize_proj_rows", "proj_rows", "proj_normal")
OUTSIDE_LM = "outside the LM (unpack, preintegration, triangulation, gauge, the gate)"
# The factor kernels launch through ctypes, so the profiler links them to no
# op: their device time goes to a part by the kernel's name (cost modes:
# proj_rows_kernel<T, false>, imu_rows_kernel<T, false>).
KERNEL_PARTS = {"proj_rows_kernel<float, true>": "projection",
                "proj_rows_kernel<double, true>": "projection",
                "proj_rows_kernel<float, false>": "cost", "proj_rows_kernel<double, false>": "cost",
                "proj_normal_kernel": "projection",
                "imu_rows_kernel<float, true>": "imu and prior",
                "imu_rows_kernel<double, true>": "imu and prior",
                "imu_rows_kernel<float, false>": "cost", "imu_rows_kernel<double, false>": "cost",
                "imu_normal_kernel": "imu and prior"}
# The ranges the factor wrappers open around a launch (tracing.region).
WRAPPER_RANGES = ("proj_factor::", "imu_factor::", "relo_factor::")


class annotated_solver:
    """Within the ``with``, the solver's functions (and the estimator's
    lm_solve) run inside record_function ranges "solve::<name>"."""

    def __enter__(self):
        import torch
        from lfvio_tpu_torch.backend import solver
        from lfvio_tpu_torch.runtime import estimator

        def wrap(name, fn):
            def run(*a, **k):
                with torch.profiler.record_function(f"solve::{name}"):
                    return fn(*a, **k)
            return run

        self.saved = [(m, n, getattr(m, n)) for m, names in
                      ((solver, SOLVE_FUNCTIONS), (estimator, ("lm_solve",)))
                      for n in names if hasattr(m, n)]
        for m, n, fn in self.saved:
            setattr(m, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def solve_part(e):
    """The part of the solve a profiler op event belongs to."""
    chain, below, p = [], e, e.cpu_parent
    while p is not None:
        if p.name.startswith("solve::"):
            chain.append((p.name[7:], p, below))
        below, p = p, p.cpu_parent
    names = [n for n, _, _ in chain]
    if not names:
        return OUTSIDE_LM
    if "total_cost" in names:
        return "cost"
    for name, p, below in chain:  # innermost first
        if name in PROJECTION:
            return "projection"
        if name in ("linearize_imu_rows", "imu_normal", "prior_residual"):
            return "imu and prior"
        if name == "assemble_normal_equations":
            imu = [c for c in p.cpu_children if c.name == "solve::imu_normal"]
            if imu and below.time_range.start >= imu[0].time_range.start:
                return "imu and prior"
            return "projection"
        if name == "_schur_solve":
            return "schur"
    return "lm"


def solve_shares(run):
    """Run ``run()`` once under torch.profiler inside ``annotated_solver``;
    returns ({part: µs}, µs attributed, µs of every device kernel): each
    op's own device time summed by ``solve_part``, and the factor kernels'
    by KERNEL_PARTS."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with annotated_solver(), torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    parts, attributed, total = {}, 0.0, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            if e.name.startswith(("solve::", *WRAPPER_RANGES)):
                continue  # a range's span on the card's timeline, not a kernel
            us = e.time_range.elapsed_us()
            total += us
            part = KERNEL_PARTS.get(next((k for k in KERNEL_PARTS if k in e.name), None))
            if part is not None:  # a kernel launched through ctypes: no op above it
                parts[part] = parts.get(part, 0.0) + us
                attributed += us
            continue
        if e.name.startswith(WRAPPER_RANGES):
            continue  # its kernel is counted by name above
        us = e.self_device_time_total
        if us > 0:
            part = solve_part(e)
            parts[part] = parts.get(part, 0.0) + us
            attributed += us
    return parts, attributed, total


def launches_of(fn):
    """The factor kernels' launches while ``fn()`` runs (a graph's are
    counted at its replay, its conditional bodies' as often as they ran),
    and what ``fn()`` returned."""
    before = factor_launches()
    out = fn()
    return {k: v - before[k] for k, v in factor_launches().items()}, out


def replay_launches(iters, lins, relo=False):
    """The factor kernels' launches of a solve replay that ran ``iters`` LM
    iterations and ``lins`` linearizations: a normal-equation launch a
    linearization and a cost launch a cost (the initial one and one an
    iteration) of the projection, the IMU and (``relo``) the relocalization
    rows; no rows launch."""
    want = {k: 0 for k in bench.FACTOR_KERNELS}
    for k in ("proj", "imu") + (("relo",) if relo else ()):
        want[f"{k}_normal"], want[f"{k}_cost"] = lins, 1 + iters
    return want


def warm_estimator(dev, knobs):
    """A synchronous (lag 1, depth 1) pipeline in bench.py's configuration
    with ``knobs`` (bench.KNOBS), fed bench.workload's stream until its
    estimator has solved twice and holds a prior; returns the estimator."""
    import torch

    wl = bench.workload(bench.config_from_env(knobs), dev)
    _, est, pipe = wl.make(1, 1)
    for it in wl.stream:
        bench.feed(pipe, [it], wl.frames)
        if it[0] == "frame" and len(est.times) >= 2 and est.prior is not None:
            break
    pipe.flush()
    torch.cuda.synchronize()
    if not (len(est.times) >= 2 and est.prior is not None):
        raise AssertionError(f"the estimator at {knobs} did not solve twice")
    return est


def forced_solve(est):
    """A solve program of the estimator's own function captured with
    cost_tol 0 (no plateau ends its LM: every iteration up to the packed
    cap runs), in the estimator's pool; its first call captures it."""
    import dataclasses

    from lfvio_tpu_torch.device import DeviceProgram

    scfg = est.scfg

    def fn(packed, prior, chain):
        est.scfg = dataclasses.replace(scfg, cost_tol=0.0)
        try:
            return est._solve_packed_impl(packed, prior, chain)
        finally:
            est.scfg = scfg

    return DeviceProgram(fn, pool=est._pool, name="solve_forced")


# Name parts of a library's QR kernels (cuSOLVER's geqrf and its Householder
# steps, MAGMA's), none of which a MARGIN_OLD replay may run.
LIBRARY_QR = ("geqr", "larf", "orgqr", "ormqr", "cusolver", "magma", "householder")
# The record_function ranges the port opens (their spans on the card's
# timeline are profiler events too, not kernels).
RANGES = ("solve::", "marg_old::", "marg_qr::", "proj_factor::", "imu_factor::", "relo_factor::")


def graph_kernels(fn):
    """{kernel name: (launches, µs on the card)} while ``fn()`` runs once
    (a replay's, conditional bodies included), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU and not e.name.startswith(RANGES):
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


# csrc/graph_cond.cu's one-thread kernel that sets an IF node's condition
# from a device bool: launched once for each IF node a replay reaches.
COND_KERNEL = "set_condition_kernel"


def log_condition_kernel(tag, what, fn):
    """Log the set_condition_kernel launches of one replay (``fn()``) and
    their mean time on the card (torch.profiler) beside their bound, one
    byte read at the card's memory rate."""
    hits = [v for k, v in graph_kernels(fn).items() if COND_KERNEL in k]
    n = sum(c for c, _ in hits)
    mean = sum(us for _, us in hits) / max(n, 1)
    log(f"{tag} {COND_KERNEL} (csrc/graph_cond.cu) in one {what} replay under torch.profiler: "
        f"{n} launches, {mean:.3f} µs a launch on the card; bound {1e6 / PEAK_BYTES_S:.2e} µs "
        f"(one byte read)")


def program_census(est, label, trace=True):
    """The census of an estimator's programs (the solve, MARGIN_OLD,
    SECOND_NEW): nodes of each captured graph by kind, its conditional
    bodies' apart, the card's ms per replay (CUDA events, copying the inputs
    in included) of each, of the solve with every LM iteration forced to
    run (``forced_solve``, "solve_forced") and of the solve with the packed
    cap at 1 and 3 (one graph: "solve_cap1", "solve_cap3"), the LM
    iterations and
    linearizations each solve replay ran, the factor kernels' launches in
    one replay of the solve and of MARGIN_OLD, and (``trace``) the shares
    of one eager solve's device time by part (``solve_shares``). Returns a
    dict."""
    import torch

    prior = est.prior if est.prior is not None else est._empty_prior()
    chain = est._zero_chain()
    packed = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0]))
    cap = est.cfg.max_iterations
    solve, forced = est._program(("solve",)), forced_solve(est)
    capped = {f"solve_cap{k}": packed_at(est, k) for k in (1, 3)}
    ran = {"solve_forced": tuple(int(x) for x in forced(packed, prior, chain)[0]["lm_runs"])}
    for name, p in capped.items():
        ran[name] = tuple(int(x) for x in solve(p, prior, chain)[0]["lm_runs"])
    res, grid = solve(packed, prior, chain)
    ran["solve"] = tuple(int(x) for x in res["lm_runs"])
    marg_args = (res["out"], grid, res["pre"], res["sqrt_info"], res["imu_ok"], prior)
    marg_old, marg_new = est._program(("marg_old",)), est._program(("marg_new",))
    ms = {"solve": cuda_ms(lambda: solve(packed, prior, chain), n=5, warmup=1),
          "solve_forced": cuda_ms(lambda: forced(packed, prior, chain), n=5, warmup=1),
          **{k: cuda_ms(lambda p=p: solve(p, prior, chain), n=5, warmup=1)
             for k, p in capped.items()},
          "marg_old": cuda_ms(lambda: marg_old(*marg_args), n=5, warmup=1),
          "marg_new": cuda_ms(lambda: marg_new(res["out"], prior), n=5, warmup=1)}
    per_replay = {"solve": launches_of(lambda: solve(packed, prior, chain))[0],
                  "solve_forced": launches_of(lambda: forced(packed, prior, chain))[0],
                  "marg_old": launches_of(lambda: marg_old(*marg_args))[0],
                  "marg_new": launches_of(lambda: marg_new(res["out"], prior))[0]}
    qr_kernels = {n: c for n, (c, _) in graph_kernels(lambda: marg_old(*marg_args)).items()}
    log_condition_kernel(f"[14] census {label}:", "solve", lambda: solve(packed, prior, chain))
    nodes = {k: graph_nodes(p) for k, p in
             (("solve", solve), ("marg_old", marg_old), ("marg_new", marg_new))}
    F, W1 = grid.valid.shape
    obs = F * W1
    parts, attributed, total, trace_s = {}, 0.0, 0.0, 0.0
    if trace:
        run = lambda: est._solve_packed_impl(packed, prior, chain)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts, attributed, total = solve_shares(run)
        trace_s = time.perf_counter() - t0
    order = sorted(parts, key=lambda k: -parts[k])
    log(f"[14] census {label}: {F} slots x {W1} frames = {obs} observations, cap {cap}; nodes "
        + "; ".join(f"{k} " + ", ".join(f"{n} {c}" for n, c in v.items()) for k, v in nodes.items())
        + "; ms per replay " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + "; LM iterations and linearizations run a replay " + ", ".join(
            f"{k} {v}" for k, v in ran.items())
        + "; factor kernels' launches per replay " + ", ".join(
            f"{k} {v}" for k, v in per_replay.items())
        + f"; the estimator's solves so far: {lm_run_counts(est.lm_runs)}")
    log(f"[14] census {label}: one MARGIN_OLD replay under torch.profiler ran "
        f"{sum(qr_kernels.values())} kernels of {len(qr_kernels)} names: "
        + ", ".join(f"{n} x{c}" for n, c in sorted(qr_kernels.items())))
    library = [n for n in qr_kernels if any(w in n.lower() for w in LIBRARY_QR)]
    if library:
        raise AssertionError(f"census {label}: MARGIN_OLD ran a library QR kernel: {library}")
    seen = {k: sum(c for n, c in qr_kernels.items() if f"{k}_kernel<" in n) for k in MARG_KERNELS}
    if seen != {k: 1 for k in MARG_KERNELS}:
        raise AssertionError(f"census {label}: the profiled MARGIN_OLD replay recorded the "
                             f"marginalization kernels {seen} times, not once each")
    if trace:
        log(f"[14] census {label}: one eager solve traced ({trace_s:.1f} s), {total / 1e3:.3f} ms "
            f"of device kernels, {attributed / 1e3:.3f} ms attributed to ops: "
            + ", ".join(f"{k} {parts[k] / 1e3:.3f} ms "
                        f"({100 * parts[k] / max(attributed, 1e-9):.1f}%)" for k in order))
    return dict(obs=obs, ms=ms, nodes=nodes, parts_us=parts, attributed_us=attributed,
                device_us=total, per_replay=per_replay, ran=ran, est=est,
                marg_args=(*marg_args, est._gravity_t, est.scfg))


# ------------------------------------------------ phase 14: the projection kernels
# csrc/proj_factor.cu against its plain version (backend/proj_cuda.py) on
# the same inputs, relative to each output's scale. The residual's is
# sqrt_info: r = s B (u - m̂) is a difference of two terms of size s, so
# either version rounds it to about eps s, however small r is (in f32 a
# 1 px residual carries 6e-6 of itself). What is computed from r inherits
# that scale: a cost term's is its value with |r| + s for |r|; the weight's
# is s times its steepest slope in r, 2 / (3 sqrt(3) c); each sum's (H_pp,
# b_p, H_pl, H_ll, b_l) is the largest sum of its terms' magnitudes, |J|
# against |r| + s (the plain assembly of |J26| and |res| + s), which the
# rounding of a sum in any order is relative to; the Jacobian's is its
# largest magnitude. f32: rounding and sums in another order; f64: a few
# roundings. (Held against |J| |r| alone, b_l missed 1e-5
# in f32 on a window of 1 px residuals, at 1.37e-5.)
PROJ_BOUNDS = {"float32": 1e-5, "float64": 1e-12}
# Operations a kept observation costs each kernel, reckoned from the
# kernel's arithmetic: the rows (the four rotation matrices, the chain, the
# basis, G and its four products, the four skew products, λ and td) about
# 750; the cost mode about 330; the normal equations the rows and their
# assembly, a row of 26 columns into JᵀJ, Jᵀr and H_pl, 4 (26² + 2 · 26).
PROJ_FLOPS = {"proj_rows": 750, "proj_normal": 750 + 4 * (26 * 26 + 2 * 26), "proj_cost": 330}
REPLACES.update({
    "proj_rows": "lfvio_tpu/backend/solver.py:126, :184 (linearize_projection: jacfwd + vmap, "
                 "and linearize_proj_rows' dense rows for MARGIN_OLD; XLA, no Pallas kernel)",
    "proj_normal": "lfvio_tpu/backend/solver.py:287 (assemble_normal_equations' projection "
                   "terms: the rows of :126 and their JᵀJ; XLA, no Pallas kernel)",
    "proj_cost": "lfvio_tpu/backend/solver.py:326 (total_cost's projection term; XLA, no Pallas "
                 "kernel)"})
SOURCES.update({k: "lfvio_tpu_torch/csrc/proj_factor.cu"
                for k in PROJ_FLOPS})


def solve_inputs(est):
    """(state, grid, cfg) of the estimator's next solve, as its program
    unpacks them on the card."""
    packed = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0]))
    state, grid = est._unpack(packed)[:2]
    return state, grid, est.scfg


def dual_camera_inputs(dev, n_slots=64):
    """make_window_problem(64) in f64 turned into a two-camera window: a
    second extrinsic, a random camera per observation (tracks mix cameras),
    tracks of 5 frames from varied anchors, td and extrinsics estimated."""
    import dataclasses as dc

    import torch
    from lfvio_tpu_torch.geom import so3_exp
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    pb = make_window_problem(n_slots, torch.float64, n_obs_frames=5, device=dev)
    rng = np.random.default_rng(11)
    tt = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)
    st, grid = pb["state"], pb["grid"]
    state = dc.replace(st, tic=tt([[0.01, -0.02, 0.005], [-0.015, 0.03, -0.04]]),
                       qic=so3_exp(tt(0.02 * rng.standard_normal((2, 3)))), td=tt(0.003))
    cam = tt(rng.integers(0, 2, tuple(grid.valid.shape)), torch.int64)
    return state, grid.replace(cam=cam), dc.replace(pb["cfg"], n_cams=2)


def proj_outputs(state, grid, cfg, plain=False, kernels=None):
    """Every output of the three kernels, {name: tensor}: the kernels' (with
    ``kernels``, {"proj_rows", "proj_cost": callable}, other wrappers of the
    rows and cost launches) or (``plain``) their plain versions'."""
    from lfvio_tpu_torch.backend import proj_cuda as pc
    from lfvio_tpu_torch.backend.state import n_cams_of

    C = n_cams_of(state)
    if plain:
        rows, normal = pc.rows_plain(state, grid, cfg), pc.normal_plain(state, grid, cfg, C)
        cost = pc.cost_plain(state, grid, cfg)
    else:
        k = kernels or {"proj_rows": pc.proj_rows, "proj_cost": pc.proj_cost}
        rows, normal = k["proj_rows"](state, grid, cfg), pc.proj_normal(state, grid, cfg, C)
        cost = k["proj_cost"](state, grid, cfg)
    return dict(zip(PROJ_OUTPUTS, (*rows, *normal, cost)))


# The outputs of proj_outputs, and the kernel each comes from.
PROJ_OUTPUTS = {"res": "proj_rows", "J26": "proj_rows", "w": "proj_rows",
                "cost terms": "proj_rows", "H_pp": "proj_normal", "H_pl": "proj_normal",
                "H_ll": "proj_normal", "b_p": "proj_normal", "b_l": "proj_normal",
                "normal cost terms": "proj_normal", "cost mode": "proj_cost"}


def proj_scales(state, grid, cfg, p):
    """{output name: its scale} (the note above PROJ_BOUNDS) from the plain
    versions' outputs ``p`` (proj_outputs(..., plain=True))."""
    import torch
    from lfvio_tpu_torch.backend import proj_cuda as pc
    from lfvio_tpu_torch.backend.state import n_cams_of

    s = float(cfg.proj_sqrt_info)
    r_scale = p["res"].abs() + s
    absum = dict(zip(("H_pp", "H_pl", "H_ll", "b_p", "b_l"), pc.assemble_plain(
        grid, (r_scale, p["J26"].abs(), p["w"]), cfg, n_cams_of(state))))
    top = lambda x: max(float(x.abs().max()), 1e-30) if x.numel() else 1.0
    c2 = cfg.cauchy_c ** 2
    cost_scale = top(c2 * torch.log1p((r_scale * r_scale).sum(-1) / c2))
    w_scale = s * 2.0 / (3.0 * 3.0 ** 0.5 * cfg.cauchy_c)
    return {"res": s, "J26": top(p["J26"]), "w": w_scale, "cost terms": cost_scale,
            "normal cost terms": cost_scale, "cost mode": cost_scale,
            **{n: top(absum[n]) for n in absum}}


def proj_compare(state, grid, cfg, kernels=None):
    """(errors relative to each output's scale, {kernel: (largest absolute
    error, largest relative error) of its outputs}, a repeat of the kernels
    bit-identical); ``kernels`` as ``proj_outputs``'."""
    import torch

    k = proj_outputs(state, grid, cfg, kernels=kernels)
    p = proj_outputs(state, grid, cfg, plain=True)
    again = proj_outputs(state, grid, cfg, kernels=kernels)
    identical = all(torch.equal(k[n], again[n]) for n in k)
    scale = proj_scales(state, grid, cfg, p)
    errs, mode_err = {}, {}
    for n in k:
        d = float((k[n] - p[n]).abs().max()) if k[n].numel() else 0.0
        errs[n] = d / scale[n]
        mode = PROJ_OUTPUTS[n]
        a, r = mode_err.get(mode, (0.0, 0.0))
        mode_err[mode] = (max(a, d), max(r, errs[n]))
    return errs, mode_err, identical


def proj_bound_ms(state, grid, mode):
    """The least time of one launch of ``mode`` (a key of PROJ_FLOPS) on an
    H100 at these inputs: its inputs (the state, the grid and its masks)
    read once and its outputs written once at 3.35 TB/s, against PROJ_FLOPS
    a kept observation at the float32 rate; (ms, by, bytes, FLOP)."""
    from lfvio_tpu_torch.backend.factors import residual_mask

    F, W1 = grid.valid.shape
    C = 1 if state.tic.ndim == 1 else state.tic.shape[0]
    e = state.p.element_size()
    D = 15 * W1 + 6 * C + 1
    masks = F * W1 + F * 8 + F + (F * W1 * 8 if grid.cam is not None else 0)
    state_in = e * (7 * W1 + 7 * C + 1 + F + F * W1 * 7)
    out = {"proj_rows": F * W1 * 56, "proj_cost": F * W1,
           "proj_normal": D * D + D + D * F + 2 * F + F * W1}[mode]
    nbytes = masks + state_in + e * out
    flops = PROJ_FLOPS[mode] * int(residual_mask(grid).sum())
    t_b, t_o = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / PEAK_F32_FLOPS
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, flops


def phase_proj_factor(dev, est_a, est_b):
    """The projection kernels against their plain version at (a) phase 4's
    estimator's solve inputs (256 slots, window 10, f32), (b) the
    high-rate estimator's (384 slots, window 20, f32) and a dual-camera
    window (64 slots, f64, td and extrinsics estimated), within PROJ_BOUNDS,
    a repeat bit-identical; each kernel's times behind a full queue and
    launched alone, beside its plain version's and its bound, at (a) and
    (b), and the anchors of (a)'s and (b)'s features, which proj_normal's
    tiles enumerate. Returns the kernels line's numbers: times at (a),
    bench.py's default; errors the worst of (a) and (b), absolute and
    relative to each output's scale, beside the f32 bound."""
    import torch
    from lfvio_tpu_torch.backend import proj_cuda as pc
    from lfvio_tpu_torch.backend.factors import residual_mask
    from lfvio_tpu_torch.backend.state import n_cams_of

    cases = {"(a) 256 slots, window 10, f32": solve_inputs(est_a),
             "(b) 384 slots, window 20, f32": solve_inputs(est_b),
             "dual-camera 64 slots, f64": dual_camera_inputs(dev)}
    worst = {}
    for label, (state, grid, cfg) in cases.items():
        errs, mode_err, identical = proj_compare(state, grid, cfg)
        bound = PROJ_BOUNDS[str(state.p.dtype).split(".")[-1]]
        log(f"[14p] proj_factor {label} against the plain version, relative to each output's "
            f"scale: " + ", ".join(f"{n} {v:.2e}" for n, v in errs.items())
            + f" (bound {bound}); repeat bit-identical {identical}")
        if not (identical and all(v <= bound for v in errs.values())):
            raise AssertionError(f"proj_factor disagrees with its plain version at {label}")
        if state.p.dtype == torch.float32:
            for m, (a, r) in mode_err.items():
                wa, wr = worst.get(m, (0.0, 0.0))
                worst[m] = (max(wa, a), max(wr, r))
    block = make_blocker(dev)
    out = {}
    for label, (state, grid, cfg) in list(cases.items())[:2]:
        C = n_cams_of(state)
        F, W1 = grid.valid.shape
        kept = residual_mask(grid)
        anchors = torch.bincount(grid.anchor[grid.used & (grid.anchor >= 0)], minlength=W1)
        log(f"[14p] {label}: {int(grid.used.sum())} of {F} slots used, {int(kept.sum())} kept "
            f"observations; used features by anchor frame {anchors.tolist()}")
        runs = {"proj_rows": (lambda: pc.proj_rows(state, grid, cfg),
                              lambda: pc.rows_plain(state, grid, cfg)),
                "proj_normal": (lambda: pc.proj_normal(state, grid, cfg, C),
                                lambda: pc.normal_plain(state, grid, cfg, C)),
                "proj_cost": (lambda: pc.proj_cost(state, grid, cfg),
                              lambda: pc.cost_plain(state, grid, cfg))}
        for mode, (kern, plain) in runs.items():
            ms = cuda_ms(kern, reps=10, blocker=block)
            alone = cuda_ms(kern)
            floor = {}
            if mode != "proj_normal":
                empty = lambda: pc.latency_floor(mode, state, grid, cfg)
                floor = dict(floor_ms=cuda_ms(empty, reps=10, blocker=block))
                log(f"[14p] {mode} {label}: latency floor (the empty kernel, same grid, block and "
                    f"launch path) {floor['floor_ms']:.4f} ms behind a full queue, "
                    f"{cuda_ms(empty):.4f} ms alone")
            plain_ms = cuda_ms(plain, reps=3, blocker=block)
            bound, by, nbytes, flops = proj_bound_ms(state, grid, mode)
            log(f"[14p] {mode} {label}: {ms:.4f} ms behind a full queue, {alone:.4f} ms launched "
                f"alone; plain version {plain_ms:.4f} ms; bound {bound:.6f} ms by {by} "
                f"({nbytes} B, {flops / 1e6:.3f} MFLOP); at {100 * bound / ms:.2f}% of it")
            if label.startswith("(a)"):
                out[mode] = dict(max_abs_err=worst[mode][0], max_rel_err=worst[mode][1],
                                 rel_bound=PROJ_BOUNDS["float32"], ms=ms, ms_launched_alone=alone,
                                 **floor, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                 library_ms=None)
    return out


# ------------------------------------------------ phase 14: the IMU kernels
# csrc/imu_factor.cu against its plain version (backend/imu_cuda.py) on the
# same inputs, each output's error over its scale: the magnitude m such that
# either version's rounding is about eps m. A raw residual row is a
# difference of terms far larger than itself (r_p: R_iᵀ a - Δp', with a = ½ g
# T² + p_j - p_i - v_i T; r_v likewise; r_q: 2 vec of a product of unit
# quaternions), so either version rounds it to about eps times those terms'
# magnitudes m; whitened, entry i to eps r_s,i with r_s = |sqrt_info| m. So
# r_w is held entry by entry against r_s; interval w's |r_w|² (both cost
# outputs) against Σ_i r_i² + 2 |r_i| r_s,i + eps r_s,i² (its own rounding,
# the residual's carried through the square, and their product), interval by
# interval; J30 against the largest entry of J_s = |sqrt_info| |J_raw|; H_pp
# against the largest of J_sᵀ J_s over the dense rows; b_p against the
# largest of |J|ᵀ r_s + J_sᵀ |r|. An entry whose scale is 0 (an invalid
# interval) must be 0 in both. f32: rounding and sums in another order; f64:
# a few roundings. ``imu_planted_faults`` holds the check against outputs a
# faulty kernel would give (a zero cost, a dropped interval, r_q's sign
# flipped), which it must reject.
IMU_BOUNDS = {"float32": 2e-6, "float64": 1e-14}
# Operations a valid interval costs each kernel, reckoned from the kernel's
# arithmetic: the raw rows (the rotation, a and b, the bias-corrected deltas,
# the quaternion products of r_q and its nine columns) about 500, and their
# whitening by the lower-triangular sqrt_info (whiten_covariance: Linv D⁻¹,
# 120 entries), 2 · 120 a column over 31 columns; the cost mode the raw
# residual (about 300), its whitening and its square; the normal equations
# the rows, the 465 distinct entries of the symmetric 30 x 30 JᵀJ over 15
# rows and Jᵀr (30 · 2 · 15).
IMU_FLOPS = {"imu_rows": 500 + 2 * 120 * 31, "imu_cost": 300 + 2 * 120 + 2 * 15,
             "imu_normal": 500 + 2 * 120 * 31 + 465 * 2 * 15 + 30 * 2 * 15 + 2 * 15}
REPLACES.update({
    "imu_rows": "lfvio_tpu/backend/solver.py:241 (linearize_imu_rows: jacfwd + vmap of "
                "_imu_local_residual :107, the dense rows MARGIN_OLD stacks; XLA, no Pallas "
                "kernel)",
    "imu_normal": "lfvio_tpu/backend/solver.py:308 (assemble_normal_equations' IMU terms: the "
                  "rows of :241 and their JᵀJ; XLA, no Pallas kernel)",
    "imu_cost": "lfvio_tpu/backend/solver.py:336 (total_cost's IMU term, factors.py:158 "
                "imu_residuals_window; XLA, no Pallas kernel)"})
SOURCES.update({k: "lfvio_tpu_torch/csrc/imu_factor.cu" for k in IMU_FLOPS})
# The outputs of imu_outputs, and the kernel each comes from.
IMU_OUTPUTS = {"r_w": "imu_rows", "J30": "imu_rows", "H_pp": "imu_normal", "b_p": "imu_normal",
               "normal cost terms": "imu_normal", "cost mode": "imu_cost"}


def imu_solve_inputs(est):
    """(state, pre, sqrt_info, imu_valid, gravity) of the estimator's next
    solve as its program computes them on the card (unpack, preintegrate at
    the state's biases, whiten)."""
    from lfvio_tpu_torch.imu import preintegrate, whiten_covariance

    packed = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0]))
    state, _, imu = est._unpack(packed)[:3]
    pre = preintegrate(*imu[:5], state.ba[:-1], state.bg[:-1], est.cfg.imu_noise)
    si, ok = whiten_covariance(pre.covariance, imu[5])
    return state, pre, si, ok, est._gravity_t


def imu_window(dev, dtype, W1, seed=0, invalid=1):
    """A window of W1 frames along a curve on the card in ``dtype``: 16 IMU
    samples an interval (200 Hz), preintegrated at biases 0.05 (ba) and 0.01
    (bg) standard deviations away from the state's, so that the solve's
    off-linearization case is exercised, and interval ``invalid`` invalid
    (None: every interval valid).
    Returns (state, pre, sqrt_info, imu_valid, gravity)."""
    import torch
    from lfvio_tpu_torch.backend.state import WindowState
    from lfvio_tpu_torch.geom import so3_exp
    from lfvio_tpu_torch.imu import ImuNoise, preintegrate, whiten_covariance

    rng = np.random.default_rng(seed)
    tt = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    t = np.linspace(0.0, 0.08 * (W1 - 1), W1)
    p = np.stack([t, 0.2 * np.sin(t), 0.1 * t], -1) + 0.01 * rng.standard_normal((W1, 3))
    theta = np.stack([0.05 * np.sin(3 * t), 0.1 * t, 0.1 * np.cos(2 * t)], -1)
    S, W = 16, W1 - 1
    ba, bg = 0.02 * rng.standard_normal((W1, 3)), 0.002 * rng.standard_normal((W1, 3))
    state = WindowState(
        p=tt(p), q=so3_exp(tt(theta)), v=tt(0.5 * rng.standard_normal((W1, 3))), ba=tt(ba),
        bg=tt(bg), tic=tt(np.zeros(3)), qic=tt([1.0, 0.0, 0.0, 0.0]), td=tt(0.0),
        inv_depth=tt(np.ones(4)))
    accs = np.array([0.0, 0.0, 9.81]) + 0.2 * rng.standard_normal((W, S, 3))
    gyrs = 0.1 * rng.standard_normal((W, S, 3))
    lba = ba[:-1] + 0.05 * rng.standard_normal((W, 3))
    lbg = bg[:-1] + 0.01 * rng.standard_normal((W, 3))
    pre = preintegrate(tt(np.full((W, S), 0.005)), tt(accs), tt(gyrs), tt(accs[:, 0]),
                       tt(gyrs[:, 0]), tt(lba), tt(lbg), ImuNoise(0.08, 0.004, 0.00004, 2e-6))
    valid = torch.ones(W, dtype=torch.bool, device=dev)
    if invalid is not None:
        valid[invalid] = False
    si, ok = whiten_covariance(pre.covariance, valid)
    return state, pre, si, ok, tt([0.0, 0.0, 9.81])


def imu_outputs(args, plain=False, kernels=None):
    """Every output of the three kernels at ``args`` (state, pre, sqrt_info,
    imu_valid, gravity), {name: tensor}: the kernels' (``kernels``: other
    wrappers, {"imu_rows", "imu_cost", "imu_normal": callable}) or
    (``plain``) their plain versions'; imu_normal's sums added into zeros."""
    import torch
    from lfvio_tpu_torch.backend import imu_cuda as ic
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

    state = args[0]
    D = pose_dim(state.p.shape[0], n_cams_of(state))
    z = lambda *shape: torch.zeros(shape, dtype=state.p.dtype, device=state.p.device)
    if plain:
        rows, cost = ic.imu_rows_plain(*args), ic.imu_cost_plain(*args)
        normal = ic.imu_normal_plain(z(D, D), z(D), *args)
    else:
        k = kernels or {"imu_rows": ic.imu_rows, "imu_cost": ic.imu_cost,
                        "imu_normal": ic.imu_normal}
        rows, cost = k["imu_rows"](*args), k["imu_cost"](*args)
        normal = k["imu_normal"](z(D, D), z(D), *args)
    return dict(zip(IMU_OUTPUTS, (*rows, *normal, cost)))


def imu_raw(args):
    """The plain version's raw (unwhitened) rows at ``args``: (r [W, 15],
    J [W, 15, 30])."""
    import torch
    from lfvio_tpu_torch.backend.factors import imu_jacobian

    state, pre, si, _, g = args
    i, j = slice(None, -1), slice(1, None)
    eye = torch.eye(15, dtype=si.dtype, device=si.device).expand_as(si)
    return imu_jacobian(pre, eye, state.p[i], state.q[i], state.v[i], state.ba[i], state.bg[i],
                        state.p[j], state.q[j], state.v[j], state.ba[j], state.bg[j], g)


def imu_scales(args):
    """{output name: its scale} (the note above IMU_BOUNDS) at ``args``: a
    number, or a tensor for an output held entry by entry (r_w [W, 15])
    or interval by interval (the cost outputs, [W])."""
    import torch
    from lfvio_tpu_torch.backend import imu_cuda as ic
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim
    from lfvio_tpu_torch.imu.preintegration import bias_corrected_delta

    state, pre, si, ok, g = args
    i, j = slice(None, -1), slice(1, None)
    n = lambda x: torch.linalg.norm(x, dim=-1, keepdim=True).expand(*x.shape[:-1], 3)
    dt = pre.sum_dt[:, None]
    dp, _, dv = bias_corrected_delta(pre, state.ba[i], state.bg[i])
    mags = torch.cat([
        n(0.5 * g * dt * dt) + n(state.p[j]) + n(state.p[i]) + n(state.v[i]) * dt + n(dp),
        torch.full_like(dp, 2.0),
        n(g * dt) + n(state.v[j]) + n(state.v[i]) + n(dv),
        n(state.ba[j]) + n(state.ba[i]), n(state.bg[j]) + n(state.bg[i])], dim=-1)
    _, J_raw = imu_raw(args)
    r, J = ic.imu_rows_plain(*args)
    keep = lambda x: torch.where(ok.reshape(-1, *[1] * (x.ndim - 1)), x, 0.0)
    r_s = keep((si.abs() @ mags[..., None])[..., 0])
    J_s = keep(si.abs() @ J_raw.abs())
    D = pose_dim(state.p.shape[0], n_cams_of(state))
    Jd, Ja = ic.dense_rows(J_s, D), ic.dense_rows(J.abs(), D)
    top = lambda x: max(float(x.abs().max()), 1e-30)
    eps = torch.finfo(r.dtype).eps
    cost = (r * r + 2.0 * r.abs() * r_s + eps * r_s * r_s).sum(-1)
    return {"r_w": r_s, "J30": top(J_s), "H_pp": top(Jd.T @ Jd),
            "b_p": top(Ja.T @ r_s.reshape(-1) + Jd.T @ r.abs().reshape(-1)),
            "normal cost terms": cost, "cost mode": cost}


# The cost outputs held against the same run's rows as well: each interval's
# cost against Σ r_w² of imu_rows' r_w, relative to that sum (the residual
# is held against the plain version's above; this leaves the square and its
# sum, which rounds to a few eps of it). {name: (cost output, its kernel)}.
IMU_SELF = {"normal cost terms against the rows": ("normal cost terms", "imu_normal"),
            "cost mode against the rows": ("cost mode", "imu_cost")}


def imu_errors(outs, ref, scale):
    """{output name: the largest |outs - ref| over its scale}: entry by entry
    where the scale is a tensor (an entry of scale 0 must agree exactly);
    then IMU_SELF's: each cost output of ``outs`` against Σ r_w² of its
    r_w, interval by interval."""
    import torch

    def rel(x, y, s):
        d = (x - y).abs()
        if not isinstance(s, torch.Tensor):
            return float(d.max()) / s
        s = s.expand_as(d)
        return float(torch.where(s > 0, d / torch.where(s > 0, s, 1.0),
                                 torch.where(d > 0, np.inf, 0.0)).max())

    errs = {name: rel(outs[name], ref[name], scale[name]) for name in ref}
    rr = (outs["r_w"] * outs["r_w"]).sum(-1)
    errs.update({name: rel(outs[of], rr, rr) for name, (of, _) in IMU_SELF.items()})
    return errs


def imu_compare(args, kernels=None):
    """(errors relative to each output's scale, {kernel: (largest absolute
    error, largest relative error) of its outputs}, a repeat of the kernels
    bit-identical) at ``args`` (state, pre, sqrt_info, imu_valid, gravity);
    ``kernels`` as ``imu_outputs``'."""
    import torch

    k, p = imu_outputs(args, kernels=kernels), imu_outputs(args, plain=True)
    again = imu_outputs(args, kernels=kernels)
    identical = all(torch.equal(k[n], again[n]) for n in k)
    errs = imu_errors(k, p, imu_scales(args))
    mode_err = {}
    for n in errs:
        mode = IMU_OUTPUTS[n] if n in IMU_OUTPUTS else IMU_SELF[n][1]
        d = float((k[n] - p[n]).abs().max()) if n in IMU_OUTPUTS else 0.0
        a, r = mode_err.get(mode, (0.0, 0.0))
        mode_err[mode] = (max(a, d), max(r, errs[n]))
    return errs, mode_err, identical


# A planted fault, and the outputs whose check must reject it on its own.
IMU_FAULT_OUTPUTS = {"cost 0": tuple(IMU_SELF),
                     "least-cost interval dropped": ("J30", "H_pp"),
                     "r_q's sign flipped": ("r_w",)}


def imu_planted_faults(args):
    """{fault: {output name: its error over its scale}}: the plain
    version's outputs at ``args`` against those a kernel with each fault of
    IMU_FAULT_OUTPUTS would give (a zero cost; the valid interval of least
    cost left out; the raw r_q rows negated before the whitening)."""
    import torch
    from lfvio_tpu_torch.backend import imu_cuda as ic
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

    state, pre, si, ok, g = args
    p = imu_outputs(args, plain=True)
    cost = p["cost mode"]
    faults = {"cost 0": {**p, "normal cost terms": torch.zeros_like(cost),
                         "cost mode": torch.zeros_like(cost)}}
    drop = ok.clone()
    drop[int(torch.where(ok, cost, np.inf).argmin())] = False
    faults["least-cost interval dropped"] = imu_outputs((state, pre, si, drop, g), plain=True)
    r_raw, _ = imu_raw(args)
    flip = torch.ones(15, dtype=r_raw.dtype, device=r_raw.device)
    flip[3:6] = -1.0
    r_f = torch.where(ok[:, None], (si @ (flip * r_raw)[..., None])[..., 0], 0.0)
    D = pose_dim(state.p.shape[0], n_cams_of(state))
    c_f = (r_f * r_f).sum(-1)
    faults["r_q's sign flipped"] = {**p, "r_w": r_f, "b_p": ic.dense_rows(p["J30"], D).T
                                    @ r_f.reshape(-1), "normal cost terms": c_f, "cost mode": c_f}
    scale = imu_scales(args)
    return {name: imu_errors(f, p, scale) for name, f in faults.items()}


def imu_bound_ms(args, mode):
    """The least time of one launch of ``mode`` (a key of IMU_FLOPS) on an
    H100 at ``args``: what the function needs read once and written once at
    3.35 TB/s (the state; a interval's Δp, Δq, Δv, the 45 entries of the
    preintegration's Jacobian the residual uses (J_p,ba, J_p,bg, J_v,ba,
    J_v,bg, J_q,bg), Σdt, the linearization biases and the 120 entries of
    the lower-triangular sqrt_info; gravity; imu_valid; imu_normal: the
    entries of H_pp and b_p it adds to, read and written), against
    IMU_FLOPS a valid interval at the float32 rate; (ms, by, bytes, FLOP)."""
    state, ok = args[0], args[3]
    W1 = state.p.shape[0]
    W = W1 - 1
    e = state.p.element_size()
    ins = e * (16 * W1 + W * (3 + 4 + 3 + 45 + 1 + 3 + 3 + 120) + 3) + W
    out = {"imu_rows": e * W * 15 * 31, "imu_cost": e * W,
           "imu_normal": e * (2 * (225 * W1 + 2 * 225 * W + 15 * W1) + W)}[mode]
    nbytes = ins + out
    flops = IMU_FLOPS[mode] * int(ok.sum())
    t_b, t_o = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / PEAK_F32_FLOPS
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, flops


def moved_biases(args, seed=0):
    """``args`` with the state's ba and bg moved after the preintegration,
    as an LM step moves them inside a solve (0.05 and 0.01 standard
    deviations), so that the bias correction's normalization term counts."""
    import dataclasses as dc

    import torch

    state = args[0]
    rng = np.random.default_rng(seed)
    tt = lambda sd: torch.as_tensor(sd * rng.standard_normal(state.ba.shape),
                                    dtype=state.ba.dtype, device=state.ba.device)
    return (dc.replace(state, ba=state.ba + tt(0.05), bg=state.bg + tt(0.01)), *args[1:])


def phase_imu_factor(dev, est_a, est_b):
    """The IMU kernels against their plain version at (a) phase 4's
    estimator's solve inputs (window 10, f32), (b) the high-rate estimator's
    (window 20, f32), each also with its biases moved after the
    preintegration (``moved_biases``), and a two-camera f64 window
    (``imu_window`` with ``dual_camera_inputs``' extrinsics) with its biases
    off the preintegration's linearization point and one interval invalid,
    within IMU_BOUNDS, a repeat bit-identical; at each, the planted faults
    of IMU_FAULT_OUTPUTS rejected by the outputs named there; each kernel's
    times behind a full queue and launched alone, beside its latency floor
    (``imu_cuda.latency_floor``), its plain version's and its bound, at (a)
    and (b). Returns the kernels line's
    numbers: times at (a); errors the worst of the f32 cases, absolute and
    relative to each output's scale."""
    import dataclasses as dc

    import torch
    from lfvio_tpu_torch.backend import imu_cuda as ic
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

    dual_state = dual_camera_inputs(dev)[0]
    w_state, *w_rest = imu_window(dev, torch.float64, dual_state.p.shape[0])
    a, b = imu_solve_inputs(est_a), imu_solve_inputs(est_b)
    timed = {"(a) window 10, f32": a, "(b) window 20, f32": b}
    cases = {**timed, "(a), biases moved": moved_biases(a), "(b), biases moved": moved_biases(b),
             "two-camera window 10, f64, biases off the linearization point, interval 1 invalid":
             (dc.replace(w_state, tic=dual_state.tic, qic=dual_state.qic), *w_rest)}
    worst = {}
    for label, args in cases.items():
        errs, mode_err, identical = imu_compare(args)
        bound = IMU_BOUNDS[str(args[0].p.dtype).split(".")[-1]]
        log(f"[14i] imu_factor {label} against the plain version, relative to each output's "
            f"scale: " + ", ".join(f"{n} {v:.2e}" for n, v in errs.items())
            + f" (bound {bound}); repeat bit-identical {identical}; valid intervals "
            f"{int(args[3].sum())} of {args[3].numel()}")
        if not (identical and all(v <= bound for v in errs.values())):
            raise AssertionError(f"imu_factor disagrees with its plain version at {label}")
        for fault, fe in imu_planted_faults(args).items():
            log(f"[14i] planted fault at {label}, {fault}: " + ", ".join(
                f"{n} {v:.2e}" for n, v in fe.items()) + f" (must exceed {bound}: "
                + ", ".join(IMU_FAULT_OUTPUTS[fault]) + ")")
            if not all(fe[n] > bound for n in IMU_FAULT_OUTPUTS[fault]):
                raise AssertionError(f"the IMU check does not see '{fault}' at {label}")
        if args[0].p.dtype == torch.float32:
            for m, (ae, re) in mode_err.items():
                wa, wr = worst.get(m, (0.0, 0.0))
                worst[m] = (max(wa, ae), max(wr, re))
    block = make_blocker(dev)
    out = {}
    for label, args in timed.items():
        state = args[0]
        D = pose_dim(state.p.shape[0], n_cams_of(state))
        H = torch.zeros((D, D), dtype=state.p.dtype, device=dev)
        bp = torch.zeros(D, dtype=state.p.dtype, device=dev)
        runs = {"imu_rows": (lambda: ic.imu_rows(*args), lambda: ic.imu_rows_plain(*args)),
                "imu_normal": (lambda: ic.imu_normal(H, bp, *args),
                               lambda: ic.imu_normal_plain(H, bp, *args)),
                "imu_cost": (lambda: ic.imu_cost(*args), lambda: ic.imu_cost_plain(*args))}
        for mode, (kern, plain) in runs.items():
            ms = cuda_ms(kern, reps=10, blocker=block)
            alone = cuda_ms(kern)
            empty = lambda: ic.latency_floor(mode, *args)
            floor, floor_alone = cuda_ms(empty, reps=10, blocker=block), cuda_ms(empty)
            plain_ms = cuda_ms(plain, reps=3, blocker=block)
            bound, by, nbytes, flops = imu_bound_ms(args, mode)
            log(f"[14i] {mode} {label}: {ms:.4f} ms behind a full queue, {alone:.4f} ms launched "
                f"alone; latency floor (the empty kernel, same grid, block and launch path) "
                f"{floor:.4f} ms behind a full queue, {floor_alone:.4f} ms alone; plain version "
                f"{plain_ms:.4f} ms; bound {bound:.6f} ms by {by} ({nbytes} B, "
                f"{flops / 1e6:.3f} MFLOP); at {100 * bound / ms:.2f}% of it")
            if label.startswith("(a)"):
                out[mode] = dict(max_abs_err=worst[mode][0], max_rel_err=worst[mode][1],
                                 rel_bound=IMU_BOUNDS["float32"], ms=ms, ms_launched_alone=alone,
                                 floor_ms=floor, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                 library_ms=None)
    return out


# ------------------------------------------------ phase 14: the relocalization kernels
# csrc/proj_factor.cu's relo launches against their plain version
# (backend/relo_cuda.py) on the same inputs, relative to each output's scale
# as PROJ_BOUNDS holds the projection's (a relo row is a projection row):
# each sum's scale is the largest sum of its terms' magnitudes, |J| against
# |r| + s (relo_sums of |J25| and |res| + s), a cost term's its value with
# |r| + s for |r|. The sums start from zero, so each output is the relo
# rows' part alone.
RELO_BOUNDS = PROJ_BOUNDS
# Operations a kept feature costs each launch: the row (PROJ_FLOPS' rows)
# and, for relo_normal, its 24 columns into H6, b6 and H_pl6 and its λ
# column into H_ll and b_l, two residual rows each: 4 (24² + 2 · 24) + 8.
RELO_FLOPS = {"relo_normal": PROJ_FLOPS["proj_rows"] + 4 * (24 * 24 + 2 * 24) + 8,
              "relo_cost": PROJ_FLOPS["proj_cost"]}
REPLACES.update({
    "relo_normal": "lfvio_tpu/backend/relo.py:75 (linearize_relo_rows: jacfwd :108 + vmap) and "
                   ":181-202 (lm_solve_relo's sums into the D+6 system; XLA, no Pallas kernel)",
    "relo_cost": "lfvio_tpu/backend/relo.py:209 (lm_solve_relo's cost: linearize_relo_rows' "
                 "cost; XLA, no Pallas kernel)"})
SOURCES.update({k: "lfvio_tpu_torch/csrc/proj_factor.cu" for k in RELO_FLOPS})
# The outputs of relo_outputs, and the launch each comes from.
RELO_OUTPUTS = {"H6": "relo_normal", "H_pl6": "relo_normal", "H_ll": "relo_normal",
                "b6": "relo_normal", "b_l": "relo_normal", "cost terms": "relo_cost"}
# A planted fault, and the outputs whose check must reject it on its own
# (the last only where the anchor and loop cameras differ).
RELO_FAULT_OUTPUTS = {"cost 0": ("cost terms",),
                      "least-cost match dropped": ("H6", "H_pl6", "H_ll"),
                      "loop side in the anchor camera's columns": ("H6", "H_pl6")}


def relo_window(dev, dtype, n_cams, n_slots=64):
    """make_window_problem's window (f64, tracks of 5 frames from varied
    anchors, td and extrinsics estimated; with two cameras
    ``dual_camera_inputs``' form, anchors on both) with a loop closure:
    window frame 3 seen again through camera 0 with 3e-3 bearing noise,
    from a pose 3 cm off, a quarter of the matches masked; cast to
    ``dtype``. Returns (state, grid, cfg, (relo_p, relo_q, relo_bearing,
    relo_mask))."""
    import dataclasses as dc

    import torch
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    if n_cams == 2:
        state, grid, cfg = dual_camera_inputs(dev, n_slots)
    else:
        pb = make_window_problem(n_slots, torch.float64, n_obs_frames=5, device=dev)
        state, grid, cfg = pb["state"], pb["grid"], pb["cfg"]
    rng = np.random.default_rng(17)
    tt = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    b = grid.bearing[:, 3] + tt(3e-3 * rng.standard_normal((n_slots, 3)))
    relo = (state.p[3] + tt(0.03 * rng.standard_normal(3)), state.q[3].clone(), b,
            torch.as_tensor(rng.random(n_slots) < 0.75, device=dev))
    cast = lambda x: x.to(dtype).contiguous() if x is not None and x.is_floating_point() else x
    state = type(state)(**{f.name: cast(getattr(state, f.name)) for f in dc.fields(state)})
    grid = type(grid)(**{f.name: cast(getattr(grid, f.name)) for f in dc.fields(grid)})
    return state, grid, cfg, tuple(cast(x) for x in relo)


# The anchor layouts of relo_layout: the main path's (96-97% of the used
# features anchored at frame 0 on the bench's streams) and anchors spread
# evenly over the window's first W1 - 2 frames.
RELO_LAYOUTS = {"front": 0.96, "spread": None}


def relo_layout(dev, dtype, W1, n_slots, n_cams, layout, seed=0):
    """Relo inputs of any window length, slot count and anchor layout (a key
    of RELO_LAYOUTS), made with numpy from ``seed``: W1 frames along a
    curve (2 m over the window), points 3-8 m away seen from every frame (through a random camera
    of ``n_cams`` a observation), inverse depths 5% off, a tenth of the slots
    unused, the loop frame a pose 3 cm off window frame 3 seen through
    camera 0 with 3e-3 bearing noise, a quarter of the matches masked; one
    camera without the extrinsic estimated (the main path's), two with it.
    Returns (state, grid, cfg, (relo_p, relo_q, relo_bearing, relo_mask))
    in ``dtype``."""
    import torch
    from lfvio_tpu_torch.backend import FeatureGrid, SolverConfig, WindowState
    from lfvio_tpu_torch.geom import host as hg

    rng = np.random.default_rng(seed)
    F, C = n_slots, n_cams
    t = np.linspace(0.0, 1.0, W1)
    p = np.stack([2.0 * t, 0.3 * np.sin(3 * t), 0.1 * t], -1)
    q = np.stack([hg.so3_exp(np.array([0.05 * np.sin(2 * s), 0.1 * s, 0.3 * s])) for s in t])
    R = hg.quat_to_mat(q)
    tic = np.array([[0.01, -0.02, 0.005], [-0.015, 0.03, -0.04]])[:C]
    qic = np.stack([hg.so3_exp(0.02 * rng.standard_normal(3)) for _ in range(C)])
    Ric = hg.quat_to_mat(qic)
    dirs = rng.standard_normal((F, 3))
    pts = p.mean(0) + dirs / np.linalg.norm(dirs, axis=-1, keepdims=True) * rng.uniform(3, 8, (F, 1))
    front = RELO_LAYOUTS[layout]
    spread = rng.integers(0, max(W1 - 2, 1), F)
    anchor = (spread if front is None else
              np.where(rng.random(F) < front, 0, rng.integers(1, max(W1 - 2, 2), F)))
    cam = rng.integers(0, C, (F, W1))

    def bearing(Rw, pw, c, X):  # X seen from the body pose (Rw, pw) through camera c
        b = np.einsum("...k,...kl->...l", np.einsum("...k,...kl->...l", X - pw, Rw) - tic[c],
                      Ric[c])
        return b / np.linalg.norm(b, axis=-1, keepdims=True)

    bear = bearing(R[None], p[None], cam, pts[:, None])
    fi = np.arange(F)
    pc = np.einsum("fk,fkl->fl", np.einsum("fk,fkl->fl", pts - p[anchor], R[anchor])
                   - tic[cam[fi, anchor]], Ric[cam[fi, anchor]])
    inv_depth = rng.uniform(0.95, 1.05, F) / np.linalg.norm(pc, axis=-1)
    rp = p[3] + 0.03 * rng.standard_normal(3)
    rb = bearing(R[3], rp, np.zeros(F, int), pts) + 3e-3 * rng.standard_normal((F, 3))
    tt = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    state = WindowState(p=tt(p), q=tt(q), v=tt(np.zeros((W1, 3))), ba=tt(np.zeros((W1, 3))),
                        bg=tt(np.zeros((W1, 3))), tic=tt(tic[0] if C == 1 else tic),
                        qic=tt(qic[0] if C == 1 else qic), td=tt(0.0), inv_depth=tt(inv_depth))
    grid = FeatureGrid(bearing=tt(bear), velocity=tt(0.01 * rng.standard_normal((F, W1, 3))),
                       td_obs=tt(np.zeros((F, W1))), valid=tt(np.ones((F, W1), bool), torch.bool),
                       anchor=tt(anchor, torch.int64),
                       used=tt(rng.random(F) < 0.9, torch.bool),
                       cam=tt(cam, torch.int64) if C > 1 else None)
    cfg = SolverConfig(n_cams=C, estimate_extrinsic=C > 1)
    relo = (tt(rp), tt(q[3]), tt(rb), tt(rng.random(F) < 0.75, torch.bool))
    return state, grid, cfg, relo


# The float32 kernels against the plain version run in float64 on the same
# inputs upcast, relative to each output's scale: on relo_layout's 16 card
# test windows the f32 kernels landed at most 1.01e-5 from it and the f32
# plain version 1.21e-5 (relo_f32_spread.py on an H100), so twice the
# largest reading.
RELO_F32_EXACT_BOUND = 2e-5


def relo_upcast(args):
    """relo inputs (state, grid, cfg, relo) in float64, from their values."""
    import dataclasses as dc

    cast = lambda x: x.double() if x is not None and x.is_floating_point() else x
    re = lambda obj: type(obj)(**{f.name: cast(getattr(obj, f.name)) for f in dc.fields(obj)})
    state, grid, cfg, relo = args
    return re(state), re(grid), cfg, tuple(cast(x) for x in relo)


def relo_outputs(args, plain=False, mask=None, kernels=None):
    """Every output of the two relo launches on zero sums, {name: tensor}:
    the kernels' (with ``kernels``, {"relo_normal", "relo_cost": callable},
    other wrappers of the two launches) or (``plain``) their plain
    versions' (``mask`` in place of the match mask)."""
    import torch
    from lfvio_tpu_torch.backend import relo_cuda as rc
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

    state, grid, cfg, relo = args
    if mask is not None:
        relo = (*relo[:3], mask)
    F, W1 = grid.valid.shape
    D6 = pose_dim(W1, n_cams_of(state)) + 6
    z = lambda *s: torch.zeros(s, dtype=state.p.dtype, device=state.p.device)
    sums = (z(D6, D6), z(D6, F), z(F), z(D6), z(F))
    kernels = kernels or {"relo_normal": rc.relo_normal, "relo_cost": rc.relo_cost}
    normal = rc.relo_normal_plain if plain else kernels["relo_normal"]
    cost = rc.relo_cost_plain if plain else kernels["relo_cost"]
    return dict(zip(RELO_OUTPUTS, (*normal(*sums, state, grid, *relo, cfg),
                                   cost(state, grid, *relo, cfg))))


def relo_scales(args):
    """{output name: its scale} (the note above RELO_BOUNDS)."""
    import torch
    from lfvio_tpu_torch.backend import relo_cuda as rc
    from lfvio_tpu_torch.backend.state import n_cams_of

    state, grid, cfg, relo = args
    res, J25, w, valid, _ = rc.relo_jacobian(state, grid, *relo, cfg)
    r_scale = torch.where(valid[:, None], res.abs() + float(cfg.proj_sqrt_info), 0.0)
    absum = rc.relo_sums(r_scale * w[:, None], J25.abs() * w[:, None, None], grid, cfg,
                         n_cams_of(state))
    top = lambda x: max(float(x.abs().max()), 1e-30) if x.numel() else 1.0
    c2 = cfg.cauchy_c ** 2
    return {**{n: top(a) for n, a in zip(RELO_OUTPUTS, absum)},
            "cost terms": top(c2 * torch.log1p((r_scale * r_scale).sum(-1) / c2))}


def relo_errors(outs, ref, scale):
    return {n: (float((outs[n] - ref[n]).abs().max()) if ref[n].numel() else 0.0) / scale[n]
            for n in ref}


def relo_compare(args, kernels=None):
    """(errors relative to each output's scale, {launch: (largest absolute
    error, largest relative error) of its outputs}, a repeat of the kernels
    bit-identical); ``kernels`` as relo_outputs takes them."""
    import torch

    k, again = relo_outputs(args, kernels=kernels), relo_outputs(args, kernels=kernels)
    p = relo_outputs(args, plain=True)
    identical = all(torch.equal(k[n], again[n]) for n in k)
    errs = relo_errors(k, p, relo_scales(args))
    mode_err = {}
    for n, e in errs.items():
        a, r = mode_err.get(RELO_OUTPUTS[n], (0.0, 0.0))
        mode_err[RELO_OUTPUTS[n]] = (max(a, float((k[n] - p[n]).abs().max())), max(r, e))
    return errs, mode_err, identical


def relo_planted_faults(args):
    """{fault: {output name: its error over its scale}}: the plain
    version's outputs at ``args`` against those a kernel with each fault of
    RELO_FAULT_OUTPUTS would give (a zero cost; the kept match of least cost
    left out; where some kept feature's anchor camera is not camera 0 and
    the extrinsic is estimated, the loop side's extrinsic block added into
    the anchor camera's columns)."""
    import torch
    from lfvio_tpu_torch.backend import relo_cuda as rc
    from lfvio_tpu_torch.backend.state import n_cams_of

    state, grid, cfg, relo = args
    p = relo_outputs(args, plain=True)
    faults = {"cost 0": {**p, "cost terms": torch.zeros_like(p["cost terms"])}}
    res, J25, w, valid, terms = rc.relo_jacobian(state, grid, *relo, cfg)
    drop = relo[3].clone()
    drop[int(torch.where(valid, terms, np.inf).argmin())] = False
    faults["least-cost match dropped"] = relo_outputs(args, plain=True, mask=drop)
    F = valid.shape[0]
    cam_i = grid.cam_index()[torch.arange(F, device=valid.device), grid.anchor]
    if cfg.estimate_extrinsic and bool((valid & (cam_i != 0)).any()):
        J = J25 * w[:, None, None]
        J = torch.cat([J[..., :12], J[..., 12:18] + J[..., 18:24], torch.zeros_like(J[..., 18:24]),
                       J[..., 24:]], dim=-1)
        terms_f = rc.relo_sums(res * w[:, None], J, grid, cfg, n_cams_of(state))
        faults["loop side in the anchor camera's columns"] = {
            **p, **dict(zip(("H6", "H_pl6", "H_ll", "b6", "b_l"), terms_f))}
    scale = relo_scales(args)
    return {name: relo_errors(f, p, scale) for name, f in faults.items()}


def relo_bound_ms(args, mode):
    """The least time of one launch of ``mode`` (a key of RELO_FLOPS) on an
    H100 at ``args``: what the function needs read once and written once at
    3.35 TB/s (the frames' and cameras' poses, the loop pose; a feature's
    inverse depth, anchor observation's bearing, loop bearing and masks;
    relo_cost: a cost term a feature; relo_normal: the entries of H6, b6,
    H_pl6, H_ll and b_l its kept features reach, read and written), against
    RELO_FLOPS a kept feature at the float32 rate; (ms, by, bytes, FLOP)."""
    import torch

    state, grid, cfg, relo = args
    F, W1 = grid.valid.shape
    C = 1 if state.tic.ndim == 1 else state.tic.shape[0]
    e = state.p.element_size()
    valid = relo[3] & grid.used
    n = int(valid.sum())
    masks = 2 * F + 8 * F + (8 * F if grid.cam is not None else 0)
    ins = e * (7 * W1 + 7 * C + 7 + F * (1 + 3 + 3)) + masks
    if mode == "relo_cost":
        out = e * F
    else:
        ex = 6 * C if cfg.estimate_extrinsic else 0
        n_pose = int(torch.unique(grid.anchor[valid]).numel())
        # H6: each reached pose tile, its tiles with the loop pose (both
        # mirrors), the loop pose's own, the extrinsic rows' and columns';
        # b6 the blocks; H_pl6 a kept feature's 12 + extrinsic entries.
        h6 = n_pose * (36 + 2 * 36) + 36 + (2 * ex * (6 * n_pose + 6) + ex * ex if ex else 0)
        out = 2 * e * (h6 + 6 * n_pose + 6 + ex + n * (12 + min(ex, 12) + 2))
    nbytes = ins + out
    flops = RELO_FLOPS[mode] * n
    t_b, t_o = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / PEAK_F32_FLOPS
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, flops


def phase_relo_factor(dev, full_args):
    """The relo launches against their plain version at (r) phase 6r's
    relocalization inputs (256 slots, window 10, f32, bench.py's
    configuration) and on the two-camera window of ``relo_window`` in f64
    and f32, within RELO_BOUNDS, a repeat bit-identical, the planted faults
    of RELO_FAULT_OUTPUTS rejected; each launch's times behind a full queue
    and launched alone, beside its latency floor
    (``relo_cuda.latency_floor``), its plain version's and its bound, at
    (r) and on the two-camera f32 window (extrinsics estimated). Returns
    the kernels line's numbers, (r)'s times (the two-camera window's under
    "two_camera"): errors the worst of the f32 cases."""
    import torch
    from lfvio_tpu_torch.backend.state import n_cams_of

    label_r = "(r) phase 6r's relo solve, 256 slots, window 10, f32"
    cases = {label_r: full_args,
             "two-camera 64 slots, f64": relo_window(dev, torch.float64, 2),
             "two-camera 64 slots, f32": relo_window(dev, torch.float32, 2)}
    worst = {}
    for label, args in cases.items():
        errs, mode_err, identical = relo_compare(args)
        bound = RELO_BOUNDS[str(args[0].p.dtype).split(".")[-1]]
        state, grid, cfg, relo = args
        valid = relo[3] & grid.used
        cam_i = grid.cam_index()[torch.arange(valid.shape[0], device=dev), grid.anchor]
        log(f"[14r] relo {label} against the plain version, relative to each output's scale: "
            + ", ".join(f"{n} {v:.2e}" for n, v in errs.items())
            + f" (bound {bound}); repeat bit-identical {identical}; kept matches "
            f"{int(valid.sum())} of {valid.numel()} slots ({int((valid & (cam_i != 0)).sum())} "
            f"anchored on a camera other than 0)")
        if not (identical and all(v <= bound for v in errs.values())):
            raise AssertionError(f"the relo kernels disagree with their plain version at {label}")
        faults = relo_planted_faults(args)
        for fault, fe in faults.items():
            log(f"[14r] planted fault at {label}, {fault}: " + ", ".join(
                f"{n} {v:.2e}" for n, v in fe.items()) + f" (must exceed {bound}: "
                + ", ".join(RELO_FAULT_OUTPUTS[fault]) + ")")
            if not all(fe[n] > bound for n in RELO_FAULT_OUTPUTS[fault]):
                raise AssertionError(f"the relo check does not see '{fault}' at {label}")
        if n_cams_of(state) == 2 and len(faults) != len(RELO_FAULT_OUTPUTS):
            raise AssertionError(f"{label}: no kept match anchored on camera 1")
        if state.p.dtype == torch.float32:
            for m, (a, r) in mode_err.items():
                wa, wr = worst.get(m, (0.0, 0.0))
                worst[m] = (max(wa, a), max(wr, r))
    block = make_blocker(dev)
    out = {}
    for label, args in ((label_r, full_args), ("two-camera 64 slots, f32, extrinsics estimated",
                                               cases["two-camera 64 slots, f32"])):
        for mode, rec in relo_times(args, label, block).items():
            if label != label_r:
                out[mode]["two_camera"] = rec
                continue
            out[mode] = dict(max_abs_err=worst[mode][0], max_rel_err=worst[mode][1],
                             rel_bound=RELO_BOUNDS["float32"], library_ms=None, **rec)
    return out


def relo_times(args, label, block):
    """Each relo launch at ``args`` behind a full queue and launched alone,
    beside its latency floor (relo_cuda.latency_floor), its plain version's
    time and its bound; logged, and returned as {mode: {ms, ...}}."""
    import torch
    from lfvio_tpu_torch.backend import relo_cuda as rc
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

    state, grid, cfg, relo = args
    F, W1 = grid.valid.shape
    D6 = pose_dim(W1, n_cams_of(state)) + 6
    z = lambda *s: torch.zeros(s, dtype=state.p.dtype, device=state.p.device)
    sums = (z(D6, D6), z(D6, F), z(F), z(D6), z(F))
    runs = {"relo_normal": (lambda: rc.relo_normal(*sums, state, grid, *relo, cfg),
                            lambda: rc.relo_normal_plain(*sums, state, grid, *relo, cfg)),
            "relo_cost": (lambda: rc.relo_cost(state, grid, *relo, cfg),
                          lambda: rc.relo_cost_plain(state, grid, *relo, cfg))}
    out = {}
    for mode, (kern, plain) in runs.items():
        ms, alone = cuda_ms(kern, reps=10, blocker=block), cuda_ms(kern)
        empty = lambda: rc.latency_floor(mode, state, grid, *relo, cfg)
        floor, floor_alone = cuda_ms(empty, reps=10, blocker=block), cuda_ms(empty)
        plain_ms = cuda_ms(plain, reps=3, blocker=block)
        bound, by, nbytes, flops = relo_bound_ms(args, mode)
        log(f"[14r] {mode} {label}: {ms:.4f} ms behind a full queue, {alone:.4f} ms launched "
            f"alone; latency floor (the empty kernel, same grid, block and launch path) "
            f"{floor:.4f} ms behind a full queue, {floor_alone:.4f} ms alone; plain version "
            f"{plain_ms:.4f} ms; bound {bound:.6f} ms by {by} ({nbytes} B, {flops / 1e6:.3f} "
            f"MFLOP); at {100 * bound / ms:.2f}% of it; no PyTorch call computes this function")
        out[mode] = dict(ms=ms, ms_launched_alone=alone, floor_ms=floor, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by)
    return out


# ------------------------------------------------ phase 14: the marginalizations' QR
# csrc/marg_qr.cu against its plain version (backend/marg_cuda.py) on the
# same inputs. marg_depth's rows relative to each slot's scale, the largest
# magnitude of the slot's dense rows (a reflected row is a row less a
# multiple of vᵀA, a sum over the slot's 2 W rows: f32 rounds it to a few
# 2 W eps of that scale). marg_qr's R through its information, RᵀR against
# AᵀA (``rtr_error``) and the kept rows' (those below the dropped columns,
# the prior: ``kept_error``), entry (i, j) relative to |a_i| |a_j| of A's
# columns (against the largest entry of |A|ᵀ|A| instead, the projection
# rows' information sits below 1e-5 of the IMU's and the prior's, and a
# tile of them left out went unseen on the CPU). f32 at the main path's
# inputs, f64 on the same inputs upcast.
MARG_BOUNDS = {"float32": 2e-5, "float64": 1e-13}
MARG_KERNELS = ("marg_depth", "marg_qr")
MARG_RTR = "marg_qr (RᵀR against AᵀA)"
MARG_STRUCTURE = "marg_qr (a lower entry or a zero pivot's row non-zero)"
# The kept information is a Schur complement: it carries the dropped
# block's conditioning, so two f32 QRs of the same stack differ there by
# more than their backward errors (up to 6.2e-5 of the scale at (b) on an
# H100). In f32 it is held against the plain version run in f64 on the
# stack upcast, within twice the largest f32 reading of marg_f32_spread.py
# (marg_qr, the plain version and torch.linalg.qr, each against that f64
# answer, over the 71 MARGIN_OLD stacks of bench.py's two streams on an
# H100: at most 4.98e-4, 8.51e-4 and 5.82e-4): the kernel is held to what
# an f32 QR of these stacks attains. In f64 it is held against the plain
# version in f64, within that bound scaled by the ratio of the two types'
# rounding units, doubled (both sides round).
MARG_KEPT = "marg_qr (kept information)"
MARG_KEPT_F32_BOUND = 1.7e-3
MARG_KEPT_BOUNDS = {"float32": MARG_KEPT_F32_BOUND,
                    "float64": 2 * MARG_KEPT_F32_BOUND * 2.0 ** -29}
REPLACES.update({
    "marg_depth": "lfvio_tpu/backend/marginalize.py:260 (jnp.linalg.qr in marginalize_old_qr "
                  ":207, its F anchored-depth columns; XLA, no Pallas kernel)",
    "marg_qr": "lfvio_tpu/backend/marginalize.py:260 and :297 (jnp.linalg.qr in "
               "marginalize_old_qr :207 and marginalize_second_new_qr :276; XLA, no Pallas "
               "kernel)"})
SOURCES.update({k: "lfvio_tpu_torch/csrc/marg_qr.cu" for k in MARG_KERNELS})
# A planted fault of each kernel, and the check that must reject it.
MARG_FAULTS = {"marg_depth": ("a slot left unreflected", "a slot's pivot row kept"),
               "marg_qr": ("a tile of rows left out", "a kept row of R zeroed")}
# The rows of that tile: the first non-zero ones after the head (all rows
# where the head is all of them), as many as a float64 tile holds.
MARG_FAULT_ROWS = 32


def marg_panel_stack(dev, dtype, C, seed=0):
    """(A, head, dropped columns) of a stack that exercises marg_qr's
    panels: 1,400 rows of C columns (173 and 323 are no multiple of the
    kernel's 16-column panel, 384 is the widest), 30% of them zero, a head
    of 60 whose first 20 rows alone touch columns [16, 48) (two whole
    panels in which every later reflection skips: the other rows are zero
    there, and so is R above them) and an empty column, 100, in mid-panel;
    15 dropped columns."""
    import torch

    rng = np.random.default_rng(seed + C)
    head, M = 60, 1400
    A = rng.standard_normal((M, C)) * np.exp(rng.uniform(-1, 1, (M, 1)))
    A[rng.random(M) < 0.3] = 0.0
    A[:, 16:48] = 0.0
    A[:20, :] = 0.0
    A[:20, 16:48] = rng.standard_normal((20, 32)) + 4 * np.eye(20, 32)
    A[:, 100] = 0.0
    return torch.as_tensor(A, dtype=dtype, device=dev), head, 15


def marg_cases(census, dev):
    """{label: (args, kind)}: MARGIN_OLD's arguments at (a) and (b) (the
    census' estimators' solve outputs, their priors) and SECOND_NEW's at
    (b) (the estimator's prior at the solve's state, the program's inputs),
    in f32, and the f64 upcast of each; ``marg_window``'s two-camera window
    (64 slots, the extrinsics and td estimated) in f32 and f64; and
    ``marg_panel_stack``'s stacks (kind "stack") at C = 173, 323 and 384 in
    f32 and f64."""
    import torch

    a, b = census["a"]["marg_args"], census["b"]["marg_args"]
    sn = (b[0], b[5])
    cases = {"(a) MARGIN_OLD, window 10, 256 slots, f32": (a, "old"),
             "(b) MARGIN_OLD, window 20, 384 slots, f32": (b, "old"),
             "(b) SECOND_NEW, window 20, f32": (sn, "new"),
             "(a) MARGIN_OLD, f64": (to_f64(a), "old"),
             "(b) MARGIN_OLD, f64": (to_f64(b), "old"),
             "(b) SECOND_NEW, f64": (to_f64(sn), "new")}
    for dtype in (torch.float32, torch.float64):
        cases[f"two cameras, extrinsics and td estimated, 64 slots, f{str(dtype)[-2:]}"] = (
            marg_window(dev, dtype, 64, 2), "old")
    for dtype in (torch.float32, torch.float64):
        for C in (173, 323, 384):
            cases[f"panel stack, C = {C}, whole panels skipping, an empty column, "
                  f"f{str(dtype)[-2:]}"] = (marg_panel_stack(dev, dtype, C), "stack")
    return cases


def marg_inputs(est):
    """MARGIN_OLD's arguments at an estimator's next solve (the solve
    program's outputs, its prior, gravity and solver config), as the census
    records them."""
    prior = est.prior if est.prior is not None else est._empty_prior()
    packed = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0]))
    res, grid = est._program(("solve",))(packed, prior, est._zero_chain())
    return (res["out"], grid, res["pre"], res["sqrt_info"], res["imu_ok"], prior,
            est._gravity_t, est.scfg)


def marg_stacks(dev):
    """{label: (stack, head, dropped columns)}: marg_qr's f32 inputs at (a)
    and (b)'s MARGIN_OLD and (b)'s SECOND_NEW (``warm_estimator`` in
    bench.py's default and high-rate configurations, ``marg_inputs``)."""
    a, b = (marg_inputs(warm_estimator(dev, k)) for k in ({}, BENCH_HIGH_RATE))
    cases = {"(a) MARGIN_OLD": (a, "old"), "(b) MARGIN_OLD": (b, "old"),
             "(b) SECOND_NEW": ((b[0], b[5]), "new")}
    return {label: marg_stage_inputs(args, kind)[1:] for label, (args, kind) in cases.items()}


def depth_inputs(dev):
    """{label: (marg_depth's arguments, the MARGIN_OLD stack's view after
    its head, as ``depth_out`` makes it)} at (a) and (b)'s MARGIN_OLD, f32
    (``warm_estimator`` in bench.py's default and high-rate
    configurations, ``marg_inputs``)."""
    out = {}
    for label, knobs in (("(a) MARGIN_OLD", {}), ("(b) MARGIN_OLD", BENCH_HIGH_RATE)):
        depth_args, A, head, _ = marg_stage_inputs(marg_inputs(warm_estimator(dev, knobs)), "old")
        out[label] = (depth_args, depth_out(depth_args, head * A.shape[1])[0])
    return out


def to_f64(x):
    """``x`` (a tensor, a tuple or a dataclass of them) with every floating
    tensor in float64."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple):
        return tuple(to_f64(y) for y in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: to_f64(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def marg_stage_inputs(args, kind):
    """(marg_depth's arguments or None, marg_qr's stack, its head, the
    dropped columns m) of a MARGIN_OLD (``kind`` "old") or SECOND_NEW
    ("new") case, or of a stack given as (A, head, m) ("stack")."""
    from lfvio_tpu_torch.backend import marginalize as mg
    from lfvio_tpu_torch.backend.proj_cuda import proj_rows

    if kind == "stack":
        return (None, *args)
    if kind == "new":
        state, prior = args
        D = prior.J.shape[0]
        return None, mg.second_new_stack(state, prior), D, 6
    state, grid, cfg = args[0], args[1], args[7]
    D = mg.pose_dim(state.p.shape[0], mg.n_cams_of(state))
    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    res, J26, w, _ = proj_rows(state, grid0, cfg)
    return ((res, J26, w, grid0, cfg, mg.n_cams_of(state)), mg.old_stack(*args), D + 15, 15)


def depth_error(depth_args, out, ref):
    """marg_depth's rows ``out`` against ``ref``, slot by slot over the
    slot's scale (a slot of scale 0 must agree exactly)."""
    import torch
    from lfvio_tpu_torch.backend import marg_cuda as mc

    A, _ = mc._dense_obs_rows(*depth_args)
    F, R2, C = A.shape
    scale = A.abs().amax(dim=(1, 2))[:, None, None]
    d = (out.reshape(F, R2, C) - ref.reshape(F, R2, C)).abs()
    return float(torch.where(scale > 0, d / torch.where(scale > 0, scale, 1.0),
                             torch.where(d > 0, np.inf, 0.0)).max())


def marg_window(dev, dtype, n_slots=256, n_cams=1, seed=0):
    """make_window_problem's window on ``dev`` (tracks of 5 frames, anchors
    spread, td and the extrinsics estimated; with ``n_cams`` = 2 a second
    extrinsic, a random camera an observation and an informative prior
    over the wider layout) as MARGIN_OLD's arguments."""
    import dataclasses

    import torch
    from lfvio_tpu_torch.imu import preintegrate, whiten_covariance
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    pb = make_window_problem(n_slots, dtype, n_obs_frames=5, seed=seed, device=dev)
    st, grid, cfg, prior = pb["state"], pb["grid"], pb["cfg"], pb["prior"]
    if n_cams == 2:
        dual = dual_camera_inputs(dev)[0]
        st = st.replace(tic=dual.tic.to(dtype), qic=dual.qic.to(dtype))
        g = torch.Generator(device="cpu").manual_seed(seed)
        grid = grid.replace(cam=torch.randint(0, 2, grid.valid.shape, generator=g).to(dev))
        cfg = dataclasses.replace(cfg, n_cams=2)
        D = prior.J.shape[0] + 6
        R = torch.triu(0.5 * torch.randn(D, D, generator=g, dtype=torch.float64)) + 2 * torch.eye(D)
        prior = type(prior).from_state(R.to(dev, dtype), torch.zeros(D, dtype=dtype, device=dev),
                                       st, torch.ones((), dtype=torch.bool, device=dev))
    imu = [torch.as_tensor(pb[k], dtype=dtype, device=dev)
           for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pre = preintegrate(*imu, st.ba[:-1], st.bg[:-1], pb["noise"])
    si, ok = whiten_covariance(pre.covariance, torch.as_tensor(pb["imu_valid"], device=dev))
    return (st, grid, pre, si, ok, prior, pb["gravity"], cfg)


def depth_out(depth_args, offset):
    """(a contiguous view of marg_depth's output shape starting ``offset``
    entries into a fresh buffer, the buffer): NaN everywhere, so that an
    entry left unwritten shows and one written outside the view is seen."""
    import torch
    from lfvio_tpu_torch.backend.state import pose_dim

    res, grid, nc = depth_args[0], depth_args[3], depth_args[5]
    F, W1 = grid.valid.shape
    n, C = F * 2 * (W1 - 1), pose_dim(W1, nc) + 1
    buf = torch.full((offset + n * C + 8,), float("nan"), dtype=res.dtype, device=res.device)
    return buf[offset:offset + n * C].view(n, C), buf


def depth_view_check(depth_args, offset):
    """marg_depth written into ``depth_out``'s view at ``offset``: (its
    rows against depth_plain's over each slot's scale, whether it wrote
    nothing outside the view, a repeat bit-identical, the view's start past
    a 16-byte boundary in bytes)."""
    import torch
    from lfvio_tpu_torch.backend import marg_cuda as mc

    view, buf = depth_out(depth_args, offset)
    mc.marg_depth(*depth_args, out=view)
    first = view.clone()
    mc.marg_depth(*depth_args, out=view)
    outside = torch.cat([buf[:offset], buf[offset + view.numel():]])
    return (depth_error(depth_args, view, mc.depth_plain(*depth_args)),
            bool(torch.isnan(outside).all()), torch.equal(first, view), view.data_ptr() % 16)


def depth_nonfinite_check(depth_args):
    """marg_depth and depth_plain with a NaN planted in the depth column of
    one reflected slot and an inf in another's (their reflections are not
    finite: every entry of the rows after the pivot is NaN, the speed-bias
    columns' too): (whether the kernel's NaNs are exactly depth_plain's,
    how many there are, the other entries' error over each slot's scale)."""
    import torch
    from lfvio_tpu_torch.backend import marg_cuda as mc

    res, J26, w, grid, cfg, nc = depth_args
    x = J26[:, 1:, :, 24] * w[:, 1:, None]
    f = (x.abs().amax(dim=(1, 2)) > 0).nonzero()[:, 0]
    J = J26.clone()
    J[f[0], 1, 0, 24] = float("nan")
    J[f[-1], -1, 1, 24] = float("inf")
    args = (res, J, w, grid, cfg, nc)
    k, p = mc.marg_depth(*args), mc.depth_plain(*args)
    nan_k, nan_p = torch.isnan(k), torch.isnan(p)
    fin = ~nan_p
    err = depth_error(args, torch.where(fin, k, 0.0), torch.where(fin, p, 0.0))
    return bool(torch.equal(nan_k, nan_p)), int(nan_p.sum()), err


def qr_structure(R):
    """0 if R is upper triangular and every row whose pivot is zero is zero
    (a column with nothing to eliminate consumed no row), else inf."""
    import torch

    zero_pivot = R.diagonal() == 0
    ok = (torch.tril(R, -1) == 0).all() & ~(R[zero_pivot] != 0).any()
    return 0.0 if bool(ok) else float("inf")


def _over_norms(d, norms):
    """max |d_ij| / (|a_i| |a_j|), ``norms`` the norms of A's columns (an
    entry of scale 0 must be 0), in f64."""
    import torch

    d, scale = d.abs(), torch.outer(norms, norms)
    return float(torch.where(scale > 0, d / torch.where(scale > 0, scale, 1.0),
                             torch.where(d > 0, np.inf, 0.0)).max())


def rtr_error(A, R):
    """RᵀR against AᵀA, entry (i, j) over |a_i| |a_j| (a QR's backward
    error is eps times a few of A's column by column)."""
    A, R = A.double(), R.double()
    return _over_norms(R.T @ R - A.T @ A, A.norm(dim=0))


def kept_error(A, R, Rref, m, with_rr=True):
    """The information of R's kept rows (below the first ``m``, the last
    row, the residual's rest, aside) against Rref's, entry (i, j) over
    |a_i| |a_j|; ``with_rr`` False leaves out its (r, r) entry, the part of
    the residual's norm the kept rows hold (where the kept information is
    singular, rounding-level pivots split it with the last row)."""
    A, R, Rref = A.double(), R.double(), Rref.double()
    kept = lambda X: X[m:-1, m:].T @ X[m:-1, m:]
    d = kept(R) - kept(Rref)
    if not with_rr:
        d[-1, -1] = 0.0
    return _over_norms(d, A.norm(dim=0)[m:])


def marg_bound(check, dtype):
    """The bound of ``marg_compare``'s ``check`` in ``dtype`` ("float32" or
    "float64")."""
    return (MARG_KEPT_BOUNDS if check == MARG_KEPT else MARG_BOUNDS)[dtype]


def marg_planted_faults(depth_args, A, head, m):
    """{kernel: {fault: its error}}: the plain versions' outputs against
    those a kernel with each fault of MARG_FAULTS would give."""
    import torch
    from lfvio_tpu_torch.backend import marg_cuda as mc

    out = {}
    if depth_args is not None:
        ref = mc.depth_plain(*depth_args)
        dense, x = mc._dense_obs_rows(*depth_args)
        F, R2, C = dense.shape
        f = int((x.abs().amax(dim=1) > 0).nonzero()[0])
        unref = ref.reshape(F, R2, C).clone()
        unref[f] = dense[f]
        kept = ref.reshape(F, R2, C).clone()
        kept[f, 0] = dense[f].T @ (x[f] / x[f].norm())  # the depth pivot's row (up to sign)
        out["marg_depth"] = dict(zip(MARG_FAULTS["marg_depth"],
                                     (depth_error(depth_args, unref, ref),
                                      depth_error(depth_args, kept, ref))))
    Rp = mc.qr_plain(A)
    less = A.clone()
    rows = (A[head if head < A.shape[0] else 0:] != 0).any(dim=1).nonzero()[:, 0]
    less[(head if head < A.shape[0] else 0) + rows[:MARG_FAULT_ROWS]] = 0.0
    zeroed = Rp.clone()
    diag = Rp.diagonal()[m:-1].abs() / A.norm(dim=0)[m:-1].clamp(min=torch.finfo(A.dtype).tiny)
    zeroed[m + int(diag.argmax())] = 0.0
    out["marg_qr"] = {MARG_FAULTS["marg_qr"][0]: rtr_error(A, mc.qr_plain(less)),
                      MARG_FAULTS["marg_qr"][1]: rtr_error(A, zeroed)}
    return out


def marg_compare(depth_args, A, head, m):
    """({check: error relative to its scale (MARG_STRUCTURE: 0 or inf), each
    within ``marg_bound``}, {kernel: largest absolute error: marg_depth's
    rows, marg_qr's RᵀR against the plain version's}, {QR: its kept
    information's error against the same f64 answer, f32 only: the plain
    version's and torch.linalg.qr's}, repeats bit-identical) of both kernels
    at one case. MARG_KEPT: the kernel's kept information against the plain
    version's, which in f32 runs in f64 on A upcast."""
    import torch
    from lfvio_tpu_torch.backend import marg_cuda as mc

    errs, absolute, readings, identical = {}, {}, {}, True
    if depth_args is not None:
        k, again = mc.marg_depth(*depth_args), mc.marg_depth(*depth_args)
        identical &= torch.equal(k, again)
        p = mc.depth_plain(*depth_args)
        errs["marg_depth"] = depth_error(depth_args, k, p)
        absolute["marg_depth"] = float((k - p).abs().max())
    R, again = mc.marg_qr(A, head=head), mc.marg_qr(A, head=head)
    identical &= torch.equal(R, again)
    Rp = mc.qr_plain(A)
    errs[MARG_RTR] = rtr_error(A, R)
    errs[MARG_STRUCTURE] = qr_structure(R)
    if A.dtype == torch.float32:
        exact = mc.qr_plain(A.double())
        errs[MARG_KEPT] = kept_error(A, R, exact, m)
        readings = {"plain version": kept_error(A, Rp, exact, m),
                    "torch.linalg.qr": kept_error(A, torch.linalg.qr(A, mode="r")[1], exact, m)}
    else:
        errs[MARG_KEPT] = kept_error(A, R, Rp, m)
    absolute["marg_qr"] = float((R.double().T @ R.double() - Rp.double().T @ Rp.double())
                                .abs().max())
    return errs, absolute, readings, bool(identical)


def dense_old_stack(args):
    """The port's MARGIN_OLD matrix before the two stages (torch.linalg.qr's
    input then): [pose0/sb0 | the F depth columns | kept | r] with a unit
    row in each empty dropped column; (A, dropped columns)."""
    import torch
    from lfvio_tpu_torch.backend import marginalize as mg
    from lfvio_tpu_torch.backend import solver

    state, grid, pre0, si, iv, prior, gravity, cfg = args
    n_frames = state.p.shape[0]
    F, W1 = grid.valid.shape
    dtype, dev = state.p.dtype, state.p.device
    D = mg.pose_dim(n_frames, mg.n_cams_of(state))
    with torch.profiler.record_function("marg_old::linearize"):
        grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
        imu_valid = torch.zeros_like(iv)
        imu_valid[0] = iv[0]
        res_w, Jfull, J_lam, _, _ = solver.linearize_proj_rows(state, grid0, cfg)
        imu_res, Jimu, _ = solver.linearize_imu_rows(state, pre0, si, imu_valid, gravity)
        rp = mg.prior_residual(state, prior)
        Jp = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    with torch.profiler.record_function("marg_old::stack"):
        R1 = F * W1 * 2
        dep = (J_lam[..., None] * torch.eye(F, dtype=dtype, device=dev)[:, None, None, :]
               ).reshape(R1, F)
        A_pose = torch.cat([Jfull.reshape(R1, D), Jimu, Jp], dim=0)
        A_dep = torch.cat([dep, torch.zeros((Jimu.shape[0] + D, F), dtype=dtype, device=dev)])
        r = torch.cat([res_w.reshape(R1), imu_res.reshape(-1), rp])
        drop, keep, _ = mg._indices("old", n_frames, D, dev)
        A = torch.cat([A_pose[:, drop], A_dep, A_pose[:, keep], r[:, None]], dim=1)
        m = len(drop) + F
        return mg._with_unit_rows(A, m), m


def dense_marginalize_old_qr(args):
    """The port's MARGIN_OLD before the two stages (one torch.linalg.qr of
    ``dense_old_stack``), with the same record_function ranges as
    marginalize_old_qr's: the split the two stages are measured against."""
    import torch
    from lfvio_tpu_torch.backend import marginalize as mg

    state = args[0]
    D = mg.pose_dim(state.p.shape[0], mg.n_cams_of(state))
    A, m = dense_old_stack(args)
    K = D - 15
    with torch.profiler.record_function("marg_old::qr"):
        Rfac = torch.linalg.qr(A, mode="r")[1]
    with torch.profiler.record_function("marg_old::scatter_slide"):
        keep = mg._indices("old", state.p.shape[0], D, state.p.device)[1]
        Jk, rk = Rfac[m:m + K, m:m + K], Rfac[m:m + K, m + K]
        ok = torch.isfinite(Jk).all() & torch.isfinite(rk).all()
        J, r0 = mg._scatter_prior(torch.where(ok, Jk, 0.0), torch.where(ok, rk, 0.0), keep, D)
        return mg._slid_old(J, r0, state, ok)


MARG_PARTS = ("linearize", "stack", "qr", "scatter_slide")
# Kernels launched through ctypes carry no op, and the ranges' spans on the
# card's timeline cover only the ops' kernels: these go to a part by name.
MARG_KERNEL_PARTS = {"proj_rows_kernel": "linearize", "imu_rows_kernel": "linearize",
                     "marg_depth_kernel": "stack", "marg_qr_kernel": "qr"}


def marg_split(run):
    """One eager MARGIN_OLD (``run()``) under torch.profiler: {part: µs of
    device kernels} by MARG_KERNEL_PARTS for the ctypes kernels, else by
    the "marg_old::<part>" range whose span on the card's timeline holds
    the kernel's start ("other" outside them), and the names of the
    kernels."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    spans = {e.name[len("marg_old::"):]: (e.time_range.start, e.time_range.end)
             for e in dev_events if e.name.startswith("marg_old::")}
    parts, names = {}, set()
    for e in dev_events:
        if e.name.startswith(RANGES):
            continue  # a range's span, not a kernel
        names.add(e.name)
        t = e.time_range.start
        part = next((p for k, p in MARG_KERNEL_PARTS.items() if k in e.name), None)
        part = part or next((p for p, (a, b) in spans.items() if a <= t < b), "other")
        parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us()
    return parts, names


def marg_bound_ms(depth_args, A, name):
    """The least time of one launch of ``name`` on an H100 at these inputs:
    marg_depth reads proj_rows' compact rows (res, J26, w, cam) and writes
    its 2 W rows a slot of the stack, and does about 8 operations a reflected
    slot's row and touched column (vᵀA and the update, 6 W + 6 nc + 8
    columns); marg_qr reads A and writes R, and does the 2 n C² - 2 C³ / 3
    operations of Householder QR on A's n non-zero rows (n >= C; 4 C³ / 3
    for fewer); against 3.35 TB/s and the float32 rate; (ms, by, bytes,
    FLOP)."""
    from lfvio_tpu_torch.backend import marg_cuda as mc

    e = A.element_size()
    C = A.shape[1]
    if name == "marg_depth":
        res, J26, w, grid, cfg, nc = depth_args
        F, W1 = grid.valid.shape
        nbytes = e * (res.numel() + J26.numel() + w.numel() + F * 2 * (W1 - 1) * C)
        nbytes += 0 if grid.cam is None else grid.cam.numel() * grid.cam.element_size()
        _, x = mc._dense_obs_rows(*depth_args)
        reflected = int((x.abs().amax(dim=1) > 0).sum())
        flops = reflected * 8 * 2 * (W1 - 1) * (6 * (W1 - 1) + 6 * nc + 8)
    else:
        n = int((A != 0).any(dim=1).sum())
        nbytes = e * (A.numel() + C * C)
        flops = 2 * n * C * C - 2 * C ** 3 // 3 if n >= C else 4 * C ** 3 // 3
    t_b, t_o = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / PEAK_F32_FLOPS
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, flops


def phase_marg_qr(dev, census):
    """The marginalizations' QR kernels against their plain versions at
    ``marg_cases`` within MARG_BOUNDS, repeats bit-identical, the planted
    faults of MARG_FAULTS rejected; marg_depth also into views that start
    0 to 3 entries into a buffer and at the MARGIN_OLD stack's rows after
    its head (``depth_view_check``: nothing written outside), and with a
    NaN and an inf depth planted (``depth_nonfinite_check``); each launch's
    time (marg_depth's into the stack's view, and into a tensor of its
    own) behind a full queue
    and alone beside its latency floor (marg_cuda.latency_floor), its plain
    version's, its bound and (marg_qr) torch.linalg.qr's of the same stack
    and of the dense stack the port factored before; MARGIN_OLD's eager
    device time by part (``marg_split``), the two stages' and the dense
    form's, at (a) and (b). ``marg_panel_stack``'s cases are checked, not
    timed. Returns the kernels line's numbers (times at (b); errors the
    worst of the f32 cases but the panel stacks, the main path's and the
    two-camera window's: absolute, marg_depth's rows and
    marg_qr's RᵀR against the plain version's, and relative, the checks'
    values)."""
    import torch
    from lfvio_tpu_torch.backend import marg_cuda as mc
    from lfvio_tpu_torch.backend.marginalize import marginalize_old_qr

    worst = {k: 0.0 for k in MARG_KERNELS}
    worst_rel = {k: 0.0 for k in MARG_KERNELS}
    worst_kept = 0.0
    timed = {}
    for label, (args, kind) in marg_cases(census, dev).items():
        depth_args, A, head, m = marg_stage_inputs(args, kind)
        dtype = str(A.dtype).split(".")[-1]
        bound = MARG_BOUNDS[dtype]
        errs, absolute, readings, identical = marg_compare(depth_args, A, head, m)
        n_rows = int((A != 0).any(dim=1).sum())
        against = "the plain version in f64" if dtype == "float32" else "the plain version"
        log(f"[14m] {label}: stack {tuple(A.shape)} ({n_rows} non-zero rows, head {head}, "
            f"leaves {mc.leaves(A.shape[0], head)}) against the plain versions: "
            + ", ".join(f"{n} {v:.2e}" for n, v in errs.items() if n != MARG_KEPT)
            + f" (bound {bound}); {MARG_KEPT} against {against} {errs[MARG_KEPT]:.2e} (bound "
            f"{marg_bound(MARG_KEPT, dtype):.2e})"
            + "".join(f", {n} f32 {v:.2e}" for n, v in readings.items())
            + f"; repeat bit-identical {identical}")
        if not (identical and all(v <= marg_bound(n, dtype) for n, v in errs.items())):
            raise AssertionError(f"the marginalization kernels disagree with their plain versions "
                                 f"at {label}")
        for kernel, faults in marg_planted_faults(depth_args, A, head, m).items():
            log(f"[14m] planted faults of {kernel} at {label}: "
                + ", ".join(f"{n} {v:.2e}" for n, v in faults.items()) + f" (must exceed {bound})")
            if not all(v > bound for v in faults.values()):
                raise AssertionError(f"the {kernel} check does not see a planted fault at {label}")
        if depth_args is not None:  # the rows written into a view, as MARGIN_OLD's graph does
            views = {f"{o} entries in": o for o in range(4)}
            views[f"the stack's view after its {head} head rows"] = head * A.shape[1]
            for where, offset in views.items():
                err, alone, same, past = depth_view_check(depth_args, offset)
                log(f"[14m] marg_depth at {label} into a view {where} ({past} bytes past a "
                    f"16-byte boundary): {err:.2e} of each slot's scale from depth_plain (bound "
                    f"{bound}); nothing written outside it {alone}; repeat bit-identical {same}")
                if not (err <= bound and alone and same):
                    raise AssertionError(f"marg_depth into a view {where} at {label} disagrees "
                                         "with depth_plain, writes outside it or differs on a "
                                         "repeat")
            same_nan, n_nan, err = depth_nonfinite_check(depth_args)
            log(f"[14m] marg_depth at {label} with a NaN and an inf depth planted in two slots: "
                f"its {n_nan} NaNs where depth_plain's are {same_nan}; the other entries "
                f"{err:.2e} of each slot's scale (bound {bound})")
            if not (same_nan and n_nan and err <= bound):
                raise AssertionError(f"marg_depth does not carry a non-finite depth as "
                                     f"depth_plain does at {label}")
        if dtype == "float32" and kind != "stack":  # the main path's inputs
            for k in MARG_KERNELS:
                worst[k] = max(worst[k], absolute.get(k, 0.0))
                worst_rel[k] = max([worst_rel[k]] + [v for n, v in errs.items()
                                                     if n.startswith(k) and n != MARG_KEPT])
            worst_kept = max(worst_kept, errs[MARG_KEPT])
            timed[label] = (depth_args, A, head, m, args, kind)
    block = make_blocker(dev)
    out = {}
    for label, (depth_args, A, head, m, args, kind) in timed.items():
        # {(kernel, where it writes): (launch, plain version, empty launch)}
        runs = {("marg_qr", ""): (lambda: mc.marg_qr(A, head=head), lambda: mc.qr_plain(A),
                                  lambda: mc.latency_floor("marg_qr", A, head=head))}
        if depth_args is not None:  # into the stack's view after the head, as MARGIN_OLD does
            view = depth_out(depth_args, head * A.shape[1])[0]
            for where, o in (("", view), (", a tensor of its own", None)):
                runs[("marg_depth", where)] = (
                    lambda o=o: mc.marg_depth(*depth_args, out=o),
                    lambda: mc.depth_plain(*depth_args),
                    lambda o=o: mc.latency_floor("marg_depth", *depth_args, out=o))
        for (name, where), (kern, plain, empty) in runs.items():
            ms, alone = cuda_ms(kern, reps=10, blocker=block), cuda_ms(kern)
            floor, floor_alone = cuda_ms(empty, reps=10, blocker=block), cuda_ms(empty)
            plain_ms = cuda_ms(plain, n=3, reps=1, blocker=block)
            bound, by, nbytes, flops = marg_bound_ms(depth_args, A, name)
            lib = ""
            library_ms = None
            if name == "marg_qr":
                library_ms = cuda_ms(lambda: torch.linalg.qr(A, mode="r"), n=5, blocker=block)
                lib = f"; torch.linalg.qr of the same stack {library_ms:.4f} ms"
                if kind == "old":
                    dense, _ = dense_old_stack(args)
                    dense_ms = cuda_ms(lambda: torch.linalg.qr(dense, mode="r"), n=3,
                                       blocker=block)
                    lib += (f", of the dense stack {tuple(dense.shape)} the port factored "
                            f"before {dense_ms:.4f} ms")
            log(f"[14m] {name}{where} {label}: {ms:.4f} ms behind a full queue, {alone:.4f} ms "
                f"launched alone; latency floor (the empty kernel, same grid, block and shared "
                f"memory) {floor:.4f} ms behind a full queue, {floor_alone:.4f} ms alone; plain "
                f"version {plain_ms:.4f} ms; bound {bound:.6f} ms by {by} ({nbytes} B, "
                f"{flops / 1e6:.3f} MFLOP); at {100 * bound / ms:.2f}% of it{lib}")
            if label.startswith("(b) MARGIN_OLD") and where:
                out[name].update(ms_fresh=ms, ms_fresh_launched_alone=alone)
            elif label.startswith("(b) MARGIN_OLD"):
                out[name] = dict(max_abs_err=worst[name], max_rel_err=worst_rel[name],
                                 rel_bound=MARG_BOUNDS["float32"],
                                 **({"kept_rel_err": worst_kept,
                                     "kept_rel_bound": MARG_KEPT_BOUNDS["float32"]}
                                    if name == "marg_qr" else {}),
                                 ms=ms, ms_launched_alone=alone, floor_ms=floor,
                                 plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                 library_ms=library_ms)
    for key in ("a", "b"):
        args = census[key]["marg_args"]
        for form, run in (("dense (torch.linalg.qr, before)", lambda: dense_marginalize_old_qr(args)),
                          ("two stages (marg_depth + marg_qr)", lambda: marginalize_old_qr(*args))):
            parts, names = marg_split(run)
            total = sum(parts.values())
            log(f"[14m] MARGIN_OLD eager at ({key}), {form}: {total / 1e3:.3f} ms of device "
                f"kernels: " + ", ".join(f"{p} {parts.get(p, 0.0) / 1e3:.3f} ms"
                                         for p in (*MARG_PARTS, "other"))
                + f"; {len(names)} kernel names")
    return out


def phase_programs(dev, rig, plain_calls, run4, relo6):
    """The eigensolver kernel, f64 graph replays against eager, phase 4's
    stream with eager programs, and the card's time per replay; the factor
    kernels against their plain versions (the relo ones at phase 6r's
    inputs, ``relo6``)."""
    import torch

    t0 = time.perf_counter()
    eig = phase_sym_eig(dev)
    phase_graphs_f64(dev)
    est = run4["est"]
    census = {"a": program_census(est, "(a) phase 4's estimator (f32, window 10)")}
    prior = est.prior
    chain = est._zero_chain()
    packed = est._upload(est._pack_solve_buffer(est.Ps[0], est.Qs[0]))
    eager_ms = cuda_ms(lambda: est._solve_packed_impl(packed, prior, chain), n=3, warmup=1)
    n, cap_s = est.graph_stats()
    log(f"[14] phase 4's estimator: solve eager on the card {eager_ms:.3f} ms between "
        f"CUDA events; {n} graphs captured in {cap_s:.2f} s in all ("
        + ", ".join(f"{k} {p.capture_s:.2f} s" for k, p in est._programs.items()
                    if hasattr(p, "capture_s")) + ")")
    census["b"] = program_census(warm_estimator(dev, BENCH_HIGH_RATE),
                                 "(b) high-rate (f32, window 20, 384 slots)", trace=False)
    want_marg = {k: int(k in ("proj_rows", "imu_rows", *MARG_KERNELS))
                 for k in bench.FACTOR_KERNELS}
    want_new = {k: int(k == "marg_qr") for k in bench.FACTOR_KERNELS}
    for key, c in census.items():
        for name in ("solve", "solve_forced"):
            want = replay_launches(*c["ran"][name])
            if c["per_replay"][name] != want:
                raise AssertionError(f"census ({key}): a {name} replay that ran {c['ran'][name]} "
                                     f"LM iterations and linearizations did not launch {want}")
        if (c["ran"]["solve_forced"][0] != est.cfg.max_iterations
                or c["ran"]["solve_cap1"][0] != 1 or c["ran"]["solve_cap3"][0] > 3):
            raise AssertionError(f"census ({key}): the forced solve or the packed caps 1 and 3 "
                                 f"ran {c['ran']}")
        if not c["nodes"]["solve"].get("conditional"):
            raise AssertionError(f"census ({key}): the solve graph holds no conditional node")
        if c["per_replay"]["marg_old"] != want_marg:
            raise AssertionError(f"census ({key}): a MARGIN_OLD replay did not launch "
                                 f"{want_marg}")
        if c["per_replay"]["marg_new"] != want_new:
            raise AssertionError(f"census ({key}): a SECOND_NEW replay did not launch "
                                 f"{want_new}")
    proj = phase_proj_factor(dev, est, census["b"]["est"])
    imu = phase_imu_factor(dev, est, census["b"]["est"])
    relo = phase_relo_factor(dev, relo6["args"])
    marg = phase_marg_qr(dev, census)
    times = dict(census=census, eager_ms=eager_ms, proj=proj, imu=imu, relo=relo, marg=marg)
    qr = phase_qr_information(dev)
    rec4, rec6 = {}, {}
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



# ------------------------------------------------ phase 15: the bench
# bench.py:71-72's high-rate configuration (BASELINE.json configs[3]).
BENCH_HIGH_RATE = {"LFVIO_BENCH_FRAME_RATE": "30", "LFVIO_BENCH_MAX_CNT": "300",
                   "LFVIO_BENCH_WINDOW": "20", "LFVIO_BENCH_SLOTS": "384"}
BENCH_TIMEOUT_S = 420


def run_bench(tag, knobs):
    """``python -m lfvio_tpu_torch.bench`` in a process of its own from the
    repository root, with ``knobs`` as its only LFVIO_BENCH_* variables.
    Checks its exit code, its one JSON line on stdout, and in its figures
    (stderr) one fused LK launch per tracked frame of the timed window,
    eigensolver launches in it, the front end's two graphs replayed at every
    tracked frame after the first of its kind, a finite trajectory and,
    where the estimator initialized, ATE < FULL_SCALE_ATE_M. Returns the
    figures."""
    env = {k: v for k, v in os.environ.items() if k not in bench.KNOBS}
    env.update(knobs)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "lfvio_tpu_torch.bench"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in res.stderr.splitlines():
        log(f"{tag} {line}")
    if res.returncode != 0:
        raise AssertionError(f"{tag} the bench exited with {res.returncode}")
    lines = res.stdout.strip().splitlines()
    out = json.loads(lines[0]) if len(lines) == 1 else {}
    if not (set(out) == {"metric", "value", "unit", "vs_baseline"}
            and out["metric"] == bench.METRIC and np.isfinite(out["value"]) and out["value"] > 0):
        raise AssertionError(f"{tag} the bench's stdout is not one JSON line of its metric: "
                             f"{res.stdout!r}")
    fig = json.loads(res.stderr.split("] figures ", 1)[1].splitlines()[0])
    log(f"{tag} stdout {lines[0]}; process wall {wall:.1f} s")
    if not (fig["lk_launches"] == fig["frames_timed"] and fig["restarts_timed"] == 0
            and fig["lk_other_launches_run"] == 0):
        raise AssertionError(f"{tag} the bench's LK is not one fused launch per tracked frame")
    if fig["sym_eig_launches"] == 0:
        raise AssertionError(f"{tag} the bench did not launch the eigensolver kernel")
    if not (fig["frontend_graphs"] == 2
            and fig["frontend_replays"] + fig["frontend_graphs"] == fig["lk_launches_run"]):
        raise AssertionError(f"{tag} not every tracked frame after the first of its kind replayed "
                             f"the front end's graph of its kind")
    if not all(v for k, v in fig["factor_launches"].items() if k not in RELO_KERNELS):
        raise AssertionError(f"{tag} the bench did not launch every factor kernel in its timed "
                             f"window")
    check_factor_launches(fig["factor_launches_run"], f"{tag} the bench")
    if not fig["trajectory_finite"]:
        raise AssertionError(f"{tag} non-finite trajectory")
    if fig["initialized"] and not (fig["ate_m"] is not None and fig["ate_m"] < FULL_SCALE_ATE_M):
        raise AssertionError(f"{tag} the bench's ATE is not below {FULL_SCALE_ATE_M} m")
    return fig


def phase_bench():
    """The bench in bench.py's default configuration (a), which must
    initialize during its warm-up, and in its high-rate one (b), once more
    over 12 s if it did not initialize within its 6 s; the last run of (b)
    must have initialized."""
    runs = {"15a": run_bench("[15a]", {})}
    a = runs["15a"]
    if not (a["initialized_in_warmup"] and a["first_solve_t"] is not None
            and a["first_solve_t"] <= a["t_split"]):
        raise AssertionError("[15a] the default configuration did not initialize in its warm-up")
    runs["15b"] = run_bench("[15b]", BENCH_HIGH_RATE)
    if not runs["15b"]["initialized"]:
        log("[15b] did not initialize within 6 s: once more with LFVIO_BENCH_DURATION=12")
        runs["15b12"] = run_bench("[15b12]", dict(BENCH_HIGH_RATE, LFVIO_BENCH_DURATION="12"))
        if not runs["15b12"]["initialized"]:
            raise AssertionError("[15b12] the high-rate configuration did not initialize in 12 s")
    for tag, f in runs.items():
        peak = f["peak_memory_bytes"]
        log(f"[{tag}] {f['frame_rate']:g} Hz, max_cnt {f['max_cnt']}, window {f['window']}, "
            f"{f['n_slots']} slots, {f['duration']:g} s: {f['frames_per_s']:.3f} frames/s over "
            f"{f['frames_timed']} frames; initialized {f['initialized']} (in the warm-up "
            f"{f['initialized_in_warmup']}), first solve at t = {f['first_solve_t']} against the "
            f"split at {f['t_split']:.2f} s; solves {f['solves']} ({f['solves_timed']} timed); "
            f"ATE {f['ate_m']} m over {f['ate_poses']} poses; LK launches {f['lk_launches_run']} in "
            f"the run ({f['lk_launches']} timed), sym_eig launches {f['sym_eig_launches_run']} "
            f"({f['sym_eig_launches']} timed); graphs {f['graphs']} "
            f"({f['capture_s']:.2f} s of capture); front-end graphs {f['frontend_graphs']} "
            f"({f['frontend_capture_s']:.3f} s of capture, {f['frontend_replays']} replays); "
            f"graphs captured in the timed window {f['graphs_captured_timed']}; peak memory "
            f"{peak / 2**20:.1f} MiB")
    return runs


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
    kernels["lk_pyramid_pallas"] = phase_pallas_mode(dev)
    plain_calls = count_plain_lk()
    rig = full_scale_rig(dev)
    run4 = phase_full_scale(rig, plain_calls, profile)
    fe_graphs = phase_frontend_graphs(rig, plain_calls, run4)
    phase_e2e_gate(dev)
    run6 = phase_bench_configuration(rig, plain_calls, run4)
    run6p = phase_pallas_frontend(rig, plain_calls, run4)
    relo6 = phase_relo_full_scale(rig, plain_calls)
    phase_capabilities(dev)
    dual = phase_dual_pal(dev, plain_calls)
    euroc = phase_euroc(rig, plain_calls)
    phase_tools(rig, dev)
    phase_profiling(dev)
    phase_dist()
    phase_kf_axis()
    kernels["sym_eig"], times14, _ = phase_programs(dev, rig, plain_calls, run4, relo6)
    kernels.update(times14["proj"], **times14["imu"], **times14["relo"], **times14["marg"])
    del rig
    benches = phase_bench()
    # Each run's counts were set to 0 just before it: the phases' by
    # reset_launches, the bench's by bench.run in its own process.
    paths = (run4, run6, dual, euroc)
    lk_runs = [r["launches"] for r in paths] + [f["lk_launches_run"] for f in benches.values()]
    sym_runs = [r["sym_launches"] for r in paths] + [f["sym_eig_launches_run"]
                                                     for f in benches.values()]
    factor_runs = {k: [r["factors"][k] for r in paths] + [f["factor_launches_run"][k]
                                                          for f in benches.values()]
                   for k in bench.FACTOR_KERNELS if k not in RELO_KERNELS}
    launches = {"lk_pyramid": sum(lk_runs),
                "lk_level": run4["level_launches"],
                "lk_pyramid_pallas": run6p["launches"],
                "sym_eig": sum(sym_runs), **{k: sum(v) for k, v in factor_runs.items()},
                **{k: relo6["launches"][k] for k in RELO_KERNELS}}
    log(f"[end] launches on the main paths (phases 4, 6, 8, 9, "
        + ", ".join(benches) + ", each a whole run): lk_pyramid "
        + ", ".join(map(str, lk_runs)) + "; sym_eig " + ", ".join(map(str, sym_runs))
        + "".join(f"; {k} " + ", ".join(map(str, v)) for k, v in factor_runs.items())
        + f"; lk_pyramid_pallas (phase 6p) {run6p['launches']}; relo_normal, relo_cost (phase "
        f"6r) {relo6['launches']['relo_normal']}, {relo6['launches']['relo_cost']}; whole run "
        f"{time.perf_counter() - t_run + 0.0:.1f} s after the build")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], **kernels[name]}
        for name in ("lk_pyramid", "lk_level", "lk_pyramid_pallas", "sym_eig", *PROJ_FLOPS,
                     *IMU_FLOPS, *RELO_FLOPS, *MARG_KERNELS)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
