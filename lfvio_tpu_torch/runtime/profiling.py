"""Stage-level profiling of the VIO pipeline on the CUDA card.

Port of ``lfvio_tpu.runtime.profiling`` (the in-package equivalent of the
reference's TicToc timers and printStatistics,
vins_estimator/src/utility/visualization.cpp:65-104). A stage is timed
with CUDA events: one first call (its seconds are reported apart: lazy
library handles, allocator growth), then ``n`` back-to-back calls between
two events and one wait at the end. With ``chain_arg`` call k+1 consumes
call k's output, so the calls are serialized by data. The events measure
the stream's elapsed time per call: where a stage is host-bound (the
solver's ``torch.func`` linearization) that includes the host's enqueue
time, which is what a caller waits for.

Run on the card:  python -m lfvio_tpu_torch.runtime.profiling [--slots 256] [--iters 8] [--frontend]
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import DeviceProgram, resolve_device


def make_window_problem(n_feat=256, dtype=torch.float32, n_obs_frames=None, seed=0,
                        imu_samples=32, max_iterations=8, estimate_td=True,
                        estimate_extrinsic=True, with_prior=True, device=None):
    """A full-scale, well-posed sliding-window BA problem (the JAX
    package's, from the same seed).

    Production shape by default: 256 feature slots over the 11-frame window
    (the bench rig's configuration), every slot valid across the window, an
    informative marginalization prior, td and extrinsics estimated. Tensors
    land on ``device`` (None: the CUDA card); the raw IMU stays numpy.
    Returns dict(state, grid, dts, accs, gyrs, a0, g0, imu_valid, prior,
    gravity, cfg, noise)."""
    from .. import geom
    from ..backend import FeatureGrid, PriorFactor, SolverConfig, WindowState
    from ..backend.state import NFRAMES, pose_dim
    from ..imu import ImuNoise

    device = resolve_device(device)
    tt = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1.0, NFRAMES)
    p = np.stack([t, 0.15 * np.sin(2 * t), 0.1 * t], -1)
    v = np.gradient(p, t, axis=0)
    theta = np.stack([0.08 * np.sin(3 * t), 0.1 * t, 0.15 * np.sin(2 * t)], -1)
    q = geom.so3_exp(torch.as_tensor(theta)).numpy()
    R = geom.quat_to_mat(torch.as_tensor(q)).numpy()  # [NFRAMES, 3, 3]
    dirs = rng.standard_normal((n_feat, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts_w = p.mean(0) + dirs * rng.uniform(3, 8, (n_feat, 1))

    bearings = np.zeros((n_feat, NFRAMES, 3))
    for j in range(NFRAMES):
        pc = (pts_w - p[j]) @ R[j]
        bearings[:, j] = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    valid = np.ones((n_feat, NFRAMES), bool)
    if n_obs_frames is not None:
        # Realistic track lengths: each feature observed in a contiguous run
        # of n_obs_frames frames starting at its anchor.
        starts = rng.integers(0, NFRAMES - 2, n_feat)
        for f in range(n_feat):
            valid[f] = False
            valid[f, starts[f]: starts[f] + n_obs_frames] = True
        anchor = starts
    else:
        anchor = np.zeros(n_feat, np.int64)
    grid = FeatureGrid(
        bearing=tt(bearings), velocity=tt(0.01 * rng.standard_normal((n_feat, NFRAMES, 3))),
        td_obs=tt(np.zeros((n_feat, NFRAMES))), valid=tt(valid, torch.bool),
        anchor=tt(anchor, torch.int64), used=tt(np.ones(n_feat, bool), torch.bool),
    )
    pc0 = np.einsum("fc,fcd->fd", pts_w - p[anchor], R[anchor])
    inv_depth = 1.0 / np.linalg.norm(pc0, axis=-1)
    state = WindowState(
        p=tt(p), q=tt(q), v=tt(v), ba=tt(np.zeros((NFRAMES, 3))), bg=tt(np.zeros((NFRAMES, 3))),
        tic=tt(np.zeros(3)), qic=tt([1.0, 0, 0, 0]), td=tt(0.0),
        inv_depth=tt(inv_depth * rng.uniform(0.95, 1.05, n_feat)),
    )

    W = NFRAMES - 1
    M = imu_samples
    G = np.array([0.0, 0.0, 9.81])
    dts = np.full((W, M), (t[1] - t[0]) / M)
    accs = np.zeros((W, M, 3))
    for i in range(W):
        a_w = (v[i + 1] - v[i]) / (t[i + 1] - t[i])
        accs[i] = np.tile(R[i].T @ (a_w + G), (M, 1))
    accs += 0.002 * rng.standard_normal(accs.shape)
    gyrs = 0.01 * rng.standard_normal((W, M, 3))

    D = pose_dim(NFRAMES)
    if with_prior:
        A = rng.standard_normal((D, D)) * 0.5
        J = np.linalg.cholesky(A @ A.T + 10.0 * np.eye(D)).T
        prior = PriorFactor.from_state(tt(J), tt(np.zeros(D)), state,
                                       torch.ones((), dtype=torch.bool, device=device))
    else:
        prior = PriorFactor.empty(dtype, device=device)
    cfg = SolverConfig(max_iterations=max_iterations, estimate_td=estimate_td,
                       estimate_extrinsic=estimate_extrinsic)
    return dict(
        state=state, grid=grid, dts=dts, accs=accs, gyrs=gyrs,
        a0=accs[:, 0].copy(), g0=gyrs[:, 0].copy(), imu_valid=np.ones(W, bool),
        prior=prior, gravity=tt(G), cfg=cfg, noise=ImuNoise(0.02, 0.01, 0.04, 0.001),
    )


@dataclasses.dataclass
class StageTime:
    name: str
    ms: float  # per call, between two CUDA events over n back-to-back calls
    first_s: float  # seconds of the first call
    note: str = ""


def time_stage(name, fn, args, n=20, chain_arg=None, note=""):
    """Time fn(*args) on the CUDA card: one first call, then n back-to-back
    calls between two CUDA events. chain_arg=i makes call k+1 consume call
    k's output (its first element for a tuple) at position i."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_stage times on the CUDA card, and there is none")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    args = list(args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn(*args)
        if chain_arg is not None:
            args[chain_arg] = out[0] if isinstance(out, tuple) else out
    end.record()
    end.synchronize()
    return StageTime(name, start.elapsed_time(end) / n, first_s, note)


def profile_solve(n_slots=256, max_iterations=8, dtype=torch.float32, n=20, device=None):
    """Per-stage times of the estimator's solve and marginalization at
    production shapes (the JAX package's rows; on the card also the solve and
    MARGIN_OLD as the estimator runs them, CUDA graph replays, with their
    capture times). Returns a list of StageTime."""
    from ..backend import lm_solve
    from ..backend.gauge import yaw_gauge_fix
    from ..backend.marginalize import marginalize_old_qr, marginalize_second_new_qr
    from ..backend.solver import _schur_solve, assemble_normal_equations, total_cost
    from ..backend.triangulate import triangulate_grid
    from ..imu import preintegrate, whiten_covariance

    pb = make_window_problem(n_slots, dtype, max_iterations=max_iterations, device=device)
    state, grid, prior, gravity, cfg, noise = (
        pb["state"], pb["grid"], pb["prior"], pb["gravity"], pb["cfg"], pb["noise"])
    dev = state.p.device
    imu = [torch.as_tensor(pb[k], dtype=dtype, device=dev) for k in ("dts", "accs", "gyrs", "a0", "g0")]
    imu_valid = torch.as_tensor(pb["imu_valid"], device=dev)
    results = []

    def f_pre(dts, accs, gyrs, a0, g0, ba, bg):
        pre = preintegrate(dts, accs, gyrs, a0, g0, ba, bg, noise)
        si, ok = whiten_covariance(pre.covariance, imu_valid)
        return pre, si, ok

    pre_args = (*imu, state.ba[:-1], state.bg[:-1])
    results.append(time_stage("preintegrate+whiten (10x32 samples)", f_pre, pre_args, n=n))
    pre, sqrt_info, imu_ok = f_pre(*pre_args)

    has_depth = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    results.append(time_stage(f"triangulate_grid ({n_slots} slots)", triangulate_grid,
                              (state, grid, has_depth), n=n))

    def f_lm(s):
        return lm_solve(s, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg)

    results.append(time_stage(f"lm_solve total ({cfg.max_iterations} iters)", f_lm, (state,),
                              n=max(n // 2, 5), chain_arg=0))
    if dev.type == "cuda":
        # The same solve as the estimator runs it on the card: one CUDA graph,
        # captured at the first call and replayed (QR through cuSOLVER, as the
        # estimator selects it: MAGMA's hybrid path cannot be captured).
        torch.backends.cuda.preferred_linalg_library("cusolver")
        prog = DeviceProgram(f_lm, name="lm_solve")
        row = time_stage(f"lm_solve total, CUDA graph replay ({cfg.max_iterations} iters)",
                         prog, (state,), n=max(n // 2, 5), chain_arg=0)
        row.note = f"1 graph captured in {prog.capture_s:.2f} s (first s includes it)"
        results.append(row)

    def f_asm(s):
        return assemble_normal_equations(s, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg)

    results.append(time_stage("  assemble_normal_equations (1x)", f_asm, (state,), n=n))
    lin = f_asm(state)[:5]
    results.append(time_stage("  schur_solve + cholesky (1x)",
                              lambda *a: _schur_solve(*a, 1e-4, grid.used), lin, n=n))
    results.append(time_stage(
        "  total_cost (1x)",
        lambda s: total_cost(s, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg), (state,), n=n))
    results.append(time_stage("yaw_gauge_fix",
                              lambda s: yaw_gauge_fix(s, state.p[0], state.q[0]), (state,), n=n))
    def f_marg(s):
        return marginalize_old_qr(s, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg)

    results.append(time_stage("marginalize_old_qr", f_marg, (state,), n=n))
    if dev.type == "cuda":
        prog = DeviceProgram(f_marg, name="marginalize_old_qr")
        row = time_stage("marginalize_old_qr, CUDA graph replay", prog, (state,), n=n)
        row.note = f"1 graph captured in {prog.capture_s:.2f} s (first s includes it)"
        results.append(row)
    results.append(time_stage("marginalize_second_new_qr",
                              lambda s: marginalize_second_new_qr(s, prior, cfg), (state,), n=n))
    return results


def profile_frontend(n=10, width=1280, height=960, dtype=torch.float32, device=None):
    """Per-stage times of the tracker at the bench rig's scale (the
    mindvision PAL polynomial, CLAHE, 256 slots)."""
    from .synthetic import MINDVISION_POLY, SyntheticWorld, fit_inverse_poly, scaramuzza_camera
    from .tracker import FrontEnd

    W, H = width, height
    device = resolve_device(device)
    cam = scaramuzza_camera(MINDVISION_POLY, fit_inverse_poly(MINDVISION_POLY, max_rho=510.0),
                            W, H, dtype=dtype)
    world = SyntheticWorld(camera=cam, width=W, height=H, device=device)
    fe = FrontEnd(cam, (H, W), max_cnt=200, min_dist=20, n_slots=256,
                  annulus=(W / 2.0, H / 2.0, 500.0 * 0.95, 160.0), equalize=True,
                  dtype=dtype, device=device)
    img0, img1 = world.render_u8(0.0), world.render_u8(1.0 / 15.0)
    fe.process_arrays(img0, 0.0)
    return [
        time_stage("preprocess alone (CLAHE + 4-level pyramid)", fe._preprocess, (img1,), n=n),
        time_stage("tracker step (pre+LK+RANSAC+detect)",
                   lambda *a: fe._step_impl(*a, publish=True),
                   (fe.prev_pyr, img1, fe._dev_pos, fe._dev_valid), n=n),
    ]


def print_table(results):
    w = max(len(r.name) for r in results) + 2
    print(f"{'stage':<{w}} {'ms':>10} {'first s':>9}  note")
    for r in results:
        print(f"{r.name:<{w}} {r.ms:>10.3f} {r.first_s:>9.2f}  {r.note}")


def main(argv=None):
    import argparse
    import subprocess

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--frontend", action="store_true",
                    help="also profile the image front end (1280x960)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}")
    results = profile_solve(args.slots, args.iters, n=args.n)
    if args.frontend:
        results += profile_frontend()
    print_table(results)


if __name__ == "__main__":
    main()
