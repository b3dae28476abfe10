"""Synthetic segmented-trajectory problems for the keyframe-axis solver.

Port of ``lfvio_tpu.dist.synthetic_traj``: the same constants and the same
``np.random.default_rng`` draws in the same order, so a problem built here
equals the JAX package's (float64: within 1e-12). Exact measurements: a
smooth closed-form trajectory, piecewise-constant world acceleration and
body rate between keyframes, unit bearings of per-segment landmark blocks
(tic = 0, ric = I), optional bearing noise. The trajectory and the IMU
buffers are built in float64 on the host (set-up, not the solve); the
returned problem lands on ``device`` (None: the CUDA card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import geom
from ..backend.solver import lm_solve
from ..backend.state import FeatureGrid, PriorFactor, WindowState, pose_dim
from ..backend.triangulate import triangulate_grid
from ..device import resolve_device
from ..imu import preintegrate, whiten_covariance

G_NORM = 9.81
FRAME_DT = 0.25
N_SAMP = 25  # IMU samples per keyframe interval (100 Hz)


def make_traj(K):
    """Keyframe states exactly consistent with piecewise-constant world
    acceleration between keyframes: closed-form velocities, positions by
    exact trapezoid integration (p_{i+1} = p_i + ½(v_i+v_{i+1})·dt), so the
    duplicated boundary keyframes of two segments see consistent IMU."""
    t = np.arange(K) * FRAME_DT
    v = np.stack([
        0.6 * np.cos(0.5 * t), 0.45 * np.cos(0.35 * t + 0.4),
        0.2 * np.cos(0.8 * t),
    ], -1)
    p = np.zeros((K, 3))
    for i in range(K - 1):
        p[i + 1] = p[i] + 0.5 * (v[i] + v[i + 1]) * FRAME_DT
    theta = np.stack([
        0.10 * np.sin(0.6 * t), 0.12 * np.sin(0.45 * t + 1.0),
        0.3 * np.sin(0.25 * t),
    ], -1)
    q = geom.so3_exp(torch.as_tensor(theta)).numpy()
    return t, p, v, q


def make_imu_buffers(p, v, q):
    """Raw padded IMU sample buffers [K-1, M(,3)] exactly consistent with
    the trajectory (piecewise-constant world acceleration and body rate),
    every interval and sample at once."""
    W = len(p) - 1
    q = torch.as_tensor(q, dtype=torch.float64)
    a_w = (v[1:] - v[:-1]) / FRAME_DT
    omega = geom.so3_log(geom.quat_mul(geom.quat_conj(q[:-1]), q[1:])).numpy() / FRAME_DT
    s = np.arange(N_SAMP + 1) / N_SAMP
    qk = geom.quat_mul(q[:-1, None], geom.so3_exp(torch.as_tensor(
        omega[:, None, :] * s[None, :, None] * FRAME_DT)))
    Rk = geom.quat_to_mat(qk).numpy()  # [W, N_SAMP + 1, 3, 3]
    acc = np.einsum("wkij,wi->wkj", Rk, a_w + np.array([0.0, 0.0, G_NORM]))
    dts = np.full((W, N_SAMP), FRAME_DT / N_SAMP)
    gyrs = np.repeat(omega[:, None, :], N_SAMP, axis=1)
    return dts, acc[:, 1:], gyrs, acc[:, 0], omega


def seg_landmarks(p, s, Wseg, n_feat, seed=10):
    rng = np.random.default_rng(seed + s)
    mid = p[s * Wseg : s * Wseg + Wseg + 1].mean(0)
    dirs = rng.standard_normal((n_feat, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radius = rng.uniform(3.0, 7.0, (n_feat, 1))
    return mid + dirs * radius


def bearings_for(pts_w, p, q, noise=0.0, rng=None):
    """Unit bearings of pts_w from each keyframe (tic=0, ric=I)."""
    n_feat = len(pts_w)
    K = len(p)
    b = np.zeros((n_feat, K, 3))
    for j in range(K):
        Rj = geom.quat_to_mat(torch.as_tensor(q[j])).numpy()
        x = (pts_w - p[j]) @ Rj
        bb = x / np.linalg.norm(x, axis=-1, keepdims=True)
        if noise > 0:
            bb = bb + rng.standard_normal(bb.shape) * noise
            bb /= np.linalg.norm(bb, axis=-1, keepdims=True)
        b[:, j] = bb
    return b


def anchor_prior(D, K_frames, anchors, x0_state, dtype=torch.float64):
    """PriorFactor with diagonal 15-dof anchors {kf_index: weight}, on
    ``x0_state``'s device."""
    J = np.zeros((D, D))
    for j, w in anchors.items():
        for k in range(6):
            J[6 * j + k, 6 * j + k] = w
        off = 6 * K_frames + 9 * j
        for k in range(9):
            J[off + k, off + k] = w
    dev = x0_state.p.device
    return PriorFactor.from_state(
        torch.as_tensor(J, dtype=dtype, device=dev), torch.zeros(D, dtype=dtype, device=dev),
        x0_state, torch.ones((), dtype=torch.bool, device=dev))


def make_state(p, v, q, inv_depth, dtype=torch.float64, device=None):
    K = len(p)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return WindowState(
        p=t(p), q=t(q), v=t(v), ba=t(np.zeros((K, 3))), bg=t(np.zeros((K, 3))),
        tic=t(np.zeros(3)), qic=t([1.0, 0.0, 0.0, 0.0]), td=t(0.0), inv_depth=t(inv_depth),
    )


def build_grid(bear, valid, anchor, dtype=torch.float64, device=None):
    n_feat, K = valid.shape
    return FeatureGrid(
        bearing=torch.as_tensor(bear, dtype=dtype, device=device),
        velocity=torch.zeros((n_feat, K, 3), dtype=dtype, device=device),
        td_obs=torch.zeros((n_feat, K), dtype=dtype, device=device),
        valid=torch.as_tensor(valid, dtype=torch.bool, device=device),
        anchor=torch.as_tensor(anchor, dtype=torch.int64, device=device),
        used=torch.ones(n_feat, dtype=torch.bool, device=device),
    )


def _stack(items):
    """One dataclass of tensors batched over a new leading axis."""
    return dataclasses.replace(items[0], **{
        f.name: None if getattr(items[0], f.name) is None
        else torch.stack([getattr(x, f.name) for x in items])
        for f in dataclasses.fields(items[0])})


def make_segmented_problem(S, Wseg, Fseg, dtype=torch.float64, noise=0.0,
                           perturb=0.04, seed=3, device=None):
    """Batched per-segment (states, grids, imu buffers, priors) for
    ``segmented_trajectory_solve``, plus the underlying ground truth.

    Returns a dict with keys: states, grids, dts, accs, gyrs, a0, g0,
    imu_valid (all batched with leading S), priors, truth (t, p, v, q),
    seg_bear (list), p_init/v_init/q_init (global [K] arrays)."""
    device = resolve_device(device)
    K = S * Wseg + 1
    rng = np.random.default_rng(seed)
    t, p, v, q = make_traj(K)
    dts, accs, gyrs, a0, g0 = make_imu_buffers(p, v, q)
    seg_pts = [seg_landmarks(p, s, Wseg, Fseg) for s in range(S)]
    seg_bear = [
        bearings_for(seg_pts[s], p[s * Wseg : s * Wseg + Wseg + 1],
                     q[s * Wseg : s * Wseg + Wseg + 1], noise, rng)
        for s in range(S)
    ]
    p_init = p + rng.standard_normal(p.shape) * perturb
    p_init[0] = p[0]
    v_init = v + rng.standard_normal(v.shape) * perturb / 2
    q_init = geom.quat_mul(
        torch.as_tensor(q),
        geom.so3_exp(torch.as_tensor(rng.standard_normal((K, 3)) * 0.005)),
    ).numpy()

    W1 = Wseg + 1
    D_seg = pose_dim(W1, 1)
    states, grids, priors = [], [], []
    for s in range(S):
        fr = slice(s * Wseg, s * Wseg + Wseg + 1)
        states.append(make_state(p_init[fr], v_init[fr], q_init[fr], np.ones(Fseg), dtype,
                                 device))
        grids.append(build_grid(seg_bear[s], np.ones((Fseg, W1), bool),
                                np.zeros((Fseg,), np.int64), dtype, device))
        w0 = 300.0 if s == 0 else 0.3
        tr = make_state(p[fr], v[fr], q[fr], np.ones(Fseg), dtype, device)
        priors.append(anchor_prior(D_seg, W1, {0: w0}, tr, dtype))
    t_ = lambda a, *shape: torch.as_tensor(a.reshape(S, Wseg, *shape), dtype=dtype,
                                           device=device)
    return dict(
        states=_stack(states), grids=_stack(grids), priors=_stack(priors),
        dts=t_(dts, -1), accs=t_(accs, -1, 3), gyrs=t_(gyrs, -1, 3), a0=t_(a0, 3),
        g0=t_(g0, 3), imu_valid=torch.ones((S, Wseg), dtype=torch.bool, device=device),
        truth=(t, p, v, q), seg_bear=seg_bear,
        p_init=p_init, v_init=v_init, q_init=q_init,
    )


def solve_joint(pb, imu_noise, cfg):
    """The monolithic reference of tests/test_kf_axis.py: the factors of a
    segmented problem ``pb`` as ONE window over the whole trajectory (every
    segment's landmarks anchored at its first keyframe and observed over
    its own keyframes, the IMU of every interval, the strong anchor on
    keyframe 0 and the weak 0.3 anchor on every other segment's first
    keyframe: the segmented solve's factor set), preintegrated,
    triangulated and solved by ``lm_solve`` in ``pb``'s dtype on its device.
    Returns (state, initial cost, final cost)."""
    S, Wseg = pb["dts"].shape[:2]
    Fseg = pb["grids"].valid.shape[1]
    dtype, device = pb["dts"].dtype, pb["dts"].device
    K = S * Wseg + 1
    _, p, v, q = pb["truth"]
    bear = np.zeros((S * Fseg, K, 3))
    bear[..., 2] = 1.0
    valid = np.zeros((S * Fseg, K), bool)
    anchor = np.zeros((S * Fseg,), np.int64)
    for s in range(S):
        rows, fr = slice(s * Fseg, (s + 1) * Fseg), slice(s * Wseg, s * Wseg + Wseg + 1)
        bear[rows, fr] = pb["seg_bear"][s]
        valid[rows, fr] = True
        anchor[rows] = s * Wseg
    anchors = {0: 300.0, **{s * Wseg: 0.3 for s in range(1, S)}}
    prior = anchor_prior(pose_dim(K, 1), K, anchors,
                         make_state(p, v, q, np.ones(S * Fseg), dtype, device), dtype)
    state = make_state(pb["p_init"], pb["v_init"], pb["q_init"], np.ones(S * Fseg), dtype, device)
    grid = build_grid(bear, valid, anchor, dtype, device)
    imu = [pb[k].reshape(S * Wseg, *pb[k].shape[2:]) for k in ("dts", "accs", "gyrs", "a0", "g0")]
    pre = preintegrate(*imu, state.ba[:-1], state.bg[:-1], imu_noise)
    sqrt_info, imu_ok = whiten_covariance(pre.covariance, pb["imu_valid"].reshape(-1))
    state = state.replace(inv_depth=triangulate_grid(
        state, grid, torch.zeros(S * Fseg, dtype=torch.bool, device=device)))
    gravity = torch.tensor([0.0, 0.0, G_NORM], dtype=dtype, device=device)
    out, c0, c1, _ = lm_solve(state, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg)
    return out, c0, c1
