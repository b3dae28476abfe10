"""Schur-complement marginalization producing the window prior.

Port of ``lfvio_tpu.backend.marginalize`` (MarginalizationInfo::marginalize,
marginalization_factor.cpp:174-297), both forms:

  * QR (``marginalize_old_qr``, ``marginalize_second_new_qr``; what the
    runtime uses): the stacked whitened Jacobian rows are column-ordered
    [dropped | kept | residual]; the rows of the R factor below the dropped
    block are the marginal square-root prior on the kept variables. No
    H = JᵀJ is formed, so f32 suffices, and a rank-deficient dropped block
    (the gauge directions) needs no pivot.
  * eigh (``marginalize_old``, ``marginalize_second_new``): the reference's
    own H-space elimination with its eigenvalue pseudo-inverse and the
    square root J = S^{1/2} Vᵀ, r = S^{-1/2} Vᵀ b. Forming H squares the
    condition number, so these take float64 only.

R's row signs and the eigenvectors' signs (and their rotation within a
repeated eigenvalue) depend on the implementation; every use of the prior
goes through JᵀJ, Jᵀr and |r|², which do not.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .factors import prior_residual
from .solver import assemble_normal_equations, linearize_imu_rows, linearize_proj_rows
from .state import (
    PriorFactor,
    SolverConfig,
    WindowState,
    n_cams_of,
    pose_dim,
    pose_off,
    sb_off,
)

EPS = 1e-8  # reference eigenvalue threshold (marginalization_factor.h eps)


def _drop_keep_old(n_frames: int, D: int):
    """Static column indices for MARGIN_OLD: drop pose0 (6) + speedbias0 (9)."""
    drop = np.r_[pose_off(0):pose_off(0) + 6, sb_off(0, n_frames):sb_off(0, n_frames) + 9]
    keep = np.setdiff1d(np.arange(D), drop)
    return drop, keep


def _drop_keep_second_new(n_frames: int, D: int):
    """Static column indices for MARGIN_SECOND_NEW: drop pose[W-1] (6)."""
    drop = np.arange(pose_off(n_frames - 2), pose_off(n_frames - 2) + 6)
    return drop, np.setdiff1d(np.arange(D), drop)


def _slide_perm(n_frames: int, D: int, src_of):
    """Column permutation for a window slide: new slot k takes old slot
    src_of(k)'s pose and speed-bias columns; ex + td unchanged."""
    perm = []
    for k in range(n_frames):
        perm.extend(range(pose_off(src_of(k)), pose_off(src_of(k)) + 6))
    for k in range(n_frames):
        s = sb_off(src_of(k), n_frames)
        perm.extend(range(s, s + 9))
    perm.extend(range(15 * n_frames, D))
    return perm


@functools.lru_cache(maxsize=None)
def _indices(kind: str, n_frames: int, D: int, device: torch.device):
    """(drop, keep, slide permutation) of a marginalization kind as int64
    tensors on ``device``, built once: an index copied from the host cannot
    be captured in a CUDA graph, and a program's warm-up call, outside the
    capture, builds them."""
    W = n_frames - 1
    if kind == "old":
        drop, keep = _drop_keep_old(n_frames, D)
        perm = _slide_perm(n_frames, D, lambda k: (k + 1) % n_frames)
    else:
        drop, keep = _drop_keep_second_new(n_frames, D)
        perm = _slide_perm(n_frames, D, lambda k: k if k < W - 1 else W)
    return tuple(torch.as_tensor(np.asarray(a, np.int64), device=device)
                 for a in (drop, keep, perm))


def _scatter_prior(Jk, rk, keep, D):
    J = torch.zeros((D, D), dtype=Jk.dtype, device=Jk.device)
    r0 = torch.zeros((D,), dtype=Jk.dtype, device=Jk.device)
    J[keep[:, None], keep[None, :]] = Jk
    r0[keep] = rk
    return J, r0


def _zero_last_slot(J, n_frames):
    """The refreshed newest slot carries no prior information."""
    W = n_frames - 1
    # fill_, not "= 0.0": a Python scalar assigned to a CUDA slice is copied
    # from the host, which a CUDA graph cannot hold.
    J[:, pose_off(W):pose_off(W) + 6].fill_(0.0)
    J[:, sb_off(W, n_frames):sb_off(W, n_frames) + 9].fill_(0.0)
    return J


def _slid_old(J, r0, state: WindowState, valid):
    """The prior re-indexed for MARGIN_OLD's slide: new slot k takes old slot
    k+1's columns, the last slot's columns (the eliminated frame 0's, zero)
    are zeroed explicitly, and x0 shifts the same way."""
    n_frames = state.p.shape[0]
    perm = _indices("old", n_frames, J.shape[1], J.device)[2]
    J = _zero_last_slot(J[:, perm], n_frames)

    def roll(a):
        return torch.cat([a[1:], a[-1:]], dim=0)

    x0 = state.replace(p=roll(state.p), q=roll(state.q), v=roll(state.v),
                       ba=roll(state.ba), bg=roll(state.bg))
    return PriorFactor.from_state(J, r0, x0, valid)


def _slid_second_new(J, r0, state: WindowState, valid):
    """The prior re-indexed for MARGIN_SECOND_NEW's merge: slots 0..W-2 keep
    their columns, slot W-1 takes slot W's; x0's slot W-1 takes slot W's
    values (the surviving newest frame)."""
    n_frames = state.p.shape[0]
    W = n_frames - 1
    perm = _indices("second_new", n_frames, J.shape[1], J.device)[2]
    J = _zero_last_slot(J[:, perm], n_frames)

    def merge(a):
        a = a.clone()
        a[W - 1] = a[W]
        return a

    x0 = state.replace(p=merge(state.p), q=merge(state.q), v=merge(state.v),
                       ba=merge(state.ba), bg=merge(state.bg))
    return PriorFactor.from_state(J, r0, x0, valid)


def marginalize_old_qr(state: WindowState, grid, pre0, sqrt_info_imu0, imu0_valid,
                       prior: PriorFactor, gravity, cfg: SolverConfig):
    """MARGIN_OLD: old prior + IMU(0,1) + projection factors anchored at
    frame 0; drops {pose0, speedbias0, anchored inverse depths}; returns the
    new PriorFactor re-indexed for the slid window."""
    n_frames = state.p.shape[0]
    dtype, dev = state.p.dtype, state.p.device
    F, W1 = grid.valid.shape
    D = pose_dim(n_frames, n_cams_of(state))

    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    imu_valid = torch.zeros_like(imu0_valid)
    imu_valid[0] = imu0_valid[0]
    res_w, Jfull, J_lam, _, _ = linearize_proj_rows(state, grid0, cfg)
    imu_res, Jimu, _ = linearize_imu_rows(state, pre0, sqrt_info_imu0, imu_valid, gravity)
    rp = prior_residual(state, prior)
    Jp = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))

    R1 = F * W1 * 2
    # Depth columns: row (f, j, a) touches depth column f only.
    dep_rows = (J_lam[..., None] * torch.eye(F, dtype=dtype, device=dev)[:, None, None, :]).reshape(R1, F)
    A_pose = torch.cat([Jfull.reshape(R1, D), Jimu, Jp], dim=0)
    A_dep = torch.cat(
        [dep_rows, torch.zeros((Jimu.shape[0] + D, F), dtype=dtype, device=dev)], dim=0
    )
    r = torch.cat([res_w.reshape(R1), imu_res.reshape(-1), rp])
    drop, keep, _ = _indices("old", n_frames, D, dev)
    A = torch.cat([A_pose[:, drop], A_dep, A_pose[:, keep], r[:, None]], dim=1)
    m, K = len(drop) + F, len(keep)
    Rfac = torch.linalg.qr(A, mode="r")[1]
    Jk = Rfac[m:m + K, m:m + K]
    rk = Rfac[m:m + K, m + K]
    ok = torch.isfinite(Jk).all() & torch.isfinite(rk).all()
    J, r0 = _scatter_prior(torch.where(ok, Jk, 0.0), torch.where(ok, rk, 0.0), keep, D)
    return _slid_old(J, r0, state, ok)


def marginalize_second_new_qr(state: WindowState, prior: PriorFactor, cfg: SolverConfig):
    """MARGIN_SECOND_NEW: the prior is the only participating factor
    (estimator.cpp:949-1005); drop pose[W-1] and re-index for the merge of
    the second-newest frame. ``valid`` stays False for an empty prior."""
    n_frames = prior.x0_p.shape[0]
    D = prior.J.shape[0]
    dev = prior.J.device
    rp = prior_residual(state, prior)
    J0 = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    drop, keep, _ = _indices("second_new", n_frames, D, dev)
    K = len(keep)
    A = torch.cat([J0[:, drop], J0[:, keep], rp[:, None]], dim=1)
    Rfac = torch.linalg.qr(A, mode="r")[1]
    Jk = Rfac[6:6 + K, 6:6 + K]
    rk = Rfac[6:6 + K, 6 + K]
    ok = prior.valid & torch.isfinite(Jk).all() & torch.isfinite(rk).all()
    J, r0 = _scatter_prior(torch.where(ok, Jk, 0.0), torch.where(ok, rk, 0.0), keep, D)
    return _slid_second_new(J, r0, state, ok)


# ------------------------------------------------------------------ eigh
def _require_f64(x):
    if x.dtype != torch.float64:
        raise TypeError(f"the eigh marginalization needs float64, got {x.dtype}: forming "
                        "H = JᵀJ squares the condition number (use the QR paths in float32)")


def _eliminate_indices(H, b, drop_idx):
    """Schur-eliminate the rows / columns ``drop_idx`` (static indices) with
    an eigendecomposition pseudo-inverse of their block
    (marginalization_factor.cpp:266-281). The output keeps the full shape
    with the eliminated rows and columns zeroed."""
    D = H.shape[0]
    idx = torch.as_tensor(np.asarray(drop_idx, np.int64), device=H.device)
    keep = torch.ones(D, dtype=H.dtype, device=H.device)
    keep[idx] = 0.0
    Amm = H[idx[:, None], idx[None, :]]
    w, V = torch.linalg.eigh(0.5 * (Amm + Amm.T))
    # Relative threshold: the spectrum spans ~[0, 1e7] with sqrt_info² scales,
    # and an absolute eps would keep noisy near-null directions.
    thr = torch.clamp(torch.max(torch.abs(w)) * 1e-12, min=EPS)
    inv_w = torch.where(w > thr, 1.0 / torch.maximum(w, thr), 0.0)
    Amm_inv = (V * inv_w[None, :]) @ V.T
    Hm = H[:, idx]
    H_new = H - Hm @ Amm_inv @ Hm.T
    b_new = b - Hm @ (Amm_inv @ b[idx])
    return H_new * keep[:, None] * keep[None, :], b_new * keep


def _sqrt_factorize(H, b):
    """J, r with JᵀJ = H and Jᵀr = b on H's numerically non-null eigenspace
    (marginalization_factor.cpp:283-291)."""
    w, V = torch.linalg.eigh(0.5 * (H + H.T))
    thr = torch.clamp(torch.max(w) * 1e-10, min=EPS)
    S = torch.where(w > thr, w, 0.0)
    S_inv = torch.where(w > thr, 1.0 / torch.maximum(w, thr), 0.0)
    J = torch.sqrt(S)[:, None] * V.T
    r = (torch.sqrt(S_inv)[:, None] * V.T) @ b
    return J, r


def marginalize_old(state: WindowState, grid, pre0, sqrt_info_imu0, imu0_valid,
                    prior: PriorFactor, gravity, cfg: SolverConfig):
    """MARGIN_OLD in H space (float64): the factors of ``marginalize_old_qr``
    assembled into normal equations; the anchored inverse depths are
    eliminated analytically (their block is diagonal), then pose0 and
    speedbias0 through the pseudo-inverse; returns the new PriorFactor
    re-indexed for the slid window."""
    _require_f64(state.p)
    n_frames = state.p.shape[0]
    D = pose_dim(n_frames, n_cams_of(state))
    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    imu_valid = torch.zeros_like(imu0_valid)
    imu_valid[0] = imu0_valid[0]
    H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
        state, grid0, pre0, sqrt_info_imu0, imu_valid, prior, gravity, cfg)
    drop_f = grid0.used & (H_ll > EPS)
    inv_Hll = torch.where(drop_f, 1.0 / torch.clamp(H_ll, min=EPS), 0.0)
    H_pp = H_pp - (H_pl * inv_Hll[None, :]) @ H_pl.T
    b_p = b_p - H_pl @ (inv_Hll * b_l)
    drop, _ = _drop_keep_old(n_frames, D)
    J, r = _sqrt_factorize(*_eliminate_indices(H_pp, b_p, drop))
    return _slid_old(J, r, state, torch.ones((), dtype=torch.bool, device=J.device))


def marginalize_second_new(state: WindowState, prior: PriorFactor, cfg: SolverConfig):
    """MARGIN_SECOND_NEW in H space (float64): the prior evaluated at the
    current state, pose[W-1] eliminated, re-indexed for the merge of the
    second-newest frame (estimator.cpp:949-1005)."""
    _require_f64(prior.J)
    n_frames = prior.x0_p.shape[0]
    rp = prior_residual(state, prior)
    J0 = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    drop, _ = _drop_keep_second_new(n_frames, J0.shape[0])
    J, r = _sqrt_factorize(*_eliminate_indices(J0.T @ J0, J0.T @ rp, drop))
    return _slid_second_new(J, r, state, torch.ones((), dtype=torch.bool, device=J.device))
