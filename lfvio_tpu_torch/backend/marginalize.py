"""Schur-complement marginalization producing the window prior.

Port of ``lfvio_tpu.backend.marginalize`` (MarginalizationInfo::marginalize,
marginalization_factor.cpp:174-297), both forms:

  * QR (``marginalize_old_qr``, ``marginalize_second_new_qr``; what the
    runtime uses): the stacked whitened Jacobian rows are column-ordered
    [dropped | kept | residual]; the rows of the R factor below the dropped
    block are the marginal square-root prior on the kept variables. No
    H = JᵀJ is formed, so f32 suffices, and a rank-deficient dropped block
    (the gauge directions) needs no pivot. MARGIN_OLD first removes each
    anchored feature's inverse depth within that feature's own rows
    (``marg_cuda.marg_depth``, one reflection a feature), then both take the
    R factor of their stack over the pose columns (``marg_cuda.marg_qr``):
    on the card the kernels of ``csrc/marg_qr.cu``, on the CPU their plain
    versions. A column with nothing to eliminate consumes no row of R, so
    an empty dropped column loses no information (the JAX package's QR
    does: tests/test_torch_backend.py's empty-column cases).
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

from ..tracing import region
from .factors import prior_residual
from .imu_cuda import imu_rows
from .marg_cuda import _stack_order, marg_depth, marg_qr, stack_columns
from .proj_cuda import proj_rows
from .solver import assemble_normal_equations
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


def _with_unit_rows(A, m):
    """A [R, C] whose first ``m`` columns are dropped, with m rows appended:
    row i is the unit row of column i where that column is all zero, and
    zero elsewhere (residual 0). The mask is computed on the device, so the
    shape is static and nothing is read back (a CUDA graph holds it)."""
    empty = (A[:, :m] == 0).all(dim=0)
    unit = torch.cat([torch.diag(empty.to(A.dtype)),
                      torch.zeros((m, A.shape[1] - m), dtype=A.dtype, device=A.device)], dim=1)
    return torch.cat([A, unit], dim=0)


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


@functools.lru_cache(maxsize=None)
def _imu0_columns(n_frames: int, D: int, device: torch.device):
    """The stack columns of interval 0's 30 Jacobian columns [δpose0, δsb0,
    δpose1, δsb1] (int64 on ``device``, built once)."""
    full = np.r_[pose_off(0):pose_off(0) + 6, sb_off(0, n_frames):sb_off(0, n_frames) + 9,
                 pose_off(1):pose_off(1) + 6, sb_off(1, n_frames):sb_off(1, n_frames) + 9]
    where = np.argsort(_stack_order(n_frames, D))
    return torch.as_tensor(where[full], device=device)


def _prior_rows(state, prior, order):
    """The prior's rows [D, D + 1] in the column order ``order``, then its
    residual at ``state``."""
    rp = prior_residual(state, prior)
    Jp = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    return torch.cat([Jp[:, order], rp[:, None]], dim=1)


def _kept_prior(Rfac, m, D, valid=True):
    """(Jk, rk, ok) from the R factor of a [dropped (m) | kept | r] stack:
    its rows below the dropped block; ok = ``valid`` and both finite; zero
    unless ok."""
    Jk, rk = Rfac[m:D, m:D], Rfac[m:D, D]
    ok = valid & torch.isfinite(Jk).all() & torch.isfinite(rk).all()
    return torch.where(ok, Jk, 0.0), torch.where(ok, rk, 0.0), ok


def old_stack(state: WindowState, grid, pre0, sqrt_info_imu0, imu0_valid, prior: PriorFactor,
              gravity, cfg: SolverConfig):
    """MARGIN_OLD's stack [D + 15 + 2 W F, D + 1] over [pose0, speedbias0 |
    kept | r] (``marg_cuda.stack_columns``): the prior's D rows, IMU(0,1)'s
    15 rows (the dense head, ``marg_qr``'s leaf 0), then 2 W rows a slot of
    ``marg_depth`` (each feature anchored at frame 0 with its inverse depth
    removed)."""
    n_frames = state.p.shape[0]
    dev = state.p.device
    F, W1 = grid.valid.shape
    nc = n_cams_of(state)
    D = pose_dim(n_frames, nc)
    with region("marg_old::linearize"):
        grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
        imu_valid = torch.zeros_like(imu0_valid)
        imu_valid[0] = imu0_valid[0]
        res, J26, w, _ = proj_rows(state, grid0, cfg)
        imu_res, J30 = imu_rows(state, pre0, sqrt_info_imu0, imu_valid, gravity)
    with region("marg_old::stack"):
        stack = torch.empty((D + 15 + F * 2 * (W1 - 1), D + 1), dtype=state.p.dtype, device=dev)
        stack[:D] = _prior_rows(state, prior, stack_columns(n_frames, D, dev))
        imu = stack[D:D + 15]
        imu.zero_()
        imu[:, _imu0_columns(n_frames, D, dev)] = J30[0]
        imu[:, D] = imu_res[0]
        marg_depth(res, J26, w, grid0, cfg, nc, out=stack[D + 15:])
    return stack


def marginalize_old_qr(state: WindowState, grid, pre0, sqrt_info_imu0, imu0_valid,
                       prior: PriorFactor, gravity, cfg: SolverConfig):
    """MARGIN_OLD: old prior + IMU(0,1) + projection factors anchored at
    frame 0; drops {pose0, speedbias0, anchored inverse depths}; returns the
    new PriorFactor re-indexed for the slid window: the rows of
    ``marg_qr`` of ``old_stack`` below the 15 dropped ones. Its ranges
    (``tracing.region``: "marg_old::linearize", "::stack", "::qr",
    "::scatter_slide") split a recording profile's time."""
    n_frames = state.p.shape[0]
    D = pose_dim(n_frames, n_cams_of(state))
    stack = old_stack(state, grid, pre0, sqrt_info_imu0, imu0_valid, prior, gravity, cfg)
    with region("marg_old::qr"):
        Rfac = marg_qr(stack, head=D + 15)
    with region("marg_old::scatter_slide"):
        Jk, rk, ok = _kept_prior(Rfac, 15, D)
        J, r0 = _scatter_prior(Jk, rk, stack_columns(n_frames, D, stack.device)[15:], D)
        return _slid_old(J, r0, state, ok)


def second_new_stack(state: WindowState, prior: PriorFactor):
    """SECOND_NEW's stack [D, D + 1]: the prior's rows over [pose[W-1] |
    kept | r]."""
    drop, keep, _ = _indices("second_new", prior.x0_p.shape[0], prior.J.shape[0], prior.J.device)
    return _prior_rows(state, prior, torch.cat([drop, keep]))


def marginalize_second_new_qr(state: WindowState, prior: PriorFactor, cfg: SolverConfig):
    """MARGIN_SECOND_NEW: the prior is the only participating factor
    (estimator.cpp:949-1005); drop pose[W-1] (``marg_qr`` of
    ``second_new_stack``, one leaf) and re-index for the merge of the
    second-newest frame. ``valid`` stays False for an empty prior."""
    n_frames = prior.x0_p.shape[0]
    D = prior.J.shape[0]
    keep = _indices("second_new", n_frames, D, prior.J.device)[1]
    Rfac = marg_qr(second_new_stack(state, prior), head=D)
    Jk, rk, ok = _kept_prior(Rfac, 6, D, prior.valid)
    J, r0 = _scatter_prior(Jk, rk, keep, D)
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
