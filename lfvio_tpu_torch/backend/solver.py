"""Sliding-window bundle adjustment: dense Schur + Levenberg-Marquardt.

Port of ``lfvio_tpu.backend.solver`` (the reference's Ceres DENSE_SCHUR
solve, estimator.cpp:810-825):

  1. Per-factor Jacobians by forward-mode autodiff on the tangent
     perturbation (``torch.func.jacfwd``), vmapped over every observation of
     the [F, W+1] grid and over the W IMU intervals.
  2. Dense normal equations in the full local layout: H_pp [D, D],
     H_pl [D, F] and the diagonal H_ll [F]. Each observation's extrinsic
     blocks are scattered to its camera's columns with ``index_add_``.
  3. Schur elimination of the inverse depths, one Cholesky of the reduced
     D×D system (``cholesky_ex`` and two triangular solves: a non-PD system
     gives a non-finite step, which LM rejects, as jnp.linalg.cholesky's
     NaN does).
  4. LM in the JAX form: a fixed count of iterations whose accept/reject,
     linearization reuse after a rejected step and relative cost-plateau
     exit are selected on the device (``torch.where``), so a solve reads
     nothing back and can be captured as one CUDA graph.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch.func import jacfwd, vmap

from ..geom import quat_mul, quat_normalize, so3_exp, tangent_basis
from ..imu import Preintegration, imu_residual
from .factors import (
    anchor_values,
    cauchy_corrector,
    obs_extrinsics,
    imu_residuals_window,
    prior_residual,
    projection_residual,
    projection_residuals_grid,
    residual_mask,
)
from .state import (
    FeatureGrid,
    PriorFactor,
    SolverConfig,
    WindowState,
    ex_2d,
    n_cams_of,
    pose_dim,
)


def apply_delta(state: WindowState, dx, dlam, cfg: SolverConfig):
    """Retract the full tangent step onto the state (right-multiplicative
    quaternion update, cf. PoseLocalParameterization::Plus)."""
    n = state.p.shape[0]
    C = n_cams_of(state)
    pose = dx[: 6 * n].reshape(n, 6)
    sb = dx[6 * n : 15 * n].reshape(n, 9)
    dex = dx[15 * n : 15 * n + 6 * C].reshape(C, 6)
    if cfg.estimate_extrinsic:
        tics, qics = ex_2d(state.tic, state.qic)
        tic = tics + dex[:, 0:3]
        qic = quat_normalize(quat_mul(qics, so3_exp(dex[:, 3:6])))
        if state.tic.ndim == 1:
            tic, qic = tic[0], qic[0]
    else:
        tic, qic = state.tic, state.qic
    return WindowState(
        p=state.p + pose[:, 0:3],
        q=quat_normalize(quat_mul(state.q, so3_exp(pose[:, 3:6]))),
        v=state.v + sb[:, 0:3],
        ba=state.ba + sb[:, 3:6],
        bg=state.bg + sb[:, 6:9],
        tic=tic,
        qic=qic,
        td=state.td + dx[-1] if cfg.estimate_td else state.td,
        inv_depth=state.inv_depth + dlam,
    )


def _proj_local_residual(d, p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j,
                         inv_dep, td, pts_i, pts_j, vel_i, vel_j, td_obs_i,
                         td_obs_j, tb, sqrt_info):
    """One projection residual as a function of the 26-dim perturbation
    [δpose_i(6), δpose_j(6), δex_i(6), δex_j(6), δλ(1), δtd(1)]. The anchor-
    and observation-side extrinsics are perturbed separately; where both
    observations come from one camera their blocks land in the same columns
    and add (the total derivative)."""
    r = projection_residual(
        p_i + d[0:3], quat_mul(q_i, so3_exp(d[3:6])),
        p_j + d[6:9], quat_mul(q_j, so3_exp(d[9:12])),
        tic_i + d[12:15], quat_mul(qic_i, so3_exp(d[15:18])),
        tic_j + d[18:21], quat_mul(qic_j, so3_exp(d[21:24])),
        inv_dep + d[24], td + d[25],
        pts_i, pts_j, vel_i, vel_j, td_obs_i, td_obs_j, tb, sqrt_info,
    )
    return r, r


def _imu_local_residual(d, dp, dq, dv, jac, sum_dt, lba, lbg, si,
                        p0, q0, v0, ba0, bg0, p1, q1, v1, ba1, bg1, gravity):
    """One whitened IMU residual as a function of the 30-dim perturbation
    [δpose_i(6), δsb_i(9), δpose_j(6), δsb_j(9)]."""
    pre = Preintegration(dp, dq, dv, jac, None, sum_dt, lba, lbg)
    r = imu_residual(
        pre,
        p0 + d[0:3], quat_mul(q0, so3_exp(d[3:6])), v0 + d[6:9],
        ba0 + d[9:12], bg0 + d[12:15],
        p1 + d[15:18], quat_mul(q1, so3_exp(d[18:21])), v1 + d[21:24],
        ba1 + d[24:27], bg1 + d[27:30], gravity,
    )
    r = si @ r
    return r, r


def linearize_projection(state: WindowState, grid: FeatureGrid, cfg: SolverConfig):
    """Residuals and per-factor Jacobians over the whole grid.
    Returns (res [F,W1,2], J26 [F,W1,2,26], valid [F,W1], w [F,W1,1])."""
    F, W1 = grid.valid.shape
    dtype = state.p.dtype
    p_i, q_i, pts_i, vel_i, td_obs_i = anchor_values(state, grid)
    tic_i, qic_i, tic_j, qic_j = obs_extrinsics(state, grid)

    def per_obs(x, k):  # [F, ...] anchor-side or [W1, ...] frame-side -> [F*W1, ...]
        x = x[:, None] if k == "f" else x[None]
        return x.expand(F, W1, *x.shape[2:]).reshape(F * W1, *x.shape[2:])

    args = (
        per_obs(p_i, "f"), per_obs(q_i, "f"), per_obs(state.p, "w"),
        per_obs(state.q, "w"),
        per_obs(tic_i, "f"), per_obs(qic_i, "f"),
        tic_j.reshape(F * W1, 3), qic_j.reshape(F * W1, 4),
        per_obs(state.inv_depth, "f"),
        per_obs(pts_i, "f"), grid.bearing.reshape(F * W1, 3),
        per_obs(vel_i, "f"), grid.velocity.reshape(F * W1, 3),
        per_obs(td_obs_i, "f"), grid.td_obs.reshape(F * W1),
        tangent_basis(grid.bearing).reshape(F * W1, 2, 3),
    )

    def fn(d, p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j, lam,
           pts_i, pts_j, vel_i, vel_j, tdo_i, tdo_j, tb):
        return _proj_local_residual(
            d, p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j, lam, state.td,
            pts_i, pts_j, vel_i, vel_j, tdo_i, tdo_j, tb, cfg.proj_sqrt_info,
        )

    zero26 = torch.zeros(26, dtype=dtype, device=state.p.device)
    J26, res = vmap(jacfwd(fn, has_aux=True), in_dims=(None,) + (0,) * len(args))(
        zero26, *args
    )
    res = res.reshape(F, W1, 2)
    J26 = J26.reshape(F, W1, 2, 26)
    valid = residual_mask(grid)
    res = torch.where(valid[..., None], res, 0.0)
    J26 = torch.where(valid[..., None, None], J26, 0.0)
    return res, J26, valid, cauchy_corrector(res, cfg.cauchy_c)


def linearize_proj_rows(state: WindowState, grid: FeatureGrid, cfg: SolverConfig):
    """Whitened, robust-weighted projection rows in the full local layout.

    Returns (res_w [F,W1,2], Jfull [F,W1,2,D], J_lam [F,W1,2], valid [F,W1],
    cost)."""
    F, W1 = grid.valid.shape
    dtype, dev = state.p.dtype, state.p.device
    C = n_cams_of(state)
    res, J26, valid, w = linearize_projection(state, grid, cfg)
    sq = torch.sum(res * res, dim=-1)
    c2 = cfg.cauchy_c**2
    cost = 0.5 * torch.sum(torch.where(valid, c2 * torch.log1p(sq / c2), 0.0))
    res_w = res * w
    J26 = J26 * w[..., None]

    J_pi, J_pj = J26[..., 0:6], J26[..., 6:12]
    J_exi, J_exj = J26[..., 12:18], J26[..., 18:24]
    J_lam, J_td = J26[..., 24], J26[..., 25]
    if not cfg.estimate_extrinsic:
        J_exi, J_exj = torch.zeros_like(J_exi), torch.zeros_like(J_exj)
    if not cfg.estimate_td:
        J_td = torch.zeros_like(J_td)

    # One-hot anchors [F, W1] by comparison (one_hot checks its classes on the
    # host off the card).
    onehot = (grid.anchor[:, None] == torch.arange(W1, device=dev)).to(dtype)
    eyeW = torch.eye(W1, dtype=dtype, device=dev)
    Jpose = torch.einsum("fjac,jk->fjakc", J_pj, eyeW) + torch.einsum(
        "fjac,fk->fjakc", J_pi, onehot
    )
    # Extrinsic columns (camera-major [C, 6]): the anchor-side block goes to
    # the anchor observation's camera, the observation-side block to the
    # observing camera; blocks of one camera add.
    cam_j = grid.cam_index().reshape(-1)  # [F*W1]
    cam_i = grid.cam_index()[torch.arange(F, device=dev), grid.anchor][:, None].expand(F, W1)
    cam_i = cam_i.reshape(-1)
    row = torch.arange(F * W1, device=dev) * C
    Jex = torch.zeros((F * W1 * C, 2, 6), dtype=dtype, device=dev)
    Jex.index_add_(0, row + cam_j, J_exj.reshape(F * W1, 2, 6))
    Jex.index_add_(0, row + cam_i, J_exi.reshape(F * W1, 2, 6))
    Jex = Jex.reshape(F, W1, C, 2, 6).permute(0, 1, 3, 2, 4).reshape(F, W1, 2, 6 * C)
    Jfull = torch.cat(
        [
            Jpose.reshape(F, W1, 2, 6 * W1),
            torch.zeros((F, W1, 2, 9 * W1), dtype=dtype, device=dev),
            Jex,
            J_td[..., None],
        ],
        dim=-1,
    )
    return res_w, Jfull, J_lam, valid, cost


def linearize_imu_rows(state: WindowState, pre: Preintegration, sqrt_info_imu,
                       imu_valid, gravity):
    """Whitened IMU rows in the full local layout.
    Returns (imu_res [W,15], Jimu [W*15, D], cost)."""
    W1 = state.p.shape[0]
    W = W1 - 1
    C = n_cams_of(state)
    D = pose_dim(W1, C)
    dtype, dev = state.p.dtype, state.p.device
    zero30 = torch.zeros(30, dtype=dtype, device=dev)
    fn = partial(_imu_local_residual, gravity=gravity)
    args = (
        pre.delta_p, pre.delta_q, pre.delta_v, pre.jacobian, pre.sum_dt,
        pre.linearized_ba, pre.linearized_bg, sqrt_info_imu,
        state.p[:-1], state.q[:-1], state.v[:-1], state.ba[:-1], state.bg[:-1],
        state.p[1:], state.q[1:], state.v[1:], state.ba[1:], state.bg[1:],
    )
    J30, imu_res = vmap(jacfwd(fn, has_aux=True), in_dims=(None,) + (0,) * len(args))(
        zero30, *args
    )
    imu_res = torch.where(imu_valid[:, None], imu_res, 0.0)
    J30 = torch.where(imu_valid[:, None, None], J30, 0.0)
    cost = 0.5 * torch.sum(imu_res * imu_res)

    eyeW = torch.eye(W1, dtype=dtype, device=dev)
    eye_i, eye_j = eyeW[:W], eyeW[1:]  # interval w -> frames w, w+1
    Jp = torch.einsum("wrc,wk->wrkc", J30[..., 0:6], eye_i) + torch.einsum(
        "wrc,wk->wrkc", J30[..., 15:21], eye_j
    )
    Jsb = torch.einsum("wrc,wk->wrkc", J30[..., 6:15], eye_i) + torch.einsum(
        "wrc,wk->wrkc", J30[..., 21:30], eye_j
    )
    Jimu = torch.cat(
        [
            Jp.reshape(W, 15, 6 * W1),
            Jsb.reshape(W, 15, 9 * W1),
            torch.zeros((W, 15, 6 * C + 1), dtype=dtype, device=dev),
        ],
        dim=-1,
    ).reshape(W * 15, D)
    return imu_res, Jimu, cost


def assemble_normal_equations(state, grid, pre, sqrt_info_imu, imu_valid,
                              prior, gravity, cfg):
    """(H_pp, H_pl, H_ll, b_p, b_l, cost) at the current linearization."""
    F, W1 = grid.valid.shape
    D = pose_dim(W1, n_cams_of(state))
    res_w, Jfull, J_lam, _, cost_proj = linearize_proj_rows(state, grid, cfg)
    Jmat = Jfull.reshape(F * W1 * 2, D)
    rvec = res_w.reshape(-1)
    H_pp = Jmat.T @ Jmat
    b_p = Jmat.T @ rvec
    H_pl = torch.einsum("fjad,fja->df", Jfull, J_lam)
    H_ll = torch.einsum("fja,fja->f", J_lam, J_lam)
    b_l = torch.einsum("fja,fja->f", J_lam, res_w)

    imu_res, Jimu, cost_imu = linearize_imu_rows(
        state, pre, sqrt_info_imu, imu_valid, gravity
    )
    H_pp = H_pp + Jimu.T @ Jimu
    b_p = b_p + Jimu.T @ imu_res.reshape(-1)

    rp = prior_residual(state, prior)
    Jp = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    H_pp = H_pp + Jp.T @ Jp
    b_p = b_p + Jp.T @ rp
    cost = cost_proj + cost_imu + 0.5 * torch.sum(rp * rp)
    return H_pp, H_pl, H_ll, b_p, b_l, cost


def total_cost(state, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg):
    """Robust total cost at a state (no Jacobians) — LM accept/reject."""
    res, valid = projection_residuals_grid(state, grid, cfg.proj_sqrt_info)
    sq = torch.sum(res * res, dim=-1)
    c2 = cfg.cauchy_c**2
    cost_proj = 0.5 * torch.sum(torch.where(valid, c2 * torch.log1p(sq / c2), 0.0))
    imu_res = imu_residuals_window(state, pre, sqrt_info_imu, gravity, imu_valid)
    rp = prior_residual(state, prior)
    return cost_proj + 0.5 * torch.sum(imu_res * imu_res) + 0.5 * torch.sum(rp * rp)


def _schur_solve(H_pp, H_pl, H_ll, b_p, b_l, lam, used, reduce=None):
    """Solve the damped system by eliminating the diagonal depth block.
    Returns (dx [D], dlam [F]); non-finite when the system is not PD.
    ``reduce`` (the feature-sharded solver's) sums the depth block's Schur
    terms (S [D, D], c [D]) over the ranks that hold the other features."""
    D = H_pp.shape[0]
    info_ok = used & (H_ll > 1e-12)  # depth slots without information stay put
    H_ll_safe = torch.where(info_ok, H_ll, 1.0)
    b_l_safe = torch.where(info_ok, b_l, 0.0)
    H_pl_safe = torch.where(info_ok[None, :], H_pl, 0.0)

    inv_Hll = 1.0 / (H_ll_safe * (1.0 + lam))
    S = (H_pl_safe * inv_Hll[None, :]) @ H_pl_safe.T
    c = H_pl_safe @ (inv_Hll * b_l_safe)
    if reduce is not None:
        S, c = reduce(S, c)
    H_red = H_pp - S
    b_red = b_p - c
    diag = torch.clamp(torch.diagonal(H_pp), 1e-6, 1e32)
    eye = torch.eye(D, dtype=H_pp.dtype, device=H_pp.device)
    L, info = torch.linalg.cholesky_ex(H_red + lam * torch.diag(diag) + 1e-10 * eye)
    # Gauss-Newton convention: step = -H^-1 b (b = Jᵀr). Two triangular
    # solves: cholesky_solve may read its status on the host.
    y = torch.linalg.solve_triangular(L, b_red[:, None], upper=False)
    dx = -torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    dx = torch.where(info == 0, dx, torch.nan)
    dlam = -inv_Hll * (b_l_safe + H_pl_safe.T @ dx)
    return dx, dlam


def _tree_where(c, a, b):
    """torch.where(c, a, b) over a state: a tensor, a tuple of states, or a
    dataclass of tensors (WindowState)."""
    if isinstance(a, torch.Tensor):
        return torch.where(c, a, b)
    if isinstance(a, tuple):
        return tuple(_tree_where(c, x, y) for x, y in zip(a, b))
    return dataclasses.replace(a, **{f.name: _tree_where(c, getattr(a, f.name), getattr(b, f.name))
                                     for f in dataclasses.fields(a)})


def _finite_or_inf(c):
    return torch.where(torch.isfinite(c), c, torch.inf)


def lm_loop(state, lin_fn, solve_fn, cost_fn, cfg: SolverConfig,
            max_iter_dyn=None, apply_fn=None, limit=None):
    """Levenberg-Marquardt accept/reject loop in the JAX form
    (``lfvio_tpu/backend/solver.py::lm_loop``): a fixed count of iterations
    carrying (state, lam, cost, lin, need_lin, done) as tensors, every
    decision a ``torch.where`` on the device, so the loop reads nothing back.

      * Linearization reuse: each iteration linearizes, and the previous
        linearization is selected after a rejected step (re-solved with more
        damping). ``lin`` starts at zeros; ``need_lin`` starts True.
      * A non-finite step (a non-PD damped system) is zeroed and rejected.
      * Cost-plateau exit: an accepted step improving the cost by less than
        cfg.cost_tol (relative) sets ``done``; later iterations change
        nothing.
      * The count: ``max_iter_dyn`` (a Python int, the caller's wall-budget
        cap, estimator.cpp:810-825) or cfg.max_iterations, whichever is
        smaller, fixes the loop's length; under a CUDA graph every iteration
        does its work, so the cap must shorten the loop, not mask it.
        ``limit`` (a device scalar, optional) masks the iterations at and
        after it, as JAX's packed ``max_iter`` does.

    ``apply_fn`` retracts a step onto whatever ``state`` is (default:
    apply_delta on a WindowState). Returns (state, init_cost, final_cost,
    cost history [n_iter])."""
    if apply_fn is None:
        apply_fn = apply_delta
    n_iter = cfg.max_iterations
    if max_iter_dyn is not None:
        n_iter = min(n_iter, int(max_iter_dyn))
    init_cost = _finite_or_inf(cost_fn(state))
    cost = init_cost
    lam = torch.full((), cfg.init_lambda, dtype=init_cost.dtype, device=init_cost.device)
    need_lin = torch.ones((), dtype=torch.bool, device=init_cost.device)
    done = torch.zeros((), dtype=torch.bool, device=init_cost.device)
    lin = None
    hist = []
    for it in range(n_iter):
        if limit is not None:
            done = done | (limit <= it)
        lin_new = lin_fn(state)
        if lin is None:
            lin = tuple(torch.zeros_like(x) for x in lin_new)
        lin_cur = tuple(torch.where(need_lin, x, y) for x, y in zip(lin_new, lin))
        dx, dlam = solve_fn(lin_cur, lam)
        step_ok = torch.isfinite(dx).all() & torch.isfinite(dlam).all()
        s_new = apply_fn(state, torch.where(step_ok, dx, 0.0), torch.where(step_ok, dlam, 0.0),
                         cfg)
        new_cost = _finite_or_inf(cost_fn(s_new))
        accept = step_ok & (new_cost < cost)
        rel_impr = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        conv = accept & (rel_impr < cfg.cost_tol)
        lam_next = torch.clamp(torch.where(accept, lam * 0.4, lam * 8.0), 1e-9, 1e6)
        # After done every carry keeps its value.
        go = ~done & accept
        state = _tree_where(go, s_new, state)
        cost = torch.where(go, new_cost, cost)
        lam = torch.where(done, lam, lam_next)
        lin = tuple(torch.where(done, x, y) for x, y in zip(lin, lin_cur))
        need_lin = torch.where(done, need_lin, accept)
        done = done | conv
        hist.append(cost)
    return state, init_cost, cost, torch.stack(hist)


def lm_solve(state: WindowState, grid: FeatureGrid, pre: Preintegration,
             sqrt_info_imu, imu_valid, prior: PriorFactor, gravity,
             cfg: SolverConfig, max_iter_dyn=None, limit=None):
    """LM over the window, ≤ cfg.max_iterations iterations (reference:
    ceres with max 8 iterations and a wall budget, estimator.cpp:810-825;
    the budget maps to max_iter_dyn and ``limit``, see lm_loop)."""

    def lin_fn(s):
        return assemble_normal_equations(
            s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg
        )[:5]

    def solve_fn(lin, lam):
        return _schur_solve(*lin, lam, grid.used)

    def cost_fn(s):
        return total_cost(s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg)

    return lm_loop(state, lin_fn, solve_fn, cost_fn, cfg, max_iter_dyn, limit=limit)
