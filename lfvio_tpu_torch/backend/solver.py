"""Sliding-window bundle adjustment: dense Schur + Levenberg-Marquardt.

Port of ``lfvio_tpu.backend.solver`` (the reference's Ceres DENSE_SCHUR
solve, estimator.cpp:810-825):

  1. Projection rows from their analytic Jacobian
     (``factors.projection_jacobian``), and their sums into the normal
     equations, by ``proj_cuda``'s wrappers: on the card the kernels of
     ``csrc/proj_factor.cu`` (rows, normal equations, cost), on the CPU
     their plain versions. The IMU rows from theirs
     (``factors.imu_jacobian``) by ``imu_cuda``'s wrappers, the kernels of
     ``csrc/imu_factor.cu`` on the card.
  2. Dense normal equations in the full local layout: H_pp [D, D],
     H_pl [D, F] and the diagonal H_ll [F]. ``linearize_proj_rows`` and
     ``linearize_imu_rows`` give the dense rows that the sharded QR
     marginalization (``dist/marginalize.py``) stacks.
  3. Schur elimination of the inverse depths, one Cholesky of the reduced
     D×D system (``cholesky_ex`` and two triangular solves: a non-PD system
     gives a non-finite step, which LM rejects, as jnp.linalg.cholesky's
     NaN does).
  4. LM in the JAX form: a fixed count of iterations whose accept/reject,
     linearization reuse after a rejected step, relative cost-plateau exit
     and iteration limit are decided on the device, each iteration and each
     linearization a ``device.cond`` block (a CUDA-graph IF node under a
     capture, as JAX's ``lax.cond``), so a solve reads nothing back and is
     one CUDA graph that skips what it does not run.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import cond
from ..geom import quat_mul, quat_normalize, so3_exp
from ..imu import Preintegration
from .factors import prior_residual, residual_mask
from .imu_cuda import dense_rows, imu_cost, imu_normal, imu_rows
from .proj_cuda import full_rows, proj_cost, proj_normal, proj_rows
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


def linearize_projection(state: WindowState, grid: FeatureGrid, cfg: SolverConfig):
    """Residuals and per-factor Jacobians over the whole grid (``proj_rows``:
    the rows kernel on the card, ``projection_jacobian`` on the CPU).
    Returns (res [F,W1,2], J26 [F,W1,2,26], valid [F,W1], w [F,W1,1])."""
    res, J26, w, _ = proj_rows(state, grid, cfg)
    return res, J26, residual_mask(grid), w[..., None]


def linearize_proj_rows(state: WindowState, grid: FeatureGrid, cfg: SolverConfig):
    """Whitened, robust-weighted projection rows in the full local layout.

    Returns (res_w [F,W1,2], Jfull [F,W1,2,D], J_lam [F,W1,2], valid [F,W1],
    cost)."""
    res, J26, w, cost_terms = proj_rows(state, grid, cfg)
    J26 = J26 * w[..., None, None]
    Jfull = full_rows(J26, grid, cfg, n_cams_of(state))
    return res * w[..., None], Jfull, J26[..., 24], residual_mask(grid), 0.5 * cost_terms.sum()


def linearize_imu_rows(state: WindowState, pre: Preintegration, sqrt_info_imu,
                       imu_valid, gravity):
    """Whitened IMU rows in the full local layout (``imu_rows``: the rows
    kernel on the card, ``imu_jacobian`` on the CPU).
    Returns (imu_res [W,15], Jimu [W*15, D], cost)."""
    imu_res, J30 = imu_rows(state, pre, sqrt_info_imu, imu_valid, gravity)
    D = pose_dim(state.p.shape[0], n_cams_of(state))
    return imu_res, dense_rows(J30, D), 0.5 * torch.sum(imu_res * imu_res)


def assemble_normal_equations(state, grid, pre, sqrt_info_imu, imu_valid,
                              prior, gravity, cfg):
    """(H_pp, H_pl, H_ll, b_p, b_l, cost) at the current linearization (the
    projection's terms: one ``proj_normal``; the IMU's added into its H_pp
    and b_p in place: one ``imu_normal``)."""
    H_pp, H_pl, H_ll, b_p, b_l, proj_terms = proj_normal(state, grid, cfg, n_cams_of(state))
    H_pp, b_p, imu_terms = imu_normal(H_pp, b_p, state, pre, sqrt_info_imu, imu_valid, gravity)

    rp = prior_residual(state, prior)
    Jp = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    H_pp = H_pp + Jp.T @ Jp
    b_p = b_p + Jp.T @ rp
    cost = 0.5 * torch.sum(proj_terms) + 0.5 * torch.sum(imu_terms) + 0.5 * torch.sum(rp * rp)
    return H_pp, H_pl, H_ll, b_p, b_l, cost


def total_cost(state, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg):
    """Robust total cost at a state (no Jacobians) — LM accept/reject."""
    cost_proj = 0.5 * torch.sum(proj_cost(state, grid, cfg))
    cost_imu = 0.5 * torch.sum(imu_cost(state, pre, sqrt_info_imu, imu_valid, gravity))
    rp = prior_residual(state, prior)
    return cost_proj + cost_imu + 0.5 * torch.sum(rp * rp)


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
    carrying (state, lam, cost, lin, need_lin, done) in tensors made before
    the loop and written in place, every decision on the device, so the
    loop reads nothing back.

      * Each iteration after the first is a ``device.cond(~done, ...)``
        block, as JAX's ``lax.cond(done, skip, work)``: under a CUDA graph
        an IF node, so an iteration at or after ``done`` launches nothing;
        otherwise its writes are masked. Iteration 0 runs outside any block
        (``need_lin`` starts True and the limit is at least 1, so it always
        runs and linearizes) and makes the carries.
      * Linearization reuse: the linearization is a ``cond(need_lin, ...)``
        block inside the iteration's; a rejected step re-solves the carried
        normal equations with more damping.
      * A non-finite step (a non-PD damped system) is zeroed and rejected.
      * Cost-plateau exit: an accepted step improving the cost by less than
        cfg.cost_tol (relative) sets ``done``.
      * The count: ``limit`` (a device scalar, optional, at least 1: the
        packed ``max_iter``) sets ``done`` at iteration ``limit``, as JAX's
        ``max_iter_dyn`` does, so one graph serves every cap.
        ``max_iter_dyn`` (a Python int) shortens the loop itself below
        cfg.max_iterations.

    ``apply_fn`` retracts a step onto whatever ``state`` is (default:
    apply_delta on a WindowState). Returns (state, init_cost, final_cost,
    cost history [n_iter], iterations run, linearizations run), the counts
    int64 device scalars."""
    if apply_fn is None:
        apply_fn = apply_delta
    n_iter = cfg.max_iterations
    if max_iter_dyn is not None:
        n_iter = min(n_iter, int(max_iter_dyn))
    init_cost = _finite_or_inf(cost_fn(state))
    dev = init_cost.device

    def iteration(state, lam, cost, lin):
        dx, dlam = solve_fn(lin, lam)
        step_ok = torch.isfinite(dx).all() & torch.isfinite(dlam).all()
        s_new = apply_fn(state, torch.where(step_ok, dx, 0.0), torch.where(step_ok, dlam, 0.0),
                         cfg)
        new_cost = _finite_or_inf(cost_fn(s_new))
        accept = step_ok & (new_cost < cost)
        rel_impr = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        lam_next = torch.clamp(torch.where(accept, lam * 0.4, lam * 8.0), 1e-9, 1e6)
        return (_tree_where(accept, s_new, state), lam_next,
                torch.where(accept, new_cost, cost), accept, accept & (rel_impr < cfg.cost_tol))

    lam0 = torch.full((), cfg.init_lambda, dtype=init_cost.dtype, device=dev)
    lin = tuple(lin_fn(state))
    state, lam, cost, need_lin, done = iteration(state, lam0, init_cost, lin)
    iters = torch.ones((), dtype=torch.int64, device=dev)
    lins = torch.ones((), dtype=torch.int64, device=dev)
    hist = torch.empty(n_iter, dtype=cost.dtype, device=dev)
    hist[0].copy_(cost)

    def body():
        cond(need_lin, lambda: lin_fn(state), lin, counters=(lins,))
        return iteration(state, lam, cost, lin)

    for it in range(1, n_iter):
        if limit is not None:
            done.logical_or_(limit <= it)
        cond(~done, body, (state, lam, cost, need_lin, done), counters=(iters,))
        hist[it].copy_(cost)
    return state, init_cost, cost, hist, iters, lins


def lm_solve(state: WindowState, grid: FeatureGrid, pre: Preintegration,
             sqrt_info_imu, imu_valid, prior: PriorFactor, gravity,
             cfg: SolverConfig, max_iter_dyn=None, limit=None, counts=False):
    """LM over the window, ≤ cfg.max_iterations iterations (reference:
    ceres with max 8 iterations and a wall budget, estimator.cpp:810-825;
    the budget maps to max_iter_dyn and ``limit``, see lm_loop). Returns
    (state, init_cost, final_cost, cost history), and with ``counts`` the
    iterations and linearizations run after them."""

    def lin_fn(s):
        return assemble_normal_equations(
            s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg
        )[:5]

    def solve_fn(lin, lam):
        return _schur_solve(*lin, lam, grid.used)

    def cost_fn(s):
        return total_cost(s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg)

    out = lm_loop(state, lin_fn, solve_fn, cost_fn, cfg, max_iter_dyn, limit=limit)
    return out if counts else out[:4]
