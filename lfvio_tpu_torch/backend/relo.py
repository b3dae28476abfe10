"""Relocalization factors inside the sliding-window BA.

Port of ``lfvio_tpu.backend.relo``. The reference appends relo projection
factors with a free loop-pose parameter block (estimator.cpp:777-808): for
every window feature matched in the loop frame, a plain unit-sphere
projection factor between the feature's anchor frame and the loop pose;
after the solve the jointly refined loop pose gives relo_relative_t/q/yaw
(double2vector, estimator.cpp:605-624).

The solve's local layout grows by one 6-dim block (the loop pose) to D+6.
A relo row is ``factors.projection_residual`` with the loop pose as the
observer seen through camera 0, so ``factors.projection_jacobian`` gives
its analytic Jacobian (``relo_cuda.relo_jacobian``). The LM's
linearization adds the relo rows into the window's normal equations with
``relo_cuda.relo_normal`` and its cost takes ``relo_cuda.relo_cost``: on
the card the kernels of ``csrc/proj_factor.cu``, on the CPU their plain
versions. The augmented system runs through the shared ``lm_loop``. Only a
frame with an armed loop match takes this path.
"""

from __future__ import annotations

import torch

from ..geom import quat_mul, quat_normalize, so3_exp
from .relo_cuda import full_relo_rows, relo_cost, relo_jacobian, relo_normal
from .solver import (
    _schur_solve,
    apply_delta,
    assemble_normal_equations,
    lm_loop,
    total_cost,
)
from .state import (
    FeatureGrid,
    PriorFactor,
    SolverConfig,
    WindowState,
    n_cams_of,
)


def linearize_relo_rows(state: WindowState, grid: FeatureGrid, relo_p, relo_q,
                        relo_bearing, relo_mask, cfg: SolverConfig):
    """Whitened, robust-weighted relo rows in the [D+6] augmented layout
    (``relo_jacobian``'s analytic rows, ``full_relo_rows``' layout).

    Returns (res_w [F,2], Jfull [F,2,D+6], J_lam [F,2], valid [F], cost)."""
    res, J25, w, valid, cost_terms = relo_jacobian(state, grid, relo_p, relo_q, relo_bearing,
                                                   relo_mask, cfg)
    J25w = J25 * w[:, None, None]
    Jfull = full_relo_rows(J25w, grid, cfg, n_cams_of(state))
    return res * w[:, None], Jfull, J25w[..., 24], valid, 0.5 * torch.sum(cost_terms)


def _relo_apply(rs, dx, dlam, cfg):
    state, relo_p, relo_q = rs
    D = dx.shape[0] - 6
    return (
        apply_delta(state, dx[:D], dlam, cfg),
        relo_p + dx[D:D + 3],
        quat_normalize(quat_mul(relo_q, so3_exp(dx[D + 3:D + 6]))),
    )


def lm_solve_relo(state: WindowState, grid: FeatureGrid, pre, sqrt_info_imu,
                  imu_valid, prior: PriorFactor, gravity, cfg: SolverConfig,
                  relo_p0, relo_q0, relo_bearing, relo_mask, max_iter_dyn=None,
                  limit=None, counts=False):
    """LM over the window plus the free loop pose (augmented D+6 system).

    Returns (state_out, relo_p, relo_q, init_cost, final_cost), and with
    ``counts`` the iterations and linearizations run (see lm_loop)."""
    pad = torch.nn.functional.pad
    relo = (relo_bearing, relo_mask)

    def lin_fn(rs):
        s, rp, rq = rs
        H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
            s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg
        )
        # The [D+6] layout (the loop pose's rows and columns zero), then the
        # relo rows added in place.
        return relo_normal(pad(H_pp, (0, 6, 0, 6)), pad(H_pl, (0, 0, 0, 6)), H_ll,
                           pad(b_p, (0, 6)), b_l, s, grid, rp, rq, *relo, cfg)

    def solve_fn(lin, lam):
        return _schur_solve(*lin, lam, grid.used)

    def cost_fn(rs):
        s, rp, rq = rs
        base = total_cost(s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg)
        return base + 0.5 * torch.sum(relo_cost(s, grid, rp, rq, *relo, cfg))

    (s_out, rp, rq), c0, c1, _, iters, lins = lm_loop(
        (state, relo_p0, relo_q0), lin_fn, solve_fn, cost_fn, cfg, max_iter_dyn,
        apply_fn=_relo_apply, limit=limit,
    )
    return (s_out, rp, rq, c0, c1) + ((iters, lins) if counts else ())
