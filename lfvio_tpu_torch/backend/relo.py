"""Relocalization factors inside the sliding-window BA.

Port of ``lfvio_tpu.backend.relo``. The reference appends relo projection
factors with a free loop-pose parameter block (estimator.cpp:777-808): for
every window feature matched in the loop frame, a plain unit-sphere
projection factor between the feature's anchor frame and the loop pose;
after the solve the jointly refined loop pose gives relo_relative_t/q/yaw
(double2vector, estimator.cpp:605-624).

The solve's local layout grows by one 6-dim block (the loop pose) to D+6;
the relo rows are linearized with the same forward-mode machinery as the
window's projection rows and the augmented system runs through the shared
``lm_loop``. Only a frame with an armed loop match takes this path.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ..geom import quat_mul, quat_normalize, so3_exp, tangent_basis
from .factors import cauchy_corrector, projection_residual
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
    ex_2d,
    n_cams_of,
    pose_dim,
)


def _relo_local_residual(d, p_i, q_i, tic_i, qic_i, lam, pts_i, b_loop, tb,
                         relo_p, relo_q, tic0, qic0, sqrt_info):
    """One relo residual as a function of the 25-dim perturbation
    [δpose_i(6), δrelo(6), δex_anchor(6), δex_cam0(6), δλ(1)]. The loop
    image comes from the primary camera, so the loop side uses camera 0's
    extrinsic (the reference passes para_Ex_Pose[0], estimator.cpp:799-806)
    and the anchor side the anchor observation's camera; on a mono rig both
    blocks land in the same columns and add."""
    z3 = torch.zeros(3, dtype=d.dtype, device=d.device)
    z = torch.zeros((), dtype=d.dtype, device=d.device)
    r = projection_residual(
        p_i + d[0:3], quat_mul(q_i, so3_exp(d[3:6])),
        relo_p + d[6:9], quat_mul(relo_q, so3_exp(d[9:12])),
        tic_i + d[12:15], quat_mul(qic_i, so3_exp(d[15:18])),
        tic0 + d[18:21], quat_mul(qic0, so3_exp(d[21:24])),
        lam + d[24], z, pts_i, b_loop, z3, z3, z, z, tb, sqrt_info,
    )
    return r, r


def linearize_relo_rows(state: WindowState, grid: FeatureGrid, relo_p, relo_q,
                        relo_bearing, relo_mask, cfg: SolverConfig):
    """Whitened, robust-weighted relo rows in the [D+6] augmented layout.

    Returns (res_w [F,2], Jfull [F,2,D+6], J_lam [F,2], valid [F], cost)."""
    dtype, dev = state.p.dtype, state.p.device
    F, W1 = grid.valid.shape
    C = n_cams_of(state)
    D = pose_dim(W1, C)

    fi = torch.arange(F, device=dev)
    a = grid.anchor
    tics, qics = ex_2d(state.tic, state.qic)
    cam_i = grid.cam_index()[fi, a]  # [F] anchor observation's camera
    b_loop = relo_bearing / torch.clamp(
        torch.linalg.norm(relo_bearing, dim=-1, keepdim=True), min=1e-12
    )

    def fn(d, p_i, q_i, tic_i, qic_i, lam, pts_i, b_r, tb):
        return _relo_local_residual(
            d, p_i, q_i, tic_i, qic_i, lam, pts_i, b_r, tb,
            relo_p, relo_q, tics[0], qics[0], cfg.proj_sqrt_info,
        )

    args = (state.p[a], state.q[a], tics[cam_i], qics[cam_i], state.inv_depth,
            grid.bearing[fi, a], b_loop, tangent_basis(b_loop))
    zero25 = torch.zeros(25, dtype=dtype, device=dev)
    J25, res = vmap(jacfwd(fn, has_aux=True), in_dims=(None,) + (0,) * len(args))(
        zero25, *args
    )  # [F, 2, 25], [F, 2]

    valid = relo_mask & grid.used
    res = torch.where(valid[:, None], res, 0.0)
    J25 = torch.where(valid[:, None, None], J25, 0.0)
    sq = torch.sum(res * res, dim=-1)
    c2 = cfg.cauchy_c**2
    cost = 0.5 * torch.sum(torch.where(valid, c2 * torch.log1p(sq / c2), 0.0))
    w = cauchy_corrector(res, cfg.cauchy_c)
    res_w = res * w
    J25 = J25 * w[..., None]

    J_pi, J_relo = J25[..., 0:6], J25[..., 6:12]
    J_exi, J_ex0 = J25[..., 12:18], J25[..., 18:24]
    J_lam = J25[..., 24]
    if not cfg.estimate_extrinsic:
        J_exi, J_ex0 = torch.zeros_like(J_exi), torch.zeros_like(J_ex0)

    # The anchor-side block lands in the anchor observation's camera columns,
    # the loop-side block in camera 0's; identical columns add.
    Jpose = torch.zeros((F, W1, 2, 6), dtype=dtype, device=dev)
    Jpose[fi, a] = J_pi
    Jpose = Jpose.permute(0, 2, 1, 3).reshape(F, 2, 6 * W1)
    Jex = torch.zeros((F * C, 2, 6), dtype=dtype, device=dev)
    Jex.index_add_(0, fi * C + cam_i, J_exi)
    Jex.index_add_(0, fi * C, J_ex0)
    Jex = Jex.reshape(F, C, 2, 6).permute(0, 2, 1, 3).reshape(F, 2, 6 * C)
    Jfull = torch.cat(
        [Jpose, torch.zeros((F, 2, 9 * W1), dtype=dtype, device=dev), Jex,
         torch.zeros((F, 2, 1), dtype=dtype, device=dev), J_relo],
        dim=-1,
    )  # [F, 2, D+6]
    return res_w, Jfull, J_lam, valid, cost


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
                  limit=None):
    """LM over the window plus the free loop pose (augmented D+6 system).

    Returns (state_out, relo_p, relo_q, init_cost, final_cost)."""
    F, W1 = grid.valid.shape
    D = pose_dim(W1, n_cams_of(state))
    pad = torch.nn.functional.pad

    def lin_fn(rs):
        s, rp, rq = rs
        H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
            s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg
        )
        res_w, Jr, Jr_lam, _, _ = linearize_relo_rows(
            s, grid, rp, rq, relo_bearing, relo_mask, cfg
        )
        Jr_mat = Jr.reshape(F * 2, D + 6)
        rvec = res_w.reshape(F * 2)
        H6 = pad(H_pp, (0, 6, 0, 6)) + Jr_mat.T @ Jr_mat
        b6 = pad(b_p, (0, 6)) + Jr_mat.T @ rvec
        H_pl6 = pad(H_pl, (0, 0, 0, 6)) + torch.einsum("fad,fa->df", Jr, Jr_lam)
        H_ll6 = H_ll + torch.einsum("fa,fa->f", Jr_lam, Jr_lam)
        b_l6 = b_l + torch.einsum("fa,fa->f", Jr_lam, res_w)
        return H6, H_pl6, H_ll6, b6, b_l6

    def solve_fn(lin, lam):
        return _schur_solve(*lin, lam, grid.used)

    def cost_fn(rs):
        s, rp, rq = rs
        base = total_cost(s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg)
        return base + linearize_relo_rows(s, grid, rp, rq, relo_bearing, relo_mask, cfg)[4]

    (s_out, rp, rq), c0, c1, _ = lm_loop(
        (state, relo_p0, relo_q0), lin_fn, solve_fn, cost_fn, cfg, max_iter_dyn,
        apply_fn=_relo_apply, limit=limit,
    )
    return s_out, rp, rq, c0, c1
