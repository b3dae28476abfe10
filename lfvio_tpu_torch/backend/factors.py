"""Residual functions of the sliding-window bundle adjustment.

Port of ``lfvio_tpu.backend.factors``:

  * unit-sphere projection factor with time-offset correction
    (projection_td_factor.cpp:36-77): the 2-D tangent-plane component of the
    bearing error at the measured bearing, scaled by FOCAL_LENGTH/1.5;
  * IMU preintegration factor (imu_factor.h:40-66), whitened;
  * marginalization prior (marginalization_factor.cpp:333-381).

The residuals broadcast over leading dimensions, so one definition serves
the whole [F, W+1] grid at once. ``projection_jacobian`` is the projection
residual's analytic Jacobian over the 26 tangents of an observation, the
plain version of ``csrc/proj_factor.cu``'s rows mode; ``imu_jacobian`` is
the IMU residual's over the 30 tangents of an interval, the plain version of
``csrc/imu_factor.cu``'s rows.
"""

from __future__ import annotations

import torch

from ..geom import (
    quat_box_minus,
    quat_conj,
    quat_from_small_angle,
    quat_left,
    quat_mul,
    quat_right,
    quat_rotate,
    quat_to_mat,
    skew,
    tangent_basis,
)
from ..imu import imu_residual
from ..imu.preintegration import O_BA, O_BG, O_P, O_R, O_V
from .state import FeatureGrid, PriorFactor, WindowState, ex_2d


def projection_residual(p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j,
                        inv_dep, td, pts_i, pts_j, vel_i, vel_j,
                        td_obs_i, td_obs_j, tangent_b, sqrt_info):
    """Unit-sphere + td projection residual [..., 2]. td_obs carries the
    measurement-time constant, so the correction is pts − (td − td_obs)·vel.
    (tic_i, qic_i) is the anchor observation's extrinsic and (tic_j, qic_j)
    the observing one's: the same camera on a mono rig; on a multi-camera rig
    (dual-PAL) one landmark may be seen from different cameras."""
    pts_i_td = pts_i - (td - td_obs_i)[..., None] * vel_i
    pts_j_td = pts_j - (td - td_obs_j)[..., None] * vel_j
    safe_dep = torch.where(torch.abs(inv_dep) < 1e-8, 1e-8, inv_dep)
    pts_cam_i = pts_i_td / safe_dep[..., None]
    pts_imu_i = quat_rotate(qic_i, pts_cam_i) + tic_i
    pts_w = quat_rotate(q_i, pts_imu_i) + p_i
    pts_imu_j = quat_rotate(quat_conj(q_j), pts_w - p_j)
    pts_cam_j = quat_rotate(quat_conj(qic_j), pts_imu_j - tic_j)
    n = torch.clamp(torch.linalg.norm(pts_cam_j, dim=-1, keepdim=True), min=1e-12)
    m = torch.clamp(torch.linalg.norm(pts_j_td, dim=-1, keepdim=True), min=1e-12)
    err = pts_cam_j / n - pts_j_td / m
    return sqrt_info * (tangent_b @ err[..., None])[..., 0]


def projection_jacobian(p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j,
                        inv_dep, td, pts_i, pts_j, vel_i, vel_j,
                        td_obs_i, td_obs_j, tangent_b, sqrt_info):
    """``projection_residual`` (r [..., 2]) and its analytic Jacobian
    J [..., 2, 26] with respect to [δpose_i, δpose_j, δex_i, δex_j, δλ, δtd]
    (each pose and extrinsic (δp, δθ), rotations perturbed on the right,
    q ⊗ exp(δθ)), over any leading shape; the arithmetic of
    ``csrc/proj_factor.cu``'s rows mode, formula for formula.

    The chain, R(q) the matrix of ``quat_rotate``:

        ρ_i = pts_i − (td − td_obs_i) vel_i, λ̃ = λ (1e-8 where |λ| < 1e-8)
        P_ci = ρ_i / λ̃, P_bi = R_ci P_ci + t_ci, P_w = R_i P_bi + p_i,
        P_bj = R_jᵀ (P_w − p_j), P_cj = R_cjᵀ (P_bj − t_cj),
        u = P_cj / n, m̂ = ρ_j / m (n, m the norms, clamped at 1e-12),
        r = s B (u − m̂).

    With G = s B N, N = (I − u uᵀ) / n, and A = R_cjᵀ R_jᵀ, the column
    blocks are G times: A, −A R_i [P_bi]×, −A, R_cjᵀ [P_bj]×, A R_i,
    −A R_i R_ci [P_ci]×, −R_cjᵀ, [P_cj]×, −A R_i R_ci ρ_i / λ̃² (0 where λ
    is clamped), −A R_i R_ci vel_i / λ̃; the td column gains
    s B (I − m̂ m̂ᵀ) vel_j / m. A clamped norm has no derivative (no u uᵀ,
    m̂ m̂ᵀ term), as forward-mode autodiff of the clamp gives.

    The λ column is evaluated in a form free of cancellation:
    A R_i R_ci ρ_i / λ̃ = P_cj + R_cjᵀ t_cj + A (p_j − p_i − R_i t_ci), and
    N P_cj = 0, so it is −G (R_cjᵀ t_cj + A (p_j − p_i − R_i t_ci)) / λ̃
    (with −G P_cj / λ̃ added where n is clamped): only the baseline's part,
    where the first form cancels terms depth / baseline times larger."""
    T = lambda M: M.transpose(-1, -2)
    mv = lambda M, v: torch.sum(M * v[..., None, :], dim=-1)  # promotes mixed dtypes
    R_i, R_j, R_ci, R_cj = quat_to_mat(q_i), quat_to_mat(q_j), quat_to_mat(qic_i), quat_to_mat(qic_j)
    rho_i = pts_i - (td - td_obs_i)[..., None] * vel_i
    rho_j = pts_j - (td - td_obs_j)[..., None] * vel_j
    small = torch.abs(inv_dep) < 1e-8
    lam = torch.where(small, 1e-8, inv_dep)[..., None]
    P_ci = rho_i / lam
    P_bi = mv(R_ci, P_ci) + tic_i
    P_w = mv(R_i, P_bi) + p_i
    P_bj = mv(T(R_j), P_w - p_j)
    P_cj = mv(T(R_cj), P_bj - tic_j)
    n_raw = torch.linalg.norm(P_cj, dim=-1, keepdim=True)
    n = torch.clamp(n_raw, min=1e-12)
    m_raw = torch.linalg.norm(rho_j, dim=-1, keepdim=True)
    m = torch.clamp(m_raw, min=1e-12)
    u, mh = P_cj / n, rho_j / m
    r = sqrt_info * mv(tangent_b, u - mh)

    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    outer = lambda x, ok: torch.where(ok[..., None], x[..., :, None] * x[..., None, :], 0.0)
    N = (eye - outer(u, n_raw >= 1e-12)) / n[..., None]
    G = sqrt_info * (tangent_b @ N)
    GRc = G @ T(R_cj)
    GA = GRc @ T(R_j)
    GAR = GA @ R_i
    GARR = GAR @ R_ci
    Mm = (eye - outer(mh, m_raw >= 1e-12)) / m[..., None]
    col = lambda M, v: mv(M, v)[..., None]  # [..., 2, 1]
    lam2 = lam[..., None]
    base = col(GRc, tic_j) + col(GA, p_j - p_i - mv(R_i, tic_i))
    base = base + torch.where((n_raw >= 1e-12)[..., None], 0.0, col(G, P_cj))
    J = torch.cat([
        GA, -(GAR @ skew(P_bi)), -GA, GRc @ skew(P_bj),
        GAR, -(GARR @ skew(P_ci)), -GRc, G @ skew(P_cj),
        torch.where(small[..., None, None], 0.0, -base / lam2),
        -col(GARR, vel_i) / lam2 + sqrt_info * col(tangent_b, mv(Mm, vel_j)),
    ], dim=-1)
    return r, J


def anchor_values(state: WindowState, grid: FeatureGrid):
    """Per-feature anchor-frame quantities: p_i, q_i [F, ·] and the anchor
    observation's bearing, velocity and td_obs."""
    f = torch.arange(grid.anchor.shape[0], device=grid.anchor.device)
    a = grid.anchor
    return (state.p[a], state.q[a], grid.bearing[f, a], grid.velocity[f, a],
            grid.td_obs[f, a])


def obs_extrinsics(state: WindowState, grid: FeatureGrid):
    """Per-observation camera extrinsics, selected by ``grid.cam``: the
    anchor observation's (tic_i [F, 3], qic_i [F, 4]) and every
    observation's (tic_j [F, W+1, 3], qic_j [F, W+1, 4])."""
    tics, qics = ex_2d(state.tic, state.qic)
    cam = grid.cam_index()
    tic_j, qic_j = tics[cam], qics[cam]
    f = torch.arange(grid.anchor.shape[0], device=grid.anchor.device)
    return tic_j[f, grid.anchor], qic_j[f, grid.anchor], tic_j, qic_j


def residual_mask(grid: FeatureGrid):
    """[F, W+1] rows that carry a projection residual: valid, used, and not
    the anchor observation itself."""
    W1 = grid.valid.shape[1]
    not_anchor = torch.arange(W1, device=grid.valid.device)[None, :] != grid.anchor[:, None]
    return grid.valid & not_anchor & grid.used[:, None]


def projection_residuals_grid(state: WindowState, grid: FeatureGrid, sqrt_info):
    """All projection residuals over the grid. Returns (residuals
    [F, W+1, 2] zeroed where invalid, valid mask [F, W+1])."""
    p_i, q_i, pts_i, vel_i, td_obs_i = anchor_values(state, grid)
    tic_i, qic_i, tic_j, qic_j = obs_extrinsics(state, grid)
    res = projection_residual(
        p_i[:, None], q_i[:, None], state.p[None], state.q[None],
        tic_i[:, None], qic_i[:, None], tic_j, qic_j,
        state.inv_depth[:, None], state.td,
        pts_i[:, None], grid.bearing, vel_i[:, None], grid.velocity,
        td_obs_i[:, None], grid.td_obs, tangent_basis(grid.bearing), sqrt_info,
    )
    valid = residual_mask(grid)
    return torch.where(valid[..., None], res, 0.0), valid


def cauchy_corrector(res, c=1.0):
    """Per-block sqrt(rho') scale of CauchyLoss(c) for residual blocks
    [..., k] (marginalization_factor.cpp:37-68, Gauss-Newton form)."""
    sq_norm = torch.sum(res * res, dim=-1, keepdim=True)
    return torch.sqrt(1.0 / (1.0 + sq_norm / (c * c)))


def imu_residuals_window(state: WindowState, pre, sqrt_info, gravity, valid):
    """Whitened IMU residuals [W, 15] of all window intervals (zeroed where
    invalid). pre: Preintegration batched over the W intervals."""
    r = imu_residual(
        pre, state.p[:-1], state.q[:-1], state.v[:-1], state.ba[:-1], state.bg[:-1],
        state.p[1:], state.q[1:], state.v[1:], state.ba[1:], state.bg[1:], gravity,
    )
    res = (sqrt_info @ r[..., None])[..., 0]
    return torch.where(valid[:, None], res, 0.0)


def imu_jacobian(pre, sqrt_info, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j,
                 gravity):
    """The whitened IMU residual (``imu.imu_residual``, r_w [..., 15]) and its
    analytic Jacobian J [..., 15, 30] with respect to [δpose_i(6), δsb_i(9),
    δpose_j(6), δsb_j(9)] (pose (δp, δθ), speed-bias (δv, δba, δbg),
    rotations perturbed on the right, q ⊗ exp(δθ)), over any leading shape;
    the arithmetic of ``csrc/imu_factor.cu``, formula for formula. The
    whitening ``sqrt_info @`` is applied to both.

    With T = Σdt, R_i the matrix of q_i, a = ½ g T² + p_j − p_i − v_i T,
    b = g T + v_j − v_i and the bias-corrected deltas of
    ``bias_corrected_delta`` (δba = ba_i − ba₀, δbg = bg_i − bg₀,
    h = Δq ⊗ [1, ½ J_q,bg δbg], Δq' = h / |h|):

        r_p = R_iᵀ a − Δp',  r_q = 2 vec(e),  e = Δq'* ⊗ f,  f = q_i* ⊗ q_j,
        r_v = R_iᵀ b − Δv',  r_ba = ba_j − ba_i,  r_bg = bg_j − bg_i.

    The nonzero blocks: r_p over (p_i, θ_i, v_i, ba_i, bg_i, p_j) is
    (−R_iᵀ, [R_iᵀ a]×, −T R_iᵀ, −J_p,ba, −J_p,bg, R_iᵀ); r_v over
    (θ_i, v_i, ba_i, bg_i, v_j) is ([R_iᵀ b]×, −R_iᵀ, −J_v,ba, −J_v,bg,
    R_iᵀ); r_q over θ_j is vec(e ⊗ [0, δ]) = (e_w I + [e_v]×) δ, over θ_i
    −vec(Δq'* ⊗ [0, δ] ⊗ f); the bias rows ∓I. r_q over bg_i differentiates
    the normalization too: with dh = Δq ⊗ [0, ½ J_q,bg δ],
    d e = (dh* ⊗ f) / |h| − e (h · dh) / |h|². VINS-Mono's closed form drops
    the second term, which vanishes only where bg_i is the preintegration's
    linearization point."""
    mv = lambda M, x: (M @ x[..., None])[..., 0]
    J = pre.jacobian
    blk = lambda r, c: J[..., r:r + 3, c:c + 3]
    dt = pre.sum_dt[..., None]
    dba, dbg = ba_i - pre.linearized_ba, bg_i - pre.linearized_bg
    dp = pre.delta_p + mv(blk(O_P, O_BA), dba) + mv(blk(O_P, O_BG), dbg)
    dv = pre.delta_v + mv(blk(O_V, O_BA), dba) + mv(blk(O_V, O_BG), dbg)
    J_qbg = blk(O_R, O_BG)
    h = quat_mul(pre.delta_q, quat_from_small_angle(mv(J_qbg, dbg)))
    nh = torch.linalg.norm(h, dim=-1, keepdim=True)
    c = quat_conj(h / nh)
    f = quat_mul(quat_conj(q_i), q_j)
    e = quat_mul(c, f)
    RiT = quat_to_mat(q_i).transpose(-1, -2)
    RTa = mv(RiT, 0.5 * gravity * dt * dt + p_j - p_i - v_i * dt)
    RTb = mv(RiT, gravity * dt + v_j - v_i)
    r = torch.cat([RTa - dp, 2.0 * e[..., 1:4], RTb - dv, ba_j - ba_i, bg_j - bg_i], dim=-1)

    Rf = quat_right(f)
    Jq_i = -(Rf @ quat_left(c))[..., 1:, 1:]
    Jq_j = quat_left(e)[..., 1:, 1:]
    dH = quat_left(pre.delta_q)[..., :, 1:] @ (0.5 * J_qbg)  # [..., 4, 3]: dh per column
    flip = torch.ones(4, dtype=dH.dtype, device=dH.device)
    flip[1:].fill_(-1.0)  # dh* = flip · dh
    dot = (h[..., None, :] @ dH)[..., 0, :]  # h · dh per column
    nh2 = nh[..., None]
    de = (Rf @ (flip[:, None] * dH)) / nh2 - e[..., :, None] * dot[..., None, :] / (nh2 * nh2)
    Jq_bg = 2.0 * de[..., 1:, :]

    Z = torch.zeros_like(RiT)
    eye = torch.eye(3, dtype=RiT.dtype, device=RiT.device).expand_as(RiT)
    rows = lambda *blocks: torch.cat(blocks, dim=-1)
    Jraw = torch.cat([
        rows(-RiT, skew(RTa), -dt[..., None] * RiT, -blk(O_P, O_BA), -blk(O_P, O_BG),
             RiT, Z, Z, Z, Z),
        rows(Z, Jq_i, Z, Z, Jq_bg, Z, Jq_j, Z, Z, Z),
        rows(Z, skew(RTb), -RiT, -blk(O_V, O_BA), -blk(O_V, O_BG), Z, Z, RiT, Z, Z),
        rows(Z, Z, Z, -eye, Z, Z, Z, Z, eye, Z),
        rows(Z, Z, Z, Z, -eye, Z, Z, Z, Z, eye),
    ], dim=-2)
    return mv(sqrt_info, r), sqrt_info @ Jraw


def state_box_minus(state: WindowState, prior: PriorFactor):
    """Full-layout tangent difference x ⊟ x0 (quaternion-aware); the
    extrinsic part is camera-major [C, 6]."""
    tics, qics = ex_2d(state.tic, state.qic)
    x0_tics, x0_qics = ex_2d(prior.x0_tic, prior.x0_qic)
    return torch.cat([
        torch.cat([state.p - prior.x0_p, quat_box_minus(state.q, prior.x0_q)], dim=-1).reshape(-1),
        torch.cat([state.v - prior.x0_v, state.ba - prior.x0_ba,
                   state.bg - prior.x0_bg], dim=-1).reshape(-1),
        torch.cat([tics - x0_tics, quat_box_minus(qics, x0_qics)], dim=-1).reshape(-1),
        (state.td - prior.x0_td).reshape(1),
    ])


def prior_residual(state: WindowState, prior: PriorFactor):
    """r = r0 + J (x ⊟ x0); zero when no prior exists yet."""
    r = prior.r0 + prior.J @ state_box_minus(state, prior)
    return torch.where(prior.valid, r, torch.zeros_like(r))
