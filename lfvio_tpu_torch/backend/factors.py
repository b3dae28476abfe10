"""Residual functions of the sliding-window bundle adjustment.

Port of ``lfvio_tpu.backend.factors``:

  * unit-sphere projection factor with time-offset correction
    (projection_td_factor.cpp:36-77): the 2-D tangent-plane component of the
    bearing error at the measured bearing, scaled by FOCAL_LENGTH/1.5;
  * IMU preintegration factor (imu_factor.h:40-66), whitened;
  * marginalization prior (marginalization_factor.cpp:333-381).

The residuals broadcast over leading dimensions, so one definition serves
the whole [F, W+1] grid at once and, under ``torch.func.vmap``, the
per-observation linearization of ``solver.py``.
"""

from __future__ import annotations

import torch

from ..geom import quat_box_minus, quat_conj, quat_rotate, tangent_basis
from ..imu import imu_residual
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
