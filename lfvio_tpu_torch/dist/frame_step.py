"""The whole estimator frame step, feature-sharded over a process group.

Port of ``lfvio_tpu.dist.frame_step``: the per-frame computation of
``runtime/estimator.py::_solve_step`` and the marginalization, across the
ranks of a ``FeatureMesh``:

  * IMU preintegration and covariance whitening: replicated (tiny);
  * multi-view triangulation: each rank its own features (no communication);
  * the LM solve: feature-sharded normal equations, the pose system
    all-reduced, the D×D solve redundant on every rank (``sharding.py``);
  * the yaw-gauge fix: replicated;
  * MARGIN_OLD: feature-sharded TSQR (``marginalize.py``); MARGIN_SECOND_NEW
    touches only the replicated prior.
"""

from __future__ import annotations

import torch

from ..backend.gauge import yaw_gauge_fix
from ..backend.marginalize import marginalize_second_new_qr
from ..backend.state import FeatureGrid, PriorFactor, SolverConfig, WindowState
from ..backend.triangulate import triangulate_grid
from ..imu import preintegrate, whiten_covariance
from .marginalize import marginalize_old_qr_sharded
from .sharding import FeatureMesh, lm_solve_sharded


def triangulate_sharded(mesh: FeatureMesh, state: WindowState, grid: FeatureGrid, has_depth):
    """Feature-sharded multi-view triangulation: ``grid`` and ``has_depth``
    are this rank's slice, and so are the returned inverse depths; the
    window poses are replicated, so no rank needs another's features."""
    return triangulate_grid(state, grid, has_depth)


def vio_frame_step_sharded(mesh: FeatureMesh, state: WindowState, grid: FeatureGrid,
                           dts, accs, gyrs, a0, g0, imu_valid, prior: PriorFactor, has_depth,
                           origin_p0, origin_q0, imu_noise, cfg: SolverConfig,
                           g_norm: float = 9.81, marg_old: bool = True):
    """One frame: preintegrate → triangulate → LM → gauge fix → marginalize,
    over ``mesh``. ``grid``, ``has_depth`` and ``state.inv_depth`` are this
    rank's slice of the feature axis; the raw IMU window [W, M] and the
    prior are replicated. Returns (state with this rank's inverse depths,
    new prior, initial cost, final cost), the prior and costs the same on
    every rank."""
    gravity = torch.tensor([0.0, 0.0, g_norm], dtype=state.p.dtype, device=state.p.device)
    pre = preintegrate(dts, accs, gyrs, a0, g0, state.ba[:-1], state.bg[:-1], imu_noise)
    sqrt_info, imu_ok = whiten_covariance(pre.covariance, imu_valid)
    state = state.replace(inv_depth=triangulate_sharded(mesh, state, grid, has_depth))
    out, c0, c1 = lm_solve_sharded(mesh, state, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg)
    out = yaw_gauge_fix(out, origin_p0, origin_q0)
    if marg_old:
        new_prior = marginalize_old_qr_sharded(mesh, out, grid, pre, sqrt_info, imu_ok, prior,
                                               gravity, cfg)
    else:
        new_prior = marginalize_second_new_qr(out, prior, cfg)
    return out, new_prior, c0, c1
