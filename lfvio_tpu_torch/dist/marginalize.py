"""Feature-sharded square-root marginalization: TSQR over the ranks.

Port of ``lfvio_tpu.dist.marginalize``. The single-device path
(``backend/marginalize.py::marginalize_old_qr``) stacks all whitened factor
rows and takes one tall-skinny QR. The projection rows split along the
feature axis (a row touches only its own feature's depth column), so the
classic TSQR applies:

  stage 1 (local): each rank QRs its own projection rows with the column
    order [local depths | dropped pose0/sb0 | kept | r] and keeps the rows
    of R below its depth block, padded to C×C (C = 15 + K + 1): its
    depth-eliminated contribution over the shared columns.
  stage 2 (one all_gather): the n blocks are stacked with the replicated
    IMU-interval-0 and prior rows and QR'd again; the rows below the
    dropped block are the marginal square-root prior on the kept variables.

R([A1; A2]) equals R([R(A1); R(A2)]) up to row signs, and the prior enters
the solver only through JᵀJ and Jᵀr, which do not see them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..backend.factors import prior_residual
from ..backend.marginalize import _drop_keep_old, _scatter_prior, _slid_old
from ..backend.solver import linearize_imu_rows, linearize_proj_rows
from ..backend.state import FeatureGrid, PriorFactor, SolverConfig, WindowState, n_cams_of, pose_dim
from .sharding import FeatureMesh


def marginalize_old_qr_sharded(mesh: FeatureMesh, state: WindowState, grid: FeatureGrid, pre0,
                               sqrt_info_imu0, imu0_valid, prior: PriorFactor, gravity,
                               cfg: SolverConfig):
    """Feature-sharded MARGIN_OLD (TSQR): the inputs and output of
    ``backend.marginalize.marginalize_old_qr``, with ``grid`` and
    ``state.inv_depth`` this rank's slice. The prior is the same on every
    rank."""
    dtype, dev = state.p.dtype, state.p.device
    n_frames = state.p.shape[0]
    Floc, W1 = grid.valid.shape
    D = pose_dim(n_frames, n_cams_of(state))
    drop, keep = _drop_keep_old(n_frames, D)
    drop_t, keep_t = torch.as_tensor(drop, device=dev), torch.as_tensor(keep, device=dev)
    K = len(keep)
    C = len(drop) + K + 1  # shared columns: dropped pose0/sb0 | kept | residual

    # Stage 1: the local projection rows, local depths eliminated.
    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    res_w, Jfull, J_lam, _, _ = linearize_proj_rows(state, grid0, cfg)
    R1 = Floc * W1 * 2
    dep_rows = (J_lam[..., None] * torch.eye(Floc, dtype=dtype, device=dev)[:, None, None, :]
                ).reshape(R1, Floc)
    A_pose = Jfull.reshape(R1, D)
    A1 = torch.cat([dep_rows, A_pose[:, drop_t], A_pose[:, keep_t], res_w.reshape(R1, 1)], dim=1)
    # An all-zero depth column (a feature not anchored at frame 0) gets no
    # Householder reflection, so R's row at its pivot is whatever working
    # row sits there, which can carry other features' information; that row
    # would be dropped with the depth rows. A unit row in the column becomes
    # the pivot row instead and moves that information below the block.
    empty = (J_lam.reshape(Floc, -1) == 0).all(dim=1)
    A1 = torch.cat([A1, torch.cat([torch.diag(empty.to(dtype)),
                                   torch.zeros((Floc, C), dtype=dtype, device=dev)], dim=1)])
    B = torch.linalg.qr(A1, mode="r")[1][Floc:, Floc:]
    B_local = torch.zeros((C, C), dtype=dtype, device=dev)
    B_local[:min(B.shape[0], C)] = B[:C]

    # Stage 2: gather, add the replicated rows, QR again.
    parts = [torch.empty_like(B_local) for _ in range(mesh.size)]
    dist.all_gather(parts, B_local, group=mesh.group)
    imu_valid = torch.zeros_like(imu0_valid)
    imu_valid[0] = imu0_valid[0]
    imu_res, Jimu, _ = linearize_imu_rows(state, pre0, sqrt_info_imu0, imu_valid, gravity)
    rp = prior_residual(state, prior)
    Jp = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    extra = torch.cat([Jimu, Jp], dim=0)
    extra_r = torch.cat([imu_res.reshape(-1), rp])
    A2 = torch.cat([*parts, torch.cat([extra[:, drop_t], extra[:, keep_t], extra_r[:, None]],
                                      dim=1)], dim=0)
    Rfac = torch.linalg.qr(A2, mode="r")[1]
    m = len(drop)
    Jk = Rfac[m:m + K, m:m + K]
    rk = Rfac[m:m + K, m + K]
    ok = torch.isfinite(Jk).all() & torch.isfinite(rk).all()
    J, r0 = _scatter_prior(torch.where(ok, Jk, 0.0), torch.where(ok, rk, 0.0), keep, D)
    return _slid_old(J, r0, state, ok)
