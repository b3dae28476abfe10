"""Batched multi-view triangulation of window features (port of
``lfvio_tpu.backend.triangulate``; FeatureManager::triangulate,
feature_manager.cpp:199-253).

For each feature, two DLT rows per observing frame relative to the anchor
camera; the null vector of AᵀA (batched 4x4 eigh: ``geom/eigh_cuda.py``'s
kernel on the card) gives the point, and the depth is the *ray* depth
⟨X, bearing_anchor⟩ (valid on the negative half-plane). The eigenvector's
sign cancels in X[:3] / X[3].
"""

from __future__ import annotations

import torch

from ..geom import quat_to_mat
from ..geom.eigh_cuda import sym_eig
from .state import FeatureGrid, WindowState, ex_2d

INIT_DEPTH = 5.0


def triangulate_grid(state: WindowState, grid: FeatureGrid, has_depth):
    """Inverse ray depths [F]: slots with has_depth keep state.inv_depth,
    used slots with ≥ 2 observations are triangulated, the rest get
    1/INIT_DEPTH. Each observation uses its own camera's pose
    p_c = p + R tic[c], R_c = R R_ic[c]."""
    dtype, dev = state.p.dtype, state.p.device
    F, W1 = grid.valid.shape
    tics, qics = ex_2d(state.tic, state.qic)
    Rw = quat_to_mat(state.q)  # [W1, 3, 3] world<-imu
    R_wc = Rw[:, None] @ quat_to_mat(qics)[None]  # [W1, C, 3, 3] world<-cam
    t_wc = state.p[:, None, :] + torch.einsum("wij,cj->wci", Rw, tics)  # [W1, C, 3]
    w = torch.arange(W1, device=dev)[None, :].expand(F, W1)
    cam = grid.cam_index()
    R_c = R_wc[w, cam]  # [F, W1, 3, 3]
    t_c = t_wc[w, cam]  # [F, W1, 3]
    fi = torch.arange(F, device=dev)
    R0 = R_c[fi, grid.anchor]  # [F, 3, 3] anchor camera
    t0 = t_c[fi, grid.anchor]  # [F, 3]
    # X_cam_j = R_rel X_anchor + t_rel, R_rel = R_cjᵀ R_0, t_rel = R_cjᵀ (t0 − t_cj).
    R_rel = torch.einsum("fwji,fjk->fwik", R_c, R0)  # [F, W1, 3, 3]
    t_rel = torch.einsum("fwji,fwj->fwi", R_c, t0[:, None, :] - t_c)
    P = torch.cat([R_rel, t_rel[..., None]], dim=-1)  # [F, W1, 3, 4]
    f = grid.bearing / torch.clamp(
        torch.linalg.norm(grid.bearing, dim=-1, keepdim=True), min=1e-12
    )
    row0 = f[..., 0:1] * P[..., 2, :] - f[..., 2:3] * P[..., 0, :]
    row1 = f[..., 1:2] * P[..., 2, :] - f[..., 2:3] * P[..., 1, :]
    rows = torch.stack([row0, row1], dim=2) * grid.valid[..., None, None].to(dtype)
    AtA = torch.einsum("fwra,fwrb->fab", rows, rows)
    _, V = sym_eig(AtA + 1e-12 * torch.eye(4, dtype=dtype, device=dev))
    X = V[..., :, 0]
    denom = torch.where(torch.abs(X[..., 3]) < 1e-10, 1e-10, X[..., 3])
    Xp = X[..., :3] / denom[..., None]
    b0 = f[fi, grid.anchor]
    depth = torch.sum(Xp * b0, dim=-1)
    depth = torch.where(depth < 0.1, INIT_DEPTH, depth)
    can = grid.used & (grid.valid.sum(-1) >= 2)
    inv_new = torch.where(can, 1.0 / depth, 1.0 / INIT_DEPTH)
    return torch.where(has_depth, state.inv_depth, inv_new)
