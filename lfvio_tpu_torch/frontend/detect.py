"""Shi-Tomasi corner detection with annulus masking and spacing NMS.

Port of ``lfvio_tpu.frontend.detect`` (the reference's goodFeaturesToTrack
refill, feature_tracker.cpp:46-83,166): dense min-eigenvalue response,
exclusion zones around surviving tracks (square dilation), border and
quality gates, 3x3 local-max NMS, a top-k of 4·n_new candidates and the
6-sweep fixpoint spacing suppression.

The JAX top-k is ``approx_max_k`` (exact on CPU); here it is a stable
descending sort, so equal responses keep ascending pixel order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sep_filter(img, row_taps, col_taps):
    """Separable edge-replicated stencil: rows (vertical) first, then
    columns; out[j] = Σ_t taps[t] · in[clip(j + t − r, 0, n−1)]."""
    H, W = img.shape
    r = len(row_taps) // 2
    p = F.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    v = sum(w * p[t : t + H, :] for t, w in enumerate(row_taps) if w != 0.0)
    p = F.pad(v[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    return sum(w * p[:, t : t + W] for t, w in enumerate(col_taps) if w != 0.0)


def shi_tomasi_response(img, block_size: int = 3):
    """Min-eigenvalue corner response (cv::goodFeaturesToTrack's score):
    Sobel gradients (smooth [1,2,1] ∘ diff [-1,0,1]) / 8, box-summed
    structure tensor / block_size², smaller eigenvalue."""
    sm = (1.0, 2.0, 1.0)
    df = (-1.0, 0.0, 1.0)
    bx = (1.0,) * block_size
    gx = _sep_filter(img, sm, df) / 8.0
    gy = _sep_filter(img, df, sm) / 8.0

    def box(x):
        return _sep_filter(x, bx, bx) / (block_size * block_size)

    Ixx = box(gx * gx)
    Ixy = box(gx * gy)
    Iyy = box(gy * gy)
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    return 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))


def annulus_mask(shape, center_x, center_y, max_r, min_r, dtype=torch.float32,
                 device=None):
    """PAL annulus mask (reference setMask, feature_tracker.cpp:52-57)."""
    H, W = shape
    yy = torch.arange(H, dtype=dtype, device=device)[:, None]
    xx = torch.arange(W, dtype=dtype, device=device)[None, :]
    r2 = (xx - center_x) ** 2 + (yy - center_y) ** 2
    return (r2 <= max_r**2) & (r2 >= min_r**2)


def _max_filter(x, kh, kw):
    """'SAME' max filter with -inf padding (reduce_window max)."""
    return F.max_pool2d(
        x[None, None], (kh, kw), stride=1, padding=(kh // 2, kw // 2)
    )[0, 0]


def occupancy_dilated(shape, pts, valid, min_dist: int):
    """True within a (2*min_dist+1) square around any valid point — the
    'too close to an existing track' exclusion zone."""
    H, W = shape
    occ = torch.zeros(H * W, dtype=torch.float32, device=pts.device)
    iy = torch.clamp(torch.round(pts[:, 1]).to(torch.int64), 0, H - 1)
    ix = torch.clamp(torch.round(pts[:, 0]).to(torch.int64), 0, W - 1)
    occ.scatter_reduce_(0, iy * W + ix, valid.to(torch.float32), reduce="amax")
    k = 2 * min_dist + 1
    dil = _max_filter(_max_filter(occ.reshape(H, W), k, 1), 1, k)
    return dil > 0.5


def select_features(response, static_mask, existing_pts, existing_valid,
                    n_new: int, min_dist: int, quality_level: float = 0.01):
    """Pick up to n_new corners: masked response, local-max NMS, top-k, then
    the fixpoint spacing pass (a candidate survives iff no stronger
    survivor lies within min_dist).

    Returns (pts [n_new, 2] (x, y), ok [n_new] bool)."""
    H, W = response.shape
    dev = response.device
    excl = occupancy_dilated((H, W), existing_pts, existing_valid, min_dist)
    resp = torch.where(static_mask & ~excl, response, 0.0)
    B = 5  # kill the border ridge of the edge-replicated stencils
    border = torch.zeros((H, W), dtype=torch.bool, device=dev)
    border[B:-B, B:-B].fill_(True)  # fill_: "= True" copies the scalar from the host
    resp = torch.where(border, resp, 0.0)
    resp = torch.where(resp >= quality_level * torch.max(resp), resp, 0.0)
    resp = torch.where(resp >= _max_filter(resp, 3, 3), resp, 0.0)

    n_cand = min(4 * n_new, H * W)
    vals, idx = torch.sort(resp.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:n_cand], idx[:n_cand]
    cy = (idx // W).to(response.dtype)
    cx = (idx % W).to(response.dtype)
    cand_ok = vals > 0.0

    md2 = float(min_dist * min_dist)
    d2 = (cx[:, None] - cx[None, :]) ** 2 + (cy[:, None] - cy[None, :]) ** 2
    # stronger[i, j]: candidate j outranks i (sort order = strength order).
    stronger = torch.tril(
        torch.ones((n_cand, n_cand), dtype=torch.bool, device=dev), diagonal=-1
    )
    clash = stronger & (d2 < md2) & cand_ok[None, :]
    surv = cand_ok
    for _ in range(6):
        surv = cand_ok & ~torch.any(clash & surv[None, :], dim=1)
    surv = surv & (torch.cumsum(surv.to(torch.int32), dim=0) <= n_new)

    # Compact the survivors to the first slots, keeping strength order.
    order = torch.argsort((~surv).to(torch.uint8), stable=True)[:n_new]
    pts = torch.stack([cx[order], cy[order]], dim=-1)
    ok = surv[order]
    return torch.where(ok[:, None], pts, 0.0), ok
