"""CLAHE (contrast-limited adaptive histogram equalization) on torch tensors.

Equivalent of cv::createCLAHE(3.0, Size(8,8))->apply, ported from
``lfvio_tpu.frontend.clahe``: per-tile 256-bin histograms, the clipped and
redistributed per-tile LUTs of ``_tile_luts``, then the per-pixel bilinear
blend of the four neighbouring tiles' LUTs (the gather form of
``_clahe_gather``; the JAX main path computes the same values as one-hot
MXU contractions in ``_clahe_mxu``).
"""

from __future__ import annotations

import torch


def _tile_luts(hist, clip_limit, npix, n_bins):
    """Per-tile LUT from per-tile histograms: clip + uniform redistribution
    (cv semantics: clipLimit scaled by tile size), cdf scaling."""
    clip = max(clip_limit * npix / n_bins, 1.0)
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / n_bins
    cdf = torch.cumsum(hist, dim=-1)
    lut = (cdf - cdf[..., :1]) / torch.clamp(npix - cdf[..., :1], min=1.0) * 255.0
    return torch.clamp(lut, 0.0, 255.0)


def clahe(img, clip_limit: float = 3.0, grid: int = 8, n_bins: int = 256):
    """img: [H, W] float in [0, 255]; H and W divisible by grid. Returns the
    equalized image in the same range and dtype."""
    H, W = img.shape
    dtype, dev = img.dtype, img.device
    th, tw = H // grid, W // grid
    npix = th * tw

    vals = torch.clamp(img, 0.0, 255.0)
    bins = torch.clamp((vals * (n_bins / 256.0)).to(torch.int64), 0, n_bins - 1)
    rows = torch.arange(H, device=dev)
    cols = torch.arange(W, device=dev)
    tile = (rows // th)[:, None] * grid + (cols // tw)[None, :]
    # Per-tile histograms by a scatter-add (torch.bincount would make the
    # host wait for the device to learn the largest bin).
    idx = (tile * n_bins + bins).reshape(-1)
    hist = torch.zeros(grid * grid * n_bins, dtype=torch.int64, device=dev).scatter_add_(
        0, idx, torch.ones_like(idx)
    ).to(dtype).reshape(grid * grid, n_bins)
    lut = _tile_luts(hist, clip_limit, npix, n_bins).reshape(-1)

    # Bilinear blend of the 4 neighbouring tile LUTs per pixel.
    gy = torch.clamp(rows.to(dtype) / th - 0.5, 0.0, grid - 1.0)
    gx = torch.clamp(cols.to(dtype) / tw - 0.5, 0.0, grid - 1.0)
    y0 = torch.floor(gy).to(torch.int64)
    x0 = torch.floor(gx).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=grid - 1)
    x1 = torch.clamp(x0 + 1, max=grid - 1)
    fy = (gy - y0.to(dtype))[:, None]
    fx = (gx - x0.to(dtype))[None, :]

    def at(ty, tx):
        return lut[(ty[:, None] * grid + tx[None, :]) * n_bins + bins]

    return (
        at(y0, x0) * ((1 - fy) * (1 - fx))
        + at(y0, x1) * ((1 - fy) * fx)
        + at(y1, x0) * (fy * (1 - fx))
        + at(y1, x1) * (fy * fx)
    )
