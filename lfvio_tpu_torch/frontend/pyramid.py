"""Image pyramid: 5-tap Gaussian blur with 2x decimation, edge replication.

Port of ``lfvio_tpu.frontend.pyramid.gaussian_pyramid``. The JAX form is two
banded matmuls per level (an MXU shape); here each separable pass is five
strided slices of an edge-padded image, summed with the OpenCV pyrDown taps
[1, 4, 6, 4, 1] / 16. Elementwise only, so no TF32 setting can round it.
Rows are filtered before columns, as in the reference's row_mat @ img @ col_matᵀ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _blur_down(img):
    """5x5 separable Gaussian blur + 2x decimation, edge-replicated:
    out[j] = Σ_t K5[t] · in[clip(2j + t − 2, 0, n−1)] on both axes."""
    H, W = img.shape
    Ho, Wo = -(-H // 2), -(-W // 2)
    p = F.pad(img[None, None], (2, 2, 2, 2), mode="replicate")[0, 0]
    rows = sum(w * p[t : t + 2 * Ho - 1 : 2, :] for t, w in enumerate(_K5))
    return sum(w * rows[:, t : t + 2 * Wo - 1 : 2] for t, w in enumerate(_K5))


def gaussian_pyramid(img, n_levels: int = 3):
    """Returns [L0=img, L1, ...] with n_levels+1 entries (OpenCV maxLevel)."""
    levels = [img]
    for _ in range(n_levels):
        levels.append(_blur_down(levels[-1]))
    return levels
