"""Batched pyramidal Lucas-Kanade optical flow — the plain PyTorch version.

Port of ``lfvio_tpu.frontend.klt`` (cv::calcOpticalFlowPyrLK with a 41x41
window over 3 pyramid levels, reference feature_tracker.cpp:127). The same
function runs as a hand-written CUDA kernel (``klt_cuda.py``,
``csrc/lk_pyramid.cu``: the whole ``pyramidal_lk`` in one launch, or one
level step as a one-pass launch); the FrontEnd reaches this module only
for tensors on the CPU, and the tests and ``chip_smoke.py`` call it
directly as the reference the kernel is held against.

Per level, for all N features at once: template and search patches are cut
from edge-padded level images, bilinear samples are banded shift-matrix
products (so taps outside a patch read exactly 0, as in the JAX form), and
up to ``n_iters`` Gauss-Newton steps run with a per-feature convergence mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WIN = 41  # correlation window (reference: cv::Size(41, 41))
HALF = WIN // 2
SEARCH_MARGIN = 6  # extra px the iterations may move within the cached patch
N_ITERS = 20  # per level (cv default 30 w/ eps 0.01)
MIN_EIG_THR = 1e-4  # per-pixel-normalized min eigenvalue gate (cv: 1e-4)
# Edge-replication pad so windows never clip; the same for every window
# size, refine pass included.
PAD = HALF + SEARCH_MARGIN + 4
REFINE_ITERS = 10  # iterations of the small-window refine pass
REFINE_MAX_MOVE = 1.5  # px: a refined track is kept only this close


def _extract_patches(img, topleft, size):
    """[N, size, size] integer-aligned patches at topleft [N, 2] (y, x)."""
    r = torch.arange(size, device=img.device)
    rows = topleft[:, 0, None] + r
    cols = topleft[:, 1, None] + r
    return img[rows[:, :, None], cols[:, None, :]]


def _shift_matrices(o, n_out, n_in, dtype):
    """Banded shift matrices [N, n_out, n_in]: row k linearly interpolates
    input index o + k (zero weight outside [0, n_in))."""
    i0 = torch.floor(o)
    f = (o - i0).to(dtype)[:, None, None]
    tgt = i0.to(torch.int64)[:, None, None] + torch.arange(
        n_out, device=o.device
    )[None, :, None]
    idx = torch.arange(n_in, device=o.device)[None, None, :]
    return (idx == tgt).to(dtype) * (1.0 - f) + (idx == tgt + 1).to(dtype) * f


def _sample_all(patches, oy, ox, rows, cols):
    """Bilinearly sample a rows×cols window from every patch [N, PR, PC] at
    per-feature fractional offsets (oy, ox): rows first, then columns."""
    dtype = patches.dtype
    _, PR, PC = patches.shape
    Sy = _shift_matrices(oy, rows, PR, dtype)  # [N, rows, PR]
    Sx = _shift_matrices(ox, cols, PC, dtype)  # [N, cols, PC]
    return torch.bmm(torch.bmm(Sy, patches), Sx.transpose(1, 2))


def track_level(img_prev, img_next, pos_prev_l, guess, valid,
                win: int = WIN, n_iters: int = N_ITERS):
    """One pyramid level of LK for all features (``klt.py::_track_level``).

    pos_prev_l: [N, 2] (x, y) positions in this level's coordinates.
    guess: [N, 2] flow estimate at this level's scale. valid: [N] bool.
    Returns (new_guess [N, 2], ok [N] bool).
    """
    half = win // 2
    tp = win + 4
    patch = win + 1 + 2 * SEARCH_MARGIN
    H0, W0 = img_prev.shape
    img_prev = F.pad(img_prev[None, None], (PAD,) * 4, mode="replicate")[0, 0]
    img_next = F.pad(img_next[None, None], (PAD,) * 4, mode="replicate")[0, 0]
    pos = pos_prev_l + PAD
    H, W = img_prev.shape
    dtype = img_prev.dtype
    px, py = pos[:, 0], pos[:, 1]

    # Template (fixed during the iterations) + central-difference gradients
    # from one (win+2)² sample.
    tl_t = torch.stack(
        [
            torch.clamp(torch.floor(py) - half - 2, 0, H - tp),
            torch.clamp(torch.floor(px) - half - 2, 0, W - tp),
        ],
        dim=1,
    ).to(torch.int64)
    tpatch = _extract_patches(img_prev, tl_t, tp)
    off_ty = py - tl_t[:, 0].to(dtype) - half
    off_tx = px - tl_t[:, 1].to(dtype) - half
    T_ext = _sample_all(tpatch, off_ty - 1.0, off_tx - 1.0, win + 2, win + 2)
    T = T_ext[:, 1:-1, 1:-1]
    Tx = 0.5 * (T_ext[:, 1:-1, 2:] - T_ext[:, 1:-1, :-2])
    Ty = 0.5 * (T_ext[:, 2:, 1:-1] - T_ext[:, :-2, 1:-1])

    Gxx = torch.sum(Tx * Tx, dim=(1, 2))
    Gxy = torch.sum(Tx * Ty, dim=(1, 2))
    Gyy = torch.sum(Ty * Ty, dim=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    tr = Gxx + Gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    good_G = min_eig / (win * win) > MIN_EIG_THR
    inv_det = torch.where(det > 1e-12, 1.0 / torch.clamp(det, min=1e-12), 0.0)

    # Search patches from the next image around the expected location.
    target = pos + guess
    tl_s = torch.stack(
        [
            torch.clamp(torch.floor(target[:, 1]) - half - SEARCH_MARGIN, 0, H - patch),
            torch.clamp(torch.floor(target[:, 0]) - half - SEARCH_MARGIN, 0, W - patch),
        ],
        dim=1,
    ).to(torch.int64)
    spatch = _extract_patches(img_next, tl_s, patch)
    base_sy = tl_s[:, 0].to(dtype)
    base_sx = tl_s[:, 1].to(dtype)

    g = guess
    active = good_G & valid
    # A converged feature's guess is frozen, so running the loop until every
    # feature converged equals each feature stopping on its own.
    for _ in range(n_iters):
        if not bool(active.any()):
            break
        oy = torch.clamp(py + g[:, 1] - base_sy - half, 0.0, patch - win - 1.0)
        ox = torch.clamp(px + g[:, 0] - base_sx - half, 0.0, patch - win - 1.0)
        r = _sample_all(spatch, oy, ox, win, win) - T
        bx = torch.sum(Tx * r, dim=(1, 2))
        by = torch.sum(Ty * r, dim=(1, 2))
        dx = torch.clamp(-(Gyy * bx - Gxy * by) * inv_det, -2.0, 2.0)
        dy = torch.clamp(-(Gxx * by - Gxy * bx) * inv_det, -2.0, 2.0)
        g = torch.where(active[:, None], g + torch.stack([dx, dy], dim=1), g)
        active = active & (dx * dx + dy * dy > 1e-4)  # cv eps 0.01^2

    # Border validity in real-image coordinates, and the sample window
    # must have stayed inside the cached search patch.
    fx = px + g[:, 0]
    fy = py + g[:, 1]
    inb = (
        (fx >= PAD + 1.0) & (fx < PAD + W0 - 1.0)
        & (fy >= PAD + 1.0) & (fy < PAD + H0 - 1.0)
    )
    off_ok = (
        (fy - base_sy - half >= 0.0) & (fy - base_sy - half <= patch - win - 1)
        & (fx - base_sx - half >= 0.0) & (fx - base_sx - half <= patch - win - 1)
    )
    return g, valid & good_G & inb & off_ok


def lk_pyramid(level_fn, pyr_prev, pyr_next, pts_prev, valid, n_levels,
               refine_win):
    """The level loop shared by the plain path and the CUDA kernel path:
    coarse to fine, the guess doubles between levels, ``ok`` is ANDed across
    levels, then the optional small-window refine pass at level 0, whose
    result is kept only where it converged within REFINE_MAX_MOVE px."""
    g = torch.zeros_like(pts_prev)
    ok = valid
    for lvl in range(n_levels, -1, -1):
        if min(pyr_prev[lvl].shape) >= 8:  # skip degenerate tiny levels
            scale = 2.0**lvl
            g, ok_l = level_fn(pyr_prev[lvl], pyr_next[lvl], pts_prev / scale, g, ok)
            ok = ok & ok_l
        if lvl > 0:
            g = g * 2.0
    if refine_win:
        g_ref, ok_ref = level_fn(
            pyr_prev[0], pyr_next[0], pts_prev, g, ok,
            win=int(refine_win), n_iters=REFINE_ITERS,
        )
        close = torch.sum((g_ref - g) ** 2, dim=-1) < REFINE_MAX_MOVE**2
        g = torch.where((ok_ref & close)[:, None], g_ref, g)
    return pts_prev + g, ok


def pyramidal_lk(pyr_prev, pyr_next, pts_prev, valid, n_levels: int = 3,
                 refine_win: int = 0):
    """Track pts_prev ([N, 2] (x, y) full-res pixels) from pyr_prev to
    pyr_next with the plain level step. Returns (pts_next [N, 2], ok [N])."""
    return lk_pyramid(track_level, pyr_prev, pyr_next, pts_prev, valid,
                      n_levels, refine_win)
