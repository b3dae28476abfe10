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

``pyramidal_lk_pallas`` is the function of the JAX package's Pallas kernel
(``lfvio_tpu.frontend.klt_pallas``), whose patch geometry differs: wider
patches at tile-aligned origins, so a feature may move further within a
level, and no refine pass. A second kernel of the same source runs it.
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


def _extract_patches(img, topleft, size, cols=None):
    """[N, size, cols] integer-aligned patches at topleft [N, 2] (y, x);
    cols defaults to size."""
    rows = topleft[:, 0, None] + torch.arange(size, device=img.device)
    cols = topleft[:, 1, None] + torch.arange(size if cols is None else cols, device=img.device)
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
    off_t = (py - tl_t[:, 0].to(dtype) - half, px - tl_t[:, 1].to(dtype) - half)

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
    base_s = (tl_s[:, 0].to(dtype), tl_s[:, 1].to(dtype))
    hi = patch - win - 1.0
    g, ok = _gauss_newton(tpatch, off_t, spatch, base_s, (hi, hi), pos, guess, valid, win,
                          n_iters)

    # Border validity in real-image coordinates.
    fx = px + g[:, 0]
    fy = py + g[:, 1]
    inb = (
        (fx >= PAD + 1.0) & (fx < PAD + W0 - 1.0)
        & (fy >= PAD + 1.0) & (fy < PAD + H0 - 1.0)
    )
    return g, ok & inb


def _gauss_newton(tpatch, off_t, spatch, base_s, hi, pos, guess, active, win, n_iters):
    """The LK of one level once its patches are cut: the (win+2)² template
    sample at off_t - 1 (oy, ox) in tpatch, its central-difference gradients
    and structure tensor, then up to n_iters steps from ``guess`` for the
    ``active`` features, each sampling the search patch (its origin base_s
    (y, x)) at offsets clamped to [0, hi[0]] x [0, hi[1]]. Returns (guess,
    ok): ok is active & good_G & the final offset within those bounds."""
    half = win // 2
    px, py = pos[:, 0], pos[:, 1]
    base_sy, base_sx = base_s
    T_ext = _sample_all(tpatch, off_t[0] - 1.0, off_t[1] - 1.0, win + 2, win + 2)
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

    g = guess
    live = good_G & active
    # A converged feature's guess is frozen, so running the loop until every
    # feature converged equals each feature stopping on its own.
    for _ in range(n_iters):
        if not bool(live.any()):
            break
        oy = torch.clamp(py + g[:, 1] - base_sy - half, 0.0, hi[0])
        ox = torch.clamp(px + g[:, 0] - base_sx - half, 0.0, hi[1])
        r = _sample_all(spatch, oy, ox, win, win) - T
        bx = torch.sum(Tx * r, dim=(1, 2))
        by = torch.sum(Ty * r, dim=(1, 2))
        dx = torch.clamp(-(Gyy * bx - Gxy * by) * inv_det, -2.0, 2.0)
        dy = torch.clamp(-(Gxx * by - Gxy * bx) * inv_det, -2.0, 2.0)
        g = torch.where(live[:, None], g + torch.stack([dx, dy], dim=1), g)
        live = live & (dx * dx + dy * dy > 1e-4)  # cv eps 0.01^2

    # The final sample window must lie inside the search patch.
    fy = py + g[:, 1] - base_sy - half
    fx = px + g[:, 0] - base_sx - half
    off_ok = (fy >= 0.0) & (fy <= hi[0]) & (fx >= 0.0) & (fx <= hi[1])
    return g, active & good_G & off_ok


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


# The Pallas kernel's patches (klt_pallas.py:42-44): both LANES columns wide
# from a 128-aligned column, the template TROWS and the search SROWS rows
# from an 8-aligned row, of the level padded by PAD and then edge-padded to
# whole (8, 128) tiles.
LANES = 256
TROWS = 56
SROWS = 64


def pallas_tile_shape(h: int, w: int):
    """(Ht, Wt): a level of h x w rows and columns, padded by PAD and then
    to whole (8, 128) tiles of at least the search patch
    (klt_pallas.py:257-262)."""
    hp, wp = h + 2 * PAD, w + 2 * PAD
    return max(-(-hp // 8) * 8, SROWS), max(-(-wp // 128) * 128, LANES)


def _aligned_corner(p, back, hi, align):
    """floor(p) - back clamped to [0, hi], aligned down to ``align``."""
    return torch.clamp(torch.floor(p).to(torch.int64) - back, 0, hi) // align * align


def pallas_level(img_prev, img_next, pos, guess, act):
    """One level of the Pallas kernel (klt_pallas.py:86-203) for all
    features, in float32: img_* [Ht, Wt] tile-aligned padded level images,
    pos and guess [N, 2] (x, y) in their coordinates, act [N] bool. Returns
    (guess [N, 2], ok [N] bool); ok is act & good_G & off_ok."""
    Ht, Wt = img_prev.shape
    px, py = pos[:, 0], pos[:, 1]
    # Template and search patches at tile-aligned origins.
    tly = _aligned_corner(py, HALF + 2, Ht - TROWS, 8)
    tlx = _aligned_corner(px, HALF + 2, Wt - LANES, 128)
    sly = _aligned_corner(py + guess[:, 1], HALF + SEARCH_MARGIN, Ht - SROWS, 8)
    slx = _aligned_corner(px + guess[:, 0], HALF + SEARCH_MARGIN, Wt - LANES, 128)
    tpatch = _extract_patches(img_prev, torch.stack([tly, tlx], 1), TROWS, LANES)
    spatch = _extract_patches(img_next, torch.stack([sly, slx], 1), SROWS, LANES)
    off_t = (py - tly.to(torch.float32) - HALF, px - tlx.to(torch.float32) - HALF)
    base_s = (sly.to(torch.float32), slx.to(torch.float32))
    return _gauss_newton(tpatch, off_t, spatch, base_s, (SROWS - WIN - 1.0, LANES - WIN - 1.0),
                         pos, guess, act, WIN, N_ITERS)


def pyramidal_lk_pallas(pyr_prev, pyr_next, pts_prev, valid, n_levels: int = 3):
    """The level loop of ``klt_pallas.py::pyramidal_lk_pallas`` (:234-295)
    over ``pallas_level``: coarse to fine, levels under 8 px skipped, the
    guess doubling between levels; ok is ANDed at every level with the
    level's ok and its real-image border test. Each level runs in float32
    and its guess is cast back to the pyramid's dtype. Returns (pts_next
    [N, 2], ok [N] bool)."""
    dtype = pyr_prev[0].dtype
    g = torch.zeros_like(pts_prev)
    ok = valid
    for lvl in range(n_levels, -1, -1):
        if min(pyr_prev[lvl].shape) >= 8:
            H0, W0 = pyr_prev[lvl].shape
            Ht, Wt = pallas_tile_shape(H0, W0)
            pads = (PAD, Wt - W0 - PAD, PAD, Ht - H0 - PAD)
            tiled = lambda img: F.pad(img.to(torch.float32)[None, None], pads,
                                      mode="replicate")[0, 0]
            pos_l = pts_prev / 2.0**lvl + PAD
            g_l, ok_l = pallas_level(tiled(pyr_prev[lvl]), tiled(pyr_next[lvl]),
                                     pos_l.to(torch.float32), g.to(torch.float32), ok)
            g = g_l.to(dtype)
            fx = pos_l[:, 0] + g[:, 0]
            fy = pos_l[:, 1] + g[:, 1]
            inb = (fx >= PAD + 1.0) & (fx < PAD + W0 - 1.0) & (fy >= PAD + 1.0) & (fy < PAD + H0 - 1.0)
            ok = ok & ok_l & inb
        if lvl > 0:
            g = g * 2.0
    return pts_prev + g, ok
