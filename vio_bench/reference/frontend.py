"""The tracker's plain reference: CLAHE (clip 3.0, 8×8 tiles), the 4-level
Gaussian pyramid (OpenCV pyrDown taps), pyramidal Lucas-Kanade (41×41
window, 20 iterations a level, a 15-px level-0 refine pass), border and
annulus rejection and the Scaramuzza bearing lift: the function of
``cv::calcOpticalFlowPyrLK`` as LF-VIO's feature_tracker.cpp:95-184 runs it.

A frozen plain copy of the port's plain versions (``frontend/clahe.py``,
``frontend/pyramid.py``, ``frontend/klt.py``), in any dtype: the benchmark
runs it in float64 as the reference and in float32 with TF32 matmuls as the
control. The bilinear samples are banded shift-matrix products, so a TF32
setting rounds them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WIN = 41
SEARCH_MARGIN = 6
N_ITERS = 20
MIN_EIG_THR = 1e-4
PAD = WIN // 2 + SEARCH_MARGIN + 4
REFINE_ITERS = 10
REFINE_MAX_MOVE = 1.5
_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def clahe(img, clip_limit=3.0, grid=8, n_bins=256):
    """img [H, W] in [0, 255] (H, W divisible by grid) -> equalized image."""
    H, W = img.shape
    dtype, dev = img.dtype, img.device
    th, tw = H // grid, W // grid
    npix = th * tw
    bins = torch.clamp((torch.clamp(img, 0.0, 255.0) * (n_bins / 256.0)).to(torch.int64),
                       0, n_bins - 1)
    rows, cols = torch.arange(H, device=dev), torch.arange(W, device=dev)
    tile = (rows // th)[:, None] * grid + (cols // tw)[None, :]
    idx = (tile * n_bins + bins).reshape(-1)
    hist = torch.zeros(grid * grid * n_bins, dtype=torch.int64, device=dev).scatter_add_(
        0, idx, torch.ones_like(idx)).to(dtype).reshape(grid * grid, n_bins)
    clip = max(clip_limit * npix / n_bins, 1.0)
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=-1, keepdim=True)
    cdf = torch.cumsum(torch.clamp(hist, max=clip) + excess / n_bins, dim=-1)
    lut = torch.clamp((cdf - cdf[..., :1]) / torch.clamp(npix - cdf[..., :1], min=1.0) * 255.0,
                      0.0, 255.0).reshape(-1)
    gy = torch.clamp(rows.to(dtype) / th - 0.5, 0.0, grid - 1.0)
    gx = torch.clamp(cols.to(dtype) / tw - 0.5, 0.0, grid - 1.0)
    y0, x0 = torch.floor(gy).to(torch.int64), torch.floor(gx).to(torch.int64)
    y1, x1 = torch.clamp(y0 + 1, max=grid - 1), torch.clamp(x0 + 1, max=grid - 1)
    fy, fx = (gy - y0.to(dtype))[:, None], (gx - x0.to(dtype))[None, :]
    at = lambda ty, tx: lut[(ty[:, None] * grid + tx[None, :]) * n_bins + bins]
    return (at(y0, x0) * ((1 - fy) * (1 - fx)) + at(y0, x1) * ((1 - fy) * fx)
            + at(y1, x0) * (fy * (1 - fx)) + at(y1, x1) * (fy * fx))


def _blur_down(img):
    H, W = img.shape
    Ho, Wo = -(-H // 2), -(-W // 2)
    p = F.pad(img[None, None], (2, 2, 2, 2), mode="replicate")[0, 0]
    rows = sum(w * p[t:t + 2 * Ho - 1:2, :] for t, w in enumerate(_K5))
    return sum(w * rows[:, t:t + 2 * Wo - 1:2] for t, w in enumerate(_K5))


def pyramid(img, n_levels=3):
    levels = [img]
    for _ in range(n_levels):
        levels.append(_blur_down(levels[-1]))
    return levels


def _patches(img, topleft, size):
    rows = topleft[:, 0, None] + torch.arange(size, device=img.device)
    cols = topleft[:, 1, None] + torch.arange(size, device=img.device)
    return img[rows[:, :, None], cols[:, None, :]]


def _shift(o, n_out, n_in, dtype):
    """Banded bilinear shift matrices [N, n_out, n_in] at offsets o."""
    i0 = torch.floor(o)
    f = (o - i0).to(dtype)[:, None, None]
    tgt = i0.to(torch.int64)[:, None, None] + torch.arange(n_out, device=o.device)[None, :, None]
    idx = torch.arange(n_in, device=o.device)[None, None, :]
    return (idx == tgt).to(dtype) * (1.0 - f) + (idx == tgt + 1).to(dtype) * f


def _sample(patches, oy, ox, rows, cols):
    Sy = _shift(oy, rows, patches.shape[1], patches.dtype)
    Sx = _shift(ox, cols, patches.shape[2], patches.dtype)
    return torch.bmm(torch.bmm(Sy, patches), Sx.transpose(1, 2))


def _track_level(img_prev, img_next, pos_l, guess, valid, win=WIN, n_iters=N_ITERS):
    half, tp, patch = win // 2, win + 4, win + 1 + 2 * SEARCH_MARGIN
    H0, W0 = img_prev.shape
    img_prev = F.pad(img_prev[None, None], (PAD,) * 4, mode="replicate")[0, 0]
    img_next = F.pad(img_next[None, None], (PAD,) * 4, mode="replicate")[0, 0]
    pos = pos_l + PAD
    H, W = img_prev.shape
    dtype = img_prev.dtype
    px, py = pos[:, 0], pos[:, 1]
    tl_t = torch.stack([torch.clamp(torch.floor(py) - half - 2, 0, H - tp),
                        torch.clamp(torch.floor(px) - half - 2, 0, W - tp)], 1).to(torch.int64)
    tpatch = _patches(img_prev, tl_t, tp)
    oty, otx = py - tl_t[:, 0].to(dtype) - half, px - tl_t[:, 1].to(dtype) - half
    target = pos + guess
    tl_s = torch.stack([
        torch.clamp(torch.floor(target[:, 1]) - half - SEARCH_MARGIN, 0, H - patch),
        torch.clamp(torch.floor(target[:, 0]) - half - SEARCH_MARGIN, 0, W - patch)],
        1).to(torch.int64)
    spatch = _patches(img_next, tl_s, patch)
    bsy, bsx = tl_s[:, 0].to(dtype), tl_s[:, 1].to(dtype)
    hi = patch - win - 1.0

    T_ext = _sample(tpatch, oty - 1.0, otx - 1.0, win + 2, win + 2)
    T = T_ext[:, 1:-1, 1:-1]
    Tx = 0.5 * (T_ext[:, 1:-1, 2:] - T_ext[:, 1:-1, :-2])
    Ty = 0.5 * (T_ext[:, 2:, 1:-1] - T_ext[:, :-2, 1:-1])
    Gxx, Gxy, Gyy = (torch.sum(a * b, dim=(1, 2)) for a, b in ((Tx, Tx), (Tx, Ty), (Ty, Ty)))
    det, tr = Gxx * Gyy - Gxy * Gxy, Gxx + Gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    good = min_eig / (win * win) > MIN_EIG_THR
    inv_det = torch.where(det > 1e-12, 1.0 / torch.clamp(det, min=1e-12), 0.0)
    g, live = guess, good & valid
    for _ in range(n_iters):
        if not bool(live.any()):
            break
        oy = torch.clamp(py + g[:, 1] - bsy - half, 0.0, hi)
        ox = torch.clamp(px + g[:, 0] - bsx - half, 0.0, hi)
        r = _sample(spatch, oy, ox, win, win) - T
        bx, by = torch.sum(Tx * r, dim=(1, 2)), torch.sum(Ty * r, dim=(1, 2))
        dx = torch.clamp(-(Gyy * bx - Gxy * by) * inv_det, -2.0, 2.0)
        dy = torch.clamp(-(Gxx * by - Gxy * bx) * inv_det, -2.0, 2.0)
        g = torch.where(live[:, None], g + torch.stack([dx, dy], dim=1), g)
        live = live & (dx * dx + dy * dy > 1e-4)
    fy, fx = py + g[:, 1] - bsy - half, px + g[:, 0] - bsx - half
    off_ok = (fy >= 0.0) & (fy <= hi) & (fx >= 0.0) & (fx <= hi)
    ex, ey = px + g[:, 0], py + g[:, 1]
    inb = (ex >= PAD + 1.0) & (ex < PAD + W0 - 1.0) & (ey >= PAD + 1.0) & (ey < PAD + H0 - 1.0)
    return g, valid & good & off_ok & inb


def pyramidal_lk(pyr_prev, pyr_next, pts, valid, n_levels=3, refine_win=15):
    """Track pts [N, 2] (x, y) from pyr_prev to pyr_next. Returns (pts, ok)."""
    g, ok = torch.zeros_like(pts), valid
    for lvl in range(n_levels, -1, -1):
        if min(pyr_prev[lvl].shape) >= 8:
            g, ok_l = _track_level(pyr_prev[lvl], pyr_next[lvl], pts / 2.0**lvl, g, ok)
            ok = ok & ok_l
        if lvl > 0:
            g = g * 2.0
    if refine_win:
        g_ref, ok_ref = _track_level(pyr_prev[0], pyr_next[0], pts, g, ok, win=refine_win,
                                     n_iters=REFINE_ITERS)
        close = torch.sum((g_ref - g) ** 2, dim=-1) < REFINE_MAX_MOVE**2
        g = torch.where((ok_ref & close)[:, None], g_ref, g)
    return pts + g, ok


def lift(poly, cx, cy, pts):
    """Unit bearings [N, 3] of pixels [N, 2] (a centred Scaramuzza camera)."""
    xa, ya = pts[:, 0] - cx, pts[:, 1] - cy
    rho = torch.sqrt(xa * xa + ya * ya)
    z = torch.zeros_like(rho) + poly[-1]
    for c in reversed(poly[:-1]):
        z = z * rho + c
    ray = torch.stack([xa, ya, -z], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def track(img_prev_u8, img_u8, pos, valid, cfg, dtype):
    """One tracked frame from the previous slot chain (pos [N, 2], valid [N])
    and the two uint8 frames: (pts [N, 2], status [N], bearings [N, 3]);
    status is LK's ok, the 1-px border and the PAL annulus."""
    cam = cfg["camera"]
    H, W = img_u8.shape
    prep = lambda im: pyramid(clahe(im.to(dtype)) if cfg["equalize"] else im.to(dtype))
    pts, ok = pyramidal_lk(prep(img_prev_u8), prep(img_u8), pos.to(dtype), valid)
    inb = (pts[:, 0] >= 1.0) & (pts[:, 0] < W - 1.0) & (pts[:, 1] >= 1.0) & (pts[:, 1] < H - 1.0)
    ix = torch.clamp(pts[:, 0].to(torch.int64), 0, W - 1).to(dtype)
    iy = torch.clamp(pts[:, 1].to(torch.int64), 0, H - 1).to(dtype)
    max_r, min_r = cfg["annulus"]
    r2 = (ix - W / 2.0) ** 2 + (iy - H / 2.0) ** 2
    status = ok & inb & (r2 <= max_r**2) & (r2 >= min_r**2)
    return pts, status, lift(cam["poly"], W / 2.0, H / 2.0, pts)
