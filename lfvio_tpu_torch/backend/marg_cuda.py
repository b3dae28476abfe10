"""The marginalizations' QR kernels (``csrc/marg_qr.cu``) and their plain
versions.

Two wrappers, each with its own ``launches`` count (registered with
``device.register_kernel``, so a CUDA graph's replays count):

  * ``marg_depth(res, J26, w, grid, cfg, n_cams, out=None)`` -> the stack's
    projection rows [F * 2 W, C], C = D + 1, over [pose0 | speed-bias0 |
    kept | r] (``stack_columns``): each feature's 2 W rows (frames 1..W; the
    anchor, frame 0, has no row) of ``proj_rows``' compact output, weighted
    by ``w``, reflected so that its inverse-depth column lies in its first
    row alone; that row is dropped (its slot zero). A feature whose depth
    column is all zero keeps all its rows unreflected. MARGIN_OLD's stage 1;
    every used feature of ``grid`` must be anchored at frame 0. ``out`` may
    be any contiguous view (MARGIN_OLD passes its stack's rows after the
    head, which need not start on a 16-byte boundary); on the card C is at
    most ``marg_qr``'s widest stack.
  * ``marg_qr(A, head=0)`` -> R [C, C], the upper-triangular R factor of
    A [M, C]: RᵀR = AᵀA. Its first ``head`` rows (dense ones, such as a
    prior's) form a leaf of their own that the others' tree merges into
    last. A column whose part to eliminate is zero (or below the
    rounding unit of its pivot, or below the smallest normal number) takes
    no reflection and consumes no row, so an empty column's row of R stays
    zero (no unit rows are needed) and a column without information leaves
    the residual's rest to the last row. R's row signs are the
    implementation's. Stage 2 of both marginalizations.

``latency_floor(name, ...)`` launches the source's empty kernel with the
grid, block and shared memory of one of the two launches, the part of its
time that no design of the kernel removes (card only, counted nowhere).

On CUDA tensors each launches its kernel on the current stream or raises;
on CPU tensors each is its plain version (``depth_plain``, ``qr_plain``:
one reflection a column over the whole matrix, the kernel's arithmetic
without its tiles and tree). Neither reads anything back, so both sit in
the MARGIN_OLD and SECOND_NEW graphs. ``qr_blocked_plain`` is
``marg_qr_kernel``'s order in torch ops (its leaves, tiles, 16-column
panels with their compact WY updates and tree), the CPU tests' oracle of
that order, and ``depth_order_plain`` ``marg_depth_kernel``'s (its column
table ``depth_columns``, the sums of vᵀA over the rows that carry each
column, the entries by kind); both read values back.

They stand where the JAX package calls ``jnp.linalg.qr`` (XLA, no Pallas
kernel) in ``lfvio_tpu/backend/marginalize.py:260`` (marginalize_old_qr) and
``:297`` (marginalize_second_new_qr).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..device import register_kernel
from ..tracing import region
from .proj_cuda import _DTYPES, _check, _ptr, _shape, full_rows
from .state import pose_dim, pose_off, sb_off

@functools.lru_cache(maxsize=None)
def _stack_order(n_frames: int, D: int):
    drop = np.r_[pose_off(0):pose_off(0) + 6, sb_off(0, n_frames):sb_off(0, n_frames) + 9]
    return np.concatenate([drop, np.setdiff1d(np.arange(D), drop)])


@functools.lru_cache(maxsize=None)
def stack_columns(n_frames: int, D: int, device: torch.device):
    """The full layout's columns in MARGIN_OLD's stack order (pose0 and
    speed-bias0 first, then the kept ones in order) as an int64 tensor on
    ``device``, built once (a graph cannot copy an index from the host)."""
    return torch.as_tensor(_stack_order(n_frames, D), device=device)


# ------------------------------------------------------------ plain versions
def _dense_obs_rows(res, J26, w, grid, cfg, n_cams):
    """Each feature's 2 W rows (frames 1..W) in the stack's columns, dense:
    [F, 2 W, C]."""
    F, W1 = grid.valid.shape
    D = pose_dim(W1, n_cams)
    Jw = J26 * w[..., None, None]
    Jfull = full_rows(Jw, grid, cfg, n_cams)[:, :, :, stack_columns(W1, D, res.device)]
    A = torch.cat([Jfull, (res * w[..., None])[..., None]], dim=-1)
    return A[:, 1:].reshape(F, 2 * (W1 - 1), D + 1), Jw[:, 1:, :, 24].reshape(F, 2 * (W1 - 1))


def depth_plain(res, J26, w, grid, cfg, n_cams):
    """``marg_depth``'s plain version: the dense rows of each feature and one
    reflection of them, batched over the features."""
    A, x = _dense_obs_rows(res, J26, w, grid, cfg, n_cams)
    F, R2, C = A.shape
    if not F:
        return A.reshape(0, C)
    xmax = x.abs().amax(dim=1)
    bad = torch.isnan(x).any(dim=1)
    refl = bad | (xmax >= torch.finfo(x.dtype).tiny)
    inv = 1.0 / torch.where(refl, xmax, 1.0)
    xh = x * inv[:, None]
    ah = xh[:, 0]
    bh = -torch.copysign(torch.sqrt((xh * xh).sum(dim=1)), ah)
    tau = torch.where(refl, (bh - ah) / bh, 0.0)
    scal = torch.where(refl, inv / (ah - bh), 0.0)
    v = x * scal[:, None]
    v[:, 0].fill_(1.0)
    u = torch.einsum("fr,frc->fc", v, A)
    out = A - (tau[:, None] * v)[:, :, None] * u[:, None, :]
    out[:, 0] = torch.where(refl[:, None], 0.0, A[:, 0])
    return torch.where(refl[:, None, None], out, A).reshape(F * R2, C)


# The lanes of marg_depth_kernel (csrc/marg_qr.cu) that sum a column over
# all of a slot's rows.
DEPTH_GROUP = 8


def depth_columns(n_frames, n_cams, ex, td):
    """marg_depth_kernel's column table (``depth_code``): for each of the C
    stack columns its compact column q (a slot's compact rows hold pose0
    [0, 6), the observing frame's pose [6, 12), the extrinsic blocks
    camera-major [12, 12 + 6 n_cams), td, r), the rows that carry it (g: 0
    none, an empty column; 1 all; 2 + p rows 2 p and 2 p + 1 alone) and the
    first column at or after it that is not empty (zrun); three int64
    arrays."""
    W1, nc = n_frames, n_cams
    W, e0 = W1 - 1, 15 * W1
    tdc = e0 + 6 * nc
    C = tdc + 2
    q, g, zrun = np.zeros(C, np.int64), np.zeros(C, np.int64), np.arange(C)
    q[:6], g[:6] = np.arange(6), 1
    pose = np.arange(15, 15 + 6 * W)
    q[pose], g[pose] = 6 + (pose - 15) % 6, 2 + (pose - 15) // 6
    q[e0:tdc], g[e0:tdc] = 12 + np.arange(6 * nc), int(ex)
    q[tdc], g[tdc] = 12 + 6 * nc, int(td)
    q[C - 1], g[C - 1] = 13 + 6 * nc, 1
    for col in np.nonzero(g == 0)[0]:
        zrun[col] = (15 if col < 15 else e0 if ex and col < e0 else tdc if td and col < tdc
                     else C - 1)
    return q, g, zrun


def depth_order_plain(res, J26, w, grid, cfg, n_cams):
    """``marg_depth_kernel``'s arithmetic in its order, in torch ops: the
    slot's compact rows (weighted; the row's camera's extrinsic block, then
    the anchor's, added), the reflection of its depth column (its norm
    unscaled where the largest entry lies in ``UNSCALED``, else scaled by
    it), u = A[0] + scal Σ_{r >= 1} x_r A[r] a column over the rows that
    carry it (``depth_columns``: a frame's pose over its two rows; pose0,
    the extrinsics, td and r over all rows in DEPTH_GROUP interleaved
    partial sums added as the kernel's butterfly adds them; an empty column
    scal Σ x_r 0), then each entry A[r, col] - τ v_r u_col (the pivot row
    zero; A where the depth column is all zero). [F * 2 W, C]. The CPU
    tests' oracle of the kernel's order, not a program's plain version
    (``depth_plain``)."""
    F, W1 = grid.valid.shape
    W, nc = W1 - 1, n_cams
    R2 = 2 * W
    ex, td = bool(cfg.estimate_extrinsic), bool(cfg.estimate_td)
    q, g, _ = depth_columns(W1, nc, ex, td)
    C = len(q)
    dt = res.dtype
    Jw = (J26[:, 1:] * w[:, 1:, None, None]).reshape(F, R2, 26)
    cam = (grid.cam if grid.cam is not None else
           torch.zeros((F, W1), dtype=torch.int64, device=res.device))
    cj = cam[:, 1:, None].expand(F, W, 2).reshape(F, R2)
    ci = cam[:, :1].expand(F, R2)
    zero = torch.zeros((), dtype=dt)
    blocks = []
    for c in range(nc):  # the row's camera's block, then the anchor's
        if ex:
            blocks.append(torch.where((cj == c)[..., None], Jw[..., 18:24], zero)
                          + torch.where((ci == c)[..., None], Jw[..., 12:18], zero))
        else:
            blocks.append(torch.zeros_like(Jw[..., 12:18]))
    tdcol = Jw[..., 25:26] if td else torch.zeros_like(Jw[..., 25:26])
    cr = torch.cat([Jw[..., :12], *blocks, tdcol,
                    (res[:, 1:].reshape(F, R2) * w[:, 1:, None].expand(F, W, 2).reshape(F, R2)
                     )[..., None]], dim=-1)
    x = Jw[..., 24]
    lo, hi = UNSCALED[dt]
    fi = torch.finfo(dt)
    mx = torch.where(torch.isnan(x), 0.0, x.abs()).amax(dim=1)
    bad = ~torch.isfinite(x).all(dim=1)
    refl = bad | (mx >= fi.tiny)
    x0 = x[:, 0]
    b = -torch.copysign(torch.sqrt((x * x).sum(dim=1)), x0)
    inv = 1.0 / mx
    ah = x0 * inv
    bh = -torch.copysign(torch.sqrt(((x * inv[:, None]) ** 2).sum(dim=1)), ah)
    inside = (mx >= lo) & (mx <= hi)
    scal = torch.where(inside, 1.0 / (x0 - b), inv / (ah - bh))
    tau = torch.where(inside, (b - x0) / b, (bh - ah) / bh)
    scal, tau = torch.where(refl, scal, 0.0), torch.where(refl, tau, 0.0)
    finite = ~bad & torch.isfinite(scal) & torch.isfinite(tau)
    zval = torch.where(refl & ~finite, float("nan"), 0.0).to(dt)
    v = torch.cat([torch.ones_like(x[:, :1]), x[:, 1:] * scal[:, None]], dim=1)
    tv = torch.where(refl[:, None], tau[:, None] * v, 0.0)
    u = torch.zeros((F, C), dtype=dt)
    for col in range(C):
        if g[col] == 1:  # DEPTH_GROUP lanes, each over rows 1 + l, 1 + l + DEPTH_GROUP, ...
            part = [(x[:, 1 + l::DEPTH_GROUP] * cr[:, 1 + l::DEPTH_GROUP, q[col]]).sum(dim=1)
                    if 1 + l < R2 else torch.zeros(F, dtype=dt) for l in range(DEPTH_GROUP)]
            o = DEPTH_GROUP // 2
            while o:
                part = [part[l] + part[l ^ o] for l in range(DEPTH_GROUP)]
                o //= 2
            u[:, col] = cr[:, 0, q[col]] + scal * part[0]
        elif g[col] == 0:
            u[:, col] = zval
        else:
            r0 = 2 * (g[col] - 2)
            s = x[:, r0 + 1] * cr[:, r0 + 1, q[col]]
            if r0:
                s = x[:, r0] * cr[:, r0, q[col]] + s
            u[:, col] = (0.0 if r0 else cr[:, 0, q[col]]) + scal * s
    u = torch.where(refl[:, None], u, 0.0)
    rows = torch.arange(R2)
    on = (torch.as_tensor(g)[None, :] == 1) | (torch.as_tensor(g)[None, :] == rows[:, None] // 2 + 2)
    A = torch.where(on[None], cr[:, :, torch.as_tensor(q)], zero)
    out = A - tv[:, :, None] * u[:, None, :]
    out[:, 0] = torch.where(refl[:, None], 0.0, out[:, 0])
    return out.reshape(F * R2, C)


def qr_plain(A):
    """``marg_qr``'s plain version: R [C, C] of A [M, C] by one reflection a
    column of [R[k, k]; A[:, k]] over all rows (the kernel's rule for a
    column with nothing to eliminate), masked so that nothing is read
    back."""
    M, C = A.shape
    fi = torch.finfo(A.dtype)
    R = torch.zeros((C, C), dtype=A.dtype, device=A.device)
    Y = A.clone()
    for k in range(C):
        a0, y = R[k, k], Y[:, k]
        ymax = y.abs().amax() if M else torch.zeros_like(a0)
        bad = torch.isnan(y).any()
        skip = ~bad & ((ymax < fi.tiny) | (ymax <= fi.eps * a0.abs()))
        s = torch.where(skip, 1.0, torch.maximum(ymax, a0.abs()))
        inv = 1.0 / s
        yh, ah = y * inv, a0 * inv
        bh = -torch.copysign(torch.sqrt(ah * ah + (yh * yh).sum()), ah)
        tau = torch.where(skip, 0.0, (bh - ah) / bh)
        v = torch.where(skip, 0.0, y * (inv / (ah - bh)))
        if k + 1 < C:
            tw = tau * (R[k, k + 1:] + v @ Y[:, k + 1:])
            R[k, k + 1:] -= tw
            Y[:, k + 1:] -= v[:, None] * tw[None, :]
        R[k, k] = torch.where(skip, a0, bh * s)
    return R


# The kernel's shapes (csrc/marg_qr.cu): a panel's columns, a tile's rows
# by type, a leaf's rows after the head, the rows a leaf lists at once, and
# the range of a column's largest entry where its norm is summed unscaled.
PANEL = 16
TILE_ROWS = {torch.float32: 128, torch.float64: 64}
LEAF_ROWS = 256
LIST_ROWS = 512
UNSCALED = {torch.float32: (2.0 ** -40, 2.0 ** 40), torch.float64: (2.0 ** -400, 2.0 ** 400)}


def _first_nonzero(X):
    """Each row's first non-zero column (C where it has none)."""
    C = X.shape[1]
    nz = X != 0
    idx = torch.arange(C, device=X.device).expand_as(X)
    return torch.where(nz, idx, C).amin(dim=1) if C else torch.zeros(X.shape[0], dtype=torch.long)


def _factor_panel(R, X, pc, lo_hi):
    """One panel of the sweep in the kernel's order: a reflection a column
    k of pc of [R[k, k]; X[:, k]] (unscaled where its largest entry lies in
    ``lo_hi``, else scaled by it; none where the kernel's rule skips it),
    its update of the panel's later columns; R's panel block and X's panel
    columns in place. Returns (Y [n, len(pc)], T upper triangular)."""
    fi = torch.finfo(X.dtype)
    nb = len(pc)
    Y = torch.zeros((X.shape[0], nb), dtype=X.dtype)
    T = torch.zeros((nb, nb), dtype=X.dtype)
    for j, k in enumerate(pc):
        x, a0 = X[:, k].clone(), R[k, k].clone()
        mx = x.abs().max() if len(x) else torch.zeros((), dtype=X.dtype)
        bad = bool(torch.isnan(x).any())
        if not bad and (mx < fi.tiny or mx <= fi.eps * a0.abs()):
            continue  # τ = 0: Y's column and T's column stay zero
        s = torch.maximum(mx, a0.abs())
        f = 1.0 if lo_hi[0] <= s <= lo_hi[1] else 1.0 / s
        xs = x * f
        ss = xs @ x if f == 1.0 else f * (xs @ x)
        ah = a0 * f
        bh = -torch.copysign(torch.sqrt(ah * ah + ss), ah)
        coef = 1.0 / (ah - bh)
        tau = (bh - ah) * (1.0 / bh)
        later = pc[j + 1:]
        if later:
            tw = tau * (R[k, later] + coef * (xs @ X[:, later]))
            R[k, later] -= tw
        v = x * (f * coef)
        if later:
            X[:, later] -= v[:, None] * tw[None, :]
        R[k, k] = bh if f == 1.0 else bh * s
        g = Y[:, :j].T @ v
        T[:j, j] = -tau * (T[:j, :j] @ g)
        T[j, j] = tau
        Y[:, j] = v
    return Y, T


def _sweep(R, rmask, X, lo_hi, nb):
    """Absorb the tile X (its rows) into R: the columns from X's first
    non-zero one where X or R is non-zero, ``nb`` at a time (a panel, then
    its compact WY update W = R_p + Yᵀ X, W' = Tᵀ W, R_p -= W', X -= Y W'
    of the later ones); rmask |= X's columns, in place."""
    C = R.shape[0]
    tmask = (X != 0).any(dim=0)
    kmin = int(_first_nonzero(X).min()) if len(X) else C
    cols = [c for c in range(kmin, C) if bool(rmask[c] | tmask[c])]
    for p0 in range(0, len(cols), nb):
        pc, tc = cols[p0:p0 + nb], cols[p0 + nb:]
        Y, T = _factor_panel(R, X, pc, lo_hi)
        if tc:
            W = R[pc][:, tc] + Y.T @ X[:, tc]
            W = T.T @ W
            R[[[k] for k in pc], tc] -= W
            X[:, tc] -= Y @ W
    rmask |= tmask


def _absorb_rows(R, rmask, rows, tile_rows, lo_hi, nb):
    """Absorb ``rows`` [k, C], tile_rows at a time, into R."""
    for t0 in range(0, rows.shape[0], tile_rows):
        _sweep(R, rmask, rows[t0:t0 + tile_rows].clone(), lo_hi, nb)


def qr_blocked_plain(A, head=0, tile_rows=None, leaf_rows=LEAF_ROWS, nb=PANEL):
    """``marg_qr_kernel``'s arithmetic in its order, in torch ops: leaf 0
    the first ``head`` rows (LIST_ROWS at a time, the non-zero ones by
    first non-zero column), leaves 1.. ``leaf_rows`` rows each (non-zero
    rows in order), each absorbed ``tile_rows`` at a time (the kernel's
    TILE_ROWS by default) in sweeps of ``nb``-column panels with their
    compact WY updates; leaves 1.. merged up a binary tree (the right
    child's non-zero rows into the left), its root last into leaf 0. R
    [C, C]. Reads values back to choose its steps: a CPU tests' oracle of
    the kernel's order, not a program's plain version (``qr_plain``)."""
    M, C = A.shape
    tile_rows = tile_rows or TILE_ROWS[A.dtype]
    lo_hi = UNSCALED[A.dtype]

    def leaf(rows, by_first):
        R = torch.zeros((C, C), dtype=A.dtype)
        rmask = torch.zeros(C, dtype=torch.bool)
        for c0 in range(0, rows.shape[0], LIST_ROWS):
            chunk = rows[c0:c0 + LIST_ROWS]
            first = _first_nonzero(chunk)
            keep = (first < C).nonzero()[:, 0]
            if by_first:
                keep = keep[torch.sort(first[keep], stable=True)[1]]
            _absorb_rows(R, rmask, chunk[keep], tile_rows, lo_hi, nb)
        return R, rmask

    nodes = [leaf(A[:head], True)]
    nodes += [leaf(A[r:r + leaf_rows], False) for r in range(head, M, leaf_rows)]

    def merge(into, frm):
        R, rmask = nodes[into]
        Rf, fmask = nodes[frm]
        _absorb_rows(R, rmask, Rf[fmask.nonzero()[:, 0]], tile_rows, lo_hi, nb)

    nsub, step = len(nodes) - 1, 1
    while step < nsub:
        for parent in range(0, nsub, 2 * step):
            if parent + step < nsub:
                merge(1 + parent, 1 + parent + step)
        step *= 2
    if nsub:
        merge(0, 1)
    return nodes[0][0]


# ------------------------------------------------------------ the kernels
def _library():
    from ..frontend.klt_cuda import library

    return library("marg_qr")


_P, _I = ctypes.c_void_p, ctypes.c_int
_DEPTH_ARGTYPES = [_P] * 4 + [_I] * 7 + [_P, _P]
_QR_ARGTYPES = [_P] + [_I] * 6 + [_P] * 4
_fns = {}


def _fn(name, argtypes):
    if name not in _fns:
        fn = getattr(_library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _depth_inputs(res, J26, w, grid, n_cams, out):
    """Check marg_depth's inputs; (dtype, F, W1, C, out)."""
    name = "marg_depth"
    dtype, dev = res.dtype, res.device
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: takes float32 or float64, got {dtype}")
    F, W1 = grid.valid.shape
    if W1 < 2:
        raise ValueError(f"{name}: the grid has {W1} frames, no observation row")
    C = pose_dim(W1, n_cams) + 1
    max_cols = limits(dtype)[0]
    if C > max_cols:  # the widest stack marg_qr takes; the depth column fits a warp below it
        raise ValueError(f"{name}: the stack would have {C} columns; the kernels take at most "
                         f"{max_cols}")
    t = {"res": (res, None), "J26": (J26, None), "w": (w, None)}
    if grid.cam is not None:
        t["cam"] = (grid.cam, torch.int64)
    if out is None:
        out = torch.empty((F * 2 * (W1 - 1), C), dtype=dtype, device=dev)
    t["out"] = (out, None)
    _check(name, t, dtype, dev)
    for key, x, shape in (("res", res, (F, W1, 2)), ("J26", J26, (F, W1, 2, 26)),
                          ("w", w, (F, W1)), ("out", out, (F * 2 * (W1 - 1), C)),
                          *((("cam", grid.cam, (F, W1)),) if grid.cam is not None else ())):
        _shape(name, key, x, shape)
    return dtype, F, W1, C, out


def _depth_launch(fn_name, res, J26, w, grid, cfg, n_cams, out, fn=None):
    """One call of ``fn_name`` (the kernel's launch, or with empty=1 the
    empty kernel's; this library's ``marg_depth_launch`` or ``fn``, another
    build's) on ``out``; whether it launched (an empty grid launches
    nothing)."""
    dtype, F, W1, C, out = _depth_inputs(res, J26, w, grid, n_cams, out)
    if not F:
        return out, False
    empty = int(fn_name == "empty")
    dev = res.device
    with region("marg_qr::marg_depth"), torch.cuda.device(dev):
        err = (fn or _fn("marg_depth_launch", _DEPTH_ARGTYPES))(
            res.data_ptr(), J26.data_ptr(), w.data_ptr(), _ptr(grid.cam), F, W1, n_cams,
            int(cfg.estimate_extrinsic), int(cfg.estimate_td), _DTYPES[dtype], empty,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "marg_depth")
    return out, True


class MargDepthKernel:
    """``marg_depth``: one launch of ``marg_depth_kernel``, a block a slot.
    On the card it takes a stack of at most ``limits(dtype)[0]`` columns
    (marg_qr's widest) and raises ValueError above it."""

    def __init__(self):
        self.launches = 0
        self._fn = None  # another build's launch

    def __call__(self, res, J26, w, grid, cfg, n_cams, out=None):
        if not res.is_cuda:
            rows = depth_plain(res, J26, w, grid, cfg, n_cams)
            if out is None:
                return rows
            out.copy_(rows)
            return out
        out, launched = _depth_launch("kernel", res, J26, w, grid, cfg, n_cams, out, self._fn)
        self.launches += launched
        return out


def leaves(M, head, limits_fn=None):
    """(leaves, tree levels) of ``marg_qr`` on M rows whose first ``head``
    form leaf 0: 1 + ceil((M - head) / L) leaves, L the rows of a leaf
    (``limits``), the levels of the binary tree over all but leaf 0. Card
    only."""
    L = limits(torch.float32, limits_fn)[3]
    NL = 1 + -(-(M - head) // L)
    return NL, math.ceil(math.log2(NL - 1)) if NL > 2 else 0


_limits = {}
_LIMITS_ARGTYPES = [_I, _P, _P, _P, _P]


def limits(dtype, fn=None):
    """(the widest stack, words of a column mask, rows of a tile, rows of a
    leaf after the head) of ``marg_qr_kernel`` in ``dtype``. Card only (read
    from the library, or through ``fn``, another build's
    ``marg_qr_limits``)."""
    if fn is not None or dtype not in _limits:
        vals = [ctypes.c_int() for _ in range(4)]
        (fn or _fn("marg_qr_limits", _LIMITS_ARGTYPES))(_DTYPES[dtype],
                                                        *[ctypes.byref(v) for v in vals])
        if fn is not None:
            return tuple(v.value for v in vals)
        _limits[dtype] = tuple(v.value for v in vals)
    return _limits[dtype]


def _qr_launch(empty, A, head, fn=None, limits_fn=None):
    """One call of ``marg_qr_launch`` (this library's, or ``fn`` with
    ``limits_fn``, another build's) on A; R [C, C]."""
    name = "marg_qr"
    if A.dtype not in _DTYPES:
        raise ValueError(f"{name}: takes float32 or float64, got {A.dtype}")
    if A.dim() != 2 or not A.is_contiguous() or not A.shape[1] or not A.shape[0]:
        raise ValueError(f"{name}: A must be a contiguous non-empty [M, C] matrix, got "
                         f"{tuple(A.shape)}" + ("" if A.is_contiguous() else " (not contiguous)"))
    M, C = A.shape
    if not 0 <= head <= M:
        raise ValueError(f"{name}: head {head} does not fit {M} rows")
    max_cols, mask_words = limits(A.dtype, limits_fn)[:2]
    if C > max_cols:
        raise ValueError(f"{name}: takes at most {max_cols} columns, got {C}")
    dev = A.device
    NL, levels = leaves(M, head, limits_fn)
    R = torch.empty((NL, C, C), dtype=A.dtype, device=dev)
    mask = torch.empty((NL, mask_words), dtype=torch.int32, device=dev)
    # zeroed sync words: this source's 1 + 2 (2 NL - 1) (a ticket, each node's flag and
    # progress); an earlier source's (turns.py) levels * NL + 1 merge counters
    count = torch.zeros((max(4 * NL - 1, levels * NL + 1),), dtype=torch.int32, device=dev)
    with region("marg_qr::marg_qr"), torch.cuda.device(dev):
        err = (fn or _fn("marg_qr_launch", _QR_ARGTYPES))(
            A.data_ptr(), M, C, head, NL, _DTYPES[A.dtype], int(empty),
            R.data_ptr(), mask.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    return R[0]


class MargQrKernel:
    """``marg_qr``: one launch of ``marg_qr_kernel``, a block a leaf (the
    first ``head`` rows, then a fixed number each: ``limits``) and a block a
    merge of the leaves' triangles, each merge pipelined behind the two it
    reads."""

    def __init__(self):
        self.launches = 0
        self._fn = self._limits_fn = None  # another build's launch and limits

    def __call__(self, A, head=0):
        if not A.is_cuda:
            return qr_plain(A)
        R = _qr_launch(False, A, head, self._fn, self._limits_fn)
        self.launches += 1
        return R


marg_depth = register_kernel(MargDepthKernel())
marg_qr = register_kernel(MargQrKernel())


def latency_floor(name, *args, **kw):
    """One launch of ``csrc/marg_qr.cu``'s empty kernel with the grid, block
    and shared memory of ``name``'s launch ("marg_depth" with marg_depth's
    arguments, "marg_qr" with marg_qr's) through the wrappers' ctypes path,
    allocating what the wrapper allocates: the part of that launch's time
    that no design of its kernel removes. Card only; adds to no
    ``launches``."""
    if name not in ("marg_depth", "marg_qr"):
        raise ValueError(f"latency_floor: takes 'marg_depth' or 'marg_qr', got {name!r}")
    if not args[0].is_cuda:
        raise ValueError("latency_floor: times a launch on the card; the inputs lie on the CPU")
    if name == "marg_depth":
        return _depth_launch("empty", *args, out=kw.get("out"))[0]
    return _qr_launch(True, args[0], kw.get("head", 0))
