"""Chessboard corner detection for intrinsic calibration.

Port of ``lfvio_tpu.calib.chessboard`` (the capability of the reference's
grown-quad chessboard finder, camera_model/src/chessboard/Chessboard.cc):
detect the inner corners of a rows×cols chessboard and return them in
row-major board order for the calibration solvers (``calib/intrinsic.py``).

  1. X-corner (saddle) response on the device: corners of a chessboard are
     saddle points of the intensity surface, so −det(Hessian) of the
     blurred image is large exactly there and ≈0 on edges and blobs.
  2. 3×3 peak test, top-k by a stable descending sort (equal responses
     keep pixel order, as ``lax.top_k`` does), and a sub-pixel quadratic
     fit of the response in each candidate's 3×3 neighbourhood.
  3. Board ordering on the host (a numpy copy of the JAX package's): the
     projective frame of the 4 extreme corners, every detection snapped to
     its lattice node, and a bijection demanded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def chess_response(img, sigma: float = 1.5):
    """Saddle-point response map: −det(Hessian of the blurred image),
    clipped at 0. [H, W] float in, [H, W] float out."""
    k0, k1, k2 = 0.25, 0.5, 0.25  # repeated [1 2 1]/4 binomial blur
    x = img
    for _ in range(max(int(round(sigma * 2)), 1)):
        p = torch.cat([x[:1], x, x[-1:]], dim=0)
        x = p[:-2] * k0 + x * k1 + p[2:] * k2
        p = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
        x = p[:, :-2] * k0 + x * k1 + p[:, 2:] * k2

    def sh(a, dy, dx):
        return torch.roll(a, (-dy, -dx), dims=(0, 1))

    dxx = sh(x, 0, 1) - 2 * x + sh(x, 0, -1)
    dyy = sh(x, 1, 0) - 2 * x + sh(x, -1, 0)
    dxy = 0.25 * (sh(x, 1, 1) - sh(x, 1, -1) - sh(x, -1, 1) + sh(x, -1, -1))
    return torch.clamp(dxy * dxy - dxx * dyy, min=0.0)


def _detect_candidates(img, k: int = 128):
    """Top-k saddle candidates with a 3×3 peak test and sub-pixel quadratic
    refinement. Returns (pts [k, 2] (x, y), score [k])."""
    resp = chess_response(img)
    H, W = resp.shape
    m = resp
    for shift in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)):
        m = torch.maximum(m, torch.roll(resp, shift, dims=(0, 1)))
    is_peak = (resp >= m) & (resp > 0)
    flat = torch.where(is_peak, resp, 0.0).reshape(-1)
    score, idx = torch.sort(flat, descending=True, stable=True)
    score, idx = score[:k], idx[:k]
    yy, xx = idx // W, idx % W

    def grab(dy, dx):
        return resp[torch.clamp(yy + dy, 0, H - 1), torch.clamp(xx + dx, 0, W - 1)]

    c = grab(0, 0)
    dx_off = 0.5 * (grab(0, -1) - grab(0, 1)) / torch.clamp(grab(0, -1) - 2 * c + grab(0, 1),
                                                            min=1e-9)
    dy_off = 0.5 * (grab(-1, 0) - grab(1, 0)) / torch.clamp(grab(-1, 0) - 2 * c + grab(1, 0),
                                                            min=1e-9)
    pts = torch.stack([xx.to(resp.dtype) + torch.clamp(dx_off, -0.5, 0.5),
                       yy.to(resp.dtype) + torch.clamp(dy_off, -0.5, 0.5)], -1)
    return pts, score


def find_chessboard_corners(img, pattern, device=None):
    """Detect the rows×cols INNER corners of a chessboard.

    img [H, W] greyscale (any float or int range); pattern (rows, cols);
    the response runs in float32 on ``device`` (None: the CUDA card).
    Returns (corners [rows*cols, 2] float (x, y) in ROW-MAJOR board order,
    found: bool), Chessboard::findChessboardCorners' contract."""
    rows, cols = int(pattern[0]), int(pattern[1])
    n = rows * cols
    img = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=resolve_device(device))
    img = img / torch.clamp(torch.max(img), min=1e-6) * 255.0
    pts, score = _detect_candidates(img, k=max(4 * n, 64))
    pts = pts.cpu().numpy().astype(np.float64)
    score = score.cpu().numpy().astype(np.float64)
    if len(score) < n or score[n - 1] <= 0:
        return np.zeros((n, 2)), False
    # The n-th strongest response sets the scale: true X-corners of one
    # board score within a small factor of each other, edge junctions and
    # noise saddles far below.
    pts = pts[score >= 0.5 * score[n - 1]]
    if len(pts) < n:
        return np.zeros((n, 2)), False

    # Keep the strongest mutually spaced candidates.
    keep = []
    for i in range(len(pts)):
        if all(np.linalg.norm(pts[i] - pts[j]) > 4.0 for j in keep):
            keep.append(i)
    pts = pts[keep]
    if len(pts) < n:
        return np.zeros((n, 2)), False

    # Lattice frame from the 4 extreme corners (projective unit square).
    d = pts - pts.mean(0)
    quad = pts[[np.argmin(d[:, 0] + d[:, 1]), np.argmax(d[:, 0] - d[:, 1]),
                np.argmax(d[:, 0] + d[:, 1]), np.argmin(d[:, 0] - d[:, 1])]]
    # Homography unit square -> quad (4-point DLT).
    A = []
    for (u, v), (x, y) in zip(np.array([[0.0, 0], [1, 0], [1, 1], [0, 1]]), quad):
        A.append([u, v, 1, 0, 0, 0, -u * x, -v * x, -x])
        A.append([0, 0, 0, u, v, 1, -u * y, -v * y, -y])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    Hinv = np.linalg.inv(Vt[-1].reshape(3, 3))

    # Detections in the unit square; try both lattice orientations and keep
    # the bijective one.
    uvw = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ Hinv.T
    uv = uvw[:, :2] / uvw[:, 2:3]
    for r_axis, c_axis in ((1, 0), (0, 1)):
        gi = np.round(uv[:, c_axis] * (cols - 1)).astype(int)
        gj = np.round(uv[:, r_axis] * (rows - 1)).astype(int)
        ok = (gi >= 0) & (gi < cols) & (gj >= 0) & (gj < rows)
        # Residual gate: a detection must sit close to its lattice node.
        ok &= np.hypot(uv[:, c_axis] * (cols - 1) - gi, uv[:, r_axis] * (rows - 1) - gj) < 0.3
        node = gj * cols + gi
        board = np.full((n, 2), np.nan)
        used = np.zeros(n, bool)
        clash = False
        for p_idx in np.where(ok)[0]:
            if used[node[p_idx]]:
                clash = True
                break
            used[node[p_idx]] = True
            board[node[p_idx]] = pts[p_idx]
        if not clash and used.all():
            return board, True
    return np.zeros((n, 2)), False
