"""Trajectory evaluation: Umeyama / yaw-only alignment + ATE/RPE.

A copy of ``lfvio_tpu.runtime.evaluation`` (pure numpy), kept here because
that package's import chain reaches JAX.

Replaces the benchmark_publisher package (reference
benchmark_publisher_node.cpp:66-126 aligns GT by the pose at a skip index;
offline tools compute ATE). Provides the standard metrics directly.
"""

from __future__ import annotations

import numpy as np


def _associate(t_est, t_gt, max_dt=0.02):
    """Nearest-neighbor timestamp association. Returns (idx_est, idx_gt)."""
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    prev = j - 1
    choose_prev = np.abs(t_gt[prev] - t_est) < np.abs(t_gt[j] - t_est)
    jj = np.where(choose_prev, prev, j)
    ok = np.abs(t_gt[jj] - t_est) <= max_dt
    return np.where(ok)[0], jj[ok]


def align_umeyama(est, gt, with_scale=False):
    """Least-squares similarity/SE(3) alignment est -> gt.

    Returns (s, R, t) with gt ≈ s R est + t."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    Gm = gt - mu_g
    C = Gm.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (E * E).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def align_yaw_position(est_p, est_yaw0, gt_p, gt_yaw0):
    """4-DoF alignment used by benchmark_publisher: match yaw + position at
    one anchor sample."""
    dyaw = gt_yaw0 - est_yaw0
    c, s = np.cos(dyaw), np.sin(dyaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    t = gt_p - R @ est_p
    return R, t


def ate_rmse(t_est, p_est, t_gt, p_gt, with_scale=False, max_dt=0.02):
    """Absolute trajectory error RMSE after Umeyama alignment."""
    ie, ig = _associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    if len(ie) < 3:
        return np.inf, 0
    e = np.asarray(p_est)[ie]
    g = np.asarray(p_gt)[ig]
    s, R, t = align_umeyama(e, g, with_scale)
    err = g - (s * e @ R.T + t)
    return float(np.sqrt((err**2).sum(-1).mean())), len(ie)


def rpe_stats(t_est, p_est, t_gt, p_gt, delta=1.0, max_dt=0.02):
    """Relative pose (translation) error over time windows of `delta` s."""
    ie, ig = _associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    te = np.asarray(t_est)[ie]
    e = np.asarray(p_est)[ie]
    g = np.asarray(p_gt)[ig]
    errs = []
    k = 0
    for i in range(len(te)):
        while k < len(te) and te[k] < te[i] + delta:
            k += 1
        if k >= len(te):
            break
        de = np.linalg.norm(e[k] - e[i])
        dg = np.linalg.norm(g[k] - g[i])
        errs.append(abs(de - dg))
    if not errs:
        return np.inf
    return float(np.sqrt(np.mean(np.square(errs))))
