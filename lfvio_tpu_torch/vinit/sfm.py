"""Global structure-from-motion bootstrap (host, f64).

Equivalent of GlobalSFM::construct
(vins_estimator/src/initial/initial_sfm.cpp:117-316):
fix pivot frame l and the newest frame from the relative pose, PnP-chain the
frames between/before, triangulate pairwise, then a full bundle adjustment on
unit-bearing residuals. The BA here is a damped Gauss-Newton over camera
poses + points with the same gauge fixing (pose_l fully, translation of the
newest frame) instead of Ceres.

All on host float64 — this runs once at initialization.
"""

from __future__ import annotations

import numpy as np

from .pnp import pnp_bearing_gn, _exp_so3, _skew, _tangent_basis
from .relative import _triangulate_ray

DEBUG = False


def _dbg(*a):
    if DEBUG:
        print("[sfm]", *a)


def _triangulate_two(pose_i, pose_j, b_i, b_j):
    Pi = np.hstack([pose_i[0], pose_i[1][:, None]])
    Pj = np.hstack([pose_j[0], pose_j[1][:, None]])
    return _triangulate_ray(Pi, Pj, b_i, b_j)


def global_sfm(n_frames, l, relative_R, relative_T, observations):
    """Reconstruct window poses + sparse points from bearing tracks.

    Args:
      n_frames: number of frames (reference frame_count+1 = 11).
      l: pivot frame index.
      relative_R, relative_T: pose of frame n-1 in frame l's coordinates
        (solveRelativeRT output convention).
      observations: dict feature_id -> list[(frame_idx, bearing3)].

    Returns (ok, q_wxyz [n, 4], T [n, 3], points: dict id -> xyz) in the
    *body/world* convention of the reference (camera-from-world inverted).
    """
    # Camera-from-world poses (R_cw, t_cw): X_cam = R_cw X_w + t_cw.
    R_cw = [None] * n_frames
    t_cw = [None] * n_frames
    # Pivot at identity; newest frame from the relative pose (world frame = l).
    R_cw[l] = np.eye(3)
    t_cw[l] = np.zeros(3)
    R_wl = np.asarray(relative_R, np.float64)  # rotation of newest in l
    t_wl = np.asarray(relative_T, np.float64)
    R_cw[n_frames - 1] = R_wl.T
    t_cw[n_frames - 1] = -R_wl.T @ t_wl

    obs_by_frame = {}  # frame -> {fid: bearing}
    for fid, obs in observations.items():
        for fr, b in obs:
            obs_by_frame.setdefault(fr, {})[fid] = np.asarray(b, np.float64)

    points = {}

    def triangulate_pair(i, j):
        if R_cw[i] is None or R_cw[j] is None:
            return
        oi = obs_by_frame.get(i, {})
        oj = obs_by_frame.get(j, {})
        for fid in oi.keys() & oj.keys():
            if fid in points:
                continue
            X = _triangulate_two((R_cw[i], t_cw[i]), (R_cw[j], t_cw[j]), oi[fid], oj[fid])
            if X is not None and np.isfinite(X).all():
                points[fid] = X

    def pnp_frame(i, R_init, t_init):
        oi = obs_by_frame.get(i, {})
        ids = [fid for fid in oi if fid in points]
        if len(ids) < 6:
            return False
        pw = np.stack([points[fid] for fid in ids])
        bb = np.stack([oi[fid] for fid in ids])
        R, t, ok = pnp_bearing_gn(pw, bb, R_init, t_init)
        if ok:
            R_cw[i], t_cw[i] = R, t
        return ok

    # 1/2: forward chain l..n-2 with PnP against accumulating structure.
    triangulate_pair(l, n_frames - 1)
    for i in range(l + 1, n_frames - 1):
        if not pnp_frame(i, R_cw[i - 1].copy(), t_cw[i - 1].copy()):
            _dbg("pnp fwd failed at frame", i, "points", len(points))
            return False, None, None, None
        triangulate_pair(i, n_frames - 1)
    # 3: triangulate l against middle frames.
    for i in range(l + 1, n_frames - 1):
        triangulate_pair(l, i)
    # 4: backward chain l-1..0.
    for i in range(l - 1, -1, -1):
        if not pnp_frame(i, R_cw[i + 1].copy(), t_cw[i + 1].copy()):
            _dbg("pnp bwd failed at frame", i)
            return False, None, None, None
        triangulate_pair(i, l)
    # 5: remaining points from first/last observation pair.
    for fid, obs in observations.items():
        if fid in points or len(obs) < 2:
            continue
        (f0, b0), (f1, b1) = obs[0], obs[-1]
        if R_cw[f0] is None or R_cw[f1] is None:
            continue
        X = _triangulate_two((R_cw[f0], t_cw[f0]), (R_cw[f1], t_cw[f1]),
                             np.asarray(b0), np.asarray(b1))
        if X is not None and np.isfinite(X).all():
            points[fid] = X

    ok, cost = _bundle_adjust(R_cw, t_cw, points, observations, l, n_frames)
    if not ok:
        _dbg("BA failed, cost", cost, "n_points", len(points))
        return False, None, None, None

    # Convert to world-from-camera (reference's q/T output).
    from ..geom import host as hg

    q_out = np.zeros((n_frames, 4))
    T_out = np.zeros((n_frames, 3))
    for i in range(n_frames):
        R_wc = R_cw[i].T
        q_out[i] = hg.mat_to_quat(R_wc)
        T_out[i] = -R_wc @ t_cw[i]
    return True, q_out, T_out, points


def _bundle_adjust(R_cw, t_cw, points, observations, l, n_frames, n_iters=24,
                   huber=3e-3):
    """Damped GN bundle adjustment on tangent-plane bearing residuals with
    the reference's gauge: pose l fixed, translation of frame n-1 fixed.

    Robustified beyond the reference's plain L2 (initial_sfm.cpp:263-268):
    Huber weighting at ~0.5 px equivalent plus hard pruning of gross
    outliers — KLT drift accumulates over the window and per-pair RANSAC
    cannot catch it, so the bootstrap must."""
    pids = sorted(points.keys())
    pid_idx = {fid: k for k, fid in enumerate(pids)}
    n_pts = len(pids)
    if n_pts < 10:
        return False, np.inf

    # Flatten observation list.
    rows = []  # (frame, point_k, bearing, tangent_basis)
    for fid, obs in observations.items():
        if fid not in pid_idx:
            continue
        k = pid_idx[fid]
        for fr, b in obs:
            b = np.asarray(b, np.float64)
            b = b / np.linalg.norm(b)
            rows.append((fr, k, b, _tangent_basis(b)))
    if len(rows) < 30:
        return False, np.inf

    Dc = 6 * n_frames
    lam = 1e-4
    X = np.stack([points[fid] for fid in pids])  # [P, 3]

    active = [True] * len(rows)

    def compute(Rs, ts, X):
        """residuals + full dense H (small problem: ~66+3P dims)."""
        D = Dc + 3 * n_pts
        H = np.zeros((D, D))
        g = np.zeros(D)
        cost = 0.0
        for ridx, (fr, k, b, tb) in enumerate(rows):
            if not active[ridx]:
                continue
            pc = Rs[fr] @ X[k] + ts[fr]
            nrm = max(np.linalg.norm(pc), 1e-12)
            u = pc / nrm
            r = tb @ (u - b)
            rn = np.linalg.norm(r)
            w = 1.0 if rn <= huber else huber / rn  # Huber IRLS weight
            cost += float(w * (r @ r))
            P = (np.eye(3) - np.outer(u, u)) / nrm
            Jp = tb @ P
            Jpose = np.zeros((2, 6))
            Jpose[:, 0:3] = -Jp @ _skew(pc)
            Jpose[:, 3:6] = Jp
            Jpt = Jp @ Rs[fr]
            ci = 6 * fr
            pi = Dc + 3 * k
            H[ci : ci + 6, ci : ci + 6] += w * (Jpose.T @ Jpose)
            H[pi : pi + 3, pi : pi + 3] += w * (Jpt.T @ Jpt)
            H[ci : ci + 6, pi : pi + 3] += w * (Jpose.T @ Jpt)
            H[pi : pi + 3, ci : ci + 6] += w * (Jpt.T @ Jpose)
            g[ci : ci + 6] += w * (Jpose.T @ r)
            g[pi : pi + 3] += w * (Jpt.T @ r)
        return H, g, cost

    def residual_of(Rs, ts, X, ridx):
        fr, k, b, tb = rows[ridx]
        pc = Rs[fr] @ X[k] + ts[fr]
        u = pc / max(np.linalg.norm(pc), 1e-12)
        return float(np.linalg.norm(tb @ (u - b)))

    Rs = [R.copy() for R in R_cw]
    ts = [t.copy() for t in t_cw]

    # Gauge-fixed dims: pose l (all 6) and translation of frame n-1.
    fixed = np.zeros(Dc + 3 * n_pts, bool)
    fixed[6 * l : 6 * l + 6] = True
    fixed[6 * (n_frames - 1) + 3 : 6 * (n_frames - 1) + 6] = True

    H, g, cost = compute(Rs, ts, X)
    for it in range(n_iters):
        Hd = H.copy()
        Hd[fixed, :] = 0.0
        Hd[:, fixed] = 0.0
        Hd[np.diag_indices_from(Hd)] += lam * np.maximum(np.diag(H), 1e-8)
        Hd[fixed, fixed] = 1.0
        gd = np.where(fixed, 0.0, g)
        try:
            step = np.linalg.solve(Hd, -gd)
        except np.linalg.LinAlgError:
            return False, cost
        Rs2 = [_exp_so3(step[6 * i : 6 * i + 3]) @ Rs[i] for i in range(n_frames)]
        ts2 = [ts[i] + step[6 * i + 3 : 6 * i + 6] for i in range(n_frames)]
        X2 = X + step[Dc:].reshape(-1, 3)
        H2, g2, cost2 = compute(Rs2, ts2, X2)
        if cost2 < cost:
            Rs, ts, X, H, g, cost = Rs2, ts2, X2, H2, g2, cost2
            lam = max(lam * 0.3, 1e-9)
        else:
            lam = min(lam * 10, 1e5)
        if it in (n_iters // 3, 2 * n_iters // 3):
            # Mid-run pruning: drop gross outliers (> ~3 px equivalent) and
            # re-linearize; they are tracking failures, not geometry.
            n_drop = 0
            for ridx in range(len(rows)):
                if active[ridx] and residual_of(Rs, ts, X, ridx) > 6.0 * huber:
                    active[ridx] = False
                    n_drop += 1
            if n_drop:
                _dbg("pruned", n_drop, "of", len(rows), "observations")
                H, g, cost = compute(Rs, ts, X)

    # Write back.
    for i in range(n_frames):
        R_cw[i], t_cw[i] = Rs[i], ts[i]
    for fid, k in pid_idx.items():
        points[fid] = X[k]
    # Convergence gate in the spirit of final_cost < 5e-3 (initial_sfm.cpp:292)
    n_active = max(sum(active), 1)
    mean_res = cost / n_active
    _dbg("BA mean residual^2 per obs:", mean_res, "active:", n_active, "/", len(rows))
    return mean_res < 1e-4 and n_active > 0.5 * len(rows), cost
