"""Relative pose from bearing correspondences (host, f64).

Equivalent of MotionEstimator::solveRelativeRT
(vins_estimator/src/initial/solve_5pts.cpp:536-575): spherical
8-point RANSAC (shared semantics with the tracker's rejectWithF) followed by
essential-matrix decomposition with ray-dot cheirality voting, valid for
bearings on the full sphere.

Note: the reference's recoverPose returns its outputs by value, so the R/T it
reports are uninitialized garbage (latent bug, solve_5pts.cpp:566-569) — it
only "works" because GlobalSFM re-estimates geometry. We return the real
decomposition (SURVEY.md hard part #5: do not reproduce the bug).
"""

from __future__ import annotations

import numpy as np

COS_THR = 0.00872653549837  # sin(0.5 deg)


def _solve_E(b1, b2, w=None):
    A = (b2[:, :, None] * b1[:, None, :]).reshape(-1, 9)
    if w is not None:
        A = A * w[:, None]
    _, _, Vt = np.linalg.svd(A, full_matrices=True)
    E = Vt[-1].reshape(3, 3)
    U, S, Vt2 = np.linalg.svd(E)
    return U @ np.diag([S[0], S[1], 0.0]) @ Vt2


def _sym_residuals(E, b1, b2):
    Eb1 = b1 @ E.T
    Etb2 = b2 @ E
    r2 = np.abs(np.sum(Eb1 * b2, -1)) / np.maximum(np.linalg.norm(Eb1, axis=-1), 1e-12)
    r1 = np.abs(np.sum(Etb2 * b1, -1)) / np.maximum(np.linalg.norm(Etb2, axis=-1), 1e-12)
    return r1, r2


def _ransac_E(b1, b2, n_iter=100, rng=None):
    rng = rng or np.random.default_rng(0)
    N = len(b1)
    best_score, best_E, best_inl = -1.0, None, None
    for _ in range(n_iter):
        idx = rng.choice(N, 8, replace=False)
        E = _solve_E(b1[idx], b2[idx])
        r1, r2 = _sym_residuals(E, b1, b2)
        inl = (r1 <= COS_THR) & (r2 <= COS_THR)
        score = np.sum(np.where(r2 <= COS_THR, (COS_THR - r2) ** 2, 0.0)) + np.sum(
            np.where(inl, (COS_THR - r1) ** 2, 0.0)
        )
        if score > best_score:
            best_score, best_E, best_inl = score, E, inl
    if best_inl is not None and best_inl.sum() >= 8:
        E = _solve_E(b1[best_inl], b2[best_inl])
        r1, r2 = _sym_residuals(E, b1, b2)
        best_inl = (r1 <= COS_THR) & (r2 <= COS_THR)
        best_E = E
    return best_E, best_inl


def _triangulate_ray(P1, P2, b1, b2):
    """Midpoint-free DLT triangulation on bearings: rows b×(P X) = 0."""
    A = np.zeros((4, 4))
    A[0] = b1[0] * P1[2] - b1[2] * P1[0]
    A[1] = b1[1] * P1[2] - b1[2] * P1[1]
    A[2] = b2[0] * P2[2] - b2[2] * P2[0]
    A[3] = b2[1] * P2[2] - b2[2] * P2[1]
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    if abs(X[3]) < 1e-12:
        return None
    return X[:3] / X[3]


def solve_relative_rt(corr1, corr2, rng=None):
    """Relative pose of frame2 w.r.t. frame1 from ≥15 bearing pairs.

    Returns (R, t, ok) with the reference's output convention
    (solve_5pts.cpp:556-565): R = R12 (rotates frame-2 vectors into frame 1),
    t = translation of frame 1 in frame 2's... specifically the reference
    returns Rotation = R.T and Translation = -R.T t of the cam1->cam2
    transform [R|t], which estimator.relativePose feeds to GlobalSFM as the
    pose of the newest frame in the pivot frame.
    """
    b1 = np.asarray(corr1, np.float64)
    b2 = np.asarray(corr2, np.float64)
    b1 = b1 / np.linalg.norm(b1, axis=-1, keepdims=True)
    b2 = b2 / np.linalg.norm(b2, axis=-1, keepdims=True)
    if len(b1) < 15:
        return np.eye(3), np.zeros(3), False

    E, inl = _ransac_E(b1, b2, rng=rng)
    if E is None or inl.sum() < 12:
        return np.eye(3), np.zeros(3), False

    # Decompose E = [t]x R into 4 candidates; pick by cheirality votes using
    # ray-dot depth (valid for negative-plane bearings, solve_5pts.cpp:395-535).
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tt = U[:, 2]
    candidates = [(R1, tt), (R1, -tt), (R2, tt), (R2, -tt)]

    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    b1i, b2i = b1[inl], b2[inl]
    best_votes, best = -1, None
    for R, t in candidates:
        P2 = np.hstack([R, t[:, None]])
        votes = 0
        for k in range(min(len(b1i), 40)):
            X = _triangulate_ray(P1, P2, b1i[k], b2i[k])
            if X is None:
                continue
            d1 = X @ b1i[k]  # ray depth in frame 1
            X2 = R @ X + t
            d2 = X2 @ b2i[k]
            if d1 > 0 and d2 > 0:
                votes += 1
        if votes > best_votes:
            best_votes, best = votes, (R, t)

    R, t = best
    if best_votes < 9:  # reference requires >0.7 * 12.5 ≈ 9 good points
        return np.eye(3), np.zeros(3), False
    # Output convention per solve_5pts.cpp:556-565.
    return R.T, -R.T @ t, True
