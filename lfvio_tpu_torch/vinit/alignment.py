"""Visual-inertial alignment: gyro bias, velocities, gravity, scale (host, f64).

Direct functional equivalents of the reference's linear systems
(vins_estimator/src/initial/initial_aligment.cpp):
  * solveGyroscopeBias (:3-36) — LS on preintegration vs SfM rotation.
  * LinearAlignment (:121-206) — per-frame velocities + g + scale (state
    3n+3+1, scale conditioned by /100), gravity-norm gate.
  * RefineGravity (:53-119) — re-solve with g on the 2-DoF tangent of
    ||g|| = G, 4 iterations.

Frames are the `all_image_frame` sequence: every camera frame since start
(keyframes and non-keyframes), each with its SfM pose (R world<-imu, T in
the visual frame) and the preintegration from its predecessor.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AlignFrame:
    """Host mirror of ImageFrame (initial_alignment.h): SfM pose + preint."""

    R: np.ndarray  # [3,3] world<-imu rotation from SfM (visual frame)
    T: np.ndarray  # [3] position in the (unscaled) visual frame
    # Preintegration from previous frame (None for the first):
    sum_dt: float = 0.0
    delta_p: np.ndarray | None = None
    delta_q: np.ndarray | None = None  # wxyz
    delta_v: np.ndarray | None = None
    jac_q_bg: np.ndarray | None = None  # d(delta_q)/d(bg) 3x3
    is_key_frame: bool = False


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _mat_to_quat(R):
    from ..geom import host as hg

    return hg.mat_to_quat(np.asarray(R, np.float64))


def _quat_mul(q, p):
    qw, qv = q[0], q[1:]
    pw, pv = p[0], p[1:]
    return np.concatenate([
        [qw * pw - qv @ pv], qw * pv + pw * qv + np.cross(qv, pv)
    ])


def _quat_conj(q):
    return q * np.array([1.0, -1, -1, -1])


def solve_gyroscope_bias(frames: list[AlignFrame], n_irls: int = 3):
    """LS gyro bias from SfM relative rotations (initial_aligment.cpp:3-36),
    robustified with Huber IRLS — SfM rotations from real tracking contain
    occasional gross errors that a plain LS would absorb into the bias.
    Returns delta_bg [3]."""
    rows_A, rows_b = [], []
    for fi, fj in zip(frames[:-1], frames[1:]):
        q_ij = _mat_to_quat(fi.R.T @ fj.R)
        rows_A.append(fj.jac_q_bg)
        rows_b.append(2.0 * _quat_mul(_quat_conj(fj.delta_q), q_ij)[1:])
    rows_A = np.asarray(rows_A)
    rows_b = np.asarray(rows_b)
    dbg = np.zeros(3)
    huber = 0.02  # ~1.1 deg rotation disagreement
    for _ in range(n_irls):
        r = rows_b - rows_A @ dbg
        rn = np.linalg.norm(r, axis=-1)
        w = np.where(rn <= huber, 1.0, huber / np.maximum(rn, 1e-12))
        A = np.einsum("n,nij,nik->jk", w, rows_A, rows_A)
        b = np.einsum("n,nij,ni->j", w, rows_A, rows_b)
        dbg = np.linalg.solve(A + 1e-12 * np.eye(3), b)
    return dbg


def _tangent_basis(g0):
    a = g0 / np.linalg.norm(g0)
    tmp = np.array([0.0, 0.0, 1.0])
    if abs(a @ tmp) > 0.9999:
        tmp = np.array([1.0, 0.0, 0.0])
    b = tmp - a * (a @ tmp)
    b /= np.linalg.norm(b)
    c = np.cross(a, b)
    return np.stack([b, c], axis=1)  # [3, 2]


def linear_alignment(frames: list[AlignFrame], tic: np.ndarray, g_norm: float):
    """Solve [v_0..v_{n-1}, g, s] (initial_aligment.cpp:121-206).

    Returns (ok, g [3], x [3n+3+1]) with the scale already divided by 100 at
    x[-1] after refinement (matching the reference's in-place fixup)."""
    n = len(frames)
    n_state = n * 3 + 3 + 1
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)

    for i, (fi, fj) in enumerate(zip(frames[:-1], frames[1:])):
        dt = fj.sum_dt
        tmp_A = np.zeros((6, 10))
        tmp_b = np.zeros(6)
        tmp_A[0:3, 0:3] = -dt * np.eye(3)
        tmp_A[0:3, 6:9] = fi.R.T @ (0.5 * dt * dt * np.eye(3))
        tmp_A[0:3, 9] = (fi.R.T @ (fj.T - fi.T)) / 100.0
        tmp_b[0:3] = fj.delta_p + fi.R.T @ fj.R @ tic - tic
        tmp_A[3:6, 0:3] = -np.eye(3)
        tmp_A[3:6, 3:6] = fi.R.T @ fj.R
        tmp_A[3:6, 6:9] = fi.R.T @ (dt * np.eye(3))
        tmp_b[3:6] = fj.delta_v

        r_A = tmp_A.T @ tmp_A
        r_b = tmp_A.T @ tmp_b
        A[i * 3 : i * 3 + 6, i * 3 : i * 3 + 6] += r_A[:6, :6]
        b[i * 3 : i * 3 + 6] += r_b[:6]
        A[-4:, -4:] += r_A[-4:, -4:]
        b[-4:] += r_b[-4:]
        A[i * 3 : i * 3 + 6, -4:] += r_A[:6, -4:]
        A[-4:, i * 3 : i * 3 + 6] += r_A[-4:, :6]

    A *= 1000.0
    b *= 1000.0
    x = np.linalg.solve(A, b)
    s = x[-1] / 100.0
    g = x[n_state - 4 : n_state - 1].copy()
    if abs(np.linalg.norm(g) - g_norm) > 1.0 or s < 0:
        return False, g, x

    g = refine_gravity(frames, tic, g, g_norm, x)
    s = x[-1] / 100.0
    x[-1] = s
    if s < 0.0:
        return False, g, x
    return True, g, x


def refine_gravity(frames, tic, g, g_norm, x_out):
    """2-DoF gravity refinement (initial_aligment.cpp:53-119). Mutates x_out
    to the refined state [v..., dg(2), s] layout's solution values."""
    n = len(frames)
    g0 = g / np.linalg.norm(g) * g_norm
    n_state = n * 3 + 2 + 1
    for _ in range(4):
        lxly = _tangent_basis(g0)  # [3, 2]
        A = np.zeros((n_state, n_state))
        b = np.zeros(n_state)
        for i, (fi, fj) in enumerate(zip(frames[:-1], frames[1:])):
            dt = fj.sum_dt
            tmp_A = np.zeros((6, 9))
            tmp_b = np.zeros(6)
            tmp_A[0:3, 0:3] = -dt * np.eye(3)
            tmp_A[0:3, 6:8] = fi.R.T @ (0.5 * dt * dt * np.eye(3)) @ lxly
            tmp_A[0:3, 8] = (fi.R.T @ (fj.T - fi.T)) / 100.0
            tmp_b[0:3] = (
                fj.delta_p + fi.R.T @ fj.R @ tic - tic - fi.R.T @ (0.5 * dt * dt * g0)
            )
            tmp_A[3:6, 0:3] = -np.eye(3)
            tmp_A[3:6, 3:6] = fi.R.T @ fj.R
            tmp_A[3:6, 6:8] = fi.R.T @ (dt * np.eye(3)) @ lxly
            tmp_b[3:6] = fj.delta_v - fi.R.T @ (dt * g0)

            r_A = tmp_A.T @ tmp_A
            r_b = tmp_A.T @ tmp_b
            A[i * 3 : i * 3 + 6, i * 3 : i * 3 + 6] += r_A[:6, :6]
            b[i * 3 : i * 3 + 6] += r_b[:6]
            A[-3:, -3:] += r_A[-3:, -3:]
            b[-3:] += r_b[-3:]
            A[i * 3 : i * 3 + 6, -3:] += r_A[:6, -3:]
            A[-3:, i * 3 : i * 3 + 6] += r_A[-3:, :6]
        A *= 1000.0
        b *= 1000.0
        x = np.linalg.solve(A, b)
        dg = x[n_state - 3 : n_state - 1]
        g0 = (g0 + lxly @ dg)
        g0 = g0 / np.linalg.norm(g0) * g_norm
    # Copy refined velocities and scale into the caller's x (reference reuses x).
    x_out[: n * 3] = x[: n * 3]
    x_out[-1] = x[-1]
    return g0


def visual_imu_alignment(frames, tic, g_norm, repropagate_fn):
    """VisualIMUAlignment (initial_aligment.cpp:208-216): solve gyro bias,
    re-preintegrate all intervals with it (the reference's repropagate), then
    run the linear alignment on the corrected deltas.

    repropagate_fn(frames, delta_bg) must update each frame's
    delta_p/delta_q/delta_v/sum_dt in place for the new gyro bias.
    Returns (ok, delta_bg, g, x)."""
    delta_bg = solve_gyroscope_bias(frames)
    repropagate_fn(frames, delta_bg)
    ok, g, x = linear_alignment(frames, tic, g_norm)
    return ok, delta_bg, g, x
