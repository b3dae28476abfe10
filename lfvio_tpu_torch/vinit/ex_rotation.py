"""Online camera-IMU extrinsic rotation calibration (host, f64).

Equivalent of InitialEXRotation::CalibrationExRotation
(vins_estimator/src/initial/initial_ex_rotation.cpp:13-67):
hand-eye style — accumulate quaternion constraint rows L(q_cam) - R(q_imu)
with Huber-like angular downweighting, solve by SVD, accept once the window
is full and the second-smallest singular value exceeds 0.25.

The per-pair camera rotation comes from the same spherical epipolar geometry
as elsewhere (the reference embeds its own 8-point + triangulation-ratio
disambiguation, initial_ex_rotation.cpp:221-287 — we reuse solve_relative_rt).
"""

from __future__ import annotations

import numpy as np

from .relative import solve_relative_rt


def _quat_left(q):
    w, v = q[0], q[1:]
    out = np.zeros((4, 4))
    out[0, 0] = w
    out[0, 1:] = -v
    out[1:, 0] = v
    out[1:, 1:] = w * np.eye(3) + _skew(v)
    return out


def _quat_right(p):
    w, v = p[0], p[1:]
    out = np.zeros((4, 4))
    out[0, 0] = w
    out[0, 1:] = -v
    out[1:, 0] = v
    out[1:, 1:] = w * np.eye(3) - _skew(v)
    return out


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _mat_to_quat(R):
    from ..geom import host as hg

    return hg.mat_to_quat(np.asarray(R, np.float64))


def _quat_to_mat(q):
    from ..geom import host as hg

    return hg.quat_to_mat(np.asarray(q, np.float64))


class ExtrinsicRotationCalibrator:
    WINDOW = 10  # pairs before an estimate is trusted (reference frame_count >= WINDOW_SIZE)

    def __init__(self):
        self.Rc = []  # camera relative rotations
        self.Rimu = []  # IMU preintegrated relative rotations
        self.ric = np.eye(3)  # running estimate

    def add_rotation_pair(self, R_cam, delta_q_imu_wxyz):
        """Feed one frame pair's relative rotations directly.

        Constraint (Hamilton, wxyz): q_cam ⊗ x = x ⊗ q_imu, i.e.
        (quat_left(q_cam) - quat_right(q_imu)) x = 0; the true camera
        relative rotation satisfies R_cam = ric⁻¹ R_imu ric, so the null
        vector x gives ric = R(x)⁻¹ (the reference's
        estimated_R.inverse(), initial_ex_rotation.cpp:56-60).
        Returns (calibrated, ric)."""
        self.Rc.append(np.asarray(R_cam, np.float64))
        R_imu = _quat_to_mat(np.asarray(delta_q_imu_wxyz, np.float64))
        self.Rimu.append(R_imu)

        n = len(self.Rc)
        A = np.zeros((n * 4, 4))
        for i in range(n):
            q_cam = _mat_to_quat(self.Rc[i])
            q_imu = _mat_to_quat(self.Rimu[i])
            # Huber weight from disagreement with the current estimate
            # (predicted camera rotation = ric^T R_imu ric).
            pred = self.ric.T @ self.Rimu[i] @ self.ric
            d = _mat_to_quat(pred.T @ self.Rc[i])
            ang = np.degrees(2 * np.arctan2(np.linalg.norm(d[1:]), abs(d[0])))
            huber = 1.0 if ang < 5.0 else 5.0 / max(ang, 1e-9)
            A[i * 4 : i * 4 + 4] = huber * (_quat_left(q_cam) - _quat_right(q_imu))
        _, S, Vt = np.linalg.svd(A)
        x = Vt[-1]  # wxyz null vector
        x = x / np.linalg.norm(x)
        x_inv = x * np.array([1.0, -1, -1, -1])
        self.ric = _quat_to_mat(x_inv)

        if n >= self.WINDOW and S[2] > 0.25:
            return True, self.ric.copy()
        return False, self.ric.copy()

    def add_pair(self, corres1, corres2, delta_q_imu_wxyz):
        """Feed bearing correspondences + IMU delta rotation; the camera
        relative rotation comes from the spherical 8-point solver."""
        R_cam, _, ok = solve_relative_rt(np.asarray(corres1), np.asarray(corres2))
        if not ok:
            R_cam = np.eye(3)
        return self.add_rotation_pair(R_cam, delta_q_imu_wxyz)
