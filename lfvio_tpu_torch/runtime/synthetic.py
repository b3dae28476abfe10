"""Synthetic VIO world: rendered camera frames + exact IMU + ground truth.

Port of ``lfvio_tpu.runtime.synthetic``: a procedurally textured
cylindrical room seen by any of the camera models along an analytic
trajectory, from the IMU's own pose or from a camera mounted on the rig
(``render_rig``: the down camera of a dual-PAL rig). The trajectory and IMU are closed-form numpy f64 (a sum of
sinusoids; body rates from the exact SO(3) right Jacobian); rendering is
inverse-mapped in torch on the world's device: pixel → camera ray (the
camera's lift) → world ray → nearest cylinder/floor/ceiling hit → texture.
The same seed gives the same world as the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cam import ScaramuzzaCamera
from ..device import resolve_device


def fit_inverse_poly(poly, max_rho=210.0, n_coeffs=20, n_samples=400):
    """Fit inv_poly(theta) -> rho for an OCAM forward polynomial (the
    reference calibration's inverse-poly refit)."""
    rhos = np.linspace(1.0, max_rho, n_samples)
    z = np.polyval(poly[::-1], rhos)
    theta = np.arctan2(z, rhos)  # z here = -P_z (the lift uses -z)
    ok = np.isfinite(theta)
    A = np.vander(theta[ok], n_coeffs, increasing=True)
    coef, *_ = np.linalg.lstsq(A, rhos[ok], rcond=None)
    return coef


# Annulus of the synthetic PAL rig (pixels): elevations from ~+40° (inner
# radius, z>0) through the equator to ~-40° (outer radius, z<0).
SYN_MIN_R = 64.0
SYN_MAX_R = 190.0

# The mindvision PAL rig's forward polynomial at 1280x960.
MINDVISION_POLY = np.array([-2.445239e2, 0.0, 1.748610e-3, -1.757770e-6, 4.475965e-9])


def scaramuzza_camera(poly, inv_poly, width, height, dtype=torch.float32,
                      device=None):
    """A centered Scaramuzza camera with unit affine part."""
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return ScaramuzzaCamera(
        poly=t(poly), inv_poly=t(inv_poly), C=t(1.0), D=t(0.0), E=t(0.0),
        cx=t(width / 2.0), cy=t(height / 2.0),
    )


def make_synthetic_pal_camera(width=512, height=384, dtype=torch.float32,
                              device=None):
    """A small PAL camera: the mindvision polynomial radially rescaled by
    0.4 to this image size, with a fitted inverse polynomial."""
    poly = MINDVISION_POLY / 0.4 ** np.arange(5)
    return scaramuzza_camera(poly, fit_inverse_poly(poly), width, height, dtype, device)


# ------------------------------------------------------------ SO(3) (numpy)
def _np_so3_exp(th):
    """Rotation-vector exponential → quaternion (wxyz), batched [..., 3]."""
    th = np.asarray(th, np.float64)
    a = np.linalg.norm(th, axis=-1, keepdims=True)
    small = a < 1e-12
    k = np.where(small, 0.5, np.sin(0.5 * a) / np.where(small, 1.0, a))
    return np.concatenate([np.cos(0.5 * a), k * th], axis=-1)


def _np_quat_to_mat(q):
    """Quaternion (wxyz) → rotation matrix, batched [..., 4] → [..., 3, 3]."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _np_so3_right_jac(th):
    """Right Jacobian of SO(3): ω_body = Jr(θ)·θ̇ for q(t) = Exp(θ(t))."""
    th = np.asarray(th, np.float64)
    a = np.linalg.norm(th, axis=-1)
    shape = th.shape[:-1]
    W = np.zeros(shape + (3, 3))
    W[..., 0, 1] = -th[..., 2]
    W[..., 0, 2] = th[..., 1]
    W[..., 1, 0] = th[..., 2]
    W[..., 1, 2] = -th[..., 0]
    W[..., 2, 0] = -th[..., 1]
    W[..., 2, 1] = th[..., 0]
    a2 = a * a
    small = a < 1e-6
    safe = np.where(small, 1.0, a)
    c1 = np.where(small, 0.5 - a2 / 24.0, (1 - np.cos(a)) / (safe * safe))
    c2 = np.where(small, 1.0 / 6.0 - a2 / 120.0, (safe - np.sin(safe)) / safe**3)
    eye = np.broadcast_to(np.eye(3), shape + (3, 3))
    return eye - c1[..., None, None] * W + c2[..., None, None] * (W @ W)


@dataclasses.dataclass
class SyntheticWorld:
    camera: object  # any model of ..cam
    width: int = 512
    height: int = 384
    room_radius: float = 6.0
    room_half_height: float = 3.0
    g_norm: float = 9.81
    seed: int = 0
    traj_amp: float = 0.8
    traj_freq: float = 0.25
    dtype: torch.dtype = torch.float32  # rendering precision
    device: torch.device | str | None = None  # None: the CUDA card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        n_waves = 24
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)
        self.camera = self.camera.to(device=self.device, dtype=self.dtype)
        self._freqs = t(rng.uniform(0.8, 6.0, (n_waves, 3)))
        self._phases = t(rng.uniform(0, 2 * np.pi, n_waves))
        self._amps = t(rng.uniform(0.5, 1.0, n_waves) / np.arange(1, n_waves + 1) ** 0.25)
        yy, xx = torch.meshgrid(
            torch.arange(self.height, dtype=self.dtype, device=self.device),
            torch.arange(self.width, dtype=self.dtype, device=self.device),
            indexing="ij",
        )
        rays = self.camera.lift_projective(torch.stack([xx, yy], dim=-1).reshape(-1, 2))
        self._rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
        w = self.traj_freq * 2 * np.pi
        A = self.traj_amp
        # p(t) = P_AMP sin(P_W t + P_PH), θ(t) = T_AMP sin(T_W t + T_PH).
        self._P_AMP = np.array([A, 0.8 * A, 0.3])
        self._P_W = np.array([w, 0.7 * w, 1.3 * w])
        self._P_PH = np.array([0.0, 0.5, 0.0])
        self._T_AMP = np.array([0.12, 0.12, 0.8])
        self._T_W = np.array([0.9 * w, 0.6 * w, 0.33 * w])
        self._T_PH = np.array([0.0, 1.0, 0.0])

    # ------------------------------------------------------------- trajectory
    def _p_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return self._P_AMP * np.sin(self._P_W * t + self._P_PH)

    def _v_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return self._P_AMP * self._P_W * np.cos(self._P_W * t + self._P_PH)

    def _a_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return -self._P_AMP * self._P_W**2 * np.sin(self._P_W * t + self._P_PH)

    def _theta_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return self._T_AMP * np.sin(self._T_W * t + self._T_PH)

    def _thetadot_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return self._T_AMP * self._T_W * np.cos(self._T_W * t + self._T_PH)

    def pose(self, t):
        """Ground truth: position, orientation quaternion (wxyz)."""
        return self._p_of_t(t), _np_so3_exp(self._theta_of_t(t))

    def pose_batch(self, ts):
        """Ground truth for many timestamps at once."""
        return self.pose(np.asarray(ts, np.float64))

    def velocity(self, t):
        return self._v_of_t(t)

    def imu_sample(self, t):
        acc, om = self.imu_batch(np.asarray([t]))
        return acc[0], om[0]

    def imu_batch(self, ts):
        """Exact accelerometer and gyroscope at timestamps ts:
        a_body = Rᵀ(a_w + g), ω_body = Jr(θ)·θ̇."""
        ts = np.asarray(ts, np.float64)
        th = self._theta_of_t(ts)
        R = _np_quat_to_mat(_np_so3_exp(th))
        a_w = self._a_of_t(ts) + np.array([0.0, 0.0, self.g_norm])
        acc_body = np.einsum("...ji,...j->...i", R, a_w)
        om = np.einsum("...ij,...j->...i", _np_so3_right_jac(th), self._thetadot_of_t(ts))
        return acc_body, om

    # --------------------------------------------------------------- render
    def _texture(self, X):
        vals = torch.sin(X @ self._freqs.T + self._phases) @ self._amps
        return 128.0 + 100.0 * torch.tanh(0.3 * vals)

    def render_from(self, R_wc, t_wc):
        """[H, W] image (values in [0, 255]) from camera pose (R_wc, t_wc)."""
        tt = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)
        d = self._rays @ tt(R_wc).T  # world directions
        o = tt(t_wc)
        Rc = self.room_radius
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = 2 * (o[0] * d[:, 0] + o[1] * d[:, 1])
        c = o[0] ** 2 + o[1] ** 2 - Rc * Rc
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        s_cyl = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-12)
        s_cyl = torch.where((a > 1e-12) & (s_cyl > 0), s_cyl, 1e9)
        h = self.room_half_height
        s_top = torch.where(d[:, 2] > 1e-9, (h - o[2]) / d[:, 2], 1e9)
        s_bot = torch.where(d[:, 2] < -1e-9, (-h - o[2]) / d[:, 2], 1e9)
        s = torch.minimum(torch.minimum(s_cyl, s_top), s_bot)
        img = self._texture(o[None, :] + s[:, None] * d).reshape(self.height, self.width)
        return torch.clamp(img, 0.0, 255.0)

    def render(self, t):
        """Frame at time t as a float tensor on the world's device."""
        p, q = self.pose(t)
        return self.render_from(_np_quat_to_mat(q), p)

    def render_rig(self, t, ric, tic):
        """Frame from a camera mounted at (ric, tic) in the IMU frame, e.g.
        the down camera of a dual-PAL rig (ric = diag(1, -1, -1))."""
        p, q = self.pose(t)
        R_wi = _np_quat_to_mat(q)
        return self.render_from(R_wi @ np.asarray(ric, np.float64),
                                p + R_wi @ np.asarray(tic, np.float64))

    def render_u8(self, t):
        """Frame at time t rounded to uint8 (as a camera delivers it)."""
        return (self.render(t) + 0.5).to(torch.uint8)

    # ----------------------------------------------------------- full dataset
    def generate(self, duration, frame_rate=15.0, imu_rate=200.0):
        """Measurement stream of ('imu', t, acc, gyr) and ('frame', t, None)
        tuples in time order."""
        n_imu = int(duration * imu_rate) + 1
        ts = np.arange(n_imu) / imu_rate
        acc, om = self.imu_batch(ts)
        stream = [("imu", float(ts[k]), acc[k], om[k]) for k in range(n_imu)]
        for k in range(int(duration * frame_rate)):
            stream.append(("frame", k / frame_rate + 1e-4, None))
        stream.sort(key=lambda e: e[1])
        return stream
