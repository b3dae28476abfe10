"""The benchmark's synthetic world: a textured cylindrical room seen by a
PAL (Scaramuzza) camera moving along an analytic, periodic trajectory, with
its exact 200 Hz IMU.

A frozen plain copy of the port's ``runtime/synthetic.py`` world, IMU and
renderer and of the Scaramuzza lift it renders through, so that the
yardstick does not move when the port changes. Two changes from the copy:

  * every trajectory frequency is a whole number of cycles per period P
    (the traffic file's ``period_s``), so poses, IMU samples and frames at
    t and t + P agree and a replay can reuse one period's frames;
  * an optional settling envelope (the traffic file's ``settle``) scales
    the motion from 1 down to ``scale`` with a C2 smoothstep, so a stream
    can start with enough motion to initialize and then hover. The IMU is
    the exact derivative of the enveloped trajectory.

The texture's 24 waves are drawn from the run's seed; the trajectory is the
traffic file's, the same for every seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def polyval_ascending(coeffs, x):
    """Horner evaluation of sum_i coeffs[i] * x**i."""
    acc = torch.zeros_like(x) + coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def fit_inverse_poly(poly, max_rho, n_coeffs=20, n_samples=400):
    """inv_poly(theta) -> rho for an OCAM forward polynomial (rho -> z)."""
    rhos = np.linspace(1.0, max_rho, n_samples)
    theta = np.arctan2(np.polyval(np.asarray(poly)[::-1], rhos), rhos)
    ok = np.isfinite(theta)
    coef, *_ = np.linalg.lstsq(np.vander(theta[ok], n_coeffs, increasing=True), rhos[ok],
                               rcond=None)
    return coef


def lift_unit(poly, cx, cy, pts):
    """Pixels [..., 2] -> unit bearings [..., 3] of a centred Scaramuzza camera
    with unit affine part: (x - cx, y - cy, -poly(rho)), normalized."""
    xa, ya = pts[..., 0] - cx, pts[..., 1] - cy
    z = polyval_ascending(poly, torch.sqrt(xa * xa + ya * ya))
    ray = torch.stack([xa, ya, -z], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


# ------------------------------------------------------------ SO(3) (numpy)
def so3_exp(th):
    th = np.asarray(th, np.float64)
    a = np.linalg.norm(th, axis=-1, keepdims=True)
    small = a < 1e-12
    k = np.where(small, 0.5, np.sin(0.5 * a) / np.where(small, 1.0, a))
    return np.concatenate([np.cos(0.5 * a), k * th], axis=-1)


def quat_to_mat(q):
    w, x, y, z = (q[..., i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def so3_right_jac(th):
    """ω_body = Jr(θ)·θ̇ for q(t) = Exp(θ(t))."""
    a = np.linalg.norm(th, axis=-1)
    W = np.zeros(th.shape[:-1] + (3, 3))
    W[..., 0, 1], W[..., 0, 2] = -th[..., 2], th[..., 1]
    W[..., 1, 0], W[..., 1, 2] = th[..., 2], -th[..., 0]
    W[..., 2, 0], W[..., 2, 1] = -th[..., 1], th[..., 0]
    small = a < 1e-6
    safe = np.where(small, 1.0, a)
    c1 = np.where(small, 0.5 - a * a / 24.0, (1 - np.cos(a)) / (safe * safe))
    c2 = np.where(small, 1.0 / 6.0 - a * a / 120.0, (safe - np.sin(safe)) / safe**3)
    return np.eye(3) - c1[..., None, None] * W + c2[..., None, None] * (W @ W)


def smoothstep(u):
    """C2 smoothstep and its first two derivatives in u (clipped to [0, 1])."""
    u = np.clip(u, 0.0, 1.0)
    inside = (u > 0.0) & (u < 1.0)
    s = u**3 * (10 - 15 * u + 6 * u * u)
    ds = np.where(inside, 30 * u * u * (1 - u) ** 2, 0.0)
    dds = np.where(inside, 60 * u * (1 - u) * (1 - 2 * u), 0.0)
    return s, ds, dds


class Trajectory:
    """p(t) = e_p(t) A sin(2π n t / P + φ), θ(t) = e_r(t) T sin(2π m t / P + ψ),
    with the settling envelopes e_p, e_r (1 without ``settle``)."""

    def __init__(self, traffic: dict):
        P = float(traffic["period_s"])
        self.period = P
        self.P_AMP = np.asarray(traffic["pos_amp_m"], np.float64)
        self.P_W = 2 * np.pi * np.asarray(traffic["pos_cycles"], np.float64) / P
        self.P_PH = np.asarray(traffic["pos_phase"], np.float64)
        self.T_AMP = np.asarray(traffic["rot_amp_rad"], np.float64)
        self.T_W = 2 * np.pi * np.asarray(traffic["rot_cycles"], np.float64) / P
        self.T_PH = np.asarray(traffic["rot_phase"], np.float64)
        settle = traffic.get("settle")
        self.settle = None if settle is None else (
            float(settle["start_s"]), float(settle["ramp_s"]), float(settle["pos_scale"]),
            float(settle["rot_scale"]))

    @property
    def steady_from(self) -> float:
        """The time from which the motion is periodic with ``period``."""
        return 0.0 if self.settle is None else self.settle[0] + self.settle[1]

    def _env(self, t, which):
        """Envelope e(t) and its first two time derivatives."""
        if self.settle is None:
            return np.ones_like(t), np.zeros_like(t), np.zeros_like(t)
        t0, T, sp, sr = self.settle
        scale = sp if which == "p" else sr
        s, ds, dds = smoothstep((t - t0) / T)
        return 1.0 - (1.0 - scale) * s, -(1.0 - scale) * ds / T, -(1.0 - scale) * dds / (T * T)

    def _wave(self, t, amp, w, ph, which, order):
        """order-th time derivative of e(t) amp sin(w t + ph), t [...] -> [..., 3]."""
        t = np.asarray(t, np.float64)[..., None]
        e, de, dde = (x[..., None] for x in self._env(t[..., 0], which))
        s, c = np.sin(w * t + ph), np.cos(w * t + ph)
        if order == 0:
            return e * amp * s
        if order == 1:
            return de * amp * s + e * amp * w * c
        return dde * amp * s + 2 * de * amp * w * c - e * amp * w * w * s

    def pose(self, t):
        """Position [..., 3] and orientation quaternion [..., 4] (wxyz)."""
        p = self._wave(t, self.P_AMP, self.P_W, self.P_PH, "p", 0)
        return p, so3_exp(self._wave(t, self.T_AMP, self.T_W, self.T_PH, "r", 0))

    def imu(self, t, g_norm):
        """Exact accelerometer and gyroscope: a_b = Rᵀ(a_w + g), ω_b = Jr(θ) θ̇."""
        th = self._wave(t, self.T_AMP, self.T_W, self.T_PH, "r", 0)
        R = quat_to_mat(so3_exp(th))
        a_w = self._wave(t, self.P_AMP, self.P_W, self.P_PH, "p", 2) + np.array([0, 0, g_norm])
        acc = np.einsum("...ji,...j->...i", R, a_w)
        om = np.einsum("...ij,...j->...i", so3_right_jac(th),
                       self._wave(t, self.T_AMP, self.T_W, self.T_PH, "r", 1))
        return acc, om


class World:
    """The room, its texture (from ``seed``) and the camera's rays on ``device``."""

    ROOM_RADIUS = 6.0
    ROOM_HALF_HEIGHT = 3.0
    N_WAVES = 24

    def __init__(self, cfg: dict, traj: Trajectory, seed: int, device):
        cam = cfg["camera"]
        self.width, self.height = int(cam["width"]), int(cam["height"])
        self.cx, self.cy = self.width / 2.0, self.height / 2.0
        self.poly = [float(c) for c in cam["poly"]]
        self.traj = traj
        self.device = torch.device(device)
        dt = torch.float32
        rng = np.random.default_rng(seed % 2**63)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=self.device)
        self._freqs = t(rng.uniform(0.8, 6.0, (self.N_WAVES, 3)))
        self._phases = t(rng.uniform(0, 2 * np.pi, self.N_WAVES))
        self._amps = t(rng.uniform(0.5, 1.0, self.N_WAVES)
                       / np.arange(1, self.N_WAVES + 1) ** 0.25)
        yy, xx = torch.meshgrid(torch.arange(self.height, dtype=dt, device=self.device),
                                torch.arange(self.width, dtype=dt, device=self.device),
                                indexing="ij")
        pix = torch.stack([xx, yy], dim=-1).reshape(-1, 2)
        self._rays = lift_unit(self.poly, self.cx, self.cy, pix)  # [H*W, 3]

    def render_u8(self, ts, chunk=8):
        """uint8 frames [len(ts), H, W] at times ``ts``, rendered on the device
        ``chunk`` frames a call."""
        out = torch.empty((len(ts), self.height, self.width), dtype=torch.uint8,
                          device=self.device)
        for s in range(0, len(ts), chunk):
            p, q = self.traj.pose(np.asarray(ts[s:s + chunk], np.float64))
            R = torch.as_tensor(quat_to_mat(q), dtype=torch.float32, device=self.device)
            o = torch.as_tensor(p, dtype=torch.float32, device=self.device)
            img = self._render(R, o).reshape(-1, self.height, self.width)
            out[s:s + len(p)] = (img + 0.5).to(torch.uint8)
        return out

    def _render(self, R, o):
        """[B, H*W] intensities in [0, 255] from camera poses (R [B,3,3], o [B,3])."""
        d = torch.einsum("nk,bjk->bnj", self._rays, R)  # world directions
        o = o[:, None, :]
        Rc, h = self.ROOM_RADIUS, self.ROOM_HALF_HEIGHT
        a = d[..., 0] ** 2 + d[..., 1] ** 2
        b = 2 * (o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1])
        c = o[..., 0] ** 2 + o[..., 1] ** 2 - Rc * Rc
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        s_cyl = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-12)
        s_cyl = torch.where((a > 1e-12) & (s_cyl > 0), s_cyl, 1e9)
        s_top = torch.where(d[..., 2] > 1e-9, (h - o[..., 2]) / d[..., 2], 1e9)
        s_bot = torch.where(d[..., 2] < -1e-9, (-h - o[..., 2]) / d[..., 2], 1e9)
        s = torch.minimum(torch.minimum(s_cyl, s_top), s_bot)
        X = o + s[..., None] * d
        vals = torch.sin(X @ self._freqs.T + self._phases) @ self._amps
        return torch.clamp(128.0 + 100.0 * torch.tanh(0.3 * vals), 0.0, 255.0)


def period_frames(traj: Trajectory, frame_rate: float):
    """(frame times before the periodic part, frames a period) for frames at
    k / frame_rate + 1e-4: the stream's frame k shows image k while
    k < len(pre), else image len(pre) + (k - len(pre)) mod n."""
    n = traj.period * frame_rate
    if abs(n - round(n)) > 1e-9:
        raise ValueError(f"a period of {traj.period} s holds no whole number of frames at "
                         f"{frame_rate} Hz")
    k0 = math.ceil((traj.steady_from - 1e-4) * frame_rate - 1e-9)
    return [k / frame_rate + 1e-4 for k in range(max(k0, 0))], int(round(n))
