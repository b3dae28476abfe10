"""Camera models on torch tensors: batched lift / project.

Port of ``lfvio_tpu.cam.models``, the reference camodocal fork's four model
families (camodocal/camera_models/Camera.h:16-22):

  * ``ScaramuzzaCamera`` (OCAM) — the PAL model with the negative half-plane
    sign convention ("changed by wz"): the lift returns (x, y, -poly(rho)) so
    bearings span the full sphere (ScaramuzzaCamera.cc:622-674).
  * ``PinholeCamera`` — radial-tangential distortion, undistorted by
    fixed-point iteration (PinholeCamera.cc:450-530).
  * ``KannalaBrandtCamera`` — equidistant fisheye with an odd polynomial in
    theta, Newton-inverted on lift (EquidistantCamera.cc).
  * ``MeiCamera`` — unified catadioptric (xi) + rad-tan (CataCamera.cc).

Every model is a dataclass of parameter tensors whose ``lift_projective`` /
``space_to_plane`` take arbitrary batches of points. The iteration counts of
the inverse distortions (24, 10, 24) are fixed: they are part of the result.
"""

from __future__ import annotations

import dataclasses
import re

import torch


def _polyval_ascending(coeffs, x):
    """Horner evaluation of sum_i coeffs[i] * x**i (coeffs is 1-D)."""
    acc = torch.zeros_like(x) + coeffs[-1]
    for i in range(coeffs.shape[0] - 2, -1, -1):
        acc = acc * x + coeffs[i]
    return acc


class _Camera:
    """Shared by the models: device / dtype moves and the unit-sphere lift."""

    def to(self, device=None, dtype=None):
        return type(self)(**{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)
        })

    def lift_sphere(self, p):
        ray = self.lift_projective(p)
        return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def _radtan(m, x, y):
    """Radial-tangential distortion offsets (k1, k2, p1, p2 of ``m``)."""
    r2 = x * x + y * y
    radial = m.k1 * r2 + m.k2 * r2 * r2
    dx = x * radial + 2.0 * m.p1 * x * y + m.p2 * (r2 + 2.0 * x * x)
    dy = y * radial + 2.0 * m.p2 * x * y + m.p1 * (r2 + 2.0 * y * y)
    return dx, dy


def _undistort_radtan(m, mx_d, my_d, n_iters):
    x, y = mx_d, my_d
    for _ in range(n_iters):
        dx, dy = _radtan(m, x, y)
        x, y = mx_d - dx, my_d - dy
    return x, y


@dataclasses.dataclass(frozen=True)
class ScaramuzzaCamera(_Camera):
    """OCAM / Scaramuzza polynomial model for panoramic annular lenses:
    ``poly`` (5 forward coeffs, rho->z), ``inv_poly`` (20 inverse coeffs,
    theta->rho), affine C/D/E and image center (cx, cy). Every field is a
    tensor on the camera's device."""

    poly: torch.Tensor  # [5]
    inv_poly: torch.Tensor  # [20]
    C: torch.Tensor
    D: torch.Tensor
    E: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    def lift_projective(self, p):
        """Pixels [..., 2] -> projective rays [..., 3] (NOT normalized):
        center-relative, inverse affine, z = poly(rho), ray = (x, y, -z)."""
        xc0 = p[..., 0] - self.cx
        xc1 = p[..., 1] - self.cy
        inv_scale = 1.0 / (self.C - self.D * self.E)
        xa0 = inv_scale * (xc0 - self.D * xc1)
        xa1 = inv_scale * (-self.E * xc0 + self.C * xc1)
        phi = torch.sqrt(xa0 * xa0 + xa1 * xa1)
        z = _polyval_ascending(self.poly, phi)
        return torch.stack([xa0, xa1, -z], dim=-1)

    def space_to_plane(self, P):
        """3-D points [..., 3] -> pixels [..., 2] (ScaramuzzaCamera.cc:653-674)."""
        norm = torch.sqrt(P[..., 0] ** 2 + P[..., 1] ** 2)
        theta = torch.atan2(-P[..., 2], norm)
        rho = _polyval_ascending(self.inv_poly, theta)
        safe = torch.clamp(norm, min=1e-12)
        xn0 = P[..., 0] / safe * rho
        xn1 = P[..., 1] / safe * rho
        u = xn0 * self.C + xn1 * self.D + self.cx
        v = xn0 * self.E + xn1 + self.cy
        return torch.stack([u, v], dim=-1)


@dataclasses.dataclass(frozen=True)
class PinholeCamera(_Camera):
    """Pinhole + radial-tangential (k1, k2, p1, p2) distortion."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    def lift_projective(self, p, n_iters: int = 24):
        """Pixels -> rays on the z = 1 plane, undistorted by fixed-point
        iteration (the reference's recursive form, PinholeCamera.cc:473-493,
        with more iterations than its 8 for sub-1e-4 px inversion)."""
        x, y = _undistort_radtan(self, (p[..., 0] - self.cx) / self.fx,
                                 (p[..., 1] - self.cy) / self.fy, n_iters)
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def space_to_plane(self, P):
        z = P[..., 2]
        safe = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
        x, y = P[..., 0] / safe, P[..., 1] / safe
        dx, dy = _radtan(self, x, y)
        return torch.stack([self.fx * (x + dx) + self.cx, self.fy * (y + dy) + self.cy], dim=-1)


@dataclasses.dataclass(frozen=True)
class KannalaBrandtCamera(_Camera):
    """Equidistant fisheye: r(θ) = θ + k2 θ³ + k3 θ⁵ + k4 θ⁷ + k5 θ⁹."""

    mu: torch.Tensor
    mv: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor
    k5: torch.Tensor

    def _r_of_theta(self, th):
        th2 = th * th
        return th * (1.0 + th2 * (self.k2 + th2 * (self.k3 + th2 * (self.k4 + th2 * self.k5))))

    def _dr_dtheta(self, th):
        th2 = th * th
        return 1.0 + th2 * (3.0 * self.k2 + th2 * (5.0 * self.k3 + th2 * (
            7.0 * self.k4 + th2 * 9.0 * self.k5)))

    def lift_projective(self, p, n_iters: int = 10):
        mx = (p[..., 0] - self.u0) / self.mu
        my = (p[..., 1] - self.v0) / self.mv
        r_d = torch.sqrt(mx * mx + my * my)
        th = r_d  # Newton solve of r(θ) = r_d, seeded with θ = r_d
        for _ in range(n_iters):
            th = th - (self._r_of_theta(th) - r_d) / self._dr_dtheta(th)
        scale = torch.where(r_d < 1e-12, torch.ones_like(r_d),
                            torch.sin(th) / torch.clamp(r_d, min=1e-12))
        return torch.stack([mx * scale, my * scale, torch.cos(th)], dim=-1)

    def space_to_plane(self, P):
        rxy = torch.sqrt(P[..., 0] ** 2 + P[..., 1] ** 2)
        r = self._r_of_theta(torch.atan2(rxy, P[..., 2]))
        safe = torch.clamp(rxy, min=1e-12)
        return torch.stack([self.mu * r * P[..., 0] / safe + self.u0,
                            self.mv * r * P[..., 1] / safe + self.v0], dim=-1)


@dataclasses.dataclass(frozen=True)
class MeiCamera(_Camera):
    """Unified catadioptric model: sphere offset xi, rad-tan, then gamma/u0."""

    xi: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    gamma1: torch.Tensor
    gamma2: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor

    def lift_projective(self, p, n_iters: int = 24):
        x, y = _undistort_radtan(self, (p[..., 0] - self.u0) / self.gamma1,
                                 (p[..., 1] - self.v0) / self.gamma2, n_iters)
        # Unproject from the unit sphere through the offset centre.
        rho2 = x * x + y * y
        xi = self.xi
        lam = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * rho2)) / (1.0 + rho2)
        return torch.stack([lam * x, lam * y, lam - xi], dim=-1)

    def space_to_plane(self, P):
        z = P[..., 2] + self.xi * torch.linalg.norm(P, dim=-1)
        safe = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
        x, y = P[..., 0] / safe, P[..., 1] / safe
        dx, dy = _radtan(self, x, y)
        return torch.stack([self.gamma1 * (x + dx) + self.u0,
                            self.gamma2 * (y + dy) + self.v0], dim=-1)


def _parse_opencv_yaml(text: str) -> dict:
    """Minimal parser for the subset of OpenCV FileStorage YAML the reference
    uses (scalars, nested one-level maps, !!opencv-matrix blocks)."""
    import yaml

    text = re.sub(r"%YAML[^\n]*\n", "", text)
    text = re.sub(r"!!opencv-matrix", "", text)
    return yaml.safe_load(text)


def camera_from_dict(cfg: dict, dtype=torch.float32, device=None):
    """Build a camera from a parsed reference-format rig config
    (CameraFactory::generateCameraFromYamlFile, CameraFactory.cc:89-170)."""
    model = str(cfg.get("model_type", "PINHOLE")).upper()

    def arr(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    if model == "SCARAMUZZA":
        pp = cfg["poly_parameters"]
        ip = cfg["inv_poly_parameters"]
        af = cfg["affine_parameters"]
        return ScaramuzzaCamera(
            poly=arr([pp[f"p{i}"] for i in range(5)]),
            inv_poly=arr([ip[f"p{i}"] for i in range(20)]),
            C=arr(af["ac"]), D=arr(af["ad"]), E=arr(af["ae"]),
            cx=arr(af["cx"]), cy=arr(af["cy"]),
        )
    if model == "PINHOLE":
        pr = cfg["projection_parameters"]
        di = cfg.get("distortion_parameters", {})
        return PinholeCamera(
            fx=arr(pr["fx"]), fy=arr(pr["fy"]), cx=arr(pr["cx"]), cy=arr(pr["cy"]),
            k1=arr(di.get("k1", 0.0)), k2=arr(di.get("k2", 0.0)),
            p1=arr(di.get("p1", 0.0)), p2=arr(di.get("p2", 0.0)),
        )
    if model == "KANNALA_BRANDT":
        pr = cfg["projection_parameters"]
        return KannalaBrandtCamera(**{k: arr(pr[k]) for k in
                                      ("mu", "mv", "u0", "v0", "k2", "k3", "k4", "k5")})
    if model == "MEI":
        di = cfg["distortion_parameters"]
        pr = cfg["projection_parameters"]
        return MeiCamera(
            xi=arr(cfg["mirror_parameters"]["xi"]),
            k1=arr(di["k1"]), k2=arr(di["k2"]), p1=arr(di["p1"]), p2=arr(di["p2"]),
            gamma1=arr(pr["gamma1"]), gamma2=arr(pr["gamma2"]),
            u0=arr(pr["u0"]), v0=arr(pr["v0"]),
        )
    raise ValueError(f"unknown camera model_type: {model}")


def camera_from_yaml(path: str, dtype=torch.float32, device=None):
    """Build a camera from a reference-format rig YAML."""
    with open(path) as f:
        cfg = _parse_opencv_yaml(f.read())
    return camera_from_dict(cfg, dtype=dtype, device=device)
