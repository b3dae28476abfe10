"""Scaramuzza (OCAM) camera model on torch tensors.

Port of the ``ScaramuzzaCamera`` parts of ``lfvio_tpu.cam.models``: the PAL
model with the negative half-plane sign convention ("changed by wz"), where
the lift returns (x, y, -poly(rho)) so bearings span the full sphere
(ScaramuzzaCamera.cc:622-674). Lift and projection operate on arbitrary
batches of points. The other camera models are not ported yet.
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


@dataclasses.dataclass(frozen=True)
class ScaramuzzaCamera:
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

    def to(self, device=None, dtype=None):
        return ScaramuzzaCamera(**{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)
        })

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

    def lift_sphere(self, p):
        ray = self.lift_projective(p)
        return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)

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


def _parse_opencv_yaml(text: str) -> dict:
    """Minimal parser for the subset of OpenCV FileStorage YAML the reference
    uses (scalars, nested one-level maps, !!opencv-matrix blocks)."""
    import yaml

    text = re.sub(r"%YAML[^\n]*\n", "", text)
    text = re.sub(r"!!opencv-matrix", "", text)
    return yaml.safe_load(text)


def camera_from_dict(cfg: dict, dtype=torch.float32, device=None):
    """Build a camera from a parsed reference-format rig config. Only the
    SCARAMUZZA model is ported."""
    model = str(cfg.get("model_type", "PINHOLE")).upper()
    if model != "SCARAMUZZA":
        raise ValueError(f"camera model_type {model} is not ported")

    def arr(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    pp = cfg["poly_parameters"]
    ip = cfg["inv_poly_parameters"]
    af = cfg["affine_parameters"]
    return ScaramuzzaCamera(
        poly=arr([pp[f"p{i}"] for i in range(5)]),
        inv_poly=arr([ip[f"p{i}"] for i in range(20)]),
        C=arr(af["ac"]),
        D=arr(af["ad"]),
        E=arr(af["ae"]),
        cx=arr(af["cx"]),
        cy=arr(af["cy"]),
    )


def camera_from_yaml(path: str, dtype=torch.float32, device=None):
    """Build a camera from a reference-format rig YAML."""
    with open(path) as f:
        cfg = _parse_opencv_yaml(f.read())
    return camera_from_dict(cfg, dtype=dtype, device=device)
