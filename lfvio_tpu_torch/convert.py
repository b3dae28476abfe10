"""Carry the JAX package's parameters over to the port's tensors.

Every function takes a mapping of field name -> numpy array (or number),
as read off a ``lfvio_tpu`` dataclass with ``np.asarray`` by the caller,
and never touches a JAX object. Fields the port does not have (the
multi-camera ``cam`` grid column, ``n_cams``) are ignored.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .backend.state import FeatureGrid, PriorFactor, SolverConfig, WindowState
from .cam.models import ScaramuzzaCamera
from .imu.preintegration import ImuNoise


def _tensors(cls, fields: dict, dtype, device, keep_dtype=()):
    out = {}
    for f in dataclasses.fields(cls):
        a = np.array(fields[f.name])
        if f.name in keep_dtype:
            out[f.name] = torch.as_tensor(a, device=device)
        else:
            out[f.name] = torch.as_tensor(a, dtype=dtype, device=device)
    return cls(**out)


def camera(fields: dict, dtype=torch.float64, device=None) -> ScaramuzzaCamera:
    """poly, inv_poly, C, D, E, cx, cy."""
    return _tensors(ScaramuzzaCamera, fields, dtype, device)


def imu_noise(fields: dict) -> ImuNoise:
    """acc_n, gyr_n, acc_w, gyr_w."""
    return ImuNoise(**{f.name: float(np.asarray(fields[f.name]))
                       for f in dataclasses.fields(ImuNoise)})


def window_state(fields: dict, dtype=torch.float64, device=None) -> WindowState:
    return _tensors(WindowState, fields, dtype, device)


def feature_grid(fields: dict, dtype=torch.float64, device=None) -> FeatureGrid:
    g = _tensors(FeatureGrid, fields, dtype, device, keep_dtype=("valid", "anchor", "used"))
    return g.replace(valid=g.valid.to(torch.bool), anchor=g.anchor.to(torch.int64),
                     used=g.used.to(torch.bool))


def prior_factor(fields: dict, dtype=torch.float64, device=None) -> PriorFactor:
    p = _tensors(PriorFactor, fields, dtype, device, keep_dtype=("valid",))
    return dataclasses.replace(p, valid=p.valid.to(torch.bool))


def solver_config(fields: dict) -> SolverConfig:
    return SolverConfig(**{f.name: fields[f.name] for f in dataclasses.fields(SolverConfig)})
