"""Carry the JAX package's parameters over to the port's tensors.

Every function takes a mapping of field name -> numpy array (or number),
as read off a ``lfvio_tpu`` dataclass with ``np.asarray`` by the caller,
and never touches a JAX object. An optional field (``FeatureGrid.cam``) may
be absent from the mapping or None.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .backend.state import FeatureGrid, PriorFactor, SolverConfig, WindowState
from .cam import models as cam_models
from .imu.preintegration import ImuNoise


def _tensors(cls, fields: dict, dtype, device, keep_dtype=()):
    out = {}
    for f in dataclasses.fields(cls):
        if fields.get(f.name) is None and f.default is None:
            out[f.name] = None
            continue
        a = np.array(fields[f.name])
        if f.name in keep_dtype:
            out[f.name] = torch.as_tensor(a, device=device)
        else:
            out[f.name] = torch.as_tensor(a, dtype=dtype, device=device)
    return cls(**out)


def camera(fields: dict, dtype=torch.float64, device=None, model="ScaramuzzaCamera"):
    """The camera model named ``model`` (the JAX dataclass's class name:
    ScaramuzzaCamera, PinholeCamera, KannalaBrandtCamera or MeiCamera) from
    its parameter fields."""
    return _tensors(getattr(cam_models, model), fields, dtype, device)


def imu_noise(fields: dict) -> ImuNoise:
    """acc_n, gyr_n, acc_w, gyr_w."""
    return ImuNoise(**{f.name: float(np.asarray(fields[f.name]))
                       for f in dataclasses.fields(ImuNoise)})


def window_state(fields: dict, dtype=torch.float64, device=None) -> WindowState:
    return _tensors(WindowState, fields, dtype, device)


def feature_grid(fields: dict, dtype=torch.float64, device=None) -> FeatureGrid:
    g = _tensors(FeatureGrid, fields, dtype, device,
                 keep_dtype=("valid", "anchor", "used", "cam"))
    return g.replace(valid=g.valid.to(torch.bool), anchor=g.anchor.to(torch.int64),
                     used=g.used.to(torch.bool),
                     cam=None if g.cam is None else g.cam.to(torch.int64))


def prior_factor(fields: dict, dtype=torch.float64, device=None) -> PriorFactor:
    p = _tensors(PriorFactor, fields, dtype, device, keep_dtype=("valid",))
    return dataclasses.replace(p, valid=p.valid.to(torch.bool))


def solver_config(fields: dict) -> SolverConfig:
    return SolverConfig(**{f.name: fields[f.name] for f in dataclasses.fields(SolverConfig)})


def estimator_from_checkpoint(path, cfg=None, **cfg_kw):
    """An ``Estimator`` resumed from a checkpoint .npz, written by this
    package's ``save_checkpoint`` or by the JAX package's (the keys are the
    same): how a running estimator's state is carried across. ``cfg`` is an
    ``EstimatorConfig`` of the configuration the file was written under, or
    its fields are given as keywords; the estimator lands on ``cfg.device``
    (the CUDA card unless named)."""
    from .runtime.checkpoint import load_checkpoint
    from .runtime.estimator import Estimator, EstimatorConfig

    return load_checkpoint(path, Estimator(cfg or EstimatorConfig(**cfg_kw)))
