"""Static-shape estimator state for the sliding window, as tensors.

Port of ``lfvio_tpu.backend.state``: ``WindowState`` (all optimization
variables of the W+1 window frames, with one extrinsic per camera),
``FeatureGrid`` (the dense [F, W+1] observation grid with validity masks and
an optional per-observation camera id), ``PriorFactor`` (the square-root
marginalization prior over the full local layout) and ``SolverConfig``.

Local (tangent) layout, D = 15·(W+1) + 6·C + 1 for C cameras:

  [ pose_0 (6) ... pose_W (6) | sb_0 (9) ... sb_W (9) | ex_0 (6) ... | td (1) ]

pose = (δp, δθ); sb = (δv, δba, δbg). Inverse depths stay out of it and
are Schur-eliminated. ``WINDOW`` is the default window length only: every
shape derives from the tensors' own sizes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geom import quat_identity

WINDOW = 10  # default sliding-window keyframes (reference WINDOW_SIZE)
NFRAMES = WINDOW + 1


def pose_dim(n_frames: int = NFRAMES, n_cams: int = 1) -> int:
    return 15 * n_frames + 6 * n_cams + 1


def pose_off(i: int) -> int:
    return 6 * i


def sb_off(i: int, n_frames: int = NFRAMES) -> int:
    return 6 * n_frames + 9 * i


def ex_off(n_frames: int = NFRAMES) -> int:
    return 15 * n_frames


def td_off(n_frames: int = NFRAMES, n_cams: int = 1) -> int:
    return ex_off(n_frames) + 6 * n_cams


def ex_2d(tic, qic):
    """Canonical [C, 3] / [C, 4] view of the extrinsics. Mono states keep
    the rank-1 [3] / [4] shapes (NUM_OF_CAM=1 in the reference); multi-
    camera rigs (dual-PAL) store one row per camera."""
    if tic.ndim == 1:
        return tic[None, :], qic[None, :]
    return tic, qic


def n_cams_of(state) -> int:
    return 1 if state.tic.ndim == 1 else int(state.tic.shape[0])


@dataclasses.dataclass(frozen=True)
class WindowState:
    p: torch.Tensor  # [W+1, 3]
    q: torch.Tensor  # [W+1, 4] wxyz
    v: torch.Tensor  # [W+1, 3]
    ba: torch.Tensor  # [W+1, 3]
    bg: torch.Tensor  # [W+1, 3]
    tic: torch.Tensor  # [3] (mono) or [C, 3]: camera-in-IMU translation
    qic: torch.Tensor  # [4] (mono) or [C, 4]: camera-in-IMU rotation
    td: torch.Tensor  # [] time offset
    inv_depth: torch.Tensor  # [F] inverse ray depth per feature slot

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @staticmethod
    def zeros(n_features: int, dtype=torch.float32, n_frames: int = NFRAMES,
              device=None, n_cams: int = 1):
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        unit_q = quat_identity(dtype, device)
        return WindowState(
            p=z(n_frames, 3), q=unit_q.repeat(n_frames, 1), v=z(n_frames, 3),
            ba=z(n_frames, 3), bg=z(n_frames, 3),
            tic=z(3) if n_cams == 1 else z(n_cams, 3),
            qic=unit_q if n_cams == 1 else unit_q.repeat(n_cams, 1),
            td=z(), inv_depth=torch.ones(n_features, dtype=dtype, device=device),
        )


@dataclasses.dataclass(frozen=True)
class FeatureGrid:
    """Dense observation grid for F feature slots over the window frames."""

    bearing: torch.Tensor  # [F, W+1, 3] unit bearings (camera frame)
    velocity: torch.Tensor  # [F, W+1, 3] 3-D bearing velocity
    td_obs: torch.Tensor  # [F, W+1] per-observation time reference
    valid: torch.Tensor  # [F, W+1] bool observation mask
    anchor: torch.Tensor  # [F] int64 anchor (start) frame per slot
    used: torch.Tensor  # [F] bool — participates in BA
    # Per-observation camera id (multi-camera rigs; the reference carries a
    # camera id per feature-message entry, estimator_node.cpp:292-312).
    # None: every observation comes from camera 0.
    cam: torch.Tensor | None = None  # [F, W+1] int64 or None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def cam_index(self):
        """[F, W+1] int64 camera of each observation (zeros when ``cam`` is
        None)."""
        if self.cam is None:
            return torch.zeros(self.valid.shape, dtype=torch.int64, device=self.valid.device)
        return self.cam.to(torch.int64)


@dataclasses.dataclass(frozen=True)
class PriorFactor:
    """Square-root marginalization prior r(x) = r0 + J · (x ⊟ x0)
    (MarginalizationFactor::Evaluate, marginalization_factor.cpp:333-381)."""

    J: torch.Tensor  # [D, D]
    r0: torch.Tensor  # [D]
    x0_p: torch.Tensor
    x0_q: torch.Tensor
    x0_v: torch.Tensor
    x0_ba: torch.Tensor
    x0_bg: torch.Tensor
    x0_tic: torch.Tensor
    x0_qic: torch.Tensor
    x0_td: torch.Tensor
    valid: torch.Tensor  # [] bool — False until the first marginalization

    @staticmethod
    def empty(dtype=torch.float32, n_frames: int = NFRAMES, device=None,
              n_cams: int = 1):
        D = pose_dim(n_frames, n_cams)
        s = WindowState.zeros(1, dtype, n_frames, device, n_cams)
        return PriorFactor(
            J=torch.zeros((D, D), dtype=dtype, device=device),
            r0=torch.zeros((D,), dtype=dtype, device=device),
            x0_p=s.p, x0_q=s.q, x0_v=s.v, x0_ba=s.ba, x0_bg=s.bg,
            x0_tic=s.tic, x0_qic=s.qic, x0_td=s.td,
            valid=torch.zeros((), dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_state(J, r0, state: WindowState, valid):
        return PriorFactor(
            J=J, r0=r0, x0_p=state.p, x0_q=state.q, x0_v=state.v,
            x0_ba=state.ba, x0_bg=state.bg, x0_tic=state.tic,
            x0_qic=state.qic, x0_td=state.td, valid=valid,
        )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (``lfvio_tpu.backend.state.SolverConfig``)."""

    max_iterations: int = 8  # reference max_num_iterations
    focal_length: float = 160.0  # virtual focal (parameters.h:11)
    estimate_td: bool = True
    estimate_extrinsic: bool = True
    # Cameras in the rig (dual-PAL up+down = 2): the extrinsic block count
    # of the local layout.
    n_cams: int = 1
    cauchy_c: float = 1.0  # CauchyLoss(1.0) (estimator.cpp:681)
    init_lambda: float = 1e-4
    min_inv_depth: float = 1e-3
    cost_tol: float = 1e-6  # relative cost plateau for the LM early exit

    @property
    def proj_sqrt_info(self) -> float:
        # sqrt_info = FOCAL_LENGTH / 1.5 * I2 (estimator.cpp:18)
        return self.focal_length / 1.5
