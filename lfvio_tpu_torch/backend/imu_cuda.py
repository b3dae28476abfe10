"""The IMU preintegration factor's kernels (``csrc/imu_factor.cu``) and their
plain versions.

Three wrappers, each with its own ``launches`` count (registered with
``device.register_kernel``, so a CUDA graph's replays count), all over the
W = W1 - 1 intervals of a window (interval w joins frames w and w + 1):

  * ``imu_rows(state, pre, sqrt_info, imu_valid, gravity)`` -> (r_w [W, 15],
    J30 [W, 15, 30]): each interval's whitened residual and its Jacobian
    over [δpose_w, δsb_w, δpose_w+1, δsb_w+1] (``factors.imu_jacobian``),
    zero where ``imu_valid`` is False; the rows that MARGIN_OLD's QR stacks;
  * ``imu_normal(H_pp, b_p, state, pre, sqrt_info, imu_valid, gravity)`` ->
    (H_pp, b_p, cost [W]): one linearization's Σ J_wᵀ J_w and Σ J_wᵀ r_w
    added IN PLACE into H_pp [D, D] and b_p [D] of the full local layout
    (the pose block of frame k at columns 6k, its speed-bias block at
    6 W1 + 9k; the extrinsic and td columns get nothing), beside each
    interval's |r_w|²; the LM solve's, after ``proj_normal``;
  * ``imu_cost(state, pre, sqrt_info, imu_valid, gravity)`` -> cost [W]:
    each interval's |r_w|² alone (0 where invalid), for the LM's cost.

``latency_floor(name, ...)`` launches the source's empty kernel with the
grid, block and arguments of one of the three launches, the part of its
time that no design of the kernel removes (card only, counted nowhere).

On CUDA tensors each launches its kernel on the current stream or raises;
on CPU tensors each is its plain version (``imu_rows_plain``,
``imu_normal_plain``, ``imu_cost_plain``). The kernels read the whole state
(not its [:-1] / [1:] views), the preintegration, ``sqrt_info``,
``imu_valid`` and ``gravity`` through device pointers, so they can sit in a
CUDA graph whose inputs change between replays; the wrappers branch on
shapes only.

They stand where the JAX package computes ``lfvio_tpu/backend/solver.py:241``
linearize_imu_rows (forward-mode autodiff of ``_imu_local_residual``,
``:107``, vmapped over the intervals), its dense JᵀJ in
``assemble_normal_equations`` (``:308``) and ``total_cost``'s IMU term
(``:336``, ``factors.py:158`` imu_residuals_window) in XLA (no Pallas
kernel).
"""

from __future__ import annotations

import ctypes

import torch

from ..device import register_kernel
from ..tracing import region
from .factors import imu_jacobian, imu_residuals_window
from .proj_cuda import _DTYPES, _check, _ptr, _shape
from .state import n_cams_of, pose_dim

# The preintegration's fields the kernels read, in the launchers' order,
# with each one's shape after the interval axis.
_PRE_FIELDS = (("delta_p", (3,)), ("delta_q", (4,)), ("delta_v", (3,)), ("jacobian", (15, 15)),
               ("sum_dt", ()), ("linearized_ba", (3,)), ("linearized_bg", (3,)))


# ------------------------------------------------------------ plain versions
def imu_rows_plain(state, pre, sqrt_info, imu_valid, gravity):
    """``imu_rows``' plain version: ``imu_jacobian`` over the intervals,
    masked by ``imu_valid`` (an invalid interval's NaN never leaks)."""
    r, J = imu_jacobian(pre, sqrt_info, state.p[:-1], state.q[:-1], state.v[:-1],
                        state.ba[:-1], state.bg[:-1], state.p[1:], state.q[1:], state.v[1:],
                        state.ba[1:], state.bg[1:], gravity)
    return (torch.where(imu_valid[:, None], r, 0.0),
            torch.where(imu_valid[:, None, None], J, 0.0))


def imu_cost_plain(state, pre, sqrt_info, imu_valid, gravity):
    """``imu_cost``'s plain version: |r_w|² of ``imu_residuals_window``."""
    r = imu_residuals_window(state, pre, sqrt_info, gravity, imu_valid)
    return torch.sum(r * r, dim=-1)


def dense_rows(J30, D):
    """The rows J30 [W, 15, 30] in the full local layout [W * 15, D]:
    interval w's pose and speed-bias blocks at frames w and w + 1, the
    extrinsic and td columns (15 W1 .. D) zero."""
    W = J30.shape[0]
    W1 = W + 1
    dtype, dev = J30.dtype, J30.device
    eyeW = torch.eye(W1, dtype=dtype, device=dev)
    eye_i, eye_j = eyeW[:W], eyeW[1:]  # interval w -> frames w, w+1
    Jp = torch.einsum("wrc,wk->wrkc", J30[..., 0:6], eye_i) + torch.einsum(
        "wrc,wk->wrkc", J30[..., 15:21], eye_j
    )
    Jsb = torch.einsum("wrc,wk->wrkc", J30[..., 6:15], eye_i) + torch.einsum(
        "wrc,wk->wrkc", J30[..., 21:30], eye_j
    )
    return torch.cat(
        [
            Jp.reshape(W, 15, 6 * W1),
            Jsb.reshape(W, 15, 9 * W1),
            torch.zeros((W, 15, D - 15 * W1), dtype=dtype, device=dev),
        ],
        dim=-1,
    ).reshape(W * 15, D)


def imu_normal_plain(H_pp, b_p, state, pre, sqrt_info, imu_valid, gravity):
    """``imu_normal``'s plain version: the dense rows of ``imu_rows_plain``
    and their products, added into H_pp and b_p in place."""
    r, J30 = imu_rows_plain(state, pre, sqrt_info, imu_valid, gravity)
    Jimu = dense_rows(J30, H_pp.shape[0])
    H_pp += Jimu.T @ Jimu
    b_p += Jimu.T @ r.reshape(-1)
    return H_pp, b_p, torch.sum(r * r, dim=-1)


# ------------------------------------------------------------ the kernels
def _inputs(name, state, pre, sqrt_info, imu_valid, gravity):
    """The tensors the kernels read, checked; (dtype, device, W1, their
    pointers in the launchers' order)."""
    dtype, dev = state.p.dtype, state.p.device
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: takes float32 or float64, got {dtype}")
    W1 = state.p.shape[0]
    W = W1 - 1
    if W < 1:
        raise ValueError(f"{name}: the state has {W1} frames, no interval")
    floats = {"p": (state.p, (W1, 3)), "q": (state.q, (W1, 4)), "v": (state.v, (W1, 3)),
              "ba": (state.ba, (W1, 3)), "bg": (state.bg, (W1, 3))}
    floats.update({k: (getattr(pre, k), (W, *s)) for k, s in _PRE_FIELDS})
    floats.update(sqrt_info=(sqrt_info, (W, 15, 15)), gravity=(gravity, (3,)))
    _check(name, {k: (t, None) for k, (t, _) in floats.items()}, dtype, dev)
    _check(name, {"imu_valid": (imu_valid, torch.bool)}, dtype, dev)
    for k, (t, s) in floats.items():
        _shape(name, k, t, s)
    _shape(name, "imu_valid", imu_valid, (W,))
    tensors = [t for t, _ in floats.values()] + [imu_valid]
    return dtype, dev, W1, [_ptr(t) for t in tensors]


def _bind(name, argtypes):
    from ..frontend.klt_cuda import library

    fn = getattr(library("imu_factor"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, name, dev, *args):
    with region(f"imu_factor::{name}"), torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_N_IN = 5 + len(_PRE_FIELDS) + 3  # the state, the preintegration, sqrt_info, gravity, imu_valid


class ImuRowsKernel:
    """``imu_rows`` (``cost_only=False``) or ``imu_cost``: one launch of
    ``imu_rows_kernel`` in rows or cost mode."""

    def __init__(self, cost_only):
        self.cost_only = cost_only
        self.launches = 0
        self._fn = None

    def __call__(self, state, pre, sqrt_info, imu_valid, gravity):
        if not state.p.is_cuda:
            plain = imu_cost_plain if self.cost_only else imu_rows_plain
            return plain(state, pre, sqrt_info, imu_valid, gravity)
        name = "imu_cost" if self.cost_only else "imu_rows"
        dtype, dev, W1, ptrs = _inputs(name, state, pre, sqrt_info, imu_valid, gravity)
        W = W1 - 1
        new = lambda *s: torch.empty(s, dtype=dtype, device=dev)
        cost = r = J30 = None
        if self.cost_only:
            cost = new(W)
        else:
            r, J30 = new(W, 15), new(W, 15, 30)
        if self._fn is None:
            self._fn = _bind("imu_rows_launch", [_P] * _N_IN + [_I, _I, _I, _P, _P, _P, _P])
        _launch(self._fn, name, dev, *ptrs, W1, 0 if self.cost_only else 1, _DTYPES[dtype],
                _ptr(r), _ptr(J30), _ptr(cost))
        self.launches += 1
        return cost if self.cost_only else (r, J30)


class ImuNormalKernel:
    """``imu_normal``: one launch of ``imu_normal_kernel``."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, H_pp, b_p, state, pre, sqrt_info, imu_valid, gravity):
        if not state.p.is_cuda:
            return imu_normal_plain(H_pp, b_p, state, pre, sqrt_info, imu_valid, gravity)
        name = "imu_normal"
        dtype, dev, W1, ptrs = _inputs(name, state, pre, sqrt_info, imu_valid, gravity)
        D = pose_dim(W1, n_cams_of(state))
        _check(name, {"H_pp": (H_pp, None), "b_p": (b_p, None)}, dtype, dev)
        _shape(name, "H_pp", H_pp, (D, D))
        _shape(name, "b_p", b_p, (D,))
        cost = torch.empty(W1 - 1, dtype=dtype, device=dev)
        if self._fn is None:
            self._fn = _bind("imu_normal_launch", [_P] * _N_IN + [_I, _I, _I, _P, _P, _P, _P])
        _launch(self._fn, name, dev, *ptrs, W1, D, _DTYPES[dtype], H_pp.data_ptr(),
                b_p.data_ptr(), cost.data_ptr())
        self.launches += 1
        return H_pp, b_p, cost


# The empty kernel's mode for each launch whose grid and block it takes.
_EMPTY_MODES = {"imu_cost": 0, "imu_rows": 1, "imu_normal": 2}
_empty_fn = None


def latency_floor(name, state, pre, sqrt_info, imu_valid, gravity):
    """One launch of ``csrc/imu_factor.cu``'s empty kernel with the grid,
    block and arguments of ``name``'s launch ("imu_cost", "imu_rows" or
    "imu_normal") at these inputs, through the wrappers' ctypes path and
    allocating the outputs the wrapper allocates (returned): the part of
    that launch's time that no design of its kernel removes. Card only;
    adds to no ``launches``."""
    global _empty_fn
    if not state.p.is_cuda:
        raise ValueError("latency_floor: times a launch on the card; the inputs lie on the CPU")
    dtype, dev, W1, ptrs = _inputs(name, state, pre, sqrt_info, imu_valid, gravity)
    W = W1 - 1
    shapes = {"imu_cost": [(W,)], "imu_rows": [(W, 15), (W, 15, 30)], "imu_normal": [(W,)]}[name]
    outs = [torch.empty(s, dtype=dtype, device=dev) for s in shapes]
    if _empty_fn is None:
        _empty_fn = _bind("imu_empty_launch", [_P] * _N_IN + [_I, _I, _I, _P])
    _launch(_empty_fn, name, dev, *ptrs, W1, _EMPTY_MODES[name], _DTYPES[dtype])
    return outs


imu_rows = register_kernel(ImuRowsKernel(cost_only=False))
imu_cost = register_kernel(ImuRowsKernel(cost_only=True))
imu_normal = register_kernel(ImuNormalKernel())
