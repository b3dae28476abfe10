"""The relocalization rows' kernels (``csrc/proj_factor.cu``: ``relo_normal_kernel``,
``relo_cost_kernel``) and their plain versions.

A relo row is the projection residual (``factors.projection_residual``) of a
window feature matched in the loop frame: anchored as in the window, seen
from the loop pose through camera 0 (the loop image is the primary
camera's), with td = td_obs = 0, zero velocities and the loop bearing in
place of the observation's (``backend/relo.py``). So
``factors.projection_jacobian`` gives its 2×25 Jacobian over [δpose_i,
δrelo, δex_anchor, δex_cam0, δλ]: its first 25 columns (its td column is 0).

Two wrappers, each with its own ``launches`` count (registered with
``device.register_kernel``, so a CUDA graph's replays count):

  * ``relo_normal(H6, H_pl6, H_ll, b6, b_l, state, grid, relo_p, relo_q,
    relo_bearing, relo_mask, cfg)`` -> the same five tensors: one
    linearization's whitened, Cauchy-weighted relo rows added IN PLACE into
    the augmented normal equations of the [D + 6] layout (the loop pose's
    block last): H6 [D+6, D+6], H_pl6 [D+6, F], H_ll [F], b6 [D+6], b_l [F].
    The rows reach the anchor-pose, extrinsic and loop-pose blocks of H6
    and b6, and each matched feature's H_pl6 column, H_ll and b_l; the
    extrinsic columns only where ``cfg.estimate_extrinsic``. No row is
    written to memory; each kept feature is linearized once a launch, in
    one cluster of blocks: at most ``MAX_SLOTS`` slots and ``MAX_FRAMES``
    frames, whose rows and sums fit in the shared memory a block may take
    (``normal_smem``; a ValueError otherwise);
  * ``relo_cost(state, grid, relo_p, relo_q, relo_bearing, relo_mask, cfg)``
    -> cost [F]: each feature's robust cost term c² log1p(|r|²/c²), 0 where
    it is not matched (``relo_mask & grid.used``).

``latency_floor(name, ...)`` launches the source's empty kernel with the
grid, block, shared memory and arguments of one of the two launches (card
only, counted nowhere).

On CUDA tensors each launches its kernel on the current stream or raises;
on CPU tensors each is its plain version (``relo_normal_plain``,
``relo_cost_plain``). The kernels read the state, the grid, the loop pose,
bearings and mask through device pointers, so a CUDA graph's replay sees
new ones; the wrappers branch on shapes only.

They stand where the JAX package computes ``lfvio_tpu/backend/relo.py:75``
linearize_relo_rows (forward-mode autodiff of ``_relo_local_residual``, ``:108``,
vmapped over the features) and its sums into the augmented system
(``:181``, ``:192-202``) and cost (``:209``) in XLA (no Pallas kernel).
"""

from __future__ import annotations

import ctypes

import torch

from ..device import register_kernel
from ..geom import tangent_basis
from ..tracing import region
from .factors import anchor_values, cauchy_corrector, projection_jacobian, projection_residual
from .proj_cuda import _DTYPES, _bind, _check, _cost_terms, _ptr, _shape, _state_inputs
from .state import ex_2d, n_cams_of, pose_dim


# ------------------------------------------------------------ plain versions
def _relo_args(state, grid, relo_p, relo_q, relo_bearing):
    """``projection_residual``'s arguments of every feature's relo row."""
    F = grid.anchor.shape[0]
    fi = torch.arange(F, device=grid.anchor.device)
    p_i, q_i, pts_i, _, _ = anchor_values(state, grid)
    tics, qics = ex_2d(state.tic, state.qic)
    cam_i = grid.cam_index()[fi, grid.anchor]
    b_loop = relo_bearing / torch.clamp(torch.linalg.norm(relo_bearing, dim=-1, keepdim=True),
                                        min=1e-12)
    z3, z = torch.zeros_like(b_loop), torch.zeros_like(state.inv_depth)
    ex = lambda x: x.expand(F, *x.shape)
    return (p_i, q_i, ex(relo_p), ex(relo_q), tics[cam_i], qics[cam_i], ex(tics[0]),
            ex(qics[0]), state.inv_depth, z, pts_i, b_loop, z3, z3, z, z, tangent_basis(b_loop))


def relo_jacobian(state, grid, relo_p, relo_q, relo_bearing, relo_mask, cfg):
    """Every feature's relo row from ``projection_jacobian``, masked by
    ``relo_mask & grid.used`` (an unmatched feature's NaN never leaks).
    Returns (res [F, 2], J25 [F, 2, 25], w [F], valid [F], cost terms [F])."""
    r, J = projection_jacobian(*_relo_args(state, grid, relo_p, relo_q, relo_bearing),
                               cfg.proj_sqrt_info)
    valid = relo_mask & grid.used
    res = torch.where(valid[:, None], r, 0.0)
    J25 = torch.where(valid[:, None, None], J[..., :25], 0.0)
    w = cauchy_corrector(res, cfg.cauchy_c)[..., 0]
    return res, J25, w, valid, _cost_terms(res, valid, cfg)


def full_relo_rows(J25w, grid, cfg, n_cams):
    """The weighted relo Jacobians [F, 2, 25] in the augmented layout
    [F, 2, D+6]: the anchor-side pose block at frame ``anchor[f]``,
    speed-bias and td columns zero, the anchor-side extrinsic block at the
    anchor observation's camera and the loop side's at camera 0 (added where
    they coincide; zero unless estimated), the loop pose's block last."""
    F, W1 = grid.valid.shape
    C = n_cams
    dtype, dev = J25w.dtype, J25w.device
    fi = torch.arange(F, device=dev)
    J_exi, J_ex0 = J25w[..., 12:18], J25w[..., 18:24]
    if not cfg.estimate_extrinsic:
        J_exi, J_ex0 = torch.zeros_like(J_exi), torch.zeros_like(J_ex0)
    Jpose = torch.zeros((F, W1, 2, 6), dtype=dtype, device=dev)
    Jpose[fi, grid.anchor] = J25w[..., 0:6]
    Jpose = Jpose.permute(0, 2, 1, 3).reshape(F, 2, 6 * W1)
    Jex = torch.zeros((F * C, 2, 6), dtype=dtype, device=dev)
    Jex.index_add_(0, fi * C + grid.cam_index()[fi, grid.anchor], J_exi)
    Jex.index_add_(0, fi * C, J_ex0)
    Jex = Jex.reshape(F, C, 2, 6).permute(0, 2, 1, 3).reshape(F, 2, 6 * C)
    return torch.cat(
        [Jpose, torch.zeros((F, 2, 9 * W1), dtype=dtype, device=dev), Jex,
         torch.zeros((F, 2, 1), dtype=dtype, device=dev), J25w[..., 6:12]],
        dim=-1,
    )


def relo_sums(res_w, J25w, grid, cfg, n_cams):
    """The products of the weighted relo rows (``res_w`` [F, 2], ``J25w``
    [F, 2, 25]) in the augmented layout (``full_relo_rows``), as the JAX
    package's lm_solve_relo sums them: (H6, H_pl6, H_ll, b6, b_l) terms."""
    F = J25w.shape[0]
    Jr = full_relo_rows(J25w, grid, cfg, n_cams)
    J_lam = J25w[..., 24]
    Jmat = Jr.reshape(F * 2, -1)
    return (Jmat.T @ Jmat, torch.einsum("fad,fa->df", Jr, J_lam),
            torch.einsum("fa,fa->f", J_lam, J_lam), Jmat.T @ res_w.reshape(-1),
            torch.einsum("fa,fa->f", J_lam, res_w))


def relo_normal_plain(H6, H_pl6, H_ll, b6, b_l, state, grid, relo_p, relo_q, relo_bearing,
                      relo_mask, cfg):
    """``relo_normal``'s plain version: ``relo_sums`` of ``relo_jacobian``'s
    weighted rows added in place."""
    res, J25, w = relo_jacobian(state, grid, relo_p, relo_q, relo_bearing, relo_mask, cfg)[:3]
    sums = (H6, H_pl6, H_ll, b6, b_l)
    terms = relo_sums(res * w[:, None], J25 * w[:, None, None], grid, cfg, n_cams_of(state))
    for out, term in zip(sums, terms):
        out += term
    return sums


def relo_cost_plain(state, grid, relo_p, relo_q, relo_bearing, relo_mask, cfg):
    """``relo_cost``'s plain version: ``projection_residual`` of every
    feature's relo row, its cost term where matched."""
    args = _relo_args(state, grid, relo_p, relo_q, relo_bearing)
    r = projection_residual(*args, cfg.proj_sqrt_info)
    valid = relo_mask & grid.used
    return _cost_terms(torch.where(valid[:, None], r, 0.0), valid, cfg)


# ------------------------------------------------------------ the kernels
# relo_normal_kernel's cluster linearizes a slot a thread, at most
# RN_CLUSTER * RN_THREADS in the source, and a thread a frame lists the
# segments: W1 < RN_THREADS.
MAX_SLOTS, MAX_FRAMES = 2048, 255
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_P] * 13 + [_I, _I, _I, ctypes.c_double, ctypes.c_double] + [_P] * 4
             + [_I, _I, _I, _I] + [_P] * 7)
_LL = ctypes.POINTER(ctypes.c_longlong)
_smem_fn = None


def normal_smem(F, W1, n_cams, estimate_extrinsic, dtype, device):
    """``relo_normal_kernel``'s dynamic shared memory at these sizes and the
    most a block of the card ``device`` may take: (need, limit) in bytes
    (``relo_normal_smem`` in the source). Card only."""
    global _smem_fn
    if _smem_fn is None:
        _smem_fn = _bind("relo_normal_smem", [_I] * 5 + [_LL, _LL])
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(device):
        err = _smem_fn(F, W1, n_cams, int(bool(estimate_extrinsic)), _DTYPES[dtype],
                       ctypes.byref(need), ctypes.byref(limit))
    if err != 0:
        raise RuntimeError(f"relo_normal_smem failed: cudaError {err}")
    return need.value, limit.value


def _relo_inputs(name, state, grid, relo_p, relo_q, relo_bearing, relo_mask):
    """The inputs the launches read, checked; (dtype, device, C, F, W1,
    their pointers in the launcher's order)."""
    dtype, dev, C, F, W1, ptrs = _state_inputs(name, state, grid)
    t = {"relo_p": (relo_p, None), "relo_q": (relo_q, None), "relo_bearing": (relo_bearing, None),
         "relo_mask": (relo_mask, torch.bool)}
    _check(name, t, dtype, dev)
    for key, shape in (("relo_p", (3,)), ("relo_q", (4,)), ("relo_bearing", (F, 3)),
                       ("relo_mask", (F,))):
        _shape(name, key, t[key][0], shape)
    return dtype, dev, C, F, W1, ptrs + [_ptr(x) for x, _ in t.values()]


def _launch(fn, name, mode, empty, state, grid, relo, cfg, sums=None):
    """One call of ``relo_launch`` (``name`` "relo_normal": mode 1, adding
    into ``sums`` = (H6, H_pl6, H_ll, b6, b_l); "relo_cost": mode 0) or
    (``empty``) of the empty kernel with that launch's grid, block and
    shared memory; returns (cost [F] or None, whether it launched)."""
    dtype, dev, C, F, W1, ptrs = _relo_inputs(name, state, grid, *relo)
    H6 = H_pl6 = H_ll = b6 = b_l = cost = None
    if mode:
        H6, H_pl6, H_ll, b6, b_l = sums
        if F > MAX_SLOTS or W1 > MAX_FRAMES:
            raise ValueError(f"{name}: the kernel takes at most {MAX_SLOTS} slots and "
                             f"{MAX_FRAMES} frames, got {F} and {W1}")
        need, limit = normal_smem(F, W1, C, cfg.estimate_extrinsic, dtype, dev)
        if need > limit:
            raise ValueError(
                f"{name}: {F} slots over {W1} frames, {C} camera(s), extrinsics "
                f"{'estimated' if cfg.estimate_extrinsic else 'fixed'}, {dtype}: the kernel needs "
                f"{need} B of shared memory a block, the card allows {limit} B")
    else:
        cost = torch.empty(F, dtype=dtype, device=dev)
    if not F:
        return (torch.zeros(0, dtype=dtype, device=dev) if cost is not None else None), False
    with region(f"relo_factor::{name}"), torch.cuda.device(dev):
        err = fn(*ptrs[:13], F, W1, C, float(cfg.proj_sqrt_info), float(cfg.cauchy_c), *ptrs[13:],
                 int(cfg.estimate_extrinsic), mode, int(empty), _DTYPES[dtype], _ptr(H6), _ptr(b6),
                 _ptr(H_pl6), _ptr(H_ll), _ptr(b_l), _ptr(cost),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return cost, True


def _check_sums(name, sums, state, grid):
    """Raise unless (H6, H_pl6, H_ll, b6, b_l) are the augmented system's
    contiguous tensors of the state's dtype on its device."""
    dtype, dev = state.p.dtype, state.p.device
    F, W1 = grid.valid.shape
    D6 = pose_dim(W1, n_cams_of(state)) + 6
    keys = ("H6", "H_pl6", "H_ll", "b6", "b_l")
    _check(name, {k: (t, None) for k, t in zip(keys, sums)}, dtype, dev)
    for k, t, s in zip(keys, sums, ((D6, D6), (D6, F), (F,), (D6,), (F,))):
        _shape(name, k, t, s)


class ReloKernel:
    """``relo_normal`` (``normal=True``) or ``relo_cost``: one launch of
    ``relo_normal_kernel`` or ``relo_cost_kernel``."""

    def __init__(self, normal):
        self.normal = normal
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if not args[-7].p.is_cuda:
            return (relo_normal_plain if self.normal else relo_cost_plain)(*args)
        sums, (state, grid, *relo, cfg) = (args[:5], args[5:]) if self.normal else (None, args)
        name = "relo_normal" if self.normal else "relo_cost"
        if self.normal:
            _check_sums(name, sums, state, grid)
        if self._fn is None:
            self._fn = _bind("relo_launch", _ARGTYPES)
        cost, launched = _launch(self._fn, name, int(self.normal), False, state, grid, relo, cfg,
                                 sums)
        self.launches += launched
        return tuple(sums) if self.normal else cost


relo_normal = register_kernel(ReloKernel(normal=True))
relo_cost = register_kernel(ReloKernel(normal=False))


_empty_fn = None


def latency_floor(name, state, grid, relo_p, relo_q, relo_bearing, relo_mask, cfg):
    """One launch of the empty relo kernel with the grid, block, shared
    memory and arguments of ``name``'s launch ("relo_normal" or
    "relo_cost") at these inputs, through the wrappers' ctypes path (for
    "relo_normal" on sums allocated here, which it leaves as they are): the
    part of that launch's time that no design of its kernel removes. Card
    only; adds to no ``launches``."""
    global _empty_fn
    if name not in ("relo_normal", "relo_cost"):
        raise ValueError(f"latency_floor: takes 'relo_normal' or 'relo_cost', got {name!r}")
    if not state.p.is_cuda:
        raise ValueError("latency_floor: times a launch on the card; the inputs lie on the CPU")
    if _empty_fn is None:
        _empty_fn = _bind("relo_launch", _ARGTYPES)
    sums = None
    if name == "relo_normal":
        F, W1 = grid.valid.shape
        D6 = pose_dim(W1, n_cams_of(state)) + 6
        new = lambda *s: torch.empty(s, dtype=state.p.dtype, device=state.p.device)
        sums = (new(D6, D6), new(D6, F), new(F), new(D6), new(F))
    return _launch(_empty_fn, name, int(name == "relo_normal"), True, state, grid,
                   (relo_p, relo_q, relo_bearing, relo_mask), cfg, sums)[0]
