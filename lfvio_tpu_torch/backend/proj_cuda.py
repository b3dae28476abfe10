"""The projection factor's kernels (``csrc/proj_factor.cu``) and their plain
versions.

Three wrappers, each with its own ``launches`` count (registered with
``device.register_kernel``, so a CUDA graph's replays count):

  * ``proj_rows(state, grid, cfg)`` -> (res [F, W1, 2], J26 [F, W1, 2, 26],
    w [F, W1], cost [F, W1]): every observation's masked residual, its
    analytic Jacobian over [δpose_i, δpose_j, δex_i, δex_j, δλ, δtd], its
    Cauchy weight (held constant, IRLS) and its robust cost term
    c² log1p(|r|²/c²) (0 where the mask drops it); the dense rows that
    MARGIN_OLD's QR stacks;
  * ``proj_normal(state, grid, cfg, n_cams)`` -> (H_pp [D, D], H_pl [D, F],
    H_ll [F], b_p [D], b_l [F], cost [F, W1]): one linearization's whitened
    rows summed into the normal equations of the full local layout, and the
    cost terms, in one launch that writes no row to memory (the LM solve's);
  * ``proj_cost(state, grid, cfg)`` -> cost [F, W1]: the cost terms alone.

``latency_floor(name, state, grid, cfg)`` launches the source's empty kernel
with the grid, block, shared memory and arguments of the rows or the cost
launch, the part of its time that no design of the kernel removes (card
only, counted nowhere).

On CUDA tensors each launches its kernel on the current stream or raises;
on CPU tensors each is its plain version (``rows_plain``,
``normal_plain``, ``cost_plain``). Everything the kernels read of the
state is read through device pointers, so they can sit inside a CUDA graph
whose state changes between replays; the wrappers branch on shapes only.

They stand where the JAX package computes ``lfvio_tpu/backend/solver.py:126``
linearize_projection, ``:184`` linearize_proj_rows and ``:287``
assemble_normal_equations' projection terms in XLA (no Pallas kernel).
"""

from __future__ import annotations

import ctypes

import torch

from ..device import register_kernel
from ..geom import tangent_basis
from ..tracing import region
from .factors import (
    anchor_values,
    cauchy_corrector,
    obs_extrinsics,
    projection_jacobian,
    projection_residuals_grid,
    residual_mask,
)
from .state import ex_2d, pose_dim

_DTYPES = {torch.float32: 0, torch.float64: 1}


# ------------------------------------------------------------ plain versions
def rows_plain(state, grid, cfg):
    """The rows mode's plain version: ``projection_jacobian`` over the grid,
    masked by ``residual_mask`` (a dropped observation's NaN never leaks)."""
    p_i, q_i, pts_i, vel_i, td_obs_i = anchor_values(state, grid)
    tic_i, qic_i, tic_j, qic_j = obs_extrinsics(state, grid)
    r, J = projection_jacobian(
        p_i[:, None], q_i[:, None], state.p[None], state.q[None],
        tic_i[:, None], qic_i[:, None], tic_j, qic_j,
        state.inv_depth[:, None], state.td,
        pts_i[:, None], grid.bearing, vel_i[:, None], grid.velocity,
        td_obs_i[:, None], grid.td_obs, tangent_basis(grid.bearing), cfg.proj_sqrt_info,
    )
    valid = residual_mask(grid)
    res = torch.where(valid[..., None], r, 0.0)
    J26 = torch.where(valid[..., None, None], J, 0.0)
    w = cauchy_corrector(res, cfg.cauchy_c)[..., 0]
    return res, J26, w, _cost_terms(res, valid, cfg)


def _cost_terms(res, valid, cfg):
    c2 = cfg.cauchy_c**2
    return torch.where(valid, c2 * torch.log1p(torch.sum(res * res, dim=-1) / c2), 0.0)


def cost_plain(state, grid, cfg):
    """The cost mode's plain version (``total_cost``'s projection terms)."""
    res, valid = projection_residuals_grid(state, grid, cfg.proj_sqrt_info)
    return _cost_terms(res, valid, cfg)


def full_rows(J26w, grid, cfg, n_cams):
    """The whitened Jacobians [F, W1, 2, 26] in the full local layout
    [F, W1, 2, D]: the anchor-side pose block at frame ``anchor[f]``, the
    observer-side at frame j, speed-bias columns zero, the extrinsic blocks
    at their cameras' columns (camera-major; blocks of one camera add), td
    last; the extrinsic and td columns zero unless estimated."""
    F, W1 = grid.valid.shape
    C = n_cams
    dtype, dev = J26w.dtype, J26w.device
    J_pi, J_pj = J26w[..., 0:6], J26w[..., 6:12]
    J_exi, J_exj = J26w[..., 12:18], J26w[..., 18:24]
    J_td = J26w[..., 25]
    if not cfg.estimate_extrinsic:
        J_exi, J_exj = torch.zeros_like(J_exi), torch.zeros_like(J_exj)
    if not cfg.estimate_td:
        J_td = torch.zeros_like(J_td)
    # One-hot anchors [F, W1] by comparison (one_hot checks its classes on the
    # host off the card).
    onehot = (grid.anchor[:, None] == torch.arange(W1, device=dev)).to(dtype)
    eyeW = torch.eye(W1, dtype=dtype, device=dev)
    Jpose = torch.einsum("fjac,jk->fjakc", J_pj, eyeW) + torch.einsum(
        "fjac,fk->fjakc", J_pi, onehot
    )
    cam_j = grid.cam_index().reshape(-1)  # [F*W1]
    cam_i = grid.cam_index()[torch.arange(F, device=dev), grid.anchor][:, None].expand(F, W1)
    cam_i = cam_i.reshape(-1)
    row = torch.arange(F * W1, device=dev) * C
    Jex = torch.zeros((F * W1 * C, 2, 6), dtype=dtype, device=dev)
    Jex.index_add_(0, row + cam_j, J_exj.reshape(F * W1, 2, 6))
    Jex.index_add_(0, row + cam_i, J_exi.reshape(F * W1, 2, 6))
    Jex = Jex.reshape(F, W1, C, 2, 6).permute(0, 1, 3, 2, 4).reshape(F, W1, 2, 6 * C)
    return torch.cat(
        [
            Jpose.reshape(F, W1, 2, 6 * W1),
            torch.zeros((F, W1, 2, 9 * W1), dtype=dtype, device=dev),
            Jex,
            J_td[..., None],
        ],
        dim=-1,
    )


def assemble_plain(grid, rows, cfg, n_cams):
    """The assemble mode's plain version: the dense rows and their products."""
    res, J26, w = rows[:3]
    F, W1 = grid.valid.shape
    D = pose_dim(W1, n_cams)
    res_w = res * w[..., None]
    J26w = J26 * w[..., None, None]
    Jfull = full_rows(J26w, grid, cfg, n_cams)
    J_lam = J26w[..., 24]
    Jmat = Jfull.reshape(F * W1 * 2, D)
    H_pp = Jmat.T @ Jmat
    b_p = Jmat.T @ res_w.reshape(-1)
    H_pl = torch.einsum("fjad,fja->df", Jfull, J_lam)
    H_ll = torch.einsum("fja,fja->f", J_lam, J_lam)
    b_l = torch.einsum("fja,fja->f", J_lam, res_w)
    return H_pp, H_pl, H_ll, b_p, b_l


def normal_plain(state, grid, cfg, n_cams):
    """``proj_normal``'s plain version: the sums of ``rows_plain``'s rows
    (``assemble_plain``) and its cost terms."""
    rows = rows_plain(state, grid, cfg)
    return (*assemble_plain(grid, rows, cfg, n_cams), rows[3])


# ------------------------------------------------------------ the kernels
def _library():
    from ..frontend.klt_cuda import library

    return library("proj_factor")


def _check(name, tensors, dtype, dev):
    """Raise unless every tensor lies on ``dev``, is contiguous and has its
    expected dtype (``dtype`` for floating tensors)."""
    for key, (t, want) in tensors.items():
        want = dtype if want is None else want
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {want} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}"
                             + ("" if t.is_contiguous() else " (not contiguous)"))


def _shape(name, key, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _grid_inputs(name, grid, dtype, dev):
    """The grid's tensors the kernels read, checked; (F, W1, tensors)."""
    F, W1 = grid.valid.shape
    t = {"valid": (grid.valid, torch.bool), "anchor": (grid.anchor, torch.int64),
         "used": (grid.used, torch.bool)}
    if grid.cam is not None:
        t["cam"] = (grid.cam, torch.int64)
    _check(name, t, dtype, dev)
    _shape(name, "anchor", grid.anchor, (F,))
    _shape(name, "used", grid.used, (F,))
    if grid.cam is not None:
        _shape(name, "cam", grid.cam, (F, W1))
    return F, W1, {k: v[0] for k, v in t.items()}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _state_inputs(name, state, grid):
    """The state's and grid's tensors the kernels read, checked; (dtype,
    device, C, F, W1, their pointers in the launchers' order). Every one is
    the state's or the grid's tensor or a view of it."""
    dtype, dev = state.p.dtype, state.p.device
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: takes float32 or float64, got {dtype}")
    tics, qics = ex_2d(state.tic, state.qic)
    C, W1s = tics.shape[0], state.p.shape[0]
    F, W1, g = _grid_inputs(name, grid, dtype, dev)
    floats = {"p": state.p, "q": state.q, "tic": tics, "qic": qics, "td": state.td,
              "inv_depth": state.inv_depth, "bearing": grid.bearing,
              "velocity": grid.velocity, "td_obs": grid.td_obs}
    _check(name, {k: (v, None) for k, v in floats.items()}, dtype, dev)
    for key, shape in (("p", (W1, 3)), ("q", (W1, 4)), ("tic", (C, 3)), ("qic", (C, 4)),
                       ("td", ()), ("inv_depth", (F,)), ("bearing", (F, W1, 3)),
                       ("velocity", (F, W1, 3)), ("td_obs", (F, W1))):
        _shape(name, key, floats[key], shape)
    if W1s != W1:
        raise ValueError(f"{name}: the state has {W1s} frames, the grid {W1}")
    tensors = [*floats.values(), g["valid"], g["anchor"], g["used"], g.get("cam")]
    return dtype, dev, C, F, W1, [_ptr(t) for t in tensors]


def _bind(name, argtypes):
    fn = getattr(_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


_ROWS_ARGTYPES = [_P] * 13 + [_I, _I, _I, _DBL, _DBL, _I, _I, _P, _P, _P, _P, _P]


def _rows_launch(fn, name, state, grid, cfg):
    """One call of ``fn`` (``proj_rows_launch`` or ``proj_empty_launch``,
    which take the same arguments) in the rows mode or (``name`` is
    "proj_cost") the cost mode, on outputs allocated here: (cost, or (res,
    J26, w, cost); whether it launched: an empty grid launches nothing)."""
    cost_only = name == "proj_cost"
    dtype, dev, C, F, W1, ptrs = _state_inputs(name, state, grid)
    new = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    cost = new(F, W1)
    res = J26 = w = None
    if not cost_only:
        res, J26, w = new(F, W1, 2), new(F, W1, 2, 26), new(F, W1)
    out = cost if cost_only else (res, J26, w, cost)
    if not F:
        return out, False
    with region(f"proj_factor::{name}"), torch.cuda.device(dev):
        err = fn(*ptrs, F, W1, C, float(cfg.proj_sqrt_info), float(cfg.cauchy_c),
                 0 if cost_only else 1, _DTYPES[dtype], _ptr(res), _ptr(J26), _ptr(w),
                 cost.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out, True


class ProjRowsKernel:
    """``proj_rows`` (``cost_only=False``) or ``proj_cost``: one launch of
    ``proj_rows_kernel`` in rows or cost mode."""

    def __init__(self, cost_only):
        self.cost_only = cost_only
        self.launches = 0
        self._fn = None

    def __call__(self, state, grid, cfg):
        if not state.p.is_cuda:
            return cost_plain(state, grid, cfg) if self.cost_only else rows_plain(state, grid, cfg)
        if self._fn is None:
            self._fn = _bind("proj_rows_launch", _ROWS_ARGTYPES)
        out, launched = _rows_launch(self._fn, "proj_cost" if self.cost_only else "proj_rows",
                                     state, grid, cfg)
        self.launches += launched
        return out


class ProjNormalKernel:
    """``proj_normal``: one launch of ``proj_normal_kernel``."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, state, grid, cfg, n_cams):
        if not state.p.is_cuda:
            return normal_plain(state, grid, cfg, n_cams)
        name = "proj_normal"
        dtype, dev, C, F, W1, ptrs = _state_inputs(name, state, grid)
        if C != n_cams:
            raise ValueError(f"{name}: the state has {C} cameras, n_cams is {n_cams}")
        D = pose_dim(W1, C)
        if not F:
            z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
            return z(D, D), z(D, 0), z(0), z(D), z(0), z(0, W1)
        new = lambda *s: torch.empty(s, dtype=dtype, device=dev)
        H_pp, b_p, H_pl, H_ll, b_l, cost = new(D, D), new(D), new(D, F), new(F), new(F), new(F, W1)
        if self._fn is None:
            self._fn = _bind("proj_normal_launch", [_P] * 13 + [_I, _I, _I, _DBL, _DBL, _I, _I, _I]
                             + [_P] * 7)
        with region("proj_factor::proj_normal"), torch.cuda.device(dev):
            err = self._fn(
                *ptrs, F, W1, C, float(cfg.proj_sqrt_info), float(cfg.cauchy_c),
                int(cfg.estimate_extrinsic), int(cfg.estimate_td), _DTYPES[dtype],
                H_pp.data_ptr(), b_p.data_ptr(), H_pl.data_ptr(), H_ll.data_ptr(),
                b_l.data_ptr(), cost.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
        self.launches += 1
        return H_pp, H_pl, H_ll, b_p, b_l, cost


proj_rows = register_kernel(ProjRowsKernel(cost_only=False))
proj_cost = register_kernel(ProjRowsKernel(cost_only=True))
proj_normal = register_kernel(ProjNormalKernel())


_empty_fn = None


def latency_floor(name, state, grid, cfg):
    """One launch of ``csrc/proj_factor.cu``'s empty kernel with the grid,
    block, shared memory and arguments of ``name``'s launch ("proj_rows" or
    "proj_cost") at these inputs, through the wrappers' ctypes path and
    allocating the outputs the wrapper allocates (returned): the part of
    that launch's time that no design of its kernel removes. Card only;
    adds to no ``launches``."""
    global _empty_fn
    if name not in ("proj_rows", "proj_cost"):
        raise ValueError(f"latency_floor: takes 'proj_rows' or 'proj_cost', got {name!r}")
    if not state.p.is_cuda:
        raise ValueError("latency_floor: times a launch on the card; the inputs lie on the CPU")
    if _empty_fn is None:
        _empty_fn = _bind("proj_empty_launch", _ROWS_ARGTYPES)
    return _rows_launch(_empty_fn, name, state, grid, cfg)[0]
