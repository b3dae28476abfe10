"""Sliding-window VIO estimator.

Port of ``lfvio_tpu.runtime.estimator`` (the reference Estimator,
estimator.cpp): the INITIAL → NON_LINEAR state machine, measurement
handling, the numpy bootstrap (``..vinit``, the port's own copy) with the
online extrinsic-rotation calibration, the per-frame solve with td and
extrinsic estimation, relocalization, the solver's wall-clock budget,
failure detection, marginalization and the window slide, for any window
length and number of cameras.

Division of labour: host mirrors (numpy f64) hold the window and drive the
policy; each frame's device work is two programs in ``cfg.solver_dtype``,
as in the JAX package (``lfvio_tpu/runtime/estimator.py:125-149``): the
solve (unpack, the device state chain, preintegration of all window
intervals, covariance whitening, triangulation, LM, the yaw-gauge fix) and
the QR marginalization, whose prior stays on the device. All host inputs
of a solve travel as ONE packed buffer (the JAX layout, ``_build_pack_layout``)
in one non-blocking copy from a ring of pinned buffers. On the card each
program is a ``device.DeviceProgram``: captured once as a CUDA graph (one
solve graph and one relocalization solve graph, both at the first solve,
before any loop closure, and one graph per marginalization kind, all in
one memory pool) and replayed once per published frame, so dispatching a
frame reads nothing from the card. The LM's iteration cap (the wall
budget's) is the packed ``max_iter``, read on the device: its iterations
and linearizations are conditional nodes, as JAX's ``lax.cond``, so one
graph serves every cap and a skipped iteration launches nothing. On the
CPU the same functions run eagerly.

A dispatched solve is completed (written back, checked, slid) by
:meth:`finalize_solve`. Its results travel to the host as non-blocking
copies into pinned buffers behind one CUDA event, started right after the
replay, and finalize waits on that event only. With ``solve_lag`` > 1 up to
that many solves stay pending: the window slides eagerly at dispatch with
the IMU-propagated mirrors, and a solved window is rebased through the
slides that happened since when it arrives. With ``device_chain`` the next
solve then starts from the previous solve's output on the device (slid, the
new frame propagated) instead of from the stale mirrors; the packed
``use_chain`` / ``marg_prev`` flags select it on the device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..backend import (
    FeatureGrid,
    PriorFactor,
    SolverConfig,
    WindowState,
    lm_solve,
    lm_solve_relo,
    marginalize_old_qr,
    marginalize_second_new_qr,
    triangulate_grid,
    yaw_gauge_fix,
)
from ..backend.factors import projection_residuals_grid
from ..backend.gauge import gauge_apply_pose, yaw_gauge_transform
from ..backend.state import WINDOW  # the default window length only
from ..device import DeviceProgram, Fetch, clone_tree, resolve_device
from ..geom import host as hg
from ..geom import quat_identity
from ..imu import ImuNoise, preintegrate, propagate_interval_midpoint, whiten_covariance
from ..tracing import span
from ..vinit import global_sfm, pnp_bearing_gn, solve_relative_rt, visual_imu_alignment
from ..vinit.alignment import AlignFrame
from ..vinit.ex_rotation import ExtrinsicRotationCalibrator
from .feature_manager import HostFeatureManager


def _norm_deg(a):
    return (a + 180.0) % 360.0 - 180.0


@dataclasses.dataclass
class EstimatorConfig:
    n_feature_slots: int = 256
    # Sliding-window keyframes (reference WINDOW_SIZE, parameters.h:12):
    # every shape (solver layout, grids, priors, IMU buffers) derives from it.
    window: int = WINDOW
    # Cameras in the rig (dual-PAL up+down = 2). tic / ric may be per-camera
    # arrays ([C,3] / [C,3,3]) when n_cams > 1.
    n_cams: int = 1
    max_imu_per_interval: int = 256
    min_parallax: float = 10.0 / 160.0  # keyframe_parallax / FOCAL_LENGTH
    imu_noise: ImuNoise = dataclasses.field(
        default_factory=lambda: ImuNoise(0.02, 0.01, 0.04, 0.001)
    )
    g_norm: float = 9.81
    estimate_td: bool = False
    estimate_extrinsic: bool = False
    # ESTIMATE_EXTRINSIC=2 (estimator.cpp:126-142): start with no knowledge
    # of the extrinsic rotation and hand-eye calibrate it during INITIAL.
    calib_extrinsic_rotation: bool = False
    # Rolling shutter (projection_td_factor.cpp:21-22,53-56): per-observation
    # td_obs = td_meas - TR/ROW * (row - ROW/2). TR = 0: global shutter.
    rolling_shutter_tr: float = 0.0
    image_rows: int = 480
    td0: float = 0.0
    tic: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    ric: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    max_iterations: int = 8
    # Reference wall-clock budget per solve (estimator.cpp:810-825):
    # max_solver_time seconds, x0.8 when marginalizing old; 0 = unlimited.
    # Enforced as an iteration cap: budget / measured time of one LM
    # iteration (calibrate_solver_budget).
    max_solver_time: float = 0.0
    # Frames a solve's result may lag before its values are integrated:
    # 1 = finalize before the next dispatch; 2 or more = the window slides
    # eagerly at dispatch with propagated values, and the solved values are
    # rebased through the slides when they arrive.
    solve_lag: int = 1
    # With solve_lag > 1: seed solve k+1 on the device from solve k's output
    # (slide + IMU propagation of the new frame) instead of from the host's
    # stale propagated mirrors.
    device_chain: bool = True
    solver_dtype: torch.dtype = torch.float32
    device: torch.device | str | None = None  # None: the CUDA card


class Estimator:
    INITIAL, NON_LINEAR = 0, 1

    # Reprojection gate: observations with residuals beyond this (sqrt_info
    # units, 1 px ~ 0.667) would be dropped after the solve. Off by default,
    # as the reference ships removeOutlier disabled
    # (feature_manager.cpp:255-268): the Cauchy loss bounds outliers already.
    GATE_THRESH = 1e9

    def __init__(self, cfg: EstimatorConfig):
        self.cfg = cfg
        self.WIN = int(cfg.window)
        self.NF = self.WIN + 1
        self.device = resolve_device(cfg.device)
        self.scfg = SolverConfig(
            max_iterations=cfg.max_iterations,
            estimate_td=cfg.estimate_td,
            estimate_extrinsic=cfg.estimate_extrinsic,
            n_cams=cfg.n_cams,
        )
        self.gravity = None  # set by the bootstrap
        # Measured time of one LM iteration (calibrate_solver_budget); None
        # until calibrated, and then the wall budget cannot bind.
        self._iter_time = None
        self._pack_layout, self._pack_size = self._build_pack_layout()
        on_card = self.device.type == "cuda"
        if on_card:
            # QR and the batched Cholesky through cuSOLVER: MAGMA's hybrid
            # paths wait for the host and cannot be captured.
            torch.backends.cuda.preferred_linalg_library("cusolver")
        # The device programs, keyed ("solve",), ("relo",), ("marg_old",),
        # ("marg_new",); on the card their graphs share a pool.
        self._programs = {}
        self._pool = torch.cuda.graph_pool_handle() if on_card else None
        # False before the first solve runs the programs eagerly, op for op,
        # on the card too: the reference the graphs are held against.
        self.use_graphs = True
        # solve_lag + 1 pinned upload buffers, each reused once the copy out
        # of it (its event) has completed.
        self._ring = ([[torch.empty(self._pack_size, dtype=cfg.solver_dtype, pin_memory=True),
                        None] for _ in range(max(cfg.solve_lag, 1) + 1)] if on_card else None)
        self._ring_i = 0
        self._gravity_t = self._tensor([0.0, 0.0, cfg.g_norm])
        self._empty_prior_cache = None
        self._zero_chain_cache = None
        # (LM iterations run, linearizations run, relocalization solve) of
        # each finalized solve.
        self.lm_runs = []
        self.clear_state()

    # ------------------------------------------------------------------ state
    def clear_state(self):
        cfg = self.cfg
        W1 = self.NF
        self.Ps = np.zeros((W1, 3))
        self.Qs = np.tile(np.array([1.0, 0, 0, 0]), (W1, 1))
        self.Vs = np.zeros((W1, 3))
        self.Bas = np.zeros((W1, 3))
        self.Bgs = np.zeros((W1, 3))
        tic_in = np.asarray(cfg.tic, np.float64)
        ric_in = np.asarray(cfg.ric, np.float64)
        if cfg.n_cams > 1:
            # One row per camera; a single extrinsic is broadcast.
            if tic_in.ndim == 1:
                tic_in = np.tile(tic_in, (cfg.n_cams, 1))
            if ric_in.ndim == 2:
                ric_in = np.tile(ric_in, (cfg.n_cams, 1, 1))
            self.tic = tic_in.copy()
            self.qic = np.stack([hg.mat_to_quat(R) for R in ric_in])
        else:
            self.tic = tic_in.copy()
            self.qic = hg.mat_to_quat(ric_in)
        self.td = cfg.td0
        self.frame_count = 0
        self.solver_flag = self.INITIAL
        self.first_imu = False
        self.acc_0 = np.zeros(3)
        self.gyr_0 = np.zeros(3)
        # Per-interval IMU: lists (bootstrap) and padded arrays (solve input).
        self.imu_buf = [[] for _ in range(W1)]
        M = cfg.max_imu_per_interval
        self._imu_dts = np.zeros((W1, M))
        self._imu_accs = np.zeros((W1, M, 3))
        self._imu_gyrs = np.zeros((W1, M, 3))
        self._imu_n = np.zeros(W1, np.int64)
        self._imu_sumdt = np.zeros(W1)
        self._imu_a0 = np.zeros((W1, 3))
        self._imu_g0 = np.zeros((W1, 3))
        self.tmp_imu_buf = []
        self.tmp_start = None
        self.fm = HostFeatureManager(cfg.n_feature_slots, W1)
        self.all_frames = []
        self.prior = None
        self.headers = np.zeros(W1)
        self.times = []
        self.traj_p = []
        self.traj_q = []
        self.failure_occur = False
        self.last_P = np.zeros(3)
        self.last_R = np.eye(3)
        self.last_P0 = np.zeros(3)
        self.last_R0 = np.eye(3)
        self.initial_timestamp = -1e18
        self.marg_old = True
        # Online extrinsic-rotation calibration (ESTIMATE_EXTRINSIC=2).
        self.ex_calib = ExtrinsicRotationCalibrator()
        self.extrinsic_calibrated = not cfg.calib_extrinsic_rotation
        # Dispatched, not yet finalized solves, oldest first; at most
        # cfg.solve_lag of them.
        self._pending_q = []
        # Device state chain: the previous solve's output window and the
        # kind of the eager slide that followed it. None: the next solve is
        # seeded from the host mirrors (start, restart, failure, relo).
        self._chain = None
        # Relocalization (estimator_node.cpp:261-285).
        self.relo_relative_t = None
        self.relo_relative_q = None
        self.relo_relative_yaw = None
        self.relo_frame_stamp = None
        self._relo_active = None  # armed loop match for the next solve
        # Under a solve lag: the landmarks of the last finalized solve,
        # (feature ids [F], world points [F, 3], which are known [F]), the
        # points set_relo_frame seeds its PnP from (see there).
        self._solved_points = None

    def _tic0(self):
        """Primary camera's extrinsic translation: the host geometry paths
        (bootstrap, relo, slide re-anchoring) work on camera 0."""
        return self.tic if self.tic.ndim == 1 else self.tic[0]

    def _ric0(self):
        return hg.quat_to_mat(self.qic if self.qic.ndim == 1 else self.qic[0])

    # ------------------------------------------------------------------- IMU
    def process_imu(self, dt, acc, gyr):
        """Estimator::processIMU (estimator.cpp:86-120): buffer + midpoint
        propagation of the newest window frame."""
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        if not self.first_imu:
            self.first_imu = True
            self.acc_0, self.gyr_0 = acc, gyr
        j = self.frame_count
        if j != 0:
            self.imu_buf[j].append((dt, acc.copy(), gyr.copy()))
            self.tmp_imu_buf.append((dt, acc.copy(), gyr.copy()))
            n = self._imu_n[j]
            if n == 0:
                # The interval starts at the previous stream sample.
                self._imu_a0[j] = self.acc_0
                self._imu_g0[j] = self.gyr_0
            if n < self._imu_dts.shape[1]:
                self._imu_dts[j, n] = dt
                self._imu_accs[j, n] = acc
                self._imu_gyrs[j, n] = gyr
                self._imu_n[j] = n + 1
            self._imu_sumdt[j] += dt
            self.Ps[j], self.Qs[j], self.Vs[j] = self._midpoint_step(
                self.Ps[j], self.Qs[j], self.Vs[j], self.Bas[j], self.Bgs[j],
                self.acc_0, self.gyr_0, acc, gyr, dt)
        self.acc_0, self.gyr_0 = acc, gyr

    def _midpoint_step(self, P, Q, V, Ba, Bg, acc0, gyr0, acc, gyr, dt):
        """One world-frame midpoint propagation step on the host."""
        g = np.array([0.0, 0.0, self.cfg.g_norm])
        un_acc_0 = hg.quat_to_mat(Q) @ (acc0 - Ba) - g
        un_gyr = 0.5 * (gyr0 + gyr) - Bg
        Q = hg.quat_normalize(hg.quat_mul(Q, hg.so3_exp(un_gyr * dt)))
        un_acc_1 = hg.quat_to_mat(Q) @ (acc - Ba) - g
        un_acc = 0.5 * (un_acc_0 + un_acc_1)
        return P + dt * V + 0.5 * dt * dt * un_acc, Q, V + dt * un_acc

    # ------------------------------------------------------- device inputs
    def _tensor(self, a, dtype=None):
        """A copy of host data on the solve device (never a view of a host
        mirror, which the slide ops mutate in place)."""
        return torch.tensor(
            np.asarray(a), dtype=dtype or self.cfg.solver_dtype, device=self.device
        )

    def _device_state(self):
        inv_depth = np.where(self.fm.depth > 0, 1.0 / np.maximum(self.fm.depth, 1e-6), 1.0)
        t = self._tensor
        return WindowState(
            p=t(self.Ps), q=t(self.Qs), v=t(self.Vs), ba=t(self.Bas), bg=t(self.Bgs),
            tic=t(self.tic), qic=t(self.qic), td=t(self.td), inv_depth=t(inv_depth),
        )

    def _device_grid(self):
        fm, t = self.fm, self._tensor
        return FeatureGrid(
            bearing=t(fm.bearing), velocity=t(fm.velocity), td_obs=t(fm.td_obs),
            valid=t(fm.valid, torch.bool), anchor=t(fm.anchor, torch.int64),
            used=t(fm.used_mask(), torch.bool),
            cam=t(fm.cam, torch.int64) if self.cfg.n_cams > 1 else None,
        )

    def _apply_chain(self, state, chain, marg_prev, dts, accs, gyrs, a0, g0):
        """The window that seeds the LM when the device chain is on: the
        previous solve's output ``chain`` advanced on the device. The eager
        slide that followed it is applied (shift for MARGIN_OLD, newest-merge
        for SECOND_NEW; ``marg_prev`` a bool or a device flag) and the new
        frame (slot W) is midpoint-propagated from the previous newest frame
        over the newest interval's samples: row W−1 of the padded window
        holds exactly the samples since the previous dispatch after either
        slide (the SECOND_NEW merge lands in row W−2). Inverse depths stay
        the host's."""
        cp, cq, cv, cba, cbg, ctic, cqic, ctd = chain
        W = self.WIN

        def shift(a):
            old = torch.cat([a[1:], a[-1:]], dim=0)
            new = a.clone()
            new[W - 1] = a[W]
            if isinstance(marg_prev, bool):
                return old if marg_prev else new
            return torch.where(marg_prev, old, new)

        p2, q2, v2, ba2, bg2 = (shift(x) for x in (cp, cq, cv, cba, cbg))
        # Post-slide slot W still holds the previous newest frame.
        p2[W], q2[W], v2[W] = propagate_interval_midpoint(
            p2[W], q2[W], v2[W], dts[W - 1], accs[W - 1], gyrs[W - 1],
            a0[W - 1], g0[W - 1], ba2[W], bg2[W], self._gravity_t,
        )
        return WindowState(p=p2, q=q2, v=v2, ba=ba2, bg=bg2, tic=ctic, qic=cqic,
                           td=ctd, inv_depth=state.inv_depth)

    def _solve_step(self, state, grid, imu, prior, has_depth, origin_p0, origin_q0, limit,
                    relo=None):
        """The per-frame solve (solveOdometry + double2vector,
        estimator.cpp:475-515, 532-626): preintegrate every window interval
        at its start frame's biases, whiten, triangulate new features, LM
        (with the loop pose as a free block when ``relo`` = (p, q, bearing,
        mask) tensors is given, estimator.cpp:777-808), yaw-gauge fix.
        ``limit`` (the packed ``max_iter``, a device scalar) caps the LM's
        iterations. Returns a dict with the solved state, the LM's
        iterations and linearizations run (``lm_runs``) and the
        intermediates the MARGIN_OLD prior needs."""
        dts, accs, gyrs, a0, g0, imu_valid = imu
        gravity = self._gravity_t
        pre = preintegrate(dts, accs, gyrs, a0, g0, state.ba[:-1], state.bg[:-1],
                           self.cfg.imu_noise)
        sqrt_info, imu_valid = whiten_covariance(pre.covariance, imu_valid)
        state = state.replace(inv_depth=triangulate_grid(state, grid, has_depth))
        res = dict(pre=pre, sqrt_info=sqrt_info, imu_ok=imu_valid,
                   rn=None, rvalid=None, relo_p=None, relo_q=None)
        if relo is None:
            out, _, _, _, iters, lins = lm_solve(state, grid, pre, sqrt_info, imu_valid, prior,
                                                 gravity, self.scfg, limit=limit, counts=True)
        else:
            out, rp, rq, _, _, iters, lins = lm_solve_relo(
                state, grid, pre, sqrt_info, imu_valid, prior, gravity, self.scfg,
                *relo, limit=limit, counts=True,
            )
            # The loop pose rides the window's gauge correction
            # (estimator.cpp:605-611).
            rot, pivot = yaw_gauge_transform(out, origin_p0, origin_q0)
            res["relo_p"], res["relo_q"] = gauge_apply_pose(rot, pivot, origin_p0, rp, rq)
        out = yaw_gauge_fix(out, origin_p0, origin_q0)
        res["lm_runs"] = torch.stack([iters, lins])
        if relo is None and self.GATE_THRESH < 1e8:
            r, res["rvalid"] = projection_residuals_grid(out, grid, self.scfg.proj_sqrt_info)
            res["rn"] = torch.linalg.norm(r, dim=-1)
        res["out"] = out
        return res

    # ------------------------------------------------------- packed upload
    def _build_pack_layout(self):
        """Static layout of the ONE per-solve host→device buffer (the JAX
        package's entries, order and sizes): every solve input (window state,
        feature grid, padded IMU window, gauge origin, the iteration limit,
        the chain flags, relo extras) flattened into one solver-dtype vector.
        Bools ride as 0/1, int indices as exact small floats."""
        cfg = self.cfg
        F, W1, W, M, C = (cfg.n_feature_slots, self.NF, self.WIN,
                          cfg.max_imu_per_interval, cfg.n_cams)
        entries = [
            ("p", (W1, 3)), ("q", (W1, 4)), ("v", (W1, 3)),
            ("ba", (W1, 3)), ("bg", (W1, 3)),
            ("tic", (C, 3) if C > 1 else (3,)),
            ("qic", (C, 4) if C > 1 else (4,)),
            ("td", ()), ("inv_depth", (F,)),
            ("g_bearing", (F, W1, 3)), ("g_velocity", (F, W1, 3)),
            ("g_td_obs", (F, W1)), ("g_valid", (F, W1)),
            ("g_anchor", (F,)), ("g_used", (F,)),
            ("g_cam", (F, W1) if C > 1 else (0,)),
            ("dts", (W, M)), ("accs", (W, M, 3)), ("gyrs", (W, M, 3)),
            ("a0", (W, 3)), ("g0", (W, 3)), ("imu_valid", (W,)),
            ("has_depth", (F,)), ("origin_p0", (3,)), ("origin_q0", (4,)),
            ("max_iter", ()),
            # The device chain: use_chain selects the advanced previous
            # solve over the packed host state; marg_prev is the kind of the
            # eager slide that followed that solve.
            ("use_chain", ()), ("marg_prev", ()),
            ("relo_p", (3,)), ("relo_q", (4,)),
            ("relo_bearing", (F, 3)), ("relo_mask", (F,)),
        ]
        layout, off = {}, 0
        for name, shape in entries:
            n = int(np.prod(shape)) if shape else 1
            layout[name] = (off, shape)
            off += n
        return layout, off

    def _pack_solve_buffer(self, origin_p0, origin_q0, relo=None, chain_flags=None):
        """A fresh packed buffer (numpy, solver dtype) from the host mirrors."""
        cfg, fm, L = self.cfg, self.fm, self._pack_layout
        buf = np.zeros(self._pack_size, np.dtype(str(cfg.solver_dtype).split(".")[-1]))

        def put(name, val):
            off, shape = L[name]
            n = int(np.prod(shape)) if shape else 1
            buf[off:off + n] = np.asarray(val, buf.dtype).ravel()

        put("p", self.Ps)
        put("q", self.Qs)
        put("v", self.Vs)
        put("ba", self.Bas)
        put("bg", self.Bgs)
        put("tic", self.tic)
        put("qic", self.qic)
        put("td", self.td)
        put("inv_depth", np.where(fm.depth > 0, 1.0 / np.maximum(fm.depth, 1e-6), 1.0))
        put("g_bearing", fm.bearing)
        put("g_velocity", fm.velocity)
        put("g_td_obs", fm.td_obs)
        put("g_valid", fm.valid)
        put("g_anchor", fm.anchor)
        put("g_used", fm.used_mask())
        if cfg.n_cams > 1:
            put("g_cam", fm.cam)
        put("dts", self._imu_dts[1:])
        put("accs", self._imu_accs[1:])
        put("gyrs", self._imu_gyrs[1:])
        put("a0", self._imu_a0[1:])
        put("g0", self._imu_g0[1:])
        put("imu_valid", (self._imu_n[1:] > 0) & (self._imu_sumdt[1:] < 10.0))
        put("has_depth", fm.depth > 0)
        put("origin_p0", origin_p0)
        put("origin_q0", origin_q0)
        put("max_iter", self._iterations_allowed())
        if chain_flags is not None:
            put("use_chain", float(chain_flags[0]))
            put("marg_prev", float(chain_flags[1]))
        if relo is not None:
            put("relo_p", relo["p"])
            put("relo_q", relo["q"])
            put("relo_bearing", relo["bearing"])
            put("relo_mask", relo["mask"])
        return buf

    def _upload(self, buf):
        """The packed buffer on the solve device: on the card one
        non-blocking copy out of the next pinned ring buffer (waiting only if
        that buffer's previous copy has not completed yet)."""
        if self._ring is None:
            return torch.from_numpy(buf).to(self.device)
        slot = self._ring[self._ring_i]
        self._ring_i = (self._ring_i + 1) % len(self._ring)
        host, event = slot
        if event is not None and not event.query():
            event.synchronize()
        host.numpy()[:] = buf
        packed = host.to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return packed

    def _unpack(self, packed):
        """The solve's inputs from the packed buffer (views of it). Returns
        (state, grid, imu, (has_depth, origin_p0, origin_q0, max_iter),
        (relo_p, relo_q, relo_bearing, relo_mask), use_chain, marg_prev)."""
        L = self._pack_layout

        def get(name):
            off, shape = L[name]
            n = int(np.prod(shape)) if shape else 1
            return packed[off:off + n].reshape(shape)

        state = WindowState(
            p=get("p"), q=get("q"), v=get("v"), ba=get("ba"), bg=get("bg"),
            tic=get("tic"), qic=get("qic"), td=get("td"), inv_depth=get("inv_depth"),
        )
        grid = FeatureGrid(
            bearing=get("g_bearing"), velocity=get("g_velocity"), td_obs=get("g_td_obs"),
            valid=get("g_valid") > 0.5, anchor=get("g_anchor").to(torch.int64),
            used=get("g_used") > 0.5,
            cam=get("g_cam").to(torch.int64) if self.cfg.n_cams > 1 else None,
        )
        imu = (get("dts"), get("accs"), get("gyrs"), get("a0"), get("g0"),
               get("imu_valid") > 0.5)
        misc = (get("has_depth") > 0.5, get("origin_p0"), get("origin_q0"),
                get("max_iter").to(torch.int32))
        relo = (get("relo_p"), get("relo_q"), get("relo_bearing"), get("relo_mask") > 0.5)
        return state, grid, imu, misc, relo, get("use_chain") > 0.5, get("marg_prev") > 0.5

    # ------------------------------------------------------ device programs
    def _solve_packed_impl(self, packed, prior, chain):
        """The solve program: unpack, the device chain selected by the packed
        flags, then the solve. Returns (solve dict, grid)."""
        state, grid, imu, misc, _, use, marg_prev = self._unpack(packed)
        has_depth, op0, oq0, mi = misc
        chained = self._apply_chain(state, chain, marg_prev, *imu[:5])
        sel = lambda a, b: torch.where(use, a, b)
        state = WindowState(
            p=sel(chained.p, state.p), q=sel(chained.q, state.q), v=sel(chained.v, state.v),
            ba=sel(chained.ba, state.ba), bg=sel(chained.bg, state.bg),
            tic=sel(chained.tic, state.tic), qic=sel(chained.qic, state.qic),
            td=sel(chained.td, state.td), inv_depth=state.inv_depth,
        )
        # Gauge origin: pre-solve frame 0 of whichever state seeds the LM.
        op0, oq0 = sel(chained.p[0], op0), sel(chained.q[0], oq0)
        return self._solve_step(state, grid, imu, prior, has_depth, op0, oq0, mi), grid

    def _solve_relo_packed_impl(self, packed, prior):
        """The relocalization solve program (the D+6 system)."""
        state, grid, imu, misc, relo, _, _ = self._unpack(packed)
        has_depth, op0, oq0, mi = misc
        return self._solve_step(state, grid, imu, prior, has_depth, op0, oq0, mi,
                                relo=relo), grid

    def _marg_old_impl(self, out, grid, pre, sqrt_info, imu_ok, prior):
        """The MARGIN_OLD program (estimator.cpp:832-948)."""
        return marginalize_old_qr(out, grid, pre, sqrt_info, imu_ok, prior, self._gravity_t,
                                  self.scfg)

    def _marg_new_impl(self, out, prior):
        """The MARGIN_SECOND_NEW program (estimator.cpp:949-1005)."""
        return marginalize_second_new_qr(out, prior, self.scfg)

    def _program(self, key):
        """The device program of ``key``, made at first use (on the card its
        graph is captured at its first call)."""
        prog = self._programs.get(key)
        if prog is None:
            fn = {"solve": self._solve_packed_impl, "relo": self._solve_relo_packed_impl,
                  "marg_old": self._marg_old_impl, "marg_new": self._marg_new_impl}[key[0]]
            prog = DeviceProgram(fn, pool=self._pool, name=key[0])
            self._programs[key] = prog if self.use_graphs else fn
        return self._programs[key]

    def graph_stats(self):
        """(graphs captured, their capture seconds in all)."""
        caps = [p.capture_s for p in self._programs.values()
                if isinstance(p, DeviceProgram) and p.graph is not None]
        return len(caps), float(sum(caps))

    def _zero_chain(self):
        """A finite stand-in chain (identity rotations) for solves that do
        not chain: the packed flag deselects it on the device."""
        if self._zero_chain_cache is None:
            sd, dev, W1, C = self.cfg.solver_dtype, self.device, self.NF, self.cfg.n_cams
            z = lambda *sh: torch.zeros(sh, dtype=sd, device=dev)
            unit_q = quat_identity(sd, dev)
            self._zero_chain_cache = (
                z(W1, 3), unit_q.repeat(W1, 1), z(W1, 3), z(W1, 3), z(W1, 3),
                z(3) if C == 1 else z(C, 3), unit_q if C == 1 else unit_q.repeat(C, 1), z(),
            )
        return self._zero_chain_cache

    def _empty_prior(self):
        if self._empty_prior_cache is None:
            self._empty_prior_cache = PriorFactor.empty(self.cfg.solver_dtype, self.NF,
                                                        self.device, self.cfg.n_cams)
        return self._empty_prior_cache

    # ------------------------------------------------------------------ frame
    def process_image_arrays(self, ids, bearings, vels, rows, mask, t: float,
                             defer_solve=False, td_pair=None, cams=None):
        """Estimator::processImage (estimator.cpp:122-220), array interface.

        ids/bearings/vels/rows: per-slot arrays from FrontEnd.process_arrays;
        mask selects the published observations; cams is the per-observation
        camera id of a multi-camera front end. td_pair is the td the
        pipeline paired IMU with.

        Every pending solve is finalized before the call returns, so that a
        direct caller reads this frame's pose. defer_solve=True dispatches
        the frame's solve and leaves it for :meth:`finalize_solve`: the
        pipeline finalizes it ``solve_lag`` frames later and on flush, and
        mutates no estimator state in between (it queues IMU for replay).
        """
        with span("est.image", t):
            cfg = self.cfg
            sel = np.where(np.asarray(mask))[0]
            ids_s = np.asarray(ids)[sel]
            b_s = np.asarray(bearings)[sel]
            v_s = np.asarray(vels)[sel]
            # td_obs records the td used for the IMU pairing (finalize_solve may
            # have moved self.td since) minus the rolling-shutter row term.
            td_rec = self.td if td_pair is None else td_pair
            tr = cfg.rolling_shutter_tr
            if tr != 0.0:
                rows_s = np.asarray(rows, np.float64)[sel]
                tds = td_rec - (tr / cfg.image_rows) * (rows_s - cfg.image_rows / 2.0)
            else:
                tds = np.full(len(sel), td_rec)
            cams_s = None if cams is None else np.asarray(cams, np.int32)[sel]
            with span("est.features"):
                self.marg_old = self.fm.add_frame_arrays(
                    self.frame_count, ids_s, b_s, v_s, tds, cfg.min_parallax, cams=cams_s
                )

            # Online extrinsic-rotation calibration during INITIAL
            # (estimator.cpp:126-142): hand-eye on frame-pair rotations until
            # the calibrator's excitation gate passes.
            if (not self.extrinsic_calibrated and self.frame_count != 0
                    and self.solver_flag == self.INITIAL):
                b1, b2, _ = self.fm.corresponding(self.frame_count - 1, self.frame_count)
                if len(b1) >= 9:
                    pre = self._np_preint(self.imu_buf[self.frame_count])
                    if pre is not None:
                        done, ric = self.ex_calib.add_pair(b1, b2, pre["delta_q"])
                        if done:
                            if self.qic.ndim == 2:
                                self.qic[0] = hg.mat_to_quat(ric)
                            else:
                                self.qic = hg.mat_to_quat(ric)
                            self.extrinsic_calibrated = True

            self.headers[self.frame_count] = t
            if self.solver_flag == self.INITIAL:
                # all_frames feeds the one-shot SfM/alignment bootstrap only.
                self.all_frames.append(dict(
                    t=t, feats={int(f): b for f, b in zip(ids_s, b_s)},
                    imu=list(self.tmp_imu_buf), is_key=False,
                    imu_start=None if self.tmp_start is None
                    else (self.tmp_start[0].copy(), self.tmp_start[1].copy()),
                ))
            else:
                self.all_frames = []
            self.tmp_imu_buf = []
            self.tmp_start = (self.acc_0.copy(), self.gyr_0.copy())

            if self.solver_flag == self.INITIAL:
                if self.frame_count == self.WIN:
                    ok = False
                    # The bootstrap needs a trusted extrinsic rotation
                    # (estimator.cpp:152).
                    if self.extrinsic_calibrated and t - self.initial_timestamp > 0.1:
                        ok = self._initial_structure()
                        self.initial_timestamp = t
                    if ok:
                        self.solver_flag = self.NON_LINEAR
                        self._dispatch_solve(t, first=True)
                        if not defer_solve:
                            while self._pending_q:
                                self.finalize_solve()
                    else:
                        self._slide_window()
                else:
                    self.frame_count += 1
                    j = self.frame_count  # the new frame starts where the last is
                    for a in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs):
                        a[j] = a[j - 1]
            else:
                self._dispatch_solve(t, first=False)
                if not defer_solve:
                    while self._pending_q:
                        self.finalize_solve()

    def process_image(self, feats: dict, t: float):
        """Dict interface: feats id -> (bearing3, vel3, row)."""
        n = len(feats)
        ids = np.fromiter(feats.keys(), np.int64, count=n)
        bearings = (np.stack([np.asarray(v[0]) for v in feats.values()])
                    if n else np.zeros((0, 3)))
        vels = (np.stack([np.asarray(v[1]) for v in feats.values()])
                if n else np.zeros((0, 3)))
        rows = np.asarray([v[2] for v in feats.values()])
        return self.process_image_arrays(ids, bearings, vels, rows, np.ones(n, bool), t)

    # ------------------------------------------------------------------ relo
    def _header_index(self, stamp, n):
        idx = None
        for i in range(n):
            if abs(self.headers[i] - stamp) < 1e-7:
                idx = i
        return idx

    def _set_relo_outputs(self, idx, relo_t, relo_r, prev_p, prev_q):
        """relo_relative_t/q/yaw and the drift correction from a loop pose
        (double2vector, estimator.cpp:605-624)."""
        R_idx = hg.quat_to_mat(self.Qs[idx])
        self.relo_relative_t = relo_r.T @ (self.Ps[idx] - relo_t)
        self.relo_relative_q = hg.mat_to_quat(relo_r.T @ R_idx)
        yaw_r = float(hg.R_to_ypr_deg(relo_r)[0])
        self.relo_relative_yaw = _norm_deg(float(hg.R_to_ypr_deg(R_idx)[0]) - yaw_r)
        dy = _norm_deg(float(hg.R_to_ypr_deg(hg.quat_to_mat(prev_q))[0]) - yaw_r)
        self.drift_correct_r = hg.ypr_deg_to_R([dy, 0.0, 0.0])
        self.drift_correct_t = prev_p - self.drift_correct_r @ relo_t

    def set_relo_frame(self, frame_stamp, match_ids, match_bearings, prev_relo_p,
                       prev_relo_q):
        """The estimator side of a loop closure (setReloFrame,
        estimator.cpp:1133-1152, fed from estimator_node.cpp:261-285).

        ``frame_stamp`` must match a window keyframe header;
        ``match_ids`` / ``match_bearings`` are the loop frame's matched
        feature ids and unit bearings (old camera frame); (``prev_relo_p``,
        ``prev_relo_q``) is the loop frame's pose in the pose-graph world.

        A bearing-space PnP of the loop frame against the window's
        triangulated landmarks seeds the loop pose at once (this method's
        outputs); the next frame's solve takes the loop pose as a free
        6-dim block with one relo row per matched feature (backend/relo.py),
        and the refined outputs land at that solve's finalize. Returns True
        when a drift estimate was produced.

        The landmarks: at solve lag 1 the host depths at the anchors (the
        reference's); under a solve lag, the last finalized solve's points
        (``_landmarks``). A lagged write-back keeps no solved depth of a
        feature re-anchored since its dispatch (a MARGIN_OLD slide
        re-anchors every feature of frame 0, and with one every frame none
        is ever written back), so those host depths stay the re-anchored
        initial ones: at 640x480 on the bench's stream a median 0.13 of the
        solved depths, which PnP cannot fit."""
        idx = self._header_index(frame_stamp, self.WIN)
        if idx is None or self.solver_flag != self.NON_LINEAR:
            return False
        ric, tic0 = self._ric0(), self._tic0()
        pw, bb = [], []
        relo_bearing = np.zeros((self.cfg.n_feature_slots, 3))
        relo_mask = np.zeros(self.cfg.n_feature_slots, bool)
        match_bearings = np.asarray(match_bearings, np.float64)
        solved = None
        if self.cfg.solve_lag > 1 and self._solved_points is not None:
            ids, pts, known = self._solved_points
            solved = {int(i): x for i, x in zip(ids[known], pts[known])}
        for fid, b_old in zip(np.asarray(match_ids, np.int64), match_bearings):
            s = self.fm._id2slot.get(int(fid), -1)
            if s < 0 or self.fm.depth[s] <= 0:
                continue
            if solved is None:
                a = int(self.fm.anchor[s])
                p_cam = self.fm.bearing[s, a] * self.fm.depth[s]
                pw.append(hg.quat_to_mat(self.Qs[a]) @ (ric @ p_cam + tic0) + self.Ps[a])
            elif int(fid) in solved:
                pw.append(solved[int(fid)])
            else:
                continue
            b_u = b_old / max(np.linalg.norm(b_old), 1e-12)
            bb.append(b_u)
            relo_bearing[s] = b_u
            relo_mask[s] = True
        if len(pw) < 6:
            return False

        # Seed from the matched window frame (the reference seeds relo_Pose
        # with para_Pose[i]); solve the loop frame's camera pose in the VIO
        # world.
        R_wi = hg.quat_to_mat(self.Qs[idx])
        R_wc0 = R_wi @ ric
        t_wc0 = self.Ps[idx] + R_wi @ tic0
        R_cw, t_cw, ok = pnp_bearing_gn(np.stack(pw), np.stack(bb), R_wc0.T, -R_wc0.T @ t_wc0)
        if not ok:
            return False
        R_wc = R_cw.T
        relo_r = R_wc @ ric.T  # loop frame's IMU pose in the VIO world
        relo_t = -R_wc @ t_cw - relo_r @ tic0
        prev_p = np.asarray(prev_relo_p, np.float64).copy()
        prev_q = np.asarray(prev_relo_q, np.float64).copy()
        self._set_relo_outputs(idx, relo_t, relo_r, prev_p, prev_q)
        self.relo_frame_stamp = frame_stamp
        # Arm the relo solve for the next frame; one-shot, like the reference
        # (relocalization_info is cleared in double2vector).
        self._relo_active = dict(
            bearing=relo_bearing, mask=relo_mask, p=relo_t.copy(),
            q=hg.mat_to_quat(relo_r), stamp=float(frame_stamp), prev_p=prev_p,
            prev_q=prev_q,
            # Slots can be freed and refilled before the solve: it re-checks
            # that each masked slot still holds the same feature.
            snap_ids=self.fm.feature_id.copy(),
        )
        return True

    def _finalize_relo(self, meta, relo_p, relo_q):
        """Relative-pose outputs from the jointly refined loop pose; runs at
        the relo solve's finalize, before the window slides."""
        idx = self._header_index(meta["stamp"], self.NF)
        if idx is None:
            return
        self._set_relo_outputs(idx, relo_p, hg.quat_to_mat(relo_q), meta["prev_p"],
                               meta["prev_q"])

    # ----------------------------------------------------------------- solve
    def _iterations_allowed(self) -> int:
        """LM iteration cap for the reference's real-time wall budget
        (estimator.cpp:810-825): max_solver_time seconds per solve, x0.8
        when marginalizing old. Uncalibrated or budget <= 0: the static
        cap."""
        cfg = self.cfg
        if cfg.max_solver_time <= 0 or not self._iter_time:
            return cfg.max_iterations
        budget = cfg.max_solver_time * (0.8 if self.marg_old else 1.0)
        return int(np.clip(budget / self._iter_time, 1, cfg.max_iterations))

    def calibrate_solver_budget(self, n=4):
        """Measure the time of one LM iteration so that max_solver_time can
        bind: the solve program with the packed cap at 1 against it at
        max_iterations (on the card, replays of its one graph), n runs each on
        the host's clock around a device synchronize; the fixed cost cancels
        in the difference. Each run perturbs the window positions so the
        iterations do real work (a converged window stops at the cost
        plateau). Reads the estimator only (its chain and prior are copies
        no replay overwrites); costs 2(n+1) solves."""
        if self.frame_count < self.WIN or self.solver_flag != self.NON_LINEAR:
            return None
        prior = self.prior if self.prior is not None else self._empty_prior()
        packed = self._pack_solve_buffer(self.Ps[0], self.Qs[0])
        L = self._pack_layout
        off_mi = L["max_iter"][0]
        off_p, shape_p = L["p"]
        n_p = int(np.prod(shape_p))

        def run(max_iter, seed):
            b = packed.copy()
            b[off_mi] = max_iter
            b[off_p:off_p + n_p] += np.random.default_rng(seed).normal(0.0, 0.05, n_p)
            return self._program(("solve",))(self._upload(b), prior, self._zero_chain())

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        for mi in (1, self.cfg.max_iterations):  # captured and warm at both caps
            run(mi, 0)
        sync()
        t0 = time.perf_counter()
        for i in range(n):
            run(1, 1 + i)
        sync()
        t1 = time.perf_counter()
        for i in range(n):
            run(self.cfg.max_iterations, 1 + i)
        sync()
        t2 = time.perf_counter()
        iters = max(self.cfg.max_iterations - 1, 1)
        self._iter_time = max(((t2 - t1) - (t1 - t0)) / (n * iters), 1e-7)
        return self._iter_time

    def _dispatch_solve(self, t: float, first: bool = False):
        """Enqueue the frame's solve and marginalization programs and the
        result's copies to the host, without waiting for the device: pack,
        one upload, one replay per program, one fetch behind an event. The
        host-side completion waits for :meth:`finalize_solve`."""
        if self.frame_count < self.WIN:
            return
        with span("est.dispatch", t):
            while len(self._pending_q) >= max(self.cfg.solve_lag, 1):
                self.finalize_solve()  # for direct use without the pipeline
            prior = self.prior if self.prior is not None else self._empty_prior()
            # Gauge origin: pre-solve frame 0, or the last good pose after a
            # detected failure (estimator.cpp:536-547).
            if self.failure_occur:
                origin_p0, origin_q0 = self.last_P0, hg.mat_to_quat(self.last_R0)
                self.failure_occur = False
            else:
                origin_p0, origin_q0 = self.Ps[0], self.Qs[0]

            relo = self._relo_active if not first else None
            if relo is not None:
                # Only slots still holding the feature seen at set_relo_frame.
                relo = dict(relo, mask=relo["mask"] & (self.fm.feature_id == relo["snap_ids"]))
            lagged = self.cfg.solve_lag > 1
            chain_on = (self.cfg.device_chain and lagged and self._chain is not None
                        and relo is None and not first)
            with span("est.pack"):
                buf = self._pack_solve_buffer(
                    origin_p0, origin_q0, relo=relo,
                    chain_flags=(chain_on, self._chain["marg"] if chain_on else False))
            with span("est.upload"):
                packed = self._upload(buf)
            if relo is not None:
                res, grid = self._program(("relo",))(packed, prior)
            else:
                chain = self._chain["state"] if chain_on else self._zero_chain()
                res, grid = self._program(("solve",))(packed, prior, chain)
            out = res["out"]
            # The copies to the host start now, before any other replay can
            # overwrite the program's outputs.
            fetch = Fetch([out.p, out.q, out.v, out.ba, out.bg, out.tic, out.qic, out.td,
                           out.inv_depth, res["rn"], res["rvalid"], res["relo_p"], res["relo_q"],
                           res["lm_runs"]])
            relo_meta = None
            if relo is not None:
                relo_meta = dict(stamp=relo["stamp"], prev_p=relo["prev_p"], prev_q=relo["prev_q"])
                self._relo_active = None  # one-shot
            # Arm the chain for the next dispatch (its advance needs a copy of
            # this output and the kind of the eager slide below); a relo solve
            # breaks it.
            if self.cfg.device_chain and lagged and relo is None:
                self._chain = dict(
                    state=clone_tree((out.p, out.q, out.v, out.ba, out.bg, out.tic, out.qic,
                                      out.td)),
                    marg=bool(self.marg_old),
                )
            else:
                self._chain = None
            if self.marg_old:
                new_prior = self._program(("marg_old",))(out, grid, res["pre"], res["sqrt_info"],
                                                        res["imu_ok"], prior)
            else:
                new_prior = self._program(("marg_new",))(out, prior)
            with span("est.prior_copy"):
                self.prior = clone_tree(new_prior)  # the next solve's input, kept off the graphs
            if relo is None:
                self._capture_relo(packed, prior)
            pend = dict(
                fetch=fetch, t=t, first=first, relo=relo_meta, eager_slid=lagged,
                slides=[],  # slides that happen after this dispatch
                # Which depths a lagged write-back may touch: slots can re-anchor
                # or change hands between dispatch and finalize.
                snap_id=self.fm.feature_id.copy(),
                snap_anchor=self.fm.anchor.copy(),
                snap_used=np.asarray(self.fm.used_mask()).copy(),
            )
            if lagged:  # each slot's anchor bearing, for the solve's landmarks
                pend["snap_bearing"] = self.fm.bearing[np.arange(len(self.fm.anchor)),
                                                       self.fm.anchor].copy()
            self._pending_q.append(pend)
            if lagged:
                # Slide now with the propagated (pre-solve) mirrors, so the next
                # frame's bookkeeping goes on without the result; every pending
                # solve records the slide.
                marg = bool(self.marg_old)
                with span("est.slide"):
                    self._slide_window()
                for p_ in self._pending_q:
                    p_["slides"].append(marg)

    def _capture_relo(self, packed, prior):
        """On the card, once: the relocalization program made and captured
        now, behind the solve's fetch, its marginalization
        and their copies, so that the first loop closure replays a graph
        instead of holding the frame loop for the program's warm-up and
        capture. It runs on a copy of this solve's packed buffer with no
        match (``relo_mask`` all 0, the loop pose at the identity) and its
        outputs are dropped: it touches no estimator state. (Its static
        outputs share the pool, so a later replay of any program may
        overwrite them, as they may overwrite each other's.) The packed cap
        is read on the device, so this graph serves every loop closure.
        Nothing on the CPU, or with ``use_graphs`` off."""
        if self.device.type != "cuda" or not self.use_graphs or ("relo",) in self._programs:
            return
        L = self._pack_layout
        buf = packed.clone()
        (m, (F,)), (q, _) = L["relo_mask"], L["relo_q"]
        buf[m:m + F].zero_()
        buf[q:q + 4].zero_()
        buf[q:q + 1].fill_(1.0)
        self._program(("relo",))(buf, prior)

    def pending_count(self):
        return len(self._pending_q)

    def finalize_solve(self):
        """Complete the oldest pending solve: wait for its copies, write
        back, failure detection, window slide (unless it happened at
        dispatch), trajectory record."""
        if not self._pending_q:
            return
        pend = self._pending_q.pop(0)
        with span("est.finalize", pend["t"]):
            with span("est.wait"):
                host = [a if a is None or a.dtype.kind != "f" else a.astype(np.float64)
                        for a in pend["fetch"].numpy()]
            state_host, (rn, rvalid, relo_p, relo_q, lm_runs) = host[:9], host[9:]
            self.lm_runs.append((int(lm_runs[0]), int(lm_runs[1]), pend["relo"] is not None))
            with span("est.write_back"):
                if pend["eager_slid"]:
                    self._write_back_lagged(pend, state_host)
                    self._solved_points = self._landmarks(pend, state_host)
                else:
                    self._write_back(*state_host)
            if relo_p is not None and pend["relo"] is not None:
                self._finalize_relo(pend["relo"], relo_p, relo_q)
            if rn is not None and not pend["eager_slid"]:
                self._gate_observations(rn, rvalid)
            if not pend["first"] and self._failure_detection():
                self.failure_occur = True
                self.clear_state()
                return
            if not pend["eager_slid"]:
                self._slide_window()
            if not pend["first"]:
                self.fm.remove_failures()
            if pend["eager_slid"]:
                # The dispatched frame's solved pose (pre-slide slot W).
                p_s, q_s = state_host[0], state_host[1]
            else:
                p_s, q_s = self.Ps, self.Qs
            self.times.append(pend["t"])
            self.traj_p.append(p_s[self.WIN].copy())
            self.traj_q.append(q_s[self.WIN].copy())
            self.last_R = hg.quat_to_mat(q_s[self.WIN])
            self.last_P = p_s[self.WIN].copy()
            if not pend["first"]:
                self.last_R0 = hg.quat_to_mat(q_s[0])
                self.last_P0 = p_s[0].copy()

    def _write_back(self, p, q, v, ba, bg, tic, qic, td, inv_depth):
        """Copy the solved (gauge-fixed) window into the host mirrors."""
        self.Ps[:] = p
        self.Qs[:] = q
        self.Vs[:] = v
        self.Bas = ba.copy()
        self.Bgs = bg.copy()
        if self.cfg.estimate_extrinsic:
            self.tic = tic.copy()
            self.qic = qic.copy()
        if self.cfg.estimate_td:
            self.td = float(td)
        self.fm.mark_solved_depths(inv_depth, np.asarray(self.fm.used_mask()))

    def _write_back_lagged(self, pend, state_host):
        """Rebase a lagged solve onto the current (already slid,
        IMU-propagated) mirrors: map each solved slot through the slides
        since dispatch, then re-propagate the trailing slots created
        afterwards from their corrected predecessors with the buffered
        interval samples."""
        p, q, v, ba, bg, tic, qic, td, inv_depth = state_host
        src = np.arange(self.NF)
        n_old = 0
        for marg_old in pend["slides"]:
            if marg_old:
                src = np.concatenate([src[1:], [-1]])
                n_old += 1
            else:
                src = np.concatenate([src[: self.WIN - 1], src[self.WIN:], [-1]])
        ok = src >= 0
        self.Ps[ok] = p[src[ok]]
        self.Qs[ok] = q[src[ok]]
        self.Vs[ok] = v[src[ok]]
        self.Bas[ok] = ba[src[ok]]
        self.Bgs[ok] = bg[src[ok]]
        if self.cfg.estimate_extrinsic:
            self.tic = tic.copy()
            self.qic = qic.copy()
        if self.cfg.estimate_td:
            self.td = float(td)
        for j in np.where(~ok)[0]:
            if j > 0:
                self._propagate_slot(int(j))
        # Depths: only slots still holding the same feature at the same
        # physical anchor (its index shifted by the old-slides count).
        applicable = (
            pend["snap_used"]
            & (self.fm.feature_id == pend["snap_id"])
            & (self.fm.anchor == pend["snap_anchor"] - n_old)
        )
        self.fm.mark_solved_depths(inv_depth, applicable)

    def _landmarks(self, pend, state_host):
        """The world points of a lagged solve's features: each used slot's
        solved inverse depth along its anchor bearing at dispatch, from its
        solved anchor pose (camera 0's extrinsic, as set_relo_frame's
        points). Returns (feature ids, points [F, 3], known [F])."""
        p, q, inv_depth = state_host[0], state_host[1], state_host[8]
        a = pend["snap_anchor"]
        known = pend["snap_used"] & (pend["snap_id"] >= 0) & (inv_depth > 0)
        depth = np.where(known, 1.0 / np.where(known, inv_depth, 1.0), 0.0)
        p_imu = (pend["snap_bearing"] * depth[:, None]) @ self._ric0().T + self._tic0()
        pts = np.einsum("fij,fj->fi", hg.quat_to_mat(q[a]), p_imu) + p[a]
        return pend["snap_id"].copy(), pts, known

    def _propagate_slot(self, j):
        """Midpoint-propagate mirror slot j from slot j-1 over its buffered
        interval samples (process_imu's scheme)."""
        P, Q, V = self.Ps[j - 1].copy(), self.Qs[j - 1].copy(), self.Vs[j - 1].copy()
        Ba, Bg = self.Bas[j - 1].copy(), self.Bgs[j - 1].copy()
        self.Bas[j] = Ba
        self.Bgs[j] = Bg
        acc0, gyr0 = self._imu_a0[j].copy(), self._imu_g0[j].copy()
        for k in range(int(self._imu_n[j])):
            acc, gyr = self._imu_accs[j, k], self._imu_gyrs[j, k]
            P, Q, V = self._midpoint_step(P, Q, V, Ba, Bg, acc0, gyr0, acc, gyr,
                                          self._imu_dts[j, k])
            acc0, gyr0 = acc, gyr
        self.Ps[j], self.Qs[j], self.Vs[j] = P, Q, V

    def _gate_observations(self, rn, valid):
        bad = valid.astype(bool) & (rn > self.GATE_THRESH)
        if not bad.any():
            return
        fm = self.fm
        for f, j in zip(*np.where(bad)):
            if fm.anchor[f] != j:  # anchor rows are never residual rows
                fm.valid[f, j] = False
        # Features left with < 2 observations are dead.
        for f in np.where(fm.feature_id >= 0)[0]:
            if fm.valid[f].sum() < 2:
                fm._free(f)
            elif not fm.valid[f, fm.anchor[f]]:
                fm.anchor[f] = int(np.argmax(fm.valid[f]))
                fm.depth[f] = -1.0

    # ------------------------------------------------------------------ slide
    def _slide_window(self):
        if self.frame_count < self.WIN:
            return
        if self.marg_old:
            back_R0 = hg.quat_to_mat(self.Qs[0])
            back_P0 = self.Ps[0].copy()
            ric, tic0 = self._ric0(), self._tic0()
            for arr in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs, self.headers):
                arr[:-1] = arr[1:]
            self.imu_buf = self.imu_buf[1:] + [[]]
            self.imu_buf[0] = []
            for arr in (self._imu_dts, self._imu_accs, self._imu_gyrs,
                        self._imu_a0, self._imu_g0, self._imu_n, self._imu_sumdt):
                arr[:-1] = arr[1:]
                arr[-1] = 0
            self._imu_n[0] = 0
            self._imu_sumdt[0] = 0.0
            if self.solver_flag == self.NON_LINEAR:
                Rnew0 = hg.quat_to_mat(self.Qs[0])
                self.fm.slide_old(back_R0 @ ric, back_P0 + back_R0 @ tic0,
                                  Rnew0 @ ric, self.Ps[0] + Rnew0 @ tic0)
            else:
                self.fm.slide_old(np.eye(3), np.zeros(3), np.eye(3), np.zeros(3))
            t0 = self.headers[0]
            self.all_frames = [f for f in self.all_frames if f["t"] >= t0]
        else:
            j = self.frame_count
            # Merge the newest interval's IMU into interval j-1.
            self.imu_buf[j - 1].extend(self.imu_buf[j])
            self.imu_buf[j] = []
            M = self._imu_dts.shape[1]
            n0 = int(self._imu_n[j - 1])
            take = min(int(self._imu_n[j]), M - n0)
            if take > 0:
                self._imu_dts[j - 1, n0:n0 + take] = self._imu_dts[j, :take]
                self._imu_accs[j - 1, n0:n0 + take] = self._imu_accs[j, :take]
                self._imu_gyrs[j - 1, n0:n0 + take] = self._imu_gyrs[j, :take]
                self._imu_n[j - 1] = n0 + take
            if self._imu_n[j - 1] > 0 and n0 == 0:
                self._imu_a0[j - 1] = self._imu_a0[j]
                self._imu_g0[j - 1] = self._imu_g0[j]
            self._imu_sumdt[j - 1] += self._imu_sumdt[j]
            for arr in (self._imu_dts, self._imu_accs, self._imu_gyrs,
                        self._imu_n, self._imu_sumdt):
                arr[j] = 0
            for arr in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs, self.headers):
                arr[j - 1] = arr[j]
            self.fm.slide_second_new(j)
            # Drop the discarded frame's bootstrap entry, keeping its IMU.
            if len(self.all_frames) >= 2:
                self.all_frames[-1]["imu"] = self.all_frames[-2]["imu"] + self.all_frames[-1]["imu"]
                del self.all_frames[-2]

    def _failure_detection(self):
        """estimator.cpp:628-674 (the active checks)."""
        if np.linalg.norm(self.Bgs[self.WIN]) > 1.0:
            return True
        if np.linalg.norm(self.Ps[self.WIN] - self.last_P) > 5.0:
            return True
        return abs(self.Ps[self.WIN][2] - self.last_P[2]) > 1.0

    # ---------------------------------------------------------------- initial
    def _np_preint(self, imu, bg=None, start=None):
        """Host (numpy f64) midpoint preintegration of one buffer: the deltas
        and the gyro-bias rotation Jacobian the alignment needs."""
        if not imu:
            return None
        bg = np.zeros(3) if bg is None else np.asarray(bg, np.float64)
        accs = np.asarray([b[1] for b in imu], np.float64)
        gyrs = np.asarray([b[2] for b in imu], np.float64)
        dts = np.asarray([b[0] for b in imu], np.float64)
        a0, g0 = start if start is not None else (accs[0], gyrs[0])
        dp = np.zeros(3)
        dq = np.array([1.0, 0, 0, 0])
        dv = np.zeros(3)
        sum_dt = 0.0
        acc_p, gyr_p = np.asarray(a0, np.float64), np.asarray(g0, np.float64)
        Jq = np.zeros((3, 3))  # d(theta)/d(bg), propagated as in F
        for dt, acc_c, gyr_c in zip(dts, accs, gyrs):
            un_acc_0 = hg.quat_to_mat(dq) @ acc_p
            un_gyr = 0.5 * (gyr_p + gyr_c) - bg
            dq_new = hg.quat_normalize(hg.quat_mul(dq, np.concatenate([[1.0], 0.5 * un_gyr * dt])))
            un_acc = 0.5 * (un_acc_0 + hg.quat_to_mat(dq_new) @ acc_c)
            dp = dp + dv * dt + 0.5 * un_acc * dt * dt
            dv = dv + un_acc * dt
            w = un_gyr
            Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
            Jq = (np.eye(3) - Wx * dt) @ Jq - np.eye(3) * dt
            dq = dq_new
            sum_dt += dt
            acc_p, gyr_p = acc_c, gyr_c
        return dict(delta_p=dp, delta_q=dq, delta_v=dv, sum_dt=sum_dt, jac_q_bg=Jq)

    def _initial_structure(self):
        """estimator.cpp:221-363 initialStructure + visualInitialAlign."""
        ric, tic = self._ric0(), self._tic0()
        # 1. Relative pose pivot.
        rel = None
        for i in range(self.WIN):
            b1, b2, _ = self.fm.corresponding(i, self.WIN)
            if len(b1) > 20:
                with np.errstate(divide="ignore", invalid="ignore"):
                    par = np.linalg.norm(b1[:, :2] / b1[:, 2:3] - b2[:, :2] / b2[:, 2:3], axis=-1)
                par = par[np.isfinite(par)]
                if len(par) and par.mean() * 160.0 > 30.0:
                    R, T, ok = solve_relative_rt(b1, b2)
                    if ok:
                        rel = (i, R, T)
                        break
        if rel is None:
            return False
        l, rel_R, rel_T = rel

        # 2. Global SfM over the window features.
        ok, q_sfm, T_sfm, points = global_sfm(self.NF, l, rel_R, rel_T, self.fm.observations_dict())
        if not ok:
            self.marg_old = True
            return False

        # 3. PnP poses for the non-keyframes against the SfM points.
        frame_poses = []
        ki = 0
        for fr in self.all_frames:
            if ki < self.NF and abs(fr["t"] - self.headers[ki]) < 1e-9:
                fr["R"] = hg.quat_to_mat(q_sfm[ki]) @ ric.T
                fr["T"] = T_sfm[ki]
                fr["is_key"] = True
                ki += 1
                frame_poses.append((fr["R"], fr["T"]))
                continue
            ids = [fid for fid in fr["feats"] if fid in points]
            if len(ids) < 6:
                return False
            pw = np.stack([points[fid] for fid in ids])
            bb = np.stack([fr["feats"][fid] for fid in ids])
            if frame_poses:
                R_init, t_init = frame_poses[-1][0] @ ric, frame_poses[-1][1]
            else:
                R_init, t_init = np.eye(3), np.zeros(3)
            R_cw, t_cw, ok = pnp_bearing_gn(pw, bb, R_init.T, -R_init.T @ t_init)
            if not ok:
                return False
            R_wc = R_cw.T
            fr["R"] = R_wc @ ric.T
            fr["T"] = -R_wc @ t_cw
            fr["is_key"] = False
            frame_poses.append((fr["R"], fr["T"]))

        # 4. Visual-inertial alignment.
        align_frames = []
        for fr in self.all_frames:
            af = AlignFrame(R=fr["R"], T=fr["T"], is_key_frame=fr["is_key"])
            pre = self._np_preint(fr["imu"], start=fr.get("imu_start"))
            if pre is not None:
                af.sum_dt = float(pre["sum_dt"])
                af.delta_p, af.delta_q, af.delta_v = pre["delta_p"], pre["delta_q"], pre["delta_v"]
                af.jac_q_bg = pre["jac_q_bg"]
            else:
                af.sum_dt = 0.0
                af.delta_p = np.zeros(3)
                af.delta_q = np.array([1.0, 0, 0, 0])
                af.delta_v = np.zeros(3)
                af.jac_q_bg = np.zeros((3, 3))
            align_frames.append(af)

        def reprop(frames, dbg):
            for fr, af in zip(self.all_frames, frames):
                pre = self._np_preint(fr["imu"], bg=dbg, start=fr.get("imu_start"))
                if pre is not None:
                    af.delta_p, af.delta_q, af.delta_v = pre["delta_p"], pre["delta_q"], pre["delta_v"]

        ok, dbg, g_vis, x = visual_imu_alignment(align_frames, tic, self.cfg.g_norm, reprop)
        if not ok:
            return False

        # 5. visualInitialAlign (estimator.cpp:367-443).
        kf = [f for f in self.all_frames if f["is_key"]]
        for i in range(self.NF):
            self.Ps[i] = kf[i]["T"]
            self.Qs[i] = hg.mat_to_quat(np.asarray(kf[i]["R"]))
        self.Bgs[:] = self.Bgs + dbg
        s = float(x[-1])
        # Triangulate at the unscaled poses with tic = 0, then rescale.
        self.fm.depth[:] = -1.0
        state = self._device_state()
        state = state.replace(tic=torch.zeros_like(state.tic))
        grid = self._device_grid()
        inv_d = triangulate_grid(state, grid, torch.zeros_like(grid.used)).cpu().numpy()
        used = grid.used.cpu().numpy()
        self.fm.depth[used] = 1.0 / np.maximum(inv_d[used], 1e-6)

        R0s = [hg.quat_to_mat(self.Qs[i]) for i in range(self.NF)]
        base = s * self.Ps[0] - R0s[0] @ tic
        for i in range(self.NF - 1, -1, -1):
            self.Ps[i] = s * self.Ps[i] - R0s[i] @ tic - base
        kv = -1
        for fr in self.all_frames:
            if fr["is_key"]:
                kv += 1
                self.Vs[kv] = fr["R"] @ x[kv * 3 : kv * 3 + 3]
        self.fm.depth[used] *= s

        # Gravity alignment: g -> (0, 0, g_norm), yaw(R0) = 0.
        R0 = hg.g2R(g_vis)
        yaw = float(hg.R_to_ypr_deg(R0 @ R0s[0])[0])
        R0 = hg.ypr_deg_to_R([-yaw, 0.0, 0.0]) @ R0
        self.gravity = R0 @ g_vis
        for i in range(self.NF):
            self.Ps[i] = R0 @ self.Ps[i]
            self.Vs[i] = R0 @ self.Vs[i]
            self.Qs[i] = hg.mat_to_quat(R0 @ R0s[i])
        return True
