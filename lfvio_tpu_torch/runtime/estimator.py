"""Sliding-window VIO estimator (synchronous, solve lag 1).

Port of ``lfvio_tpu.runtime.estimator`` in its lag-1 configuration (the
reference Estimator, estimator.cpp): the INITIAL → NON_LINEAR state
machine, measurement handling, the numpy bootstrap (``lfvio_tpu.vinit``),
the per-frame solve, failure detection, marginalization and the window
slide.

Division of labour: host mirrors (numpy f64) hold the window and drive the
policy; each frame's solve is plain torch calls on ``cfg.device`` in
``cfg.solver_dtype`` — preintegration of all window intervals, covariance
whitening, triangulation, LM, the yaw-gauge fix — followed by the QR
marginalization, whose prior stays on the device. A dispatched solve is
completed (written back, checked, slid) by :meth:`finalize_solve` before the
next frame's measurements are applied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lfvio_tpu.vinit import global_sfm, pnp_bearing_gn, solve_relative_rt, visual_imu_alignment
from lfvio_tpu.vinit.alignment import AlignFrame

from ..backend import (
    FeatureGrid,
    PriorFactor,
    SolverConfig,
    WindowState,
    lm_solve,
    marginalize_old_qr,
    marginalize_second_new_qr,
    triangulate_grid,
    yaw_gauge_fix,
)
from ..backend.state import WINDOW
from ..geom import host as hg
from ..imu import ImuNoise, preintegrate, whiten_covariance
from .feature_manager import HostFeatureManager


@dataclasses.dataclass
class EstimatorConfig:
    n_feature_slots: int = 256
    max_imu_per_interval: int = 256
    min_parallax: float = 10.0 / 160.0  # keyframe_parallax / FOCAL_LENGTH
    imu_noise: ImuNoise = dataclasses.field(
        default_factory=lambda: ImuNoise(0.02, 0.01, 0.04, 0.001)
    )
    g_norm: float = 9.81
    td0: float = 0.0
    tic: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    ric: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    solver_dtype: torch.dtype = torch.float32
    device: str = "cpu"


class Estimator:
    INITIAL, NON_LINEAR = 0, 1

    def __init__(self, cfg: EstimatorConfig):
        self.cfg = cfg
        self.WIN = WINDOW
        self.NF = WINDOW + 1
        self.device = torch.device(cfg.device)
        # td and the extrinsics stay fixed in this configuration.
        self.scfg = SolverConfig(estimate_td=False, estimate_extrinsic=False)
        self.gravity = None  # set by the bootstrap
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
        self.tic = np.asarray(cfg.tic, np.float64).copy()
        self.qic = hg.mat_to_quat(np.asarray(cfg.ric, np.float64))
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
        self._pending = None  # the dispatched, not yet finalized solve

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
            g = np.array([0.0, 0.0, self.cfg.g_norm])
            R = hg.quat_to_mat(self.Qs[j])
            un_acc_0 = R @ (self.acc_0 - self.Bas[j]) - g
            un_gyr = 0.5 * (self.gyr_0 + gyr) - self.Bgs[j]
            q_new = hg.quat_normalize(hg.quat_mul(self.Qs[j], hg.so3_exp(un_gyr * dt)))
            un_acc_1 = hg.quat_to_mat(q_new) @ (acc - self.Bas[j]) - g
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            self.Ps[j] += dt * self.Vs[j] + 0.5 * dt * dt * un_acc
            self.Vs[j] += dt * un_acc
            self.Qs[j] = q_new
        self.acc_0, self.gyr_0 = acc, gyr

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
        )

    def _solve_step(self, state, grid, prior, origin_p0, origin_q0):
        """The per-frame solve (solveOdometry + double2vector,
        estimator.cpp:475-515, 532-626): preintegrate every window interval
        at its start frame's biases, whiten, triangulate new features, LM,
        yaw-gauge fix. Returns the solved state and the intermediates the
        MARGIN_OLD prior needs."""
        t = self._tensor
        gravity = t([0.0, 0.0, self.cfg.g_norm])
        pre = preintegrate(
            t(self._imu_dts[1:]), t(self._imu_accs[1:]), t(self._imu_gyrs[1:]),
            t(self._imu_a0[1:]), t(self._imu_g0[1:]), state.ba[:-1], state.bg[:-1],
            self.cfg.imu_noise,
        )
        imu_valid = t((self._imu_n[1:] > 0) & (self._imu_sumdt[1:] < 10.0), torch.bool)
        sqrt_info, imu_valid = whiten_covariance(pre.covariance, imu_valid)
        state = state.replace(
            inv_depth=triangulate_grid(state, grid, t(self.fm.depth > 0, torch.bool))
        )
        out, _, _, _ = lm_solve(
            state, grid, pre, sqrt_info, imu_valid, prior, gravity, self.scfg
        )
        out = yaw_gauge_fix(out, t(origin_p0), t(origin_q0))
        return out, pre, sqrt_info, imu_valid, gravity

    def _empty_prior(self):
        return PriorFactor.empty(self.cfg.solver_dtype, self.NF, self.device)

    # ------------------------------------------------------------------ frame
    def process_image_arrays(self, ids, bearings, vels, rows, mask, t: float,
                             td_pair=None):
        """Estimator::processImage (estimator.cpp:122-220), array interface.

        ids/bearings/vels/rows: per-slot arrays from FrontEnd.process_arrays;
        mask selects the published observations. A dispatched solve is left
        for :meth:`finalize_solve` to complete (the pipeline calls it at the
        next frame and on flush). td_pair is the td the pipeline paired IMU
        with.
        """
        cfg = self.cfg
        sel = np.where(np.asarray(mask))[0]
        ids_s = np.asarray(ids)[sel]
        b_s = np.asarray(bearings)[sel]
        v_s = np.asarray(vels)[sel]
        td_rec = self.td if td_pair is None else td_pair
        tds = np.full(len(sel), td_rec)
        self.marg_old = self.fm.add_frame_arrays(
            self.frame_count, ids_s, b_s, v_s, tds, cfg.min_parallax
        )

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
                if t - self.initial_timestamp > 0.1:
                    ok = self._initial_structure()
                    self.initial_timestamp = t
                if ok:
                    self.solver_flag = self.NON_LINEAR
                    self._dispatch_solve(t, first=True)
                else:
                    self._slide_window()
            else:
                self.frame_count += 1
                j = self.frame_count  # the new frame starts where the last is
                for a in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs):
                    a[j] = a[j - 1]
        else:
            self._dispatch_solve(t, first=False)

    # ----------------------------------------------------------------- solve
    def _dispatch_solve(self, t: float, first: bool = False):
        """Run the frame's solve and marginalization on the device; the
        host-side completion waits for :meth:`finalize_solve`."""
        if self.frame_count < self.WIN:
            return
        self.finalize_solve()
        prior = self.prior if self.prior is not None else self._empty_prior()
        # Gauge origin: pre-solve frame 0, or the last good pose after a
        # detected failure (estimator.cpp:536-547).
        if self.failure_occur:
            origin_p0, origin_q0 = self.last_P0, hg.mat_to_quat(self.last_R0)
            self.failure_occur = False
        else:
            origin_p0, origin_q0 = self.Ps[0], self.Qs[0]
        grid = self._device_grid()
        out, pre, sqrt_info, imu_ok, gravity = self._solve_step(
            self._device_state(), grid, prior, origin_p0, origin_q0
        )
        if self.marg_old:
            self.prior = marginalize_old_qr(
                out, grid, pre, sqrt_info, imu_ok, prior, gravity, self.scfg
            )
        else:
            self.prior = marginalize_second_new_qr(out, prior, self.scfg)
        self._pending = dict(state=out, t=t, first=first)

    def pending_count(self):
        return 0 if self._pending is None else 1

    def finalize_solve(self):
        """Complete the dispatched solve: write-back, failure detection,
        window slide, trajectory record."""
        pend, self._pending = self._pending, None
        if pend is None:
            return
        self._write_back(pend["state"])
        if not pend["first"] and self._failure_detection():
            self.failure_occur = True
            self.clear_state()
            return
        self._slide_window()
        if not pend["first"]:
            self.fm.remove_failures()
        self.times.append(pend["t"])
        self.traj_p.append(self.Ps[self.WIN].copy())
        self.traj_q.append(self.Qs[self.WIN].copy())
        self.last_R = hg.quat_to_mat(self.Qs[self.WIN])
        self.last_P = self.Ps[self.WIN].copy()
        if not pend["first"]:
            self.last_R0 = hg.quat_to_mat(self.Qs[0])
            self.last_P0 = self.Ps[0].copy()

    def _write_back(self, s: WindowState):
        """Copy the solved (gauge-fixed) window into the host mirrors."""
        host = lambda a: a.cpu().numpy().astype(np.float64)
        self.Ps[:] = host(s.p)
        self.Qs[:] = host(s.q)
        self.Vs[:] = host(s.v)
        self.Bas = host(s.ba)
        self.Bgs = host(s.bg)
        self.fm.mark_solved_depths(host(s.inv_depth), self.fm.used_mask())

    # ------------------------------------------------------------------ slide
    def _slide_window(self):
        if self.frame_count < self.WIN:
            return
        if self.marg_old:
            back_R0 = hg.quat_to_mat(self.Qs[0])
            back_P0 = self.Ps[0].copy()
            ric = hg.quat_to_mat(self.qic)
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
                self.fm.slide_old(back_R0 @ ric, back_P0 + back_R0 @ self.tic,
                                  Rnew0 @ ric, self.Ps[0] + Rnew0 @ self.tic)
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
        ric = hg.quat_to_mat(self.qic)
        tic = self.tic
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
