"""End-to-end VIO pipeline: front end + estimator over a measurement stream.

Port of ``lfvio_tpu.runtime.pipeline.VioPipeline``: each frame is paired
with the IMU interval covering it, the boundary sample linearly
interpolated at the frame time (getMeasurements, estimator_node.cpp:96-134,
216-258). Also the publish-rate throttle, stream-restart detection and the
IMU-rate propagated odometry between solves.

Frames run ``depth`` deep: a front end with ``dispatch`` / ``finalize``
enqueues a frame's device work when the frame arrives, and the host side of
that frame (its id bookkeeping, the estimator's IMU and the dispatch of its
solve) runs once ``depth`` frames are in flight, so the tracker's results
have had that long to reach the host. The device's slot chain advances at
dispatch, so the results do not depend on the depth. A solve is finalized
when ``solve_lag`` solves are pending (``EstimatorConfig.solve_lag``).
All of it runs on the caller's thread: what overlaps is the device's
stream with the host.

A front end with only ``process_arrays(img, t, publish)`` and ``reset()``
runs synchronously, one frame at a time (the test harness feeds analytic
bearings through one).
"""

from __future__ import annotations

import numpy as np

from ..geom import host as hg
from ..tracing import span


class VioPipeline:
    def __init__(self, frontend, estimator, freq: float = 0.0, td: float | None = None,
                 on_odometry=None, depth: int = 3):
        self.fe = frontend
        self.est = estimator
        self.freq = freq  # max publish rate; 0 = publish every frame
        # Initial camera-IMU offset: seeds the estimator's live td, here and
        # after a restart. None keeps the estimator's own (cfg.td0).
        self.td = td
        # Tracker frames in flight before their host processing. A higher
        # depth hides more device latency and costs one frame period of
        # output latency per level; 1 = fully synchronous.
        self.depth = max(int(depth), 1)
        self.on_odometry = on_odometry  # callback(t, p, q, v) at IMU rate
        self.n_restarts = 0
        self.high_rate = []  # (t, p[3], q[4], v[3]) IMU-rate odometry
        self._n_finalized = 0
        self._reset_stream()

    def _reset_stream(self):
        if self.td is not None:
            self.est.td = float(self.td)
        self._last_pub_t = -1e18
        self._last_pub_decision = -1e18  # throttle state, in dispatch order
        self._last_imu = None  # (t, acc, gyr)
        self._last_frame_t = None
        self._pending = []  # frames waiting for a covering IMU sample
        self._est_imu_queue = []  # estimator IMU, applied at the next frame
        self._sync_q = []  # sync times of frames whose solves are pending
        # Dispatched frames awaiting their host processing, oldest first:
        # (handle, t, td_pair, publish, that frame's estimator IMU batch).
        self._fe_inflight = []
        self._fe_deferred = []  # unpublished frames held for the next published one
        self._recent_imu = []  # samples since the last solved frame
        self._tmp = None  # (P, Q, V, Ba, Bg, acc0, gyr0, t0)

    @classmethod
    def from_yaml(cls, path, n_slots: int = 256, dtype=None, device=None, **kw):
        """Build the complete pipeline from one reference-format rig YAML
        (parameters.cpp:42-139 + feature_tracker/parameters.cpp:43-84)."""
        import torch

        from .config import load_rig_yaml

        return load_rig_yaml(path).make_pipeline(
            n_slots=n_slots, dtype=dtype or torch.float32, device=device, **kw
        )

    def _solve_lag(self) -> int:
        return max(self.est.cfg.solve_lag, 1)

    def _maybe_calibrate_budget(self):
        """One-shot calibration of the solver's wall budget after warm-up:
        max_solver_time binds as an iteration cap that needs a measured time
        per iteration (Estimator.calibrate_solver_budget). Runs once, after
        three solves have landed."""
        est = self.est
        if (est.cfg.max_solver_time <= 0 or est._iter_time is not None
                or est.solver_flag != est.NON_LINEAR):
            return
        self._n_finalized += 1
        if self._n_finalized >= 3:
            est.calibrate_solver_budget()

    @property
    def _td_now(self) -> float:
        """Live camera-IMU offset for measurement pairing (the reference
        reads estimator.td, estimator_node.cpp:100)."""
        return float(self.est.td)

    # ------------------------------------------------------------------ feed
    def feed_imu(self, t, acc, gyr):
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        prev = self._last_imu
        # Process every pending frame this sample covers.
        while self._pending and self._pending[0][0] + self._td_now <= t:
            t_f, img = self._pending.pop(0)
            with span("pipe.pair", t_f):
                t_sync = t_f + self._td_now
                if prev is not None and t_sync > prev[0]:
                    # Interpolate the boundary sample at the frame time.
                    w = (t_sync - prev[0]) / max(t - prev[0], 1e-12)
                    acc_i = (1 - w) * prev[1] + w * acc
                    gyr_i = (1 - w) * prev[2] + w * gyr
                    self._est_imu_queue.append((t_sync - prev[0], acc_i, gyr_i))
                    prev = (t_sync, acc_i, gyr_i)
                # td_obs records the td used for this pairing.
                self._process_frame(t_f, img, td_pair=t_sync - t_f)
        dt = 0.0 if prev is None else t - prev[0]
        self._est_imu_queue.append((dt, acc, gyr))
        self._last_imu = (t, acc, gyr)
        self._recent_imu.append((t, acc.copy(), gyr.copy()))
        if self._tmp is not None:  # IMU-rate odometry, after the first solve
            # It carries the newest frame handed over.
            with span("pipe.predict", self._last_frame_t):
                self._predict(t, acc, gyr)

    def _drain_est_imu(self):
        q, self._est_imu_queue = self._est_imu_queue, []
        with span("est.imu"):
            for dt, acc, gyr in q:
                self.est.process_imu(dt, acc, gyr)

    def feed_frame(self, t, img):
        # A gap > 1 s or a backwards timestamp restarts the whole system
        # (feature_tracker_node.cpp:38-48, estimator_node.cpp:176-195).
        if self._last_frame_t is not None and (
            t - self._last_frame_t > 1.0 or t < self._last_frame_t
        ):
            self.restart()
        self._last_frame_t = t
        self._pending.append((t, img))

    def restart(self):
        """Full system restart on a stream discontinuity."""
        self.n_restarts += 1
        self.fe.reset()
        self.est.clear_state()
        self._reset_stream()

    # ---------------------------------------------------------- high-rate out
    def _predict(self, t, acc, gyr):
        """Midpoint propagation of the IMU-rate state (estimator_node.cpp:
        41-77, pubLatestOdometry)."""
        if self._tmp is None or self.est.solver_flag != self.est.NON_LINEAR:
            return
        P, Q, V, Ba, Bg, acc0, gyr0, t0 = self._tmp
        dt = t - t0
        if dt <= 0:
            return
        g = np.array([0.0, 0.0, self.est.cfg.g_norm])
        un_acc_0 = hg.quat_to_mat(Q) @ (acc0 - Ba) - g
        un_gyr = 0.5 * (gyr0 + gyr) - Bg
        Q = hg.quat_normalize(hg.quat_mul(Q, hg.so3_exp(un_gyr * dt)))
        un_acc = 0.5 * (un_acc_0 + hg.quat_to_mat(Q) @ (acc - Ba) - g)
        P = P + dt * V + 0.5 * dt * dt * un_acc
        V = V + dt * un_acc
        self._tmp = (P, Q, V, Ba, Bg, acc, gyr, t)
        self.high_rate.append((t, P.copy(), Q.copy(), V.copy()))
        if self.on_odometry is not None:
            self.on_odometry(t, P, Q, V)

    def _update_tmp_state(self, t_frame):
        """Re-seed the IMU-rate state from the solved window and re-propagate
        the samples newer than the frame (estimator_node.cpp:79-94)."""
        est = self.est
        if est.solver_flag != est.NON_LINEAR or not est.times:
            self._tmp = None
            return
        with span("pipe.reseed"):
            remaining = [s for s in self._recent_imu if s[0] > t_frame]
            acc0 = remaining[0][1] if remaining else est.acc_0.copy()
            gyr0 = remaining[0][2] if remaining else est.gyr_0.copy()
            self._tmp = (est.Ps[-1].copy(), est.Qs[-1].copy(), est.Vs[-1].copy(),
                         est.Bas[-1].copy(), est.Bgs[-1].copy(), acc0, gyr0, t_frame)
            hold = self.on_odometry, self.high_rate
            self.on_odometry, self.high_rate = None, []  # re-propagate without publishing
            for t, acc, gyr in remaining:
                self._predict(t, acc, gyr)
            self.on_odometry, self.high_rate = hold
            self._recent_imu = remaining

    def _finalize_due(self):
        """Finalize the oldest solve and re-seed the IMU-rate state from it
        (the reference's update() at solve completion)."""
        with span("pipe.finalize_due"):
            self.est.finalize_solve()
            if self._sync_q:
                self._update_tmp_state(self._sync_q.pop(0))
            self._maybe_calibrate_budget()

    def _process_frame(self, t, img, td_pair=None):
        with span("pipe.frame", t):
            # Publish-rate throttle (feature_tracker_node.cpp:51-62), decided in
            # dispatch order: with frames in flight the processing-time
            # _last_pub_t lags several frames and would never throttle.
            publish = True
            if self.freq > 0:
                if (t - self._last_pub_decision) < 1.0 / self.freq - 1e-9:
                    publish = False
                else:
                    self._last_pub_decision = t

            if not hasattr(self.fe, "dispatch"):
                # Synchronous path for front ends without dispatch / finalize.
                if self.est.pending_count() >= self._solve_lag():
                    self._finalize_due()
                self._drain_est_imu()
                out = self.fe.process_arrays(img, t, publish=publish)
                self._publish_frame(out, t, td_pair, publish)
                return

            handle = self.fe.dispatch(img, t, publish=publish)
            # This frame's estimator IMU: everything queued since the previous
            # frame event, its boundary-interpolated sample included.
            imu_batch, self._est_imu_queue = self._est_imu_queue, []
            self._fe_inflight.append((handle, t, td_pair, publish, imu_batch))
            if len(self._fe_inflight) >= self.depth:
                self._advance_one()

    def _replay_deferred(self):
        """Host side of the held unpublished frames, in stream order."""
        deferred, self._fe_deferred = self._fe_deferred, []
        for h, batch in deferred:
            with span("est.imu", h[2]):
                for dt, acc, gyr in batch:
                    self.est.process_imu(dt, acc, gyr)
            self.fe.finalize(h)  # publish=False: bookkeeping only

    def _advance_one(self):
        """Host side of the oldest in-flight frame: finalize the solve that
        is due, replay the frame's IMU, finish its tracker bookkeeping and
        dispatch its own solve. Unpublished frames (the publish-rate
        throttle) are held and replayed with the next published frame."""
        handle, t, td_pair, publish, imu_batch = self._fe_inflight.pop(0)
        with span("pipe.advance", t):
            due = self.est.pending_count() >= self._solve_lag()
            if not publish and not due:
                self._fe_deferred.append((handle, imu_batch))
                return
            if due:
                self._finalize_due()
            self._replay_deferred()
            with span("est.imu"):
                for dt, acc, gyr in imu_batch:
                    self.est.process_imu(dt, acc, gyr)
            self._publish_frame(self.fe.finalize(handle), t, td_pair, publish)

    def _publish_frame(self, out, t, td_pair, publish):
        if publish and out is not None:
            ids, bearings, vels, rows, pub = out[:5]
            cams = out[5] if len(out) > 5 else None  # multi-camera front ends
            if pub.any():
                self._last_pub_t = t
                n_before = self.est.pending_count()
                self.est.process_image_arrays(
                    ids, bearings, vels, rows, pub, t, defer_solve=True, td_pair=td_pair,
                    cams=cams)
                if self.est.pending_count() > n_before:
                    self._sync_q.append(t + td_pair if td_pair is not None else t + self._td_now)

    def flush(self):
        """Complete all in-flight work (stream end, before a checkpoint)."""
        with span("pipe.flush", self._last_frame_t):
            while self._fe_inflight:
                self._advance_one()
            self._replay_deferred()
            while self.est.pending_count():
                self.est.finalize_solve()
                if self._sync_q:
                    self._update_tmp_state(self._sync_q.pop(0))
            self._drain_est_imu()

    def run(self, stream, render_fn):
        """Drive a stream of ('imu', t, acc, gyr) / ('frame', t, img or None)
        events; frames without an image are rendered by render_fn(t).
        Returns (times, traj_p, traj_q) of the solved newest frames."""
        for item in stream:
            kind, t = item[0], item[1]
            if kind == "imu":
                self.feed_imu(t, item[2], item[3])
            else:
                self.feed_frame(t, item[2] if item[2] is not None else render_fn(t))
        self.flush()
        return (
            np.asarray(self.est.times),
            np.asarray(self.est.traj_p),
            np.asarray(self.est.traj_q),
        )
