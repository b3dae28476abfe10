"""The one generator of the benchmark's traffic: a replay of a recorded
sequence, built from a traffic file (``traffic/<name>.json``) and a
configuration (``configs/<name>.json``).

Frames come at k / frame_rate + 1e-4 s and IMU samples at j / imu_rate s,
merged in time order, for as long as the caller reads. Frames and samples
are reused by phase: once the trajectory is periodic (world.py), frame k
shows the image of k minus a whole number of periods, so a run renders one
period once in its set-up and its timestamps still increase without a gap.
"""

from __future__ import annotations

import math

import numpy as np

from .world import Trajectory, World, period_frames


class Replay:
    """Rendered frames (uint8 on the device) and IMU samples (numpy f64) of a
    traffic file under a configuration, for one seed."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.traj = Trajectory(traffic)
        self.frame_rate = float(cfg["frame_rate"])
        self.imu_rate = float(cfg["imu_rate"])
        self.world = World(cfg, self.traj, seed, device)
        pre, self.n_period = period_frames(self.traj, self.frame_rate)
        self.n_pre = len(pre)
        times = pre + [(self.n_pre + j) / self.frame_rate + 1e-4 for j in range(self.n_period)]
        self.images = self.world.render_u8(times)
        n_imu = self.traj.period * self.imu_rate
        if abs(n_imu - round(n_imu)) > 1e-9:
            raise ValueError("a period must hold a whole number of IMU samples")
        self.n_imu_period = int(round(n_imu))
        self.imu_j0 = math.ceil(self.traj.steady_from * self.imu_rate - 1e-9)
        g = float(cfg["g_norm"])
        self._imu_pre = self.traj.imu(np.arange(self.imu_j0) / self.imu_rate, g)
        self._imu_period = self.traj.imu(
            (self.imu_j0 + np.arange(self.n_imu_period)) / self.imu_rate, g)

    def image_index(self, k: int) -> int:
        return k if k < self.n_pre else self.n_pre + (k - self.n_pre) % self.n_period

    def frame_time(self, k: int) -> float:
        return k / self.frame_rate + 1e-4

    def frame_of(self, t: float) -> int:
        return int(round((t - 1e-4) * self.frame_rate))

    def imu(self, j: int):
        if j < self.imu_j0:
            return self._imu_pre[0][j], self._imu_pre[1][j]
        i = (j - self.imu_j0) % self.n_imu_period
        return self._imu_period[0][i], self._imu_period[1][i]

    def events(self):
        """("imu", t, acc, gyr) and ("frame", t, k) in time order, without end."""
        j = k = 0
        while True:
            tj, tk = j / self.imu_rate, self.frame_time(k)
            if tj <= tk:
                acc, gyr = self.imu(j)
                yield "imu", tj, acc, gyr
                j += 1
            else:
                yield "frame", tk, k
                k += 1
