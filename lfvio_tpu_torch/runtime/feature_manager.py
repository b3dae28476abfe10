"""Host-side feature bookkeeping over the sliding window.

A copy of ``lfvio_tpu.runtime.feature_manager`` (pure numpy): the JAX
package's ``runtime/__init__.py`` imports the tracker and estimator, so
importing it from there would pull JAX in.

Replaces the reference's FeatureManager
(vins_estimator/src/feature_manager.{h,cpp}): per-id C++
lists become fixed-slot numpy arrays mirroring the device FeatureGrid. The
host owns id allocation, window sliding, parallax keyframe logic, and depth
re-anchoring; the device consumes the dense grid. All per-frame operations
are vectorized numpy (no Python loops over slots) — the id→slot map is an
incrementally-maintained dict touched only on allocation/free.

Conventions match the reference:
  * keyframe test: mean angular parallax acos(p_i·p_j)*10 over features seen
    in the last two frames >= MIN_PARALLAX, or track count < 20
    (addFeatureCheckParallax / compensatedParallax2).
  * depths are inverse *ray* depths at the anchor frame (valid for negative
    plane); re-anchoring on slide-old uses dep = |pts_j| (removeBackShiftDepth).
"""

from __future__ import annotations

import numpy as np

INIT_DEPTH = 5.0  # reference INIT_DEPTH (parameters.cpp)


class HostFeatureManager:
    def __init__(self, n_slots: int, n_frames: int):
        self.F = n_slots
        self.W1 = n_frames
        self.bearing = np.zeros((n_slots, n_frames, 3))
        self.velocity = np.zeros((n_slots, n_frames, 3))
        self.td_obs = np.zeros((n_slots, n_frames))
        self.valid = np.zeros((n_slots, n_frames), bool)
        self.anchor = np.zeros(n_slots, np.int32)
        self.cam = np.zeros((n_slots, n_frames), np.int32)  # per-obs camera id
        self.feature_id = np.full(n_slots, -1, np.int64)
        self.depth = np.full(n_slots, -1.0)  # ray depth at anchor; <0 = unknown
        self.last_track_num = 0
        self._id2slot: dict = {}

    # ------------------------------------------------------------------ add
    def add_frame_arrays(
        self, frame_idx: int, ids, bearings, vels, tds, min_parallax: float,
        cams=None,
    ) -> bool:
        """Insert the frame's published features (parallel arrays) at window
        slot frame_idx. Returns True if the *previous* frame should be
        treated as a keyframe (MARGIN_OLD)."""
        ids = np.asarray(ids, np.int64)
        n = len(ids)
        slots = np.fromiter(
            (self._id2slot.get(int(i), -1) for i in ids), np.int64, count=n
        )
        tracked = slots >= 0
        self.last_track_num = int(tracked.sum())

        # Allocate slots for new ids (drop overflow, reference caps NUM_OF_F).
        new_src = np.where(~tracked)[0]
        free = np.where(self.feature_id < 0)[0]
        k = min(len(free), len(new_src))
        new_src = new_src[:k]
        new_slots = free[:k]
        if k:
            self.feature_id[new_slots] = ids[new_src]
            self.anchor[new_slots] = frame_idx
            self.depth[new_slots] = -1.0
            for s, fid in zip(new_slots, ids[new_src]):
                self._id2slot[int(fid)] = int(s)

        src = np.concatenate([np.where(tracked)[0], new_src])
        dst = np.concatenate([slots[tracked], new_slots]).astype(np.int64)
        self.bearing[dst, frame_idx] = np.asarray(bearings)[src]
        self.velocity[dst, frame_idx] = np.asarray(vels)[src]
        self.td_obs[dst, frame_idx] = np.asarray(tds)[src]
        self.cam[dst, frame_idx] = (
            0 if cams is None else np.asarray(cams, np.int32)[src]
        )
        self.valid[dst, frame_idx] = True

        if frame_idx < 2 or self.last_track_num < 20:
            return True
        # Mean angular parallax between the two previous frames
        # (compensatedParallax2, feature_manager.cpp:353-369).
        m = (
            (self.feature_id >= 0)
            & self.valid[:, frame_idx - 2]
            & self.valid[:, frame_idx - 1]
            & (self.cam[:, frame_idx - 2] == self.cam[:, frame_idx - 1])
            & (self.anchor <= frame_idx - 2)
        )
        if not m.any():
            return True
        pi = self.bearing[m, frame_idx - 2]
        pj = self.bearing[m, frame_idx - 1]
        dots = np.clip(np.sum(pi * pj, -1), -1.0, 1.0)
        parallax = np.arccos(dots) * 10.0
        return float(parallax.mean()) >= min_parallax

    def add_frame(self, frame_idx: int, feats: dict, min_parallax: float) -> bool:
        """Dict-interface wrapper (id -> (bearing3, velocity3, td_obs))."""
        if feats:
            ids = np.fromiter(feats.keys(), np.int64, count=len(feats))
            bearings = np.stack([v[0] for v in feats.values()])
            vels = np.stack([v[1] for v in feats.values()])
            tds = np.asarray([v[2] for v in feats.values()])
        else:
            ids = np.zeros(0, np.int64)
            bearings = np.zeros((0, 3))
            vels = np.zeros((0, 3))
            tds = np.zeros(0)
        return self.add_frame_arrays(
            frame_idx, ids, bearings, vels, tds, min_parallax
        )

    # ----------------------------------------------------------------- query
    def used_mask(self):
        """Features that participate in BA: >=2 observations and anchored
        before W-2 (getFeatureCount semantics, feature_manager.cpp:28-42)."""
        nobs = self.valid.sum(1)
        return (self.feature_id >= 0) & (nobs >= 2) & (self.anchor < self.W1 - 3)

    def corresponding(self, fi: int, fj: int):
        """Bearing pairs observed in both frames (getCorresponding).
        Restricted to primary-camera (cam 0) observations — the SfM
        bootstrap runs on one camera, as in the reference."""
        m = (
            (self.feature_id >= 0) & self.valid[:, fi] & self.valid[:, fj]
            & (self.cam[:, fi] == 0) & (self.cam[:, fj] == 0)
        )
        return self.bearing[m, fi], self.bearing[m, fj], self.feature_id[m]

    def observations_dict(self):
        """feature_id -> [(frame, bearing)] for SfM (init-time only;
        primary camera observations only)."""
        out = {}
        for s in np.where(self.feature_id >= 0)[0]:
            obs = [
                (int(j), self.bearing[s, j].copy())
                for j in range(self.W1)
                if self.valid[s, j] and self.cam[s, j] == 0
            ]
            if obs:
                out[int(self.feature_id[s])] = obs
        return out

    # ----------------------------------------------------------------- slide
    def slide_old(self, marg_R, marg_P, new_R, new_P):
        """MARGIN_OLD slide: drop frame 0, shift, re-anchor depths of
        features anchored there (removeBackShiftDepth semantics with
        dep_j = |pts_j|, feature_manager.cpp:271-310).

        marg_R/marg_P: camera pose of the dropped frame; new_R/new_P: camera
        pose of the new frame 0.
        """
        live = self.feature_id >= 0
        anchored0 = live & (self.anchor == 0) & self.valid[:, 0]
        n_remaining = self.valid[:, 1:].sum(1)
        self._free_mask(anchored0 & (n_remaining < 2))

        reanchor = anchored0 & (n_remaining >= 2) & (self.depth > 0)
        # The closed-form re-anchor transform below uses the PRIMARY
        # camera's poses; multi-camera observations whose old/new anchor is
        # another camera just re-triangulate at the new anchor instead.
        cam_ok = (self.cam[:, 0] == 0) & (self.cam[:, 1] == 0)
        self.depth[reanchor & ~cam_ok] = -1.0
        reanchor = reanchor & cam_ok
        if reanchor.any():
            pts = self.bearing[reanchor, 0] * self.depth[reanchor, None]
            w_pts = pts @ np.asarray(marg_R).T + np.asarray(marg_P)
            pts_j = (w_pts - np.asarray(new_P)) @ np.asarray(new_R)
            dj = np.linalg.norm(pts_j, axis=-1)
            self.depth[reanchor] = np.where(dj > 0, dj, INIT_DEPTH)

        # Shift all windows left by one.
        self.bearing[:, :-1] = self.bearing[:, 1:]
        self.velocity[:, :-1] = self.velocity[:, 1:]
        self.td_obs[:, :-1] = self.td_obs[:, 1:]
        self.cam[:, :-1] = self.cam[:, 1:]
        self.valid[:, :-1] = self.valid[:, 1:]
        self.valid[:, -1] = False
        self.bearing[:, -1] = 0.0
        live = self.feature_id >= 0
        self.anchor[live] = np.maximum(self.anchor[live] - 1, 0)
        # Dead or re-anchored features after the shift.
        any_valid = self.valid.any(1)
        self._free_mask(live & ~any_valid)
        live = self.feature_id >= 0
        first = np.argmax(self.valid, axis=1)
        moved = live & (first != self.anchor)
        self.anchor[moved] = first[moved]
        self.depth[moved] = -1.0  # re-triangulate at the new anchor

    def slide_second_new(self, frame_count: int):
        """MARGIN_SECOND_NEW: remove the observation at frame_count-1 and
        pull the newest frame's observation into its place (removeFront)."""
        j = frame_count - 1
        self.bearing[:, j] = self.bearing[:, frame_count]
        self.velocity[:, j] = self.velocity[:, frame_count]
        self.td_obs[:, j] = self.td_obs[:, frame_count]
        self.cam[:, j] = self.cam[:, frame_count]
        self.valid[:, j] = self.valid[:, frame_count]
        self.valid[:, frame_count] = False
        live = self.feature_id >= 0
        at_new = live & (self.anchor == frame_count)
        self.anchor[at_new] = j
        self._free_mask(live & ~self.valid.any(1))

    def remove_failures(self):
        """Drop features whose solved depth is negative (removeFailures)."""
        bad = (self.feature_id >= 0) & (self.depth < 0) & (self.depth > -0.5)
        self._free_mask(bad)

    def mark_solved_depths(self, inv_depth, used):
        """Write solver output back: depth = 1/inv_depth for used features;
        negative solutions flagged for removal (reference sets flag=2)."""
        inv_depth = np.asarray(inv_depth)
        pos = used & (inv_depth > 0)
        neg = used & (inv_depth < 0)
        self.depth[pos] = 1.0 / inv_depth[pos]
        self.depth[neg] = -0.1

    def _free_mask(self, mask):
        idx = np.where(mask)[0]
        if len(idx) == 0:
            return
        for s in idx:
            self._id2slot.pop(int(self.feature_id[s]), None)
        self.feature_id[idx] = -1
        self.valid[idx] = False
        self.depth[idx] = -1.0
        self.bearing[idx] = 0.0
        self.velocity[idx] = 0.0

    def _free(self, s):
        self._free_mask(np.arange(self.F) == s)

    # ----------------------------------------------------------------- grid
    def device_grid_arrays(self):
        """Arrays for FeatureGrid construction (caller casts dtype)."""
        used = self.used_mask()
        return (
            self.bearing,
            self.velocity,
            self.td_obs,
            self.valid,
            self.anchor,
            used,
            self.cam,
        )
