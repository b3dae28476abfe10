"""Front end: per-frame feature tracking on torch tensors.

Port of ``lfvio_tpu.runtime.tracker.FrontEnd`` (the reference's
feature_tracker readImage pipeline + feature_tracker_node publishing):
CLAHE → pyramid → pyramidal LK (one launch of the fused CUDA kernel on a
CUDA device, the plain version on the CPU) → border/annulus/RANSAC rejection
→ masked Shi-Tomasi refill → bearing lift. Images, pyramids and the slot chain live on
``device``; id and track-count bookkeeping stays on the host (numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..frontend import (
    annulus_mask,
    clahe,
    gaussian_pyramid,
    select_features,
    shi_tomasi_response,
    spherical_ransac_e,
)
from ..frontend import klt_cuda
from ..frontend.ransac import N_HYPOTHESES

N_LEVELS = 3  # pyramid levels above the image (OpenCV maxLevel = 3)
BORDER = 1  # inBorder's BORDER_SIZE
# Small-window level-0 refinement: the 41-px window averages the curved PAL
# flow field; a final 15-px pass re-centres on the feature itself.
REFINE_WIN = 15


class FrontEnd:
    def __init__(
        self,
        camera,
        image_size,  # (H, W)
        annulus,  # (center_x, center_y, max_r, min_r): the PAL image ring
        max_cnt: int = 200,
        min_dist: int = 20,
        n_slots: int = 256,
        equalize: bool = True,
        dtype=torch.float32,
        seed: int = 0,
        device=None,  # None: the CUDA card
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.camera = camera.to(device=self.device, dtype=dtype)
        self.H, self.W = image_size
        self.max_cnt = max_cnt
        self.min_dist = min_dist
        self.N = n_slots
        self.equalize = equalize
        self.static_mask = annulus_mask(
            image_size, *[float(a) for a in annulus], dtype=dtype, device=self.device
        )
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._next_id = 0
        self.reset()

    def reset(self):
        """Drop all tracking state (stream restart)."""
        self.pos = np.zeros((self.N, 2), np.float64)
        self.ids = np.full(self.N, -1, np.int64)
        self.track_cnt = np.zeros(self.N, np.int64)
        self.prev_pyr = None
        self.prev_time = None
        self.prev_bearing = np.zeros((self.N, 3))
        self.prev_has_bearing = np.zeros(self.N, bool)
        # Device slot chain: (pos [N,2], valid [N]) feed the next step.
        self._dev_pos = None
        self._dev_valid = None

    def ransac_draws(self):
        """The [n_hyp, N] uniforms choosing RANSAC's minimal sets."""
        return torch.rand(
            (N_HYPOTHESES, self.N), generator=self.generator,
            dtype=self.dtype, device=self.device,
        )

    # ------------------------------------------------------------ device fns
    def _preprocess(self, img):
        img = torch.as_tensor(img).to(device=self.device, dtype=self.dtype)
        if self.equalize:
            img = clahe(img)
        return gaussian_pyramid(img, N_LEVELS)

    def _lift(self, pts):
        rays = self.camera.lift_projective(pts)
        return rays / torch.linalg.norm(rays, dim=-1, keepdim=True)

    def _assign_slots(self, pos_tracked, status, new_pts, new_ok):
        """Slot refill (goodFeaturesToTrack policy, feature_tracker.cpp:
        158-170): survivors keep their slots; up to max_cnt − n_alive
        accepted detections fill the lowest free slots in detection order.

        Returns (pos_next [N,2], valid_next [N], new_src [N] int32 — the
        detection index placed in each slot, −1 if none)."""
        N = self.N
        M = new_pts.shape[0]
        dev = self.device
        idxN = torch.arange(N, device=dev)
        idxM = torch.arange(M, device=dev)
        n_alive = torch.sum(status)
        n_new = torch.clamp(
            torch.minimum(self.max_cnt - n_alive, N - n_alive), min=0
        )
        take = torch.minimum(n_new, torch.sum(new_ok))
        slot_order = torch.argsort(torch.where(~status, idxN, N + idxN))
        new_order = torch.argsort(torch.where(new_ok, idxM, M + idxM))
        dst = slot_order[:M]
        src = new_order
        maskr = idxM < take
        pos_next = torch.where(status[:, None], pos_tracked, 0.0)
        pos_next[dst] = torch.where(
            maskr[:, None], new_pts[src].to(pos_next.dtype), pos_next[dst]
        )
        valid_next = status.clone()
        valid_next[dst] = status[dst] | maskr
        new_src = torch.full((N,), -1, dtype=torch.int32, device=dev)
        new_src[dst] = torch.where(maskr, src.to(torch.int32), -1)
        return pos_next, valid_next, new_src

    def _first_impl(self, img):
        """First frame: preprocess + detect + place into slots."""
        pyr = self._preprocess(img)
        new_pts, new_ok = select_features(
            shi_tomasi_response(pyr[0]), self.static_mask,
            torch.zeros((1, 2), dtype=self.dtype, device=self.device),
            torch.zeros((1,), dtype=torch.bool, device=self.device),
            self.max_cnt, self.min_dist,
        )
        pos0, valid0, new_src = self._assign_slots(
            torch.zeros((self.N, 2), dtype=self.dtype, device=self.device),
            torch.zeros((self.N,), dtype=torch.bool, device=self.device),
            new_pts, new_ok,
        )
        return pyr, pos0, valid0, new_src

    def _step_impl(self, pyr_prev, img, pos, valid, publish: bool):
        """Per-frame step: preprocess, pyramidal LK, rejection, refill
        detection, bearing lift. Returns (pyr, status, new_src, pos_next,
        bear_next, valid_next)."""
        pyr = self._preprocess(img)
        # The frame's LK: one fused kernel launch on a CUDA device.
        pts_next, ok = klt_cuda.pyramidal_lk(
            pyr_prev, pyr, pos, valid, N_LEVELS, refine_win=REFINE_WIN
        )
        # Border containment (inBorder, BORDER_SIZE=1) + annulus mask.
        b = float(BORDER)
        inb = (
            (pts_next[:, 0] >= b) & (pts_next[:, 0] < self.W - b)
            & (pts_next[:, 1] >= b) & (pts_next[:, 1] < self.H - b)
        )
        ix = torch.clamp(pts_next[:, 0].to(torch.int64), 0, self.W - 1)
        iy = torch.clamp(pts_next[:, 1].to(torch.int64), 0, self.H - 1)
        status = ok & inb & self.static_mask[iy, ix]

        if publish:
            # Spherical RANSAC on prev vs cur bearings (rejectWithF).
            _, inl = spherical_ransac_e(
                self.ransac_draws(), self._lift(pos), self._lift(pts_next), status
            )
            status = torch.where(torch.sum(status) >= 8, status & inl, status)
            new_pts, new_ok = select_features(
                shi_tomasi_response(pyr[0]), self.static_mask, pts_next, status,
                self.max_cnt, self.min_dist,
            )
            pos_next, valid_next, new_src = self._assign_slots(
                pts_next, status, new_pts, new_ok
            )
        else:
            pos_next = torch.where(status[:, None], pts_next, 0.0)
            valid_next = status
            new_src = torch.full((self.N,), -1, dtype=torch.int32, device=self.device)
        return pyr, status, new_src, pos_next, self._lift(pos_next), valid_next

    # ----------------------------------------------------------------- frame
    def process_arrays(self, img, t: float, publish: bool = True):
        """Run one frame. Returns (ids [N], bearings [N,3], vels [N,3],
        rows [N], pub_mask [N]) over the slot arrays — pub_mask selects the
        features the reference would publish (track_cnt > 1) — or None on
        the first frame and when publish=False."""
        if self._dev_pos is None:
            pyr, pos0, valid0, new_src = self._first_impl(img)
            self.prev_pyr = pyr
            self._dev_pos, self._dev_valid = pos0, valid0
            return self.finalize("first", t, publish, pos0, valid0)
        pyr, status, new_src, pos_next, bear_next, valid_next = self._step_impl(
            self.prev_pyr, img, self._dev_pos, self._dev_valid, publish
        )
        self.prev_pyr = pyr
        self._dev_pos, self._dev_valid = pos_next, valid_next
        return self.finalize("step", t, publish, status, new_src, pos_next, bear_next)

    def _take_ids(self, k):
        ids = np.arange(self._next_id, self._next_id + k)
        self._next_id += k
        return ids

    def finalize(self, kind, t, publish, *outs):
        """Host id / track-count bookkeeping on the step's outputs."""
        outs = [o.cpu().numpy() for o in outs]
        if kind == "first":
            pos0, valid0 = outs
            slots = np.where(valid0)[0]
            self.pos = pos0.astype(np.float64)
            self.ids[slots] = self._take_ids(len(slots))
            self.track_cnt[slots] = 1
            self.prev_time = t
            self.prev_bearing = np.zeros((self.N, 3))
            self.prev_has_bearing = np.zeros(self.N, bool)
            return None

        status, new_src, pos_next, bear_next = outs
        status = status & (self.ids >= 0)
        pos_next = pos_next.astype(np.float64)
        bear_next = bear_next.astype(np.float64)

        # Free failed slots; advance survivors.
        failed = (self.ids >= 0) & ~status
        self.ids[failed] = -1
        self.track_cnt[failed] = 0
        self.prev_has_bearing[failed] = False
        self.pos = pos_next
        self.track_cnt[status] += 1

        # Ids for refill slots; slots ascend with detection order.
        new_slots = np.where(new_src >= 0)[0]
        if publish and len(new_slots):
            self.ids[new_slots] = self._take_ids(len(new_slots))
            self.track_cnt[new_slots] = 1
        valid = self.ids >= 0

        cur_bearing = np.where(valid[:, None], bear_next, 0.0)
        has_prev = self.prev_has_bearing & status
        # 3-D bearing velocities (Δbearing/Δt for features tracked from the
        # previous frame).
        dt = t - self.prev_time if self.prev_time is not None else 0.0
        vels = np.zeros((self.N, 3))
        if dt > 0:
            vels[has_prev] = (
                cur_bearing[has_prev] - self.prev_bearing[has_prev]
            ) / dt

        self.prev_time = t
        self.prev_bearing = cur_bearing
        self.prev_has_bearing = valid.copy()
        if not publish:
            return None
        pub_mask = valid & (self.track_cnt > 1)
        return self.ids.copy(), cur_bearing, vels, self.pos[:, 1].copy(), pub_mask

    def process(self, img, t: float, publish: bool = True):
        """Dict interface: id -> (bearing3, vel3, row) for published
        features."""
        out = self.process_arrays(img, t, publish)
        if out is None:
            return None
        ids, bearings, vels, rows, pub = out
        return {
            int(ids[s]): (bearings[s].copy(), vels[s].copy(), float(rows[s]))
            for s in np.where(pub)[0]
        }
