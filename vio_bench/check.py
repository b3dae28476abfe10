"""What decides ``correct``: the sampled answers of the window held against
the plain reference (``reference/``), each number beside its limit
(``limits/<cell>.json``).

The reference follows the program stage by stage from the program's own
state, as a stream estimator can only be followed: a sampled tracked frame
from the slot chain the program held before it (the positions and flags)
and the benchmark's two frames; a sampled solve from its packed upload, the
prior and the device chain; its marginalization from that solve's start
and the program's solved window. Numbers compared:

  * ``bearing_gap_rad``: the 99th percentile of the angles between the
    program's and the reference's bearing of each feature both tracked, over
    the sampled frames (the front end). Not the widest: LK's stopping rule
    and its level-to-level flags are thresholds, and a rare feature lands a
    twentieth of a pixel apart across one of them on some seeds, where TF32
    moves every feature;
  * ``status_gap``: the share of the sampled frames' slots that entered LK
    valid whose status out of the program's step differs from the
    reference LK's, either way (the front end's tracking, RANSAC's
    rejections and the step's masks). The reference has no RANSAC: its
    rejections, a few percent of a published frame's tracks, are the
    sound program's reading, and a front end that drops tracks reads more;
  * ``pack_gap``: for each sampled solve, the features that the front end
    published on the solve's newest frame (its status and bearings, as
    fetched) against the newest column of the solve's packed upload, both
    ways, over the published count: a packing that leaves features out,
    or adds observations the front end never made, reads more;
  * ``solve_gap``: the widest distance, in the information the window's
    factors give, between the program's solved window and the
    reference's: √(δᵀ H δ), δ = x ⊟ x_ref over every pose, speed-bias and
    inverse depth, H the reference's normal matrix at x_ref (the
    estimator). An f32 LM that stops after 8 iterations leaves its window
    off the reference's along directions the factors hardly constrain, by
    up to a millimetre of position on some seeds; what a TF32 step puts off
    is constrained. H weighs each by what the window knows;
  * ``prior_gap``: the widest gap of the kept information H = JᵀJ, b = Jᵀr
    of the new prior, entry (i, j) of H against √(H_ii H_jj) and entry i of
    b against √(H_ii rᵀr) (the marginalization);
  * ``traj_gap``: the same distance with the newest frame's position
    taken from the published trajectory (the trajectory).

``readings(..., control=True)`` reads the same numbers for the control: the
reference itself in float32 with TF32 matmuls in the program's place.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .reference import estimator as E
from .reference import frontend as FR
from .reference import geom as G
from .reference import marg as MG

NUMBERS = ("bearing_gap_rad", "status_gap", "pack_gap", "solve_gap", "prior_gap", "traj_gap")


@contextlib.contextmanager
def precision(control):
    """float64 for the reference; float32 with TF32 matmuls for the control."""
    keep = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(control)
    try:
        yield torch.float32 if control else torch.float64
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def _prior(p, dtype):
    return dict(J=p.J.to(dtype), r0=p.r0.to(dtype), x0_p=p.x0_p.to(dtype), x0_q=p.x0_q.to(dtype),
                x0_v=p.x0_v.to(dtype), x0_ba=p.x0_ba.to(dtype), x0_bg=p.x0_bg.to(dtype),
                x0_tic=p.x0_tic.to(dtype), x0_qic=p.x0_qic.to(dtype), x0_td=p.x0_td.to(dtype),
                valid=bool(p.valid))


def _state(out, dtype):
    return {k: getattr(out, k).to(dtype) for k in
            ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")}


def _angle(a, b):
    return torch.atan2(torch.linalg.norm(torch.linalg.cross(a, b, dim=-1), dim=-1),
                       torch.sum(a * b, dim=-1))


def prior_gap(H, b, H_ref, b_ref, rr):
    """The widest scaled gap of (H, b) against the reference's."""
    d = torch.clamp(torch.diagonal(H_ref), min=0.0)
    floor = 1e-12 * float(d.max()) if d.numel() else 0.0
    s = torch.sqrt(d)
    scale_H = torch.clamp(s[:, None] * s[None, :], min=max(floor, 1e-300))
    scale_b = torch.clamp(s * np.sqrt(max(rr, 0.0)), min=max(floor, 1e-300))
    return max(float(torch.max(torch.abs(H - H_ref) / scale_H)),
               float(torch.max(torch.abs(b - b_ref) / scale_b)))


def info_distance(x, ref, normal, used):
    """√(δᵀ H δ) of the window ``x`` from ``ref``: δ over the poses (δp, δθ),
    speed-biases and inverse depths, H = [[H_pp, H_pl], [H_plᵀ, diag H_ll]]
    at ``ref`` (extrinsic and td hold still: their δ is 0)."""
    H_pp, H_pl, H_ll = normal[:3]
    pose = torch.cat([x["p"] - ref["p"], G.box_minus(x["q"], ref["q"])], -1).reshape(-1)
    sb = torch.cat([x["v"] - ref["v"], x["ba"] - ref["ba"], x["bg"] - ref["bg"]], -1).reshape(-1)
    dp = torch.cat([pose, sb, torch.zeros(H_pp.shape[0] - pose.numel() - sb.numel(),
                                          dtype=pose.dtype, device=pose.device)])
    dl = torch.where(used, x["inv_depth"] - ref["inv_depth"], 0.0)
    q = dp @ H_pp @ dp + 2.0 * dp @ H_pl @ dl + torch.sum(H_ll * dl * dl)
    return float(torch.sqrt(torch.clamp(q, min=0.0)))


def _rows(a):
    """The rows of ``a`` [n, 3] as a set of exact float32 triples."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return set(map(bytes, a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1]))).ravel()))


def pack_misses(published, bearing, valid):
    """(features missing from the packed column or in it without a
    published match, features published): the packed newest column
    (``bearing`` [F, 3], ``valid`` [F]) against the front end's published
    (status, bearings) of that frame."""
    status, bear = published
    pub = _rows(np.asarray(bear)[np.asarray(status, bool)])
    packed = _rows(bearing[valid].cpu().numpy())
    return len(pub ^ packed), len(pub)


def _kept(new_prior):
    """(H, b) that the program's new prior carries."""
    J, r0 = new_prior.J.double(), new_prior.r0.double()
    if not bool(new_prior.valid):
        J, r0 = torch.zeros_like(J), torch.zeros_like(r0)
    return J.T @ J, J.T @ r0


def readings(samples, cfg, device, control=False):
    """The numbers compared, for the program (``control`` False) or the
    control, and what they were read over."""
    dev = torch.device(device)
    F, W1, M = cfg["n_slots"], cfg["window"] + 1, cfg["max_imu_per_interval"]
    scfg = dict(g_norm=cfg["g_norm"], imu_noise=cfg["imu_noise"],
                max_iterations=cfg["max_iterations"])
    gaps = {k: 0.0 for k in NUMBERS}
    seen = dict(bearings=0, frames=0, slots=0, status_diff=0, solves=0, margs=0, traj=0,
                packs=0, pack_diff=0, published=0, pos_gap_m=0.0, rot_gap_rad=0.0,
                frontend_s=0.0, solve_s=0.0)
    t0 = time.perf_counter()
    angles = []
    for f in samples["frames"]:
        status, _, _, bear = f["handle"][1].numpy()
        prev, cur = samples["images"][f["k"] - 1], samples["images"][f["k"]]
        with precision(False) as dt:
            _, st_ref, b_ref = FR.track(prev, cur, f["pos"].to(dt), f["valid"], cfg, dt)
        if control:
            with precision(True) as dt:
                _, st_x, b_x = FR.track(prev, cur, f["pos"].to(dt), f["valid"], cfg, dt)
        else:
            st_x = torch.as_tensor(status, device=dev)
            b_x = torch.as_tensor(bear, device=dev)
        st_x = st_x.to(dev)
        both = st_x & st_ref
        angles.append(_angle(b_x.to(dev, torch.float64)[both], b_ref.double()[both]))
        seen["bearings"] += int(both.sum())
        seen["slots"] += int(f["valid"].sum())
        seen["status_diff"] += int(((st_x ^ st_ref) & f["valid"].to(dev)).sum())
        seen["frames"] += 1
    angles = torch.cat(angles) if angles else torch.zeros(0)
    if angles.numel():
        gaps["bearing_gap_rad"] = float(torch.quantile(angles, 0.99))
        seen["bearing_max_rad"] = float(angles.max())
    if seen["slots"]:
        gaps["status_gap"] = seen["status_diff"] / seen["slots"]
    seen["frontend_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    times = list(samples["times"])
    for s in samples["solves"]:
        with precision(False) as dt:
            pb = E.unpack(s["packed"].to(dt), [c.to(dt) for c in s["chain"]], F, W1, M,
                          cfg["g_norm"])
            prior = _prior(s["prior"], dt)
            ref, stage, _ = E.solve(pb, prior, scfg)
            gravity = torch.tensor([0.0, 0.0, cfg["g_norm"]], dtype=dt, device=dev)
            normal = E.normal_equations(E.dense_rows(pb, ref, *stage, prior, gravity), F)
            out = _state(s["out"], dt)
            marg_ref = None
            if s["marg"] is not None:
                marg_ref = (MG.margin_old(pb, out, stage, prior, cfg) if s["marg"][0] == "marg_old"
                            else MG.margin_second_new(out, prior, W1))
        if control:
            with precision(True) as dt:
                pb32 = E.unpack(s["packed"].to(dt), [c.to(dt) for c in s["chain"]], F, W1, M,
                                cfg["g_norm"])
                prior32 = _prior(s["prior"], dt)
                x, stage32, _ = E.solve(pb32, prior32, scfg)
                out32 = _state(s["out"], dt)
                if s["marg"] is not None:
                    H, b, _ = (MG.margin_old(pb32, out32, stage32, prior32, cfg)
                               if s["marg"][0] == "marg_old"
                               else MG.margin_second_new(out32, prior32, W1))
                    kept = (H.double(), b.double())
        else:
            x = _state(s["out"], torch.float64)
            if s["marg"] is not None:
                kept = _kept(s["marg"][1])
        if s["published"] is not None:
            # The packing is the host's: the control reads the program's.
            miss, n_pub = pack_misses(s["published"], pb.bearing[:, -1], pb.valid[:, -1])
            gaps["pack_gap"] = max(gaps["pack_gap"], miss / max(n_pub, 1))
            seen["packs"] += 1
            seen["pack_diff"] += miss
            seen["published"] += n_pub
        x = {k: v.double() for k, v in x.items()}
        gaps["solve_gap"] = max(gaps["solve_gap"], info_distance(x, ref, normal, pb.used))
        seen["pos_gap_m"] = max(seen["pos_gap_m"],
                                float(torch.linalg.norm(x["p"] - ref["p"], dim=-1).max()))
        seen["rot_gap_rad"] = max(seen["rot_gap_rad"], float(G.angle_between(x["q"], ref["q"]).max()))
        seen["solves"] += 1
        if marg_ref is not None:
            gaps["prior_gap"] = max(gaps["prior_gap"], prior_gap(*kept, *marg_ref))
            seen["margs"] += 1
        if s["t"] in times:
            i = times.index(s["t"])
            if not control:
                p = x["p"].clone()
                p[-1] = torch.as_tensor(samples["traj_p"][i], device=dev, dtype=p.dtype)
                x = dict(x, p=p)
            gaps["traj_gap"] = max(gaps["traj_gap"], info_distance(x, ref, normal, pb.used))
            seen["traj"] += 1
    seen["solve_s"] = time.perf_counter() - t0
    return gaps, seen


def judge(samples, cfg, limits, device):
    """``correct`` and each number beside its limit: correct when every
    number is at or under its limit and each stage was compared at least
    once."""
    gaps, seen = readings(samples, cfg, device)
    numbers = {k: {"value": gaps[k], "limit": float(limits[k])} for k in NUMBERS}
    ok = all(v["value"] <= v["limit"] for v in numbers.values())
    ok = ok and seen["frames"] > 0 and seen["bearings"] > 0 and seen["solves"] > 0 \
        and seen["margs"] > 0 and seen["traj"] > 0 and seen["packs"] > 0
    return dict(correct=bool(ok), numbers=numbers, seen=seen)
