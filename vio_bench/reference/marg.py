"""The marginalizations' plain reference in H space
(MarginalizationInfo::marginalize, marginalization_factor.cpp:174-297):
the kept information H = JᵀJ and b = Jᵀr that the new prior carries, in the
slid window's layout, for MARGIN_OLD (the prior, IMU(0, 1) and the
projections of the features anchored at frame 0; drop pose 0, speed-bias 0
and those inverse depths) and MARGIN_SECOND_NEW (the prior alone; drop
pose W-1). Compared through H and b, which do not depend on the square
root's signs or rotation."""

from __future__ import annotations

import torch

from . import estimator as E


def _slide(H, b, W1, src_of):
    """H, b re-indexed as the window slides: new slot k takes old slot
    src_of(k)'s pose and speed-bias; the newest slot carries nothing."""
    D = H.shape[0]
    perm = []
    for k in range(W1):
        perm += list(range(6 * src_of(k), 6 * src_of(k) + 6))
    for k in range(W1):
        perm += list(range(6 * W1 + 9 * src_of(k), 6 * W1 + 9 * src_of(k) + 9))
    perm += list(range(15 * W1, D))
    perm = torch.tensor(perm, device=H.device)
    H, b = H[perm][:, perm].clone(), b[perm].clone()
    last = list(range(6 * (W1 - 1), 6 * W1)) + list(range(6 * W1 + 9 * (W1 - 1), 15 * W1))
    H[last, :] = 0.0
    H[:, last] = 0.0
    b[last] = 0.0
    return H, b


def _eliminate(H, b, drop):
    """Schur-eliminate the index set ``drop`` with an eigenvalue
    pseudo-inverse of its block; the dropped rows and columns read 0."""
    D = H.shape[0]
    idx = torch.tensor(drop, device=H.device)
    keep = torch.ones(D, dtype=H.dtype, device=H.device)
    keep[idx] = 0.0
    Amm = H[idx][:, idx]
    w, V = torch.linalg.eigh(0.5 * (Amm + Amm.T))
    thr = torch.clamp(torch.max(torch.abs(w)) * 1e-12, min=E.EPS)
    inv = (V * torch.where(w > thr, 1.0 / torch.maximum(w, thr), 0.0)[None, :]) @ V.T
    Hm = H[:, idx]
    return ((H - Hm @ inv @ Hm.T) * keep[:, None] * keep[None, :],
            (b - Hm @ (inv @ b[idx])) * keep)


def margin_old(pb: E.Problem, out: dict, stage, prior, cfg):
    """(H [D, D], b [D], rᵀr of the stacked rows) that MARGIN_OLD keeps,
    in the slid layout. ``out`` is the solved window the program
    marginalizes at; ``stage`` the (preintegration, whitening, interval
    mask) of the solve's start."""
    pre, S, ok = stage
    F, W1 = pb.valid.shape
    used0 = pb.used & (pb.anchor == 0)
    ok0 = torch.zeros_like(ok)
    ok0[0] = ok[0]
    gravity = torch.tensor([0.0, 0.0, cfg["g_norm"]], dtype=out["p"].dtype, device=out["p"].device)
    rows = E.dense_rows(pb, out, pre, S, ok0, prior, gravity, used=used0)
    H_pp, H_pl, H_ll, b_p, b_l = E.normal_equations(rows, F)
    drop_f = used0 & (H_ll > E.EPS)
    inv = torch.where(drop_f, 1.0 / torch.clamp(H_ll, min=E.EPS), 0.0)
    H_pp = H_pp - (H_pl * inv[None, :]) @ H_pl.T
    b_p = b_p - H_pl @ (inv * b_l)
    drop = list(range(0, 6)) + list(range(6 * W1, 6 * W1 + 9))
    H, b = _eliminate(H_pp, b_p, drop)
    H, b = _slide(H, b, W1, lambda k: (k + 1) % W1)
    return H, b, float(torch.sum(rows["r"] * rows["r"]))


def margin_second_new(out: dict, prior, W1):
    """(H, b, rᵀr) that MARGIN_SECOND_NEW keeps, in the merged layout."""
    Jp, rp = E.prior_rows(out, prior)
    W = W1 - 1
    H, b = _eliminate(Jp.T @ Jp, Jp.T @ rp, list(range(6 * (W - 1), 6 * W)))
    H, b = _slide(H, b, W1, lambda k: k if k < W - 1 else W)
    return H, b, float(torch.sum(rp * rp))
