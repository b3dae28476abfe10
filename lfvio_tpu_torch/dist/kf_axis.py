"""Keyframe-axis (trajectory-segment) bundle adjustment on ``torch.distributed``.

Port of ``lfvio_tpu.dist.kf_axis``. The ranks form a kf × f grid: each kf
row owns a contiguous keyframe SEGMENT (its own window of states, its own
landmark block, its own square-root prior), and the f ranks of a row split
that segment's landmarks exactly as ``sharding.py`` does (the pose system
all-reduced over the row). Only the segment-boundary keyframes couple rows:

  * Adjacent segments share their boundary keyframe (the last keyframe of
    segment s is keyframe 0 of segment s+1); every IMU interval and every
    landmark observation lives in exactly one segment.
  * Each outer round, every segment solves its own window with
    ``backend/solver.py::lm_loop``, the two incoming boundary MESSAGES
    applied as absolute 15-dof Gaussian priors.
  * After each round the segments exchange updated messages over the kf
    axis: mean = the sender's estimate of the shared keyframe's (pose,
    velocity, biases), corrected to exclude what the receiver told it;
    sqrt-information = the sender's marginal of [its own factors + the
    message from its OTHER neighbour]. Gaussian belief propagation on the
    keyframe chain: a chain is a tree, so BP reaches the joint marginals of
    the linearized problem, re-linearized every round.

The exchange is one ``all_gather`` over the kf group of every rank's two
packed messages (a message is 16 + 225 numbers): each rank then reads its
ring neighbours (kf − 1) % S and (kf + 1) % S, the pairs of the JAX
package's ``ppermute``. The chain's two ends are cut by zero message
weights, not by skipping the exchange, so both packages form the same sums.
The kf group communicates once per round, at the same point on every rank;
inside ``lm_loop`` only the row (the f group) does, so rows may run
different numbers of LM iterations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..backend.solver import _schur_solve, assemble_normal_equations, lm_loop, total_cost
from ..backend.state import FeatureGrid, PriorFactor, SolverConfig, WindowState, n_cams_of, pose_dim
from ..backend.triangulate import triangulate_grid
from ..geom import quat_conj, quat_mul, so3_exp, so3_log
from ..imu import preintegrate, whiten_covariance
from .sharding import FeatureMesh, all_reduce_sum, gather_features, shard_features, shard_grid


@dataclasses.dataclass(frozen=True)
class KfMesh:
    """A kf × f grid of ranks and this process's place in it: ``row`` is
    the f axis (the ranks of this process's row, a ``FeatureMesh``), ``col``
    the kf axis (the process group of its column, one rank per segment:
    ``n_kf`` ranks, in which this process has rank ``kf``)."""

    n_kf: int
    kf: int
    row: FeatureMesh
    col: object  # a torch.distributed ProcessGroup


def make_kf_mesh(n_kf: int, n_f: int, group=None, timeout=None) -> KfMesh:
    """The kf × f grid over the ranks of ``group`` (None: the default
    group): rank r sits at row r // n_f and column r % n_f. Creates a
    process group for every row and every column (``new_group``, which
    every process of the default group must call in the same order: every
    rank calls this with the same arguments). ``timeout`` is each new
    group's collective timeout; pass the one the default group was
    initialized with (a new group otherwise gets its backend's default)."""
    ranks = dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)
    if len(ranks) != n_kf * n_f:
        raise ValueError(
            f"a {n_kf}x{n_f} mesh needs {n_kf * n_f} ranks, the process group has {len(ranks)}")
    backend = dist.get_backend(group)
    grid = np.asarray(ranks).reshape(n_kf, n_f)
    rows = [dist.new_group(r.tolist(), timeout=timeout, backend=backend) for r in grid]
    cols = [dist.new_group(c.tolist(), timeout=timeout, backend=backend) for c in grid.T]
    kf, f = divmod(dist.get_rank(group), n_f)
    return KfMesh(n_kf, kf, FeatureMesh(rows[kf], f, n_f), cols[f])


def _first15_selector(D, W1, dtype, device=None):
    """E [15, D]: rows selecting keyframe 0's (δp, δθ, δv, δba, δbg)."""
    E = np.zeros((15, D), np.float64)
    for k in range(6):
        E[k, k] = 1.0
    off = 6 * W1
    for k in range(9):
        E[6 + k, off + k] = 1.0
    return torch.as_tensor(E, dtype=dtype, device=device)


def _last15_idx(D, W1):
    """Indices of the LAST keyframe's 15-dof block in the local layout."""
    W = W1 - 1
    return np.concatenate([
        np.arange(6 * W, 6 * W + 6),
        np.arange(6 * W1 + 9 * W, 6 * W1 + 9 * W + 9),
    ])


def _idx15(D, W1, first: bool):
    if first:
        return np.concatenate([np.arange(6), np.arange(6 * W1, 6 * W1 + 9)])
    return _last15_idx(D, W1)


def _kf15(state, j):
    """(p, q, v, ba, bg) of keyframe j as one tuple."""
    return (state.p[j], state.q[j], state.v[j], state.ba[j], state.bg[j])


def _res15(copy, z):
    """15-dof local difference copy ⊖ z between two keyframe summaries:
    [p − p_z, Log(q_z⁻¹ q), v − v_z, ba − ba_z, bg − bg_z]."""
    dth = so3_log(quat_mul(quat_conj(z[1]), copy[1]))
    return torch.cat([copy[0] - z[0], dth, copy[2] - z[2], copy[3] - z[3], copy[4] - z[4]])


def _retract15(copy, dx):
    """Retract a 15-dof local correction onto a keyframe summary."""
    p, q, v, ba, bg = copy
    q2 = quat_mul(q, so3_exp(dx[3:6]))
    q2 = q2 / torch.linalg.norm(q2)
    return (p + dx[0:3], q2, v + dx[6:9], ba + dx[9:12], bg + dx[12:15])


def _marginal15(H_red, idx, eps=1e-9):
    """(sqrt, marg) of the 15×15 marginal information of the block ``idx``
    inside the reduced (depth-eliminated) Hessian: Schur complement onto
    the block, then a symmetric eigen square-root (negative directions,
    from far-from-convergence rounds, are clipped rather than NaN'd)."""
    D = H_red.shape[0]
    dtype, dev = H_red.dtype, H_red.device
    rest = torch.as_tensor(np.setdiff1d(np.arange(D), idx), device=dev)
    idx = torch.as_tensor(idx, device=dev)
    H_bb = H_red[idx][:, idx]
    H_br = H_red[idx][:, rest]
    H_rr = H_red[rest][:, rest]
    H_rr = H_rr + eps * torch.eye(H_rr.shape[0], dtype=dtype, device=dev)
    sol = torch.linalg.solve(H_rr, H_br.T)
    marg = H_bb - H_br @ sol
    marg = 0.5 * (marg + marg.T) + eps * torch.eye(15, dtype=dtype, device=dev)
    w, V = torch.linalg.eigh(marg)
    # A RELATIVE floor: an absolute eps floor leaves near-null directions at
    # ~eps, and the echo correction dμ = marg⁻¹g then amplifies any gradient
    # there by 1/eps (a round-over-round explosion of the mean). A fraction
    # of the largest eigenvalue bounds the amplification.
    w = torch.clamp(w, min=torch.clamp(1e-6 * torch.max(w), min=eps))
    marg_pd = (V * w[None, :]) @ V.T
    sqrt_pd = (V * torch.sqrt(w)[None, :]) @ V.T
    return sqrt_pd, marg_pd


def _gather_packed(group, n, tensors):
    """Every rank's ``tensors`` over ``group`` (n ranks) in one all_gather,
    each returned as [n, *shape]."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=group)
    rows = torch.stack(parts)
    out, k = [], 0
    for t in tensors:
        out.append(rows[:, k:k + t.numel()].reshape(n, *t.shape))
        k += t.numel()
    return out


def _segment(obj, kf):
    """Segment ``kf`` of a dataclass of tensors batched over segments."""
    return dataclasses.replace(obj, **{
        f.name: None if getattr(obj, f.name) is None else getattr(obj, f.name)[kf]
        for f in dataclasses.fields(obj)})


def segmented_trajectory_solve(
    mesh: KfMesh,
    states: WindowState,           # [S, W1, ...] batched over segments
    grids: FeatureGrid,            # [S, F, W1, ...]
    dts, accs, gyrs, a0, g0, imu_valid,   # [S, W, M(,3)] / [S, W]
    priors: PriorFactor,           # [S, ...] per-segment priors
    imu_noise,
    cfg: SolverConfig,
    g_norm: float = 9.81,
    n_outer: int = 4,
    boundary_weight: float = 1.0,
):
    """Solve S trajectory segments in parallel over the kf axis of
    ``mesh`` (each segment's features split over its row), with
    bidirectional Gaussian-BP boundary messages exchanged between rounds
    (about O(S) rounds on the chain). Every rank is given the whole batched
    problem and takes its segment and its feature slice. boundary_weight
    scales the message sqrt-infos (1.0 = exact BP). Returns, the same on
    every rank, (states_out [S, ...], boundary_gap [S]: final ‖mismatch‖ of
    each shared keyframe pair, costs [S, 2]: initial/final of the last
    round, history [S, 2, n_outer]: per-round (boundary gap,
    ‖echo correction‖))."""
    S, kf, fm = mesh.n_kf, mesh.kf, mesh.row
    st = _segment(states, kf)
    st = st.replace(inv_depth=shard_features(st.inv_depth, fm))
    g = shard_grid(_segment(grids, kf), fm)
    pr = _segment(priors, kf)
    dtype, dev = st.p.dtype, st.p.device
    W1 = st.p.shape[0]
    D = pose_dim(W1, n_cams_of(st))
    gravity = torch.tensor([0.0, 0.0, g_norm], dtype=dtype, device=dev)
    E15 = _first15_selector(D, W1, dtype, dev)
    idxF = _idx15(D, W1, first=True)
    idxL = _idx15(D, W1, first=False)
    EL = torch.zeros((15, D), dtype=dtype, device=dev)
    EL[torch.arange(15, device=dev), torch.as_tensor(idxL, device=dev)] = 1.0
    inv_sqrt_nf = 1.0 / (fm.size ** 0.5)

    pre = preintegrate(dts[kf], accs[kf], gyrs[kf], a0[kf], g0[kf], st.ba[:-1], st.bg[:-1],
                       imu_noise)
    sqrt_info, imu_ok = whiten_covariance(pre.covariance, imu_valid[kf])
    st = st.replace(inv_depth=triangulate_grid(
        st, g, torch.zeros(g.valid.shape[0], dtype=torch.bool, device=dev)))

    # Replicated factors over the f axis (see sharding.py): IMU, prior and
    # boundary factors touch only pose blocks; every rank of the row
    # evaluates them with 1/√n_f weights, so the row's sum holds one copy.
    si_s = sqrt_info * inv_sqrt_nf
    pr_s = dataclasses.replace(pr, J=pr.J * inv_sqrt_nf, r0=pr.r0 * inv_sqrt_nf)

    def boundary_terms(s, bnd):
        """(H_add, b_add, cost) of the two incoming BP messages. bnd =
        (μ_first, W_first, w_first, μ_last, W_last, w_last): each message is
        an absolute 15-dof Gaussian on the shared boundary keyframe: mean =
        the neighbour's estimate of it, sqrt-info = the neighbour's marginal
        excluding what it previously heard from this segment (no echo)."""
        zF, WFm, wF, zL, WLm, wL = bnd
        rF = _res15(_kf15(s, 0), zF)
        rL = _res15(_kf15(s, W1 - 1), zL)
        WF = (wF * inv_sqrt_nf) * WFm  # [15, 15] sqrt-info
        WL = (wL * inv_sqrt_nf) * WLm
        JF = WF @ E15
        JL = WL @ EL
        rFw = WF @ rF
        rLw = WL @ rL
        H_add = JF.T @ JF + JL.T @ JL
        b_add = JF.T @ rFw + JL.T @ rLw
        cost = 0.5 * (torch.sum(rFw * rFw) + torch.sum(rLw * rLw))
        return H_add, b_add, cost

    def make_fns(bnd):
        def lin_fn(sc):
            H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
                sc, g, pre, si_s, imu_ok, pr_s, gravity, cfg)
            H_add, b_add, _ = boundary_terms(sc, bnd)
            H_pp, b_p = all_reduce_sum(fm, H_pp + H_add, b_p + b_add)
            return H_pp, H_pl, H_ll, b_p, b_l

        def solve_fn(lin, lam):
            return _schur_solve(*lin, lam, g.used, reduce=lambda Sm, c: all_reduce_sum(fm, Sm, c))

        def cost_fn(sc):
            base = total_cost(sc, g, pre, si_s, imu_ok, pr_s, gravity, cfg)
            return all_reduce_sum(fm, base + boundary_terms(sc, bnd)[2])[0]

        return lin_fn, solve_fn, cost_fn

    def capped(dmu, cap=0.3):
        # Trust region on the extrapolation: the first-order echo correction
        # is only locally valid; an unbounded step in a weakly informed
        # direction ping-pongs between neighbours and diverges.
        n = torch.linalg.norm(dmu)
        return dmu * torch.clamp(cap / torch.clamp(n, min=1e-12), max=1.0)

    eyeW = torch.eye(15, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    # The ring's wrapped-around messages (into segment 0 from the last, and
    # back) are weighted 0: the chain's ends, as JAX's ppermute pairs have it.
    w_first_m = torch.tensor(boundary_weight * (kf > 0), dtype=dtype, device=dev)
    w_last_m = torch.tensor(boundary_weight * (kf < S - 1), dtype=dtype, device=dev)
    bnd = (_kf15(st, 0), eyeW, zero, _kf15(st, W1 - 1), eyeW, zero)
    gap_hist, dmu_hist = [], []
    for _ in range(n_outer):
        zF, WFm, wF, zL, WLm, wL = bnd
        st, c0, c1, _ = lm_loop(st, *make_fns(bnd), cfg)
        # Reduced own-factor Hessian at the solution (depths eliminated).
        H_pp, H_pl, H_ll, _, _, _ = assemble_normal_equations(
            st, g, pre, si_s, imu_ok, pr_s, gravity, cfg)
        used_ok = g.used & (H_ll > 1e-12)
        H_pl_safe = torch.where(used_ok[None, :], H_pl, 0.0)
        inv_Hll = torch.where(used_ok, 1.0 / torch.where(used_ok, H_ll, 1.0), 0.0)
        H_pp, Sm = all_reduce_sum(fm, H_pp, (H_pl_safe * inv_Hll[None, :]) @ H_pl_safe.T)
        H_red = H_pp - Sm
        # Outgoing message Hessians: own factors + the OPPOSITE side's
        # incoming message (boundary factors touch only pose/sb rows).
        WF_in = wF * WFm
        WL_in = wL * WLm
        JF_in = WF_in @ E15
        JL_in = WL_in @ EL
        sq_msg_fwd, marg_fwd = _marginal15(H_red + JF_in.T @ JF_in, idxL)
        sq_msg_bwd, marg_bwd = _marginal15(H_red + JL_in.T @ JL_in, idxF)
        # Echo-free message MEANS: x* minimizes own + left + right, but the
        # forward message must carry the minimizer of [own + left] only. The
        # right message acts on the boundary block alone, so the first-order
        # correction is dμ = marg_[own+left]⁻¹ · ∇f_right(x*)|₁₅; without it
        # each hop re-counts the receiver's own information and the chain
        # settles on a biased fixed point.
        gF15 = WF_in.T @ (WF_in @ _res15(_kf15(st, 0), zF))
        gL15 = WL_in.T @ (WL_in @ _res15(_kf15(st, W1 - 1), zL))
        dmu_fwd = capped(torch.linalg.solve(marg_fwd, gL15))
        dmu_bwd = capped(torch.linalg.solve(marg_bwd, gF15))
        my_first = _retract15(_kf15(st, 0), dmu_bwd)
        my_last = _retract15(_kf15(st, W1 - 1), dmu_fwd)
        msgs = _gather_packed(mesh.col, S, my_last + (sq_msg_fwd,) + my_first + (sq_msg_bwd,))
        recv_first = [m[(kf - 1) % S] for m in msgs[:6]]  # the previous segment's fwd message
        recv_last = [m[(kf + 1) % S] for m in msgs[6:]]   # the next segment's bwd message
        bnd = (tuple(recv_first[:5]), recv_first[5] + 1e-4 * eyeW, w_first_m,
               tuple(recv_last[:5]), recv_last[5] + 1e-4 * eyeW, w_last_m)
        gap_hist.append(torch.where(w_last_m > 0, torch.linalg.norm(my_last[0] - recv_last[0]),
                                    0.0))
        dmu_hist.append(torch.linalg.norm(dmu_fwd))

    st = st.replace(inv_depth=gather_features(st.inv_depth, fm))
    names = [f.name for f in dataclasses.fields(st)]
    out = _gather_packed(mesh.col, S, [getattr(st, k) for k in names] + [
        torch.stack([c0, c1]), torch.stack([torch.stack(gap_hist), torch.stack(dmu_hist)])])
    states_out = dataclasses.replace(st, **dict(zip(names, out)))
    # Final boundary gap: ‖segment s's last keyframe − segment s+1's first‖.
    p = states_out.p
    gap = torch.where(torch.arange(S, device=dev) < S - 1,
                      torch.linalg.norm(p[:, W1 - 1] - torch.roll(p[:, 0], -1, 0), dim=-1), 0.0)
    return states_out, gap, out[-2], out[-1]
