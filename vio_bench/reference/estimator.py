"""The estimator's plain reference: one sliding-window solve (LF-VIO's
``Estimator::optimization`` as the port runs it: Levenberg-Marquardt in the
JAX form over the projection, IMU and prior factors, Schur elimination of
the inverse depths, the yaw-gauge fix) and the marginalizations' kept
information.

Plain torch in any dtype, written from the equations: the IMU
preintegration is the sequential midpoint recursion of
integration_base.h:54-186 (the port's is a parallel prefix form), the
Jacobians are forward-mode derivatives of the residuals (the port's are
analytic, in hand kernels), and the marginalizations eliminate in H space
(the port's are QR kernels). Its input is a solve's packed buffer as the
port's estimator uploads it (the layout is the port's upload format, copied
here), the prior and the device chain; it reads nothing else of the
program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd

from . import geom as G

PROJ_SQRT_INFO = 160.0 / 1.5  # FOCAL_LENGTH / 1.5 (estimator.cpp:18)
CAUCHY_C = 1.0
INIT_LAMBDA = 1e-4
COST_TOL = 1e-6
INIT_DEPTH = 5.0
EPS = 1e-8


@dataclasses.dataclass
class Problem:
    """One window's solve inputs. Mono rig, extrinsics and td held fixed."""

    p: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor
    tic: torch.Tensor
    qic: torch.Tensor
    inv_depth: torch.Tensor
    td: torch.Tensor
    bearing: torch.Tensor  # [F, W1, 3]
    velocity: torch.Tensor
    td_obs: torch.Tensor  # [F, W1]
    valid: torch.Tensor  # [F, W1] bool
    anchor: torch.Tensor  # [F] int64
    used: torch.Tensor  # [F] bool
    imu: tuple  # dts [W, M], accs [W, M, 3], gyrs, a0 [W, 3], g0, valid [W]
    has_depth: torch.Tensor
    origin_p0: torch.Tensor
    origin_q0: torch.Tensor
    max_iter: int
    tb: torch.Tensor = None  # [F, W1, 2, 3] tangent bases at the measured bearings


def pack_layout(F, W1, M):
    """The port's upload layout for a mono window: name -> (offset, shape)."""
    W = W1 - 1
    entries = [("p", (W1, 3)), ("q", (W1, 4)), ("v", (W1, 3)), ("ba", (W1, 3)), ("bg", (W1, 3)),
               ("tic", (3,)), ("qic", (4,)), ("td", ()), ("inv_depth", (F,)),
               ("g_bearing", (F, W1, 3)), ("g_velocity", (F, W1, 3)), ("g_td_obs", (F, W1)),
               ("g_valid", (F, W1)), ("g_anchor", (F,)), ("g_used", (F,)), ("g_cam", (0,)),
               ("dts", (W, M)), ("accs", (W, M, 3)), ("gyrs", (W, M, 3)), ("a0", (W, 3)),
               ("g0", (W, 3)), ("imu_valid", (W,)), ("has_depth", (F,)), ("origin_p0", (3,)),
               ("origin_q0", (4,)), ("max_iter", ()), ("use_chain", ()), ("marg_prev", ()),
               ("relo_p", (3,)), ("relo_q", (4,)), ("relo_bearing", (F, 3)), ("relo_mask", (F,))]
    layout, off = {}, 0
    for name, shape in entries:
        n = int(np.prod(shape)) if shape else 1
        layout[name] = (off, shape)
        off += n
    return layout, off


def unpack(packed, chain, F, W1, M, g_norm):
    """The solve's starting window from the packed buffer and, where the
    packed flag selects it, the device chain (the previous solve's output,
    slid as its marginalization slid the window and the new frame
    propagated over the newest interval). Returns a Problem."""
    layout, size = pack_layout(F, W1, M)
    if packed.numel() != size:
        raise ValueError(f"packed buffer of {packed.numel()} values, layout {size}")
    get = lambda n: packed[layout[n][0]:layout[n][0] + (int(np.prod(layout[n][1]))
                                                      if layout[n][1] else 1)].reshape(layout[n][1])
    imu = (get("dts"), get("accs"), get("gyrs"), get("a0"), get("g0"), get("imu_valid") > 0.5)
    st = {k: get(k) for k in ("p", "q", "v", "ba", "bg", "tic", "qic", "td")}
    op0, oq0 = get("origin_p0"), get("origin_q0")
    if bool(get("use_chain") > 0.5):
        cp, cq, cv, cba, cbg, ctic, cqic, ctd = chain
        W = W1 - 1
        if bool(get("marg_prev") > 0.5):
            shift = lambda a: torch.cat([a[1:], a[-1:]], dim=0)
        else:
            def shift(a):
                a = a.clone()
                a[W - 1] = a[W]
                return a
        p2, q2, v2, ba2, bg2 = (shift(x) for x in (cp, cq, cv, cba, cbg))
        gravity = torch.tensor([0.0, 0.0, g_norm], dtype=packed.dtype, device=packed.device)
        p2[W], q2[W], v2[W] = propagate(p2[W], q2[W], v2[W], *(x[W - 1] for x in imu[:5]),
                                        ba2[W], bg2[W], gravity)
        st = dict(p=p2, q=q2, v=v2, ba=ba2, bg=bg2, tic=ctic, qic=cqic, td=ctd)
        op0, oq0 = p2[0], q2[0]
    return Problem(**st, inv_depth=get("inv_depth"), bearing=get("g_bearing"),
                   velocity=get("g_velocity"), td_obs=get("g_td_obs"),
                   valid=get("g_valid") > 0.5, anchor=get("g_anchor").round().to(torch.int64),
                   used=get("g_used") > 0.5, imu=imu, has_depth=get("has_depth") > 0.5,
                   origin_p0=op0, origin_q0=oq0, max_iter=int(round(float(get("max_iter")))),
                   tb=G.tangent_basis(get("g_bearing")))


def propagate(p, q, v, dts, accs, gyrs, a0, g0, ba, bg, gravity):
    """World-frame midpoint propagation through an interval's samples, one at a
    time (estimator.cpp:109-116); padded samples (dt = 0) are skipped."""
    acc0, gyr0 = a0, g0
    for k in range(dts.shape[0]):
        dt = dts[k]
        if float(dt) == 0.0:
            continue
        acc1, gyr1 = accs[k], gyrs[k]
        un_acc_0 = G.qrot(q, acc0 - ba) - gravity
        q = G.qnormalize(G.qmul(q, G.so3_exp((0.5 * (gyr0 + gyr1) - bg) * dt)))
        un_acc = 0.5 * (un_acc_0 + G.qrot(q, acc1 - ba) - gravity)
        p = p + dt * v + 0.5 * dt * dt * un_acc
        v = v + dt * un_acc
        acc0, gyr0 = acc1, gyr1
    return p, q, v


# ------------------------------------------------------------------ IMU
@dataclasses.dataclass
class Preint:
    dp: torch.Tensor
    dq: torch.Tensor
    dv: torch.Tensor
    J: torch.Tensor  # [W, 15, 15]
    cov: torch.Tensor
    sum_dt: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor


def preintegrate(dts, accs, gyrs, a0, g0, ba, bg, noise):
    """Midpoint preintegration of W intervals, one sample at a time
    (integration_base.h:54-131), with the 15×15 Jacobian and covariance."""
    Wn, M = dts.shape
    dt_, dev = dts.dtype, dts.device
    I3 = torch.eye(3, dtype=dt_, device=dev).expand(Wn, 3, 3)
    Z3 = torch.zeros_like(I3)
    n2 = [noise["acc_n"] ** 2] * 3 + [noise["gyr_n"] ** 2] * 3
    Nm = torch.diag(torch.tensor(n2 * 2 + [noise["acc_w"] ** 2] * 3 + [noise["gyr_w"] ** 2] * 3,
                                 dtype=dt_, device=dev))
    dp = torch.zeros((Wn, 3), dtype=dt_, device=dev)
    dv = torch.zeros_like(dp)
    dq = torch.zeros((Wn, 4), dtype=dt_, device=dev)
    dq[:, 0] = 1.0
    J = torch.eye(15, dtype=dt_, device=dev).repeat(Wn, 1, 1)
    P = torch.zeros((Wn, 15, 15), dtype=dt_, device=dev)
    acc0, gyr0 = a0, g0
    blk = lambda rows: torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)
    # Samples lead and padding (dt = 0, an exact no-op) trails in every row.
    for k in range(int((dts > 0).sum(-1).max()) if M else 0):
        dt = dts[:, k][:, None]
        acc1, gyr1 = accs[:, k], gyrs[:, k]
        un_gyr = 0.5 * (gyr0 + gyr1) - bg
        dq1 = G.qnormalize(G.qmul(dq, G.small_angle(un_gyr * dt)))
        R0, R1 = G.qmat(dq), G.qmat(dq1)
        a0c, a1c = acc0 - ba, acc1 - ba
        un_acc = 0.5 * ((R0 @ a0c[..., None])[..., 0] + (R1 @ a1c[..., None])[..., 0])
        dp = dp + dv * dt + 0.5 * un_acc * dt * dt
        dv = dv + un_acc * dt
        d = dt[..., None]
        A = I3 - G.skew(un_gyr) * d
        R1a1, R0a0 = R1 @ G.skew(a1c), R0 @ G.skew(a0c)
        Fm = blk([[I3, -0.25 * R0a0 * d * d - 0.25 * (R1a1 @ A) * d * d, I3 * d,
                   -0.25 * (R0 + R1) * d * d, 0.25 * R1a1 * d * d * d],
                  [Z3, A, Z3, Z3, -I3 * d],
                  [Z3, -0.5 * R0a0 * d - 0.5 * (R1a1 @ A) * d, I3, -0.5 * (R0 + R1) * d,
                   0.5 * R1a1 * d * d],
                  [Z3, Z3, Z3, I3, Z3], [Z3, Z3, Z3, Z3, I3]])
        v03, v63 = -0.125 * R1a1 * d * d * d, -0.25 * R1a1 * d * d
        V = blk([[0.25 * R0 * d * d, v03, 0.25 * R1 * d * d, v03, Z3, Z3],
                 [Z3, 0.5 * I3 * d, Z3, 0.5 * I3 * d, Z3, Z3],
                 [0.5 * R0 * d, v63, 0.5 * R1 * d, v63, Z3, Z3],
                 [Z3, Z3, Z3, Z3, I3 * d, Z3], [Z3, Z3, Z3, Z3, Z3, I3 * d]])
        J = Fm @ J
        P = Fm @ P @ Fm.transpose(-1, -2) + V @ Nm @ V.transpose(-1, -2)
        dq, acc0, gyr0 = dq1, acc1, gyr1
    return Preint(dp, dq, dv, J, P, dts.sum(-1), ba, bg)


def whiten(cov, valid):
    """S with SᵀS = cov⁻¹ by a diagonally scaled Cholesky; ok per interval."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=1e-24))
    corr = cov / d[..., :, None] / d[..., None, :] + 1e-6 * eye
    corr = torch.where(valid[..., None, None], corr, eye)
    L, info = torch.linalg.cholesky_ex(corr)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    S = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False) / d[..., None, :]
    ok = valid & torch.isfinite(S).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], S, 0.0), ok


def imu_residual(pre: Preint, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, gravity):
    """15-dim preintegration residual with the first-order bias correction
    (integration_base.h:160-186)."""
    mv = lambda Mx, x: (Mx @ x[..., None])[..., 0]
    dba, dbg = ba_i - pre.ba, bg_i - pre.bg
    J = pre.J
    dp = pre.dp + mv(J[..., 0:3, 9:12], dba) + mv(J[..., 0:3, 12:15], dbg)
    dv = pre.dv + mv(J[..., 6:9, 9:12], dba) + mv(J[..., 6:9, 12:15], dbg)
    dq = G.qnormalize(G.qmul(pre.dq, G.small_angle(mv(J[..., 3:6, 12:15], dbg))))
    T = pre.sum_dt[..., None]
    qi = G.qconj(q_i)
    r_p = G.qrot(qi, 0.5 * gravity * T * T + p_j - p_i - v_i * T) - dp
    r_q = 2.0 * G.qmul(G.qconj(dq), G.qmul(qi, q_j))[..., 1:]
    r_v = G.qrot(qi, gravity * T + v_j - v_i) - dv
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], dim=-1)


# -------------------------------------------------------------- factors
def proj_residual(pb: Problem, s, dpi, dthi, dpj, dthj, dlam):
    """Whole-grid projection residuals [F, W1, 2] (unit sphere, td-corrected
    bearings, tangent plane at the measurement; projection_td_factor.cpp),
    with every observation's anchor and observing pose and its inverse depth
    perturbed on the right by the given local steps."""
    f = torch.arange(pb.anchor.shape[0], device=pb.anchor.device)
    a = pb.anchor
    p_i, q_i = s["p"][a][:, None] + dpi, G.qmul(s["q"][a][:, None], G.so3_exp(dthi))
    p_j, q_j = s["p"][None] + dpj, G.qmul(s["q"][None], G.so3_exp(dthj))
    lam = (s["inv_depth"][:, None] + dlam)
    pts_i = pb.bearing[f, a][:, None] - (pb.td - pb.td_obs[f, a])[:, None, None] * pb.velocity[f, a][:, None]
    pts_j = pb.bearing - (pb.td - pb.td_obs)[..., None] * pb.velocity
    lam = torch.where(torch.abs(lam) < 1e-8, torch.full_like(lam, 1e-8), lam)
    P_ci = pts_i / lam[..., None]
    P_bi = G.qrot(pb.qic, P_ci) + pb.tic
    P_w = G.qrot(q_i, P_bi) + p_i
    P_bj = G.qrot(G.qconj(q_j), P_w - p_j)
    P_cj = G.qrot(G.qconj(pb.qic), P_bj - pb.tic)
    n = torch.clamp(torch.linalg.norm(P_cj, dim=-1, keepdim=True), min=1e-12)
    m = torch.clamp(torch.linalg.norm(pts_j, dim=-1, keepdim=True), min=1e-12)
    err = P_cj / n - pts_j / m
    return PROJ_SQRT_INFO * (pb.tb @ err[..., None])[..., 0]


def residual_mask(pb: Problem, used=None):
    W1 = pb.valid.shape[1]
    used = pb.used if used is None else used
    not_anchor = torch.arange(W1, device=pb.valid.device)[None, :] != pb.anchor[:, None]
    return pb.valid & not_anchor & used[:, None]


def proj_terms(pb, s, used=None):
    """(residuals [F, W1, 2] masked, mask, robust cost terms c² log1p(|r|²/c²))."""
    z3 = torch.zeros(3, dtype=s["p"].dtype, device=s["p"].device)
    r = proj_residual(pb, s, z3, z3, z3, z3, torch.zeros((), dtype=z3.dtype, device=z3.device))
    mask = residual_mask(pb, used)
    r = torch.where(mask[..., None], r, 0.0)
    cost = torch.where(mask, CAUCHY_C**2 * torch.log1p(torch.sum(r * r, -1) / CAUCHY_C**2), 0.0)
    return r, mask, cost


def proj_jacobian(pb, s, used=None):
    """Per-observation residual, its Jacobian over [δp_i, δθ_i, δp_j, δθ_j, δλ]
    ([F, W1, 2, 13], forward mode), and its Cauchy weight (held constant)."""
    r, mask, cost = proj_terms(pb, s, used)

    def fn(d):
        return proj_residual(pb, s, d[0:3], d[3:6], d[6:9], d[9:12], d[12])

    J = jacfwd(fn)(torch.zeros(13, dtype=r.dtype, device=r.device))
    J = torch.where(mask[..., None, None], J, 0.0)
    w = torch.sqrt(1.0 / (1.0 + torch.sum(r * r, -1) / CAUCHY_C**2))
    return r, J, w, mask, cost


def imu_jacobian(pb, s, pre, S, ok, gravity):
    """Whitened IMU residuals [W, 15] and Jacobians [W, 15, 30] over
    [δpose_w, δsb_w, δpose_w+1, δsb_w+1] (forward mode), zero where not ok."""
    def fn(d):
        pi, qi = s["p"][:-1] + d[0:3], G.qmul(s["q"][:-1], G.so3_exp(d[3:6]))
        vi, bai, bgi = s["v"][:-1] + d[6:9], s["ba"][:-1] + d[9:12], s["bg"][:-1] + d[12:15]
        pj, qj = s["p"][1:] + d[15:18], G.qmul(s["q"][1:], G.so3_exp(d[18:21]))
        vj, baj, bgj = s["v"][1:] + d[21:24], s["ba"][1:] + d[24:27], s["bg"][1:] + d[27:30]
        r = imu_residual(pre, pi, qi, vi, bai, bgi, pj, qj, vj, baj, bgj, gravity)
        return (S @ r[..., None])[..., 0]

    z = torch.zeros(30, dtype=s["p"].dtype, device=s["p"].device)
    r, J = fn(z), jacfwd(fn)(z)
    return torch.where(ok[:, None], r, 0.0), torch.where(ok[:, None, None], J, 0.0)


def box_minus_full(s, prior):
    """x ⊟ x0 in the full local layout [pose (6 W1) | sb (9 W1) | ex (6) | td]."""
    return torch.cat([
        torch.cat([s["p"] - prior["x0_p"], G.box_minus(s["q"], prior["x0_q"])], -1).reshape(-1),
        torch.cat([s["v"] - prior["x0_v"], s["ba"] - prior["x0_ba"], s["bg"] - prior["x0_bg"]],
                  -1).reshape(-1),
        torch.cat([s["tic"] - prior["x0_tic"], G.box_minus(s["qic"], prior["x0_qic"])], -1),
        (s["td"] - prior["x0_td"]).reshape(1)])


def prior_rows(s, prior):
    """The prior's Jacobian (held as the marginalization left it) and residual."""
    if not prior["valid"]:
        D = prior["J"].shape[0]
        return torch.zeros_like(prior["J"]), torch.zeros(D, dtype=prior["J"].dtype,
                                                         device=prior["J"].device)
    return prior["J"], prior["r0"] + prior["J"] @ box_minus_full(s, prior)


def dense_rows(pb, s, pre, S, ok, prior, gravity, used=None):
    """All whitened, robust-weighted rows of the window: (Jp [R, D], Jl
    [R, F], r [R], rows' Jl lives in one column a row, given as
    (J_lam [F, W1, 2] rows of proj, feature index))."""
    F, W1 = pb.valid.shape
    W = W1 - 1
    D = 15 * W1 + 7
    dtype, dev = s["p"].dtype, s["p"].device
    r, J13, w, _, _ = proj_jacobian(pb, s, used)
    rw, Jw = r * w[..., None], J13 * w[..., None, None]
    onehot = (pb.anchor[:, None] == torch.arange(W1, device=dev)).to(dtype)
    eyeW = torch.eye(W1, dtype=dtype, device=dev)
    Jpose = (torch.einsum("fjac,jk->fjakc", Jw[..., 6:12], eyeW)
             + torch.einsum("fjac,fk->fjakc", Jw[..., 0:6], onehot)).reshape(F * W1 * 2, 6 * W1)
    Jp_proj = torch.cat([Jpose, torch.zeros((F * W1 * 2, D - 6 * W1), dtype=dtype, device=dev)], 1)
    r_imu, J30 = imu_jacobian(pb, s, pre, S, ok, gravity)
    Jp_imu = torch.zeros((W, 15, D), dtype=dtype, device=dev)
    for w_ in range(W):
        cols = list(range(6 * w_, 6 * w_ + 6)) + list(range(6 * W1 + 9 * w_, 6 * W1 + 9 * w_ + 9))
        cols += list(range(6 * (w_ + 1), 6 * (w_ + 1) + 6))
        cols += list(range(6 * W1 + 9 * (w_ + 1), 6 * W1 + 9 * (w_ + 1) + 9))
        Jp_imu[w_][:, cols] = J30[w_]
    Jpr, rpr = prior_rows(s, prior)
    return dict(Jp=torch.cat([Jp_proj, Jp_imu.reshape(W * 15, D), Jpr], 0),
                r=torch.cat([rw.reshape(-1), r_imu.reshape(-1), rpr]),
                J_lam=Jw[..., 12], r_proj=rw, n_proj=F * W1 * 2)


def normal_equations(rows, F):
    """(H_pp, H_pl, H_ll, b_p, b_l) of the dense rows."""
    Jp, r, n = rows["Jp"], rows["r"], rows["n_proj"]
    W1 = rows["J_lam"].shape[1]
    Jpp = Jp[:n].reshape(F, W1, 2, -1)
    H_pp, b_p = Jp.T @ Jp, Jp.T @ r
    H_pl = torch.einsum("fjad,fja->df", Jpp, rows["J_lam"])
    H_ll = torch.einsum("fja,fja->f", rows["J_lam"], rows["J_lam"])
    b_l = torch.einsum("fja,fja->f", rows["J_lam"], rows["r_proj"])
    return H_pp, H_pl, H_ll, b_p, b_l


def total_cost(pb, s, pre, S, ok, prior, gravity):
    _, _, cost = proj_terms(pb, s)
    r = imu_residual(pre, s["p"][:-1], s["q"][:-1], s["v"][:-1], s["ba"][:-1], s["bg"][:-1],
                     s["p"][1:], s["q"][1:], s["v"][1:], s["ba"][1:], s["bg"][1:], gravity)
    r = torch.where(ok[:, None], (S @ r[..., None])[..., 0], 0.0)
    _, rp = prior_rows(s, prior)
    return 0.5 * cost.sum() + 0.5 * torch.sum(r * r) + 0.5 * torch.sum(rp * rp)


def schur_solve(H_pp, H_pl, H_ll, b_p, b_l, lam, used):
    D = H_pp.shape[0]
    info_ok = used & (H_ll > 1e-12)
    H_ll = torch.where(info_ok, H_ll, 1.0)
    b_l = torch.where(info_ok, b_l, 0.0)
    H_pl = torch.where(info_ok[None, :], H_pl, 0.0)
    inv = 1.0 / (H_ll * (1.0 + lam))
    H_red = H_pp - (H_pl * inv[None, :]) @ H_pl.T
    b_red = b_p - H_pl @ (inv * b_l)
    diag = torch.clamp(torch.diagonal(H_pp), 1e-6, 1e32)
    eye = torch.eye(D, dtype=H_pp.dtype, device=H_pp.device)
    L, info = torch.linalg.cholesky_ex(H_red + lam * torch.diag(diag) + 1e-10 * eye)
    if int(info) != 0:
        nan = torch.full((D,), torch.nan, dtype=H_pp.dtype, device=H_pp.device)
        return nan, torch.full_like(H_ll, torch.nan)
    dx = -torch.cholesky_solve(b_red[:, None], L)[:, 0]
    return dx, -inv * (b_l + H_pl.T @ dx)


def apply_step(s, dx, dlam):
    W1 = s["p"].shape[0]
    pose, sb = dx[:6 * W1].reshape(W1, 6), dx[6 * W1:15 * W1].reshape(W1, 9)
    return dict(s, p=s["p"] + pose[:, :3], q=G.qnormalize(G.qmul(s["q"], G.so3_exp(pose[:, 3:]))),
                v=s["v"] + sb[:, :3], ba=s["ba"] + sb[:, 3:6], bg=s["bg"] + sb[:, 6:],
                inv_depth=s["inv_depth"] + dlam)


def triangulate(pb, s):
    """Inverse ray depths: slots with a depth keep it; used slots seen twice
    or more are triangulated (null vector of the stacked DLT rows, ray depth
    along the anchor bearing; feature_manager.cpp:199-253); the rest 1/5."""
    dtype, dev = s["p"].dtype, s["p"].device
    F, W1 = pb.valid.shape
    Rw = G.qmat(s["q"])
    R_c = Rw @ G.qmat(pb.qic)  # [W1, 3, 3]
    t_c = s["p"] + (Rw @ pb.tic[:, None])[..., 0]
    fi = torch.arange(F, device=dev)
    R0, t0 = R_c[pb.anchor], t_c[pb.anchor]
    R_rel = torch.einsum("wji,fjk->fwik", R_c, R0)
    t_rel = torch.einsum("wji,fwj->fwi", R_c, t0[:, None, :] - t_c[None])
    P = torch.cat([R_rel, t_rel[..., None]], dim=-1)
    f = pb.bearing / torch.clamp(torch.linalg.norm(pb.bearing, dim=-1, keepdim=True), min=1e-12)
    row0 = f[..., 0:1] * P[..., 2, :] - f[..., 2:3] * P[..., 0, :]
    row1 = f[..., 1:2] * P[..., 2, :] - f[..., 2:3] * P[..., 1, :]
    rows = torch.stack([row0, row1], dim=2) * pb.valid[..., None, None].to(dtype)
    AtA = torch.einsum("fwra,fwrb->fab", rows, rows)
    _, V = torch.linalg.eigh(AtA + 1e-12 * torch.eye(4, dtype=dtype, device=dev))
    X = V[..., :, 0]
    den = torch.where(torch.abs(X[..., 3]) < 1e-10, torch.full_like(X[..., 3], 1e-10), X[..., 3])
    depth = torch.sum(X[..., :3] / den[..., None] * f[fi, pb.anchor], dim=-1)
    depth = torch.where(depth < 0.1, torch.full_like(depth, INIT_DEPTH), depth)
    can = pb.used & (pb.valid.sum(-1) >= 2)
    inv_new = torch.where(can, 1.0 / depth, torch.full_like(depth, 1.0 / INIT_DEPTH))
    return torch.where(pb.has_depth, s["inv_depth"], inv_new)


def gauge_fix(s, origin_p0, origin_q0):
    """Rotate and shift the window so frame 0 keeps its pre-solve yaw and
    position (double2vector, estimator.cpp:532-626)."""
    R_o, R_n = G.qmat(origin_q0), G.qmat(s["q"][0])
    ypr_o, ypr_n = G.R_to_ypr_deg(R_o), G.R_to_ypr_deg(R_n)
    z = torch.zeros_like(ypr_o[0])
    rot = G.ypr_deg_to_R(torch.stack([ypr_o[0] - ypr_n[0], z, z]))
    if bool((torch.abs(torch.abs(ypr_o[1]) - 90.0) < 1.0) | (torch.abs(torch.abs(ypr_n[1]) - 90.0) < 1.0)):
        rot = R_o @ R_n.T
    return dict(s, p=(s["p"] - s["p"][0]) @ rot.T + origin_p0,
                q=G.mat_to_quat(rot[None] @ G.qmat(s["q"])), v=s["v"] @ rot.T)


def solve(pb: Problem, prior, cfg):
    """The window's solve. Returns (the solved, gauge-fixed state as a dict,
    its preintegration, whitening and interval mask for the marginalization,
    LM iterations run)."""
    dtype, dev = pb.p.dtype, pb.p.device
    gravity = torch.tensor([0.0, 0.0, cfg["g_norm"]], dtype=dtype, device=dev)
    dts, accs, gyrs, a0, g0, imu_valid = pb.imu
    pre = preintegrate(dts, accs, gyrs, a0, g0, pb.ba[:-1], pb.bg[:-1], cfg["imu_noise"])
    S, ok = whiten(pre.cov, imu_valid)
    s = dict(p=pb.p, q=pb.q, v=pb.v, ba=pb.ba, bg=pb.bg, tic=pb.tic, qic=pb.qic, td=pb.td,
             inv_depth=pb.inv_depth)
    s["inv_depth"] = triangulate(pb, s)
    F = pb.valid.shape[0]
    lin = lambda st: normal_equations(dense_rows(pb, st, pre, S, ok, prior, gravity), F)
    cost_of = lambda st: _finite(total_cost(pb, st, pre, S, ok, prior, gravity))
    n_iter = min(cfg["max_iterations"], max(pb.max_iter, 1))
    lam = INIT_LAMBDA
    cost = cost_of(s)
    L = lin(s)
    iters = 0
    for it in range(n_iter):
        if it > 0 and need_lin:
            L = lin(s)
        dx, dlam = schur_solve(*L, torch.tensor(lam, dtype=dtype, device=dev), pb.used)
        iters += 1
        step_ok = bool(torch.isfinite(dx).all() & torch.isfinite(dlam).all())
        if not step_ok:
            dx, dlam = torch.zeros_like(dx), torch.zeros_like(dlam)
        s_new = apply_step(s, dx, dlam)
        new_cost = cost_of(s_new)
        accept = step_ok and new_cost < cost
        rel = (cost - new_cost) / max(cost, 1e-30)
        lam = min(max(lam * 0.4 if accept else lam * 8.0, 1e-9), 1e6)
        need_lin = accept
        if accept:
            s, cost = s_new, new_cost
            if rel < COST_TOL:
                break
    return gauge_fix(s, pb.origin_p0, pb.origin_q0), (pre, S, ok), iters


def _finite(c):
    c = float(c)
    return c if np.isfinite(c) else float("inf")
