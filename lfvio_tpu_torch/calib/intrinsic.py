"""Intrinsic calibration from planar chessboard correspondences.

A copy of ``lfvio_tpu.calib.intrinsic`` (host numpy over the port's own
``geom.host``); only ``synth_chessboard_views`` projects through the port's
camera models (torch, float64 on the CPU) instead of ``jnp``.

Host tooling (f64 numpy): calibration runs once per rig, offline — the same
division the reference makes (its Calibration CLI is separate from the live
nodes). The estimation pipeline for the OCAM model mirrors Scaramuzza's
method as implemented by the reference (ScaramuzzaCamera::estimateIntrinsics,
camera_model/src/camera_models/ScaramuzzaCamera.cc:224-601):

  1. per-view partial extrinsics from the collinearity nullspace,
  2. joint linear solve for the forward polynomial + per-view t3,
  3. nonlinear refinement of poly/center/extrinsics on bearing residuals,
  4. inverse-polynomial refit (theta -> rho) for fast projection.

The pinhole path is Zhang's method (homographies -> B-matrix -> K) with a
Gauss-Newton refinement over (fx, fy, cx, cy, k1, k2, p1, p2, extrinsics).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geom import host as hg


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def _gauss_newton(res_fn, x0, n_iters=30, lm0=1e-3):
    """Small dense LM with numeric Jacobian (host-side, tiny problems)."""
    x = np.asarray(x0, np.float64).copy()
    lam = lm0
    r = res_fn(x)
    cost = float(r @ r)
    for _ in range(n_iters):
        J = _num_jac(res_fn, x, r)
        H = J.T @ J
        g = J.T @ r
        for _ in range(8):
            try:
                dx = np.linalg.solve(H + lam * np.diag(np.maximum(np.diag(H), 1e-12)), -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            r_new = res_fn(x + dx)
            c_new = float(r_new @ r_new)
            if np.isfinite(c_new) and c_new < cost:
                x = x + dx
                r, cost = r_new, c_new
                lam = max(lam * 0.3, 1e-9)
                break
            lam *= 10
        else:
            break
    return x, np.sqrt(cost / max(len(r), 1))


def _num_jac(fn, x, r0, eps=1e-6):
    J = np.zeros((len(r0), len(x)))
    for i in range(len(x)):
        xp = x.copy()
        h = eps * max(1.0, abs(x[i]))
        xp[i] += h
        J[:, i] = (fn(xp) - r0) / h
    return J


def _planar(obj_pts):
    p = np.asarray(obj_pts, np.float64)
    if p.shape[-1] == 2:
        return p
    return p[:, :2]


# --------------------------------------------------------------------------
# Scaramuzza / OCAM
# --------------------------------------------------------------------------

def _ocam_partial_extrinsics(xy, XY):
    """Per-view nullspace solve for (r11, r12, r21, r22, t1, t2).

    Collinearity on the image plane: (u, v) parallel to (X_c, Y_c), i.e.
    u*(r21 X + r22 Y + t2) - v*(r11 X + r12 Y + t1) = 0 — poly-free
    (ScaramuzzaCamera.cc estimateIntrinsics stage 1)."""
    u, v = xy[:, 0], xy[:, 1]
    X, Y = XY[:, 0], XY[:, 1]
    A = np.stack([-v * X, -v * Y, u * X, u * Y, -v, u], axis=-1)
    _, _, Vt = np.linalg.svd(A, full_matrices=False)
    h = Vt[-1]
    r11, r12, r21, r22, t1, t2 = h

    # Recover r31, r32 and the scale from orthonormality of R's columns:
    # ||c1|| = ||c2||, c1.c2 = 0 with c1 = (r11, r21, r31), c2 = (r12, r22, r32).
    AA = r11 * r12 + r21 * r22          # = -r31*r32
    BB = (r11**2 + r21**2) - (r12**2 + r22**2)  # = r32^2 - r31^2
    # r31^2 is a root of x^2 + BB*x - AA^2 = 0 (substituting r32=-AA/r31).
    disc = max(BB * BB + 4 * AA * AA, 0.0)
    r31_sq = max((-BB + np.sqrt(disc)) / 2.0, 0.0)
    sols = []
    for s31 in (+1.0, -1.0):
        r31 = s31 * np.sqrt(r31_sq)
        if abs(r31) > 1e-12:
            r32 = -AA / r31
        else:
            r32 = np.sqrt(max(-BB, 0.0))
        for s32 in ((+1.0,) if abs(r31) > 1e-12 else (+1.0, -1.0)):
            sols.append((r31, s32 * r32))
    out = []
    for r31, r32 in sols:
        scale = np.sqrt(r11**2 + r21**2 + r31**2)
        if scale < 1e-12:
            continue
        for sgn in (+1.0, -1.0):
            c1 = np.array([r11, r21, r31]) * sgn / scale
            c2 = np.array([r12, r22, r32]) * sgn / scale
            c3 = np.cross(c1, c2)
            R = np.stack([c1, c2, c3], axis=1)
            t12 = np.array([t1, t2]) * sgn / scale
            out.append((R, t12))
    return out


def _ocam_linear_poly(views, poly_deg=4):
    """Joint linear solve for poly coeffs (a0, a2..a_deg; a1=0) and per-view
    t3 given partial extrinsics (stage 2 of estimateIntrinsics).

    Our lift convention is bearing = (x, y, -poly(rho)) with camera point
    (X_c, Y_c, Z_c) ∝ bearing, so Z_c = -poly(rho) * s. The v-row equation:
        poly(rho) * B_y = -v * (Z_part + t3)
    where B_y = r21 X + r22 Y + t2 (∝ v) and Z_part = r31 X + r32 Y."""
    n_t3 = len(views)
    n_coef = poly_deg  # a0 plus a2..a_deg
    rows, rhs = [], []
    for k, (xy, XY, R, t12) in enumerate(views):
        u, v = xy[:, 0], xy[:, 1]
        rho = np.sqrt(u * u + v * v)
        X, Y = XY[:, 0], XY[:, 1]
        Ax = R[0, 0] * X + R[0, 1] * Y + t12[0]
        Ay = R[1, 0] * X + R[1, 1] * Y + t12[1]
        Zp = R[2, 0] * X + R[2, 1] * Y
        for comp, img in ((Ax, u), (Ay, v)):
            # poly(rho)*comp + img*t3 = -img*Zp
            blk = np.zeros((len(u), n_coef + n_t3))
            blk[:, 0] = comp
            for d in range(2, poly_deg + 1):
                blk[:, d - 1] = comp * rho**d
            blk[:, n_coef + k] = img
            rows.append(blk)
            rhs.append(-img * Zp)
    A = np.concatenate(rows)
    b = np.concatenate(rhs)
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    poly = np.zeros(poly_deg + 1)
    poly[0] = sol[0]
    poly[2:] = sol[1:n_coef]
    t3 = sol[n_coef:]
    return poly, t3


def calibrate_scaramuzza(
    obj_pts,
    img_pts,
    image_size,
    poly_deg: int = 4,
    inv_poly_size: int = 20,
    refine_iters: int = 40,
):
    """Calibrate an OCAM/PAL camera from chessboard views.

    obj_pts: list of [N, 2|3] planar board coordinates per view.
    img_pts: list of [N, 2] detected pixel corners per view.
    Returns (params dict for ScaramuzzaCamera, extrinsics [(R, t)], rms_px)
    — rms is the pixel reprojection residual.
    """
    W, H = image_size
    cx0, cy0 = W / 2.0, H / 2.0

    # Stage 1+2: partial extrinsics per view, disambiguated by the linear
    # poly fit's residual (the reference tries hypotheses and keeps the best).
    best = None
    chosen = []
    for XY, xy in zip(map(_planar, obj_pts), img_pts):
        xy_c = np.asarray(xy, np.float64) - np.array([cx0, cy0])
        cands = _ocam_partial_extrinsics(xy_c, XY)
        # score each candidate alone with a mini linear fit
        scored = []
        for R, t12 in cands:
            poly, t3 = _ocam_linear_poly([(xy_c, XY, R, t12)], poly_deg)
            zc = R[2, 0] * XY[:, 0] + R[2, 1] * XY[:, 1] + t3[0]
            # board must be in front in range; poly(0)=a0 < 0 for our sign
            # convention (lift z = -poly -> a0 gives forward hemisphere).
            resid = _ocam_view_residual(xy_c, XY, R, t12, t3[0], poly)
            scored.append((resid, R, t12))
        scored.sort(key=lambda s: s[0])
        chosen.append(scored[0][1:])
    views = [
        (np.asarray(xy, np.float64) - np.array([cx0, cy0]), _planar(XY_), R, t12)
        for (XY_, xy, (R, t12)) in zip(obj_pts, img_pts, chosen)
    ]
    poly, t3s = _ocam_linear_poly(views, poly_deg)

    # Stage 3: nonlinear refinement on unit-bearing residuals over
    # (poly, cx, cy, per-view so3+t). C/D/E affine kept at identity (the
    # reference also initializes them so and refines optionally).
    K = len(views)

    def pack():
        x = [poly, [cx0, cy0]]
        for (xyc, XY, R, t12), t3 in zip(views, t3s):
            x.append(hg.so3_log(hg.mat_to_quat(R)))
            x.append([t12[0], t12[1], t3])
        return np.concatenate([np.atleast_1d(np.asarray(v, np.float64)) for v in x])

    n_poly = poly_deg + 1

    def unpack(x):
        p = x[:n_poly].copy()
        p[1] = 0.0  # Scaramuzza constraint: dz/drho(0) = 0 (a1 == 0)
        cx, cy = x[n_poly], x[n_poly + 1]
        ext = []
        off = n_poly + 2
        for k in range(K):
            w = x[off : off + 3]
            t = x[off + 3 : off + 6]
            ext.append((hg.quat_to_mat(hg.so3_exp(w)), t))
            off += 6
        return p, cx, cy, ext

    all_XY = [v[1] for v in views]
    all_xy = [np.asarray(ip, np.float64) for ip in img_pts]
    max_rho = float(np.hypot(W, H) / 2.0)

    def project(p, Pc, rho_init):
        """Forward-model projection: solve poly(rho) = k*rho (k = -Zc/r_xy)
        by Newton from the measured radius (pixel reprojection — no
        inverse-poly needed during calibration)."""
        rxy = np.maximum(np.linalg.norm(Pc[:, :2], axis=-1), 1e-12)
        k = -Pc[:, 2] / rxy
        rho = np.clip(rho_init, 1.0, max_rho)
        dp = np.polyder(np.poly1d(p[::-1]))
        pf = np.poly1d(p[::-1])
        for _ in range(20):
            f = pf(rho) - k * rho
            df = dp(rho) - k
            df = np.where(np.abs(df) < 1e-9, np.sign(df + 1e-30) * 1e-9, df)
            rho = np.clip(rho - f / df, 0.5, max_rho * 1.5)
        return Pc[:, :2] / rxy[:, None] * rho[:, None]

    def residuals(x):
        p, cx, cy, ext = unpack(x)
        out = []
        for (R, t), XY, xy in zip(ext, all_XY, all_xy):
            Pc = XY @ R[:, :2].T + t  # [N, 3] camera points (board z=0)
            u = xy[:, 0] - cx
            v = xy[:, 1] - cy
            rho_meas = np.sqrt(u * u + v * v)
            pred = project(p, Pc, rho_meas)
            out.append((pred - np.stack([u, v], -1)).ravel())
        return np.concatenate(out)

    x_opt, rms = _gauss_newton(residuals, pack(), n_iters=refine_iters)
    p_opt, cx, cy, ext = unpack(x_opt)

    # Stage 4: inverse-poly refit theta->rho over the calibrated range.
    max_rho = float(np.hypot(W, H) / 2.0)
    rhos = np.linspace(1.0, max_rho, 600)
    z = np.polyval(p_opt[::-1], rhos)
    theta = np.arctan2(z, rhos)
    ok = np.isfinite(theta)
    A = np.vander(theta[ok], inv_poly_size, increasing=True)
    inv_poly, *_ = np.linalg.lstsq(A, rhos[ok], rcond=None)

    params = dict(
        poly=np.concatenate([p_opt, np.zeros(max(0, 5 - len(p_opt)))])[:5]
        if len(p_opt) <= 5 else p_opt,
        inv_poly=inv_poly,
        C=1.0, D=0.0, E=0.0, cx=float(cx), cy=float(cy),
    )
    return params, ext, rms


def _ocam_view_residual(xy_c, XY, R, t12, t3, poly):
    # Sign convention (ScaramuzzaCamera.cc lift, "changed by wz"): the lift
    # z-component is -poly(rho), and poly(0) < 0 so the image center looks
    # toward +z. Candidates in the mirrored basin (a0 > 0) are unreachable
    # from SO(3) refinement and must be rejected here.
    if poly[0] > 0:
        return np.inf
    Pc = _planar(XY) @ R[:, :2].T + np.array([t12[0], t12[1], t3])
    if np.any(np.linalg.norm(Pc, axis=-1) < 1e-9):
        return np.inf
    u, v = xy_c[:, 0], xy_c[:, 1]
    rho = np.sqrt(u * u + v * v)
    z = np.polyval(poly[::-1], rho)
    b = np.stack([u, v, -z], axis=-1)
    bn = np.linalg.norm(b, axis=-1, keepdims=True)
    pn = np.linalg.norm(Pc, axis=-1, keepdims=True)
    r = b / np.maximum(bn, 1e-12) - Pc / np.maximum(pn, 1e-12)
    return float(np.sqrt(np.mean(r * r)))


# --------------------------------------------------------------------------
# Pinhole (Zhang)
# --------------------------------------------------------------------------

def _homography(XY, xy):
    """DLT homography board->image with Hartley normalization."""
    def norm(pts):
        m = pts.mean(0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - m, axis=-1)), 1e-12)
        T = np.array([[s, 0, -s * m[0]], [0, s, -s * m[1]], [0, 0, 1.0]])
        ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=-1) @ T.T
        return ph, T

    src, Ts = norm(XY)
    dst, Td = norm(xy)
    rows = []
    for (X, Y, _), (u, v, _) in zip(src, dst):
        rows.append([-X, -Y, -1, 0, 0, 0, u * X, u * Y, u])
        rows.append([0, 0, 0, -X, -Y, -1, v * X, v * Y, v])
    _, _, Vt = np.linalg.svd(np.asarray(rows))
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def _vij(H, i, j):
    return np.array(
        [
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ]
    )


def _zhang_linear(obj_pts, img_pts):
    """Zhang's linear stage: homographies → B-matrix → (α, β, u0, v0) and
    per-view extrinsics. Shared by the pinhole, Mei and Kannala-Brandt
    solvers (the latter two use it as a central-pinhole approximation to
    seed their nonlinear refinement, the same bootstrap role the
    reference's estimateIntrinsics plays)."""
    Hs = [
        _homography(_planar(XY), np.asarray(xy, np.float64))
        for XY, xy in zip(obj_pts, img_pts)
    ]
    V = np.concatenate([np.stack([_vij(H, 0, 1), _vij(H, 0, 0) - _vij(H, 1, 1)]) for H in Hs])
    _, _, Vt = np.linalg.svd(V)
    b = Vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = np.sqrt(abs(lam / B11))
    beta = np.sqrt(abs(lam * B11 / (B11 * B22 - B12 * B12)))
    u0 = -B13 * alpha * alpha / lam
    K = np.array([[alpha, 0, u0], [0, beta, v0], [0, 0, 1.0]])

    exts = []
    Kinv = np.linalg.inv(K)
    for H in Hs:
        h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
        s = 1.0 / np.linalg.norm(Kinv @ h1)
        r1 = s * (Kinv @ h1)
        r2 = s * (Kinv @ h2)
        t = s * (Kinv @ h3)
        r3 = np.cross(r1, r2)
        R = np.stack([r1, r2, r3], axis=1)
        U, _, Vt2 = np.linalg.svd(R)
        R = U @ Vt2
        if t[2] < 0:
            R, t = -R, -t  # board must be in front
            R[:, 2] = np.cross(R[:, 0], R[:, 1])
        exts.append((R, t))
    return alpha, beta, u0, v0, exts


def calibrate_pinhole(obj_pts, img_pts, image_size, refine_iters: int = 40):
    """Zhang's method + rad-tan GN refinement.

    Returns (params dict for PinholeCamera, extrinsics [(R, t)], rms_px)."""
    alpha, beta, u0, v0, exts = _zhang_linear(obj_pts, img_pts)
    Kv = len(exts)

    def pack():
        x = [[alpha, beta, u0, v0, 0.0, 0.0, 0.0, 0.0]]
        for R, t in exts:
            x.append(hg.so3_log(hg.mat_to_quat(R)))
            x.append(t)
        return np.concatenate([np.atleast_1d(np.asarray(v, np.float64)) for v in x])

    def unpack(x):
        fx, fy, cx, cy, k1, k2, p1, p2 = x[:8]
        ext = []
        off = 8
        for k in range(Kv):
            w = x[off : off + 3]
            t = x[off + 3 : off + 6]
            ext.append((hg.quat_to_mat(hg.so3_exp(w)), t))
            off += 6
        return (fx, fy, cx, cy, k1, k2, p1, p2), ext

    all_XY = [_planar(XY) for XY in obj_pts]
    all_xy = [np.asarray(xy, np.float64) for xy in img_pts]

    def residuals(x):
        (fx, fy, cx, cy, k1, k2, p1, p2), ext = unpack(x)
        out = []
        for (R, t), XY, xy in zip(ext, all_XY, all_xy):
            Pc = XY @ R[:, :2].T + t
            xn = Pc[:, 0] / Pc[:, 2]
            yn = Pc[:, 1] / Pc[:, 2]
            r2 = xn * xn + yn * yn
            rad = 1 + k1 * r2 + k2 * r2 * r2
            xd = xn * rad + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
            yd = yn * rad + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
            u = fx * xd + cx
            v = fy * yd + cy
            out.append((np.stack([u, v], -1) - xy).ravel())
        return np.concatenate(out)

    x_opt, rms = _gauss_newton(residuals, pack(), n_iters=refine_iters)
    (fx, fy, cx, cy, k1, k2, p1, p2), ext = unpack(x_opt)
    params = dict(fx=fx, fy=fy, cx=cx, cy=cy, k1=k1, k2=k2, p1=p1, p2=p2)
    return params, ext, rms


# --------------------------------------------------------------------------
# Mei (unified catadioptric) calibration
# --------------------------------------------------------------------------

def _mei_project_np(params, Pc):
    """Numpy (f64) mirror of MeiCamera.space_to_plane."""
    xi, k1, k2, p1, p2, g1, g2, u0, v0 = params
    n = np.linalg.norm(Pc, axis=-1)
    z = Pc[:, 2] + xi * n
    z = np.where(np.abs(z) < 1e-12, 1e-12, z)
    x = Pc[:, 0] / z
    y = Pc[:, 1] / z
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2
    dx = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = y * rad + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
    return np.stack([g1 * (x + dx) + u0, g2 * (y + dy) + v0], -1)


def _per_view_refine(project_np, params, obj_pts, img_pts, exts,
                     refine_iters):
    """Shared intrinsics+extrinsics GN refinement on pixel residuals for
    the non-pinhole solvers (same LM harness as the OCAM/pinhole paths —
    the counterpart of the reference's one Ceres cost-function factory,
    CostFunctionFactory.cc:533-822)."""
    Kv = len(exts)
    n_int = len(params)
    all_XY = [_planar(XY) for XY in obj_pts]
    all_xy = [np.asarray(xy, np.float64) for xy in img_pts]

    def pack():
        x = [np.asarray(params, np.float64)]
        for R, t in exts:
            x.append(hg.so3_log(hg.mat_to_quat(R)))
            x.append(np.asarray(t, np.float64))
        return np.concatenate(x)

    def unpack(x):
        pr = x[:n_int]
        ext = []
        off = n_int
        for _ in range(Kv):
            w = x[off : off + 3]
            t = x[off + 3 : off + 6]
            ext.append((hg.quat_to_mat(hg.so3_exp(w)), t))
            off += 6
        return pr, ext

    def residuals(x):
        pr, ext = unpack(x)
        out = []
        for (R, t), XY, xy in zip(ext, all_XY, all_xy):
            Pc = XY @ R[:, :2].T + t
            out.append((project_np(pr, Pc) - xy).ravel())
        return np.concatenate(out)

    x_opt, rms = _gauss_newton(residuals, pack(), n_iters=refine_iters)
    pr, ext = unpack(x_opt)
    return pr, ext, rms


def calibrate_mei(obj_pts, img_pts, image_size, refine_iters: int = 60):
    """Mei / unified-catadioptric calibration (reference: CataCamera +
    CostFunctionFactory.cc:533-822 via calib/CameraCalibration.cc).

    Bootstrap: Zhang's linear stage as a central-pinhole approximation with
    ξ₀ = 1 (parabolic) — γ ≈ α/(1+ξ) — then a full GN refinement of
    (ξ, k1, k2, p1, p2, γ1, γ2, u0, v0) + per-view extrinsics on pixel
    reprojection. Returns (params dict for MeiCamera, extrinsics, rms_px).
    """
    alpha, beta, u0, v0, exts = _zhang_linear(obj_pts, img_pts)
    xi0 = 1.0
    params0 = np.array([
        xi0, 0.0, 0.0, 0.0, 0.0,
        alpha / (1.0 + xi0), beta / (1.0 + xi0), u0, v0,
    ])
    pr, ext, rms = _per_view_refine(
        _mei_project_np, params0, obj_pts, img_pts, exts, refine_iters
    )
    params = dict(
        xi=pr[0], k1=pr[1], k2=pr[2], p1=pr[3], p2=pr[4],
        gamma1=pr[5], gamma2=pr[6], u0=pr[7], v0=pr[8],
    )
    return params, ext, rms


# --------------------------------------------------------------------------
# Kannala-Brandt (equidistant fisheye) calibration
# --------------------------------------------------------------------------

def _kb_project_np(params, Pc):
    """Numpy (f64) mirror of KannalaBrandtCamera.space_to_plane."""
    mu, mv, u0, v0, k2, k3, k4, k5 = params
    rxy = np.sqrt(Pc[:, 0] ** 2 + Pc[:, 1] ** 2)
    theta = np.arctan2(rxy, Pc[:, 2])
    th2 = theta * theta
    r = theta * (1.0 + th2 * (k2 + th2 * (k3 + th2 * (k4 + th2 * k5))))
    safe = np.maximum(rxy, 1e-12)
    xd = r * Pc[:, 0] / safe
    yd = r * Pc[:, 1] / safe
    return np.stack([mu * xd + u0, mv * yd + v0], -1)


def calibrate_kannala_brandt(obj_pts, img_pts, image_size,
                             refine_iters: int = 60):
    """Kannala-Brandt (equidistant fisheye) calibration (reference:
    EquidistantCamera + CostFunctionFactory.cc via CameraCalibration.cc).

    Bootstrap: Zhang's linear stage (for small θ, r(θ) ≈ θ makes the model
    pinhole-like with f = μ), then full GN refinement of
    (μ, ν, u0, v0, k2..k5) + per-view extrinsics on pixel reprojection.
    Returns (params dict for KannalaBrandtCamera, extrinsics, rms_px)."""
    alpha, beta, u0, v0, exts = _zhang_linear(obj_pts, img_pts)
    params0 = np.array([alpha, beta, u0, v0, 0.0, 0.0, 0.0, 0.0])
    pr, ext, rms = _per_view_refine(
        _kb_project_np, params0, obj_pts, img_pts, exts, refine_iters
    )
    params = dict(
        mu=pr[0], mv=pr[1], u0=pr[2], v0=pr[3],
        k2=pr[4], k3=pr[5], k4=pr[6], k5=pr[7],
    )
    return params, ext, rms


# --------------------------------------------------------------------------
# detection + synthetic data
# --------------------------------------------------------------------------

def find_chessboard_corners(img, pattern_size, device=None):
    """Detect chessboard inner corners (sub-pixel, board-ordered) with the
    NATIVE saddle-response detector (calib/chessboard.py) — the in-house
    equivalent of the reference's 2k-LoC grown-quad detector
    (camera_model/src/chessboard/Chessboard.cc).

    pattern_size follows the OpenCV (cols, rows) convention used by the
    reference CLI; returns [rows*cols, 2] corners (row-major) or None. The
    response runs on ``device`` (None: the CUDA card)."""
    from .chessboard import find_chessboard_corners as _native

    img = np.asarray(img)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    cols, rows = int(pattern_size[0]), int(pattern_size[1])
    corners, found = _native(img, (rows, cols), device)
    return corners if found else None


def synth_chessboard_views(camera, n_views, pattern=(6, 9), square=0.05,
                           seed=0, depth=0.6, directions=None):
    """Generate synthetic chessboard calibration data through a camera model
    (for tests and tooling demos). Returns (obj_pts, img_pts, extrinsics).

    ``directions``: optional [K, 3] camera-frame unit bearings at which board
    centers are placed (at ``depth``), each board oriented to face the
    camera. For large-FoV models pass bearings spread over the annulus so
    every radius of the polynomial is observed (boards straight ahead only
    constrain the image center)."""
    cam = camera.to(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(pattern[0]), np.arange(pattern[1]))
    XY = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float64) * square
    XY -= XY.mean(0)
    obj, img, exts = [], [], []
    k = 0
    while len(obj) < n_views:
        if directions is not None:
            d = np.asarray(directions[k % len(directions)], np.float64)
            d = d / np.linalg.norm(d)
            k += 1
            # Board frame: z-axis toward the camera center (-d), with a
            # random in-plane roll and a small random tilt.
            z = -d
            a = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
            x = np.cross(a, z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            R = np.stack([x, y, z], axis=1)
            R = R @ hg.quat_to_mat(hg.so3_exp(rng.normal(0, 0.15, 3)))
            t = d * (depth + rng.normal(0, 0.05))
        else:
            w = rng.normal(0, 0.25, 3)
            R = hg.quat_to_mat(hg.so3_exp(w))
            t = np.array([rng.normal(0, 0.08), rng.normal(0, 0.08),
                          depth + rng.normal(0, 0.1)])
        Pc = XY @ R[:, :2].T + t
        pix = cam.space_to_plane(torch.as_tensor(Pc)).numpy()
        if not np.isfinite(pix).all():
            continue
        obj.append(XY.copy())
        img.append(pix)
        exts.append((R, t))
    return obj, img, exts
