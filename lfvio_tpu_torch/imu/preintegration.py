"""IMU midpoint preintegration with first-order bias Jacobians and noise
covariance propagation, on torch tensors.

Port of ``lfvio_tpu.imu.preintegration`` (the reference's IntegrationBase,
integration_base.h:54-186). ``preintegrate`` takes any leading batch shape
(the estimator integrates all window intervals at once) and has log depth
in the sample count, like the JAX ``preintegrate_parallel``:

  1. the orientation chain Δq_k = r_1 ⊗ … ⊗ r_k is a prefix product
     (Hillis-Steele doubling), normalized once;
  2. the midpoint accelerations are then closed-form and (Δv, Δp) are
     cumulative sums;
  3. J = F_N···F_1 and P = Σ (F_N···F_{k+1}) Q_k (·)ᵀ are a pairwise tree
     reduction with (F_b, Q_b)∘(F_a, Q_a) = (F_b F_a, F_b Q_a F_bᵀ + Q_b).

Zero-padded samples (dt = 0) are exact no-ops (F = I, Q = 0, r = identity).
In exact arithmetic the result equals the sequential recursion
(``lfvio_tpu.imu.preintegrate``) as well.

State ordering: O_P=0, O_R=3, O_V=6, O_BA=9, O_BG=12 (parameters.h).
"""

from __future__ import annotations

import dataclasses

import torch

from ..geom import (
    quat_conj,
    quat_from_small_angle,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    skew,
    so3_exp,
)

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


@dataclasses.dataclass(frozen=True)
class ImuNoise:
    """Noise densities (config acc_n/gyr_n/acc_w/gyr_w)."""

    acc_n: float
    gyr_n: float
    acc_w: float
    gyr_w: float

    def noise_matrix(self, dtype, device=None):
        # Filled on the device (no host copy: capturable in a CUDA graph).
        d = torch.empty((6, 3), dtype=dtype, device=device)
        for k, x in enumerate((self.acc_n, self.gyr_n, self.acc_n, self.gyr_n,
                               self.acc_w, self.gyr_w)):
            d[k].fill_(x**2)
        return torch.diag(d.reshape(18))


@dataclasses.dataclass(frozen=True)
class Preintegration:
    """Result of integrating inter-frame IMU intervals (any batch shape B)."""

    delta_p: torch.Tensor  # [B, 3]
    delta_q: torch.Tensor  # [B, 4] wxyz
    delta_v: torch.Tensor  # [B, 3]
    jacobian: torch.Tensor  # [B, 15, 15] d(delta)/d[p,θ,v,ba,bg]
    covariance: torch.Tensor  # [B, 15, 15]
    sum_dt: torch.Tensor  # [B]
    linearized_ba: torch.Tensor  # [B, 3]
    linearized_bg: torch.Tensor  # [B, 3]


def _midpoint_FV(R0, R1, un_gyr, acc0_c, acc1_c, dt):
    """Midpoint transition F [..., 15, 15] and noise input V [..., 15, 18]
    (integration_base.h:78-131) given the prefix rotations."""
    dtype, dev = dt.dtype, dt.device
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(*dt.shape, 3, 3)
    Z3 = torch.zeros_like(I3)
    dt_ = dt[..., None, None]
    dt2 = dt_ * dt_
    A = I3 - skew(un_gyr) * dt_  # F[3:6, 3:6]
    R1Ra1 = R1 @ skew(acc1_c)
    R0Ra0 = R0 @ skew(acc0_c)
    F_pth = -0.25 * R0Ra0 * dt2 - 0.25 * (R1Ra1 @ A) * dt2
    F_vth = -0.5 * R0Ra0 * dt_ - 0.5 * (R1Ra1 @ A) * dt_

    def block(rows):
        return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)

    F = block([
        [I3, F_pth, I3 * dt_, -0.25 * (R0 + R1) * dt2, 0.25 * R1Ra1 * dt2 * dt_],
        [Z3, A, Z3, Z3, -I3 * dt_],
        [Z3, F_vth, I3, -0.5 * (R0 + R1) * dt_, 0.5 * R1Ra1 * dt_ * dt_],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ])
    v03 = -0.125 * R1Ra1 * dt2 * dt_
    v63 = -0.25 * R1Ra1 * dt_ * dt_
    V = block([
        [0.25 * R0 * dt2, v03, 0.25 * R1 * dt2, v03, Z3, Z3],
        [Z3, 0.5 * I3 * dt_, Z3, 0.5 * I3 * dt_, Z3, Z3],
        [0.5 * R0 * dt_, v63, 0.5 * R1 * dt_, v63, Z3, Z3],
        [Z3, Z3, Z3, Z3, I3 * dt_, Z3],
        [Z3, Z3, Z3, Z3, Z3, I3 * dt_],
    ])
    return F, V


def _prefix_quat(r):
    """Inclusive prefix products r_1 ⊗ … ⊗ r_k along dim -2 (log depth)."""
    n = r.shape[-2]
    d = 1
    while d < n:
        r = torch.cat([r[..., :d, :], quat_mul(r[..., :-d, :], r[..., d:, :])], dim=-2)
        d *= 2
    return r


def _reduce_FQ(F, Q):
    """Total (F_N···F_1, Σ (F_N···F_{k+1}) Q_k (·)ᵀ) over dim -3 by a
    pairwise tree; identity elements pad odd levels."""
    while F.shape[-3] > 1:
        if F.shape[-3] % 2:
            eye = torch.eye(15, dtype=F.dtype, device=F.device)
            F = torch.cat([F, eye.expand(*F.shape[:-3], 1, 15, 15)], dim=-3)
            Q = torch.cat([Q, torch.zeros_like(Q[..., :1, :, :])], dim=-3)
        Fa, Fb = F[..., 0::2, :, :], F[..., 1::2, :, :]
        Qa, Qb = Q[..., 0::2, :, :], Q[..., 1::2, :, :]
        F, Q = Fb @ Fa, Fb @ Qa @ Fb.transpose(-1, -2) + Qb
    return F[..., 0, :, :], Q[..., 0, :, :]


def preintegrate(dts, accs, gyrs, acc0, gyr0, ba, bg, noise: ImuNoise):
    """Integrate (padded) IMU sample buffers into a Preintegration.

    Args (leading batch dims B allowed):
      dts: [B, M] sample spacings; pad unused tail with 0 (exact no-op).
      accs, gyrs: [B, M, 3] samples at the *end* of each dt.
      acc0, gyr0: [B, 3] sample at the interval start.
      ba, bg: [B, 3] linearization biases.
    """
    dtype, dev = accs.dtype, accs.device
    prev_accs = torch.cat([acc0[..., None, :], accs[..., :-1, :]], dim=-2)
    prev_gyrs = torch.cat([gyr0[..., None, :], gyrs[..., :-1, :]], dim=-2)
    un_gyr = 0.5 * (prev_gyrs + gyrs) - bg[..., None, :]
    r_local = quat_from_small_angle(un_gyr * dts[..., None])

    # 1. Orientation prefix chain.
    dq_prefix = quat_normalize(_prefix_quat(r_local))  # Δq after step k
    ident = quat_identity(dtype, dev)
    dq_prev = torch.cat(
        [ident.expand(*dq_prefix.shape[:-2], 1, 4), dq_prefix[..., :-1, :]], dim=-2
    )
    R0 = quat_to_mat(dq_prev)
    R1 = quat_to_mat(dq_prefix)

    # 2. Midpoint accelerations → Δv, Δp by cumulative sums.
    acc0_c = prev_accs - ba[..., None, :]
    acc1_c = accs - ba[..., None, :]
    un_acc = 0.5 * ((R0 @ acc0_c[..., None])[..., 0] + (R1 @ acc1_c[..., None])[..., 0])
    dt_ = dts[..., None]
    dv_prefix = torch.cumsum(un_acc * dt_, dim=-2)
    dv_prev = torch.cat([torch.zeros_like(dv_prefix[..., :1, :]), dv_prefix[..., :-1, :]], dim=-2)
    delta_p = torch.sum(dv_prev * dt_ + 0.5 * un_acc * dt_**2, dim=-2)

    # 3. Jacobian + covariance as one (F, Q) reduction.
    F, V = _midpoint_FV(R0, R1, un_gyr, acc0_c, acc1_c, dts)
    Q = V @ noise.noise_matrix(dtype, dev) @ V.transpose(-1, -2)
    Ftot, Qtot = _reduce_FQ(F, Q)
    # Contiguous copies of the last step: the IMU kernels take dense inputs.
    return Preintegration(
        delta_p, dq_prefix[..., -1, :].contiguous(), dv_prefix[..., -1, :].contiguous(), Ftot,
        Qtot, torch.sum(dts, dim=-1), ba, bg,
    )


def bias_corrected_delta(pre: Preintegration, ba_new, bg_new):
    """First-order-corrected (Δp, Δq, Δv) at updated biases
    (integration_base.h:160-175)."""
    J = pre.jacobian
    dba = (ba_new - pre.linearized_ba)[..., None]
    dbg = (bg_new - pre.linearized_bg)[..., None]
    dp = pre.delta_p + (J[..., O_P:O_P + 3, O_BA:O_BA + 3] @ dba)[..., 0] \
        + (J[..., O_P:O_P + 3, O_BG:O_BG + 3] @ dbg)[..., 0]
    dv = pre.delta_v + (J[..., O_V:O_V + 3, O_BA:O_BA + 3] @ dba)[..., 0] \
        + (J[..., O_V:O_V + 3, O_BG:O_BG + 3] @ dbg)[..., 0]
    dq = quat_mul(
        pre.delta_q,
        quat_from_small_angle((J[..., O_R:O_R + 3, O_BG:O_BG + 3] @ dbg)[..., 0]),
    )
    return dp, quat_normalize(dq), dv


def imu_residual(pre: Preintegration, p_i, q_i, v_i, ba_i, bg_i,
                 p_j, q_j, v_j, ba_j, bg_j, gravity):
    """15-dim preintegration residual (integration_base.h:160-186)."""
    dp, dq, dv = bias_corrected_delta(pre, ba_i, bg_i)
    qi_inv = quat_conj(q_i)
    sum_dt = pre.sum_dt[..., None]
    r_p = quat_rotate(qi_inv, 0.5 * gravity * sum_dt**2 + p_j - p_i - v_i * sum_dt) - dp
    r_q = 2.0 * quat_mul(quat_conj(dq), quat_mul(qi_inv, q_j))[..., 1:4]
    r_v = quat_rotate(qi_inv, gravity * sum_dt + v_j - v_i) - dv
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], dim=-1)


def whiten_covariance(cov, valid):
    """Batched whitening S with SᵀS = cov⁻¹ via a diagonally scaled
    Cholesky (cov = D·C·D, S = chol(C)⁻¹·D⁻¹), f32-safe.

    Returns (sqrt_info [..., 15, 15], ok [...]) — zeroed / False where the
    factorization failed or the interval was invalid."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=1e-24))
    dinv = 1.0 / d
    corr = cov * dinv[..., :, None] * dinv[..., None, :] + 1e-6 * eye
    corr = torch.where(valid[..., None, None], corr, eye)
    L, info = torch.linalg.cholesky_ex(corr)
    # A failed factorization becomes non-finite (as jnp.linalg.cholesky's
    # NaN), which the ok test below catches.
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    S = Linv * dinv[..., None, :]
    ok = valid & torch.isfinite(S).all(dim=-1).all(dim=-1)
    # Row-major (the triangular solve may return column-major matrices): the
    # IMU kernels take dense inputs.
    return torch.where(ok[..., None, None], S, 0.0).contiguous(), ok


def propagate_state_midpoint(p, q, v, acc_0, gyr_0, acc_1, gyr_1, dt, ba, bg, gravity):
    """World-frame midpoint propagation of (p, q, v) through one IMU sample
    (estimator.cpp:109-116, estimator_node.cpp:41-77)."""
    un_acc_0 = quat_rotate(q, acc_0 - ba) - gravity
    un_gyr = 0.5 * (gyr_0 + gyr_1) - bg
    q_new = quat_normalize(quat_mul(q, quat_from_small_angle(un_gyr * dt)))
    un_acc_1 = quat_rotate(q_new, acc_1 - ba) - gravity
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    return p + dt * v + 0.5 * dt * dt * un_acc, q_new, v + dt * un_acc


def propagate_interval_midpoint(p, q, v, dts, accs, gyrs, acc0, gyr0, ba, bg, gravity):
    """World-frame midpoint propagation of one state (p, q, v) through a
    whole (padded) interval [M] of IMU samples at fixed biases: what M calls
    of ``propagate_state_midpoint`` with exact rotation increments give, in
    log depth. The orientations are a prefix product of the increments; the
    midpoint accelerations are then closed-form and (v, p) are cumulative
    sums. Zero-padded samples (dt = 0) are exact no-ops."""
    prev_accs = torch.cat([acc0[None, :], accs[:-1]], dim=0)
    prev_gyrs = torch.cat([gyr0[None, :], gyrs[:-1]], dim=0)
    dt = dts[:, None]
    r = so3_exp((0.5 * (prev_gyrs + gyrs) - bg) * dt)
    q_k = quat_normalize(quat_mul(q, _prefix_quat(r)))  # orientation after step k
    q_prev = torch.cat([q[None, :], q_k[:-1]], dim=0)
    un_acc = 0.5 * (quat_rotate(q_prev, prev_accs - ba) + quat_rotate(q_k, accs - ba)) - gravity
    dv = torch.cumsum(un_acc * dt, dim=0)
    v_prev = v + torch.cat([torch.zeros_like(dv[:1]), dv[:-1]], dim=0)
    p_end = p + torch.sum(dt * v_prev + 0.5 * dt * dt * un_acc, dim=0)
    return p_end, q_k[-1], v + dv[-1]
