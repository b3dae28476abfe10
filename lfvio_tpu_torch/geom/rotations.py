"""SO(3) / quaternion math core on torch tensors (batched, dtype-preserving).

Port of ``lfvio_tpu.geom.rotations`` with the same conventions:

  * Hamilton quaternions stored as ``[w, x, y, z]``.
  * ``quat_from_small_angle(theta)`` is the first-order exponential
    ``[1, theta/2]`` ("deltaQ").
  * Euler helpers use yaw-pitch-roll (ZYX) in degrees.

Every function broadcasts over leading batch dimensions and keeps the input
dtype and device. The solver's factors differentiate none of them: their
Jacobians are analytic (``backend/factors.py``).
"""

from __future__ import annotations

import math

import torch


def _vec(v, like):
    """The constant vector ``v`` on ``like``'s device and dtype, filled there
    (a host copy could not be captured in a CUDA graph)."""
    out = torch.empty(len(v), dtype=like.dtype, device=like.device)
    for i, x in enumerate(v):
        out[i].fill_(x)
    return out


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix. Batched over leading dims."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def quat_identity(dtype=torch.float32, device=None):
    # Filled on the device (no host copy: capturable in a CUDA graph).
    q = torch.zeros(4, dtype=dtype, device=device)
    q[0].fill_(1.0)
    return q


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(q, p):
    """Hamilton product q ⊗ p, both [..., 4] wxyz."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * _vec([1.0, -1.0, -1.0, -1.0], q)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q (R(q) @ v)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_from_small_angle(theta):
    """First-order quaternion exp [1, theta/2] (not normalized)."""
    one = torch.ones_like(theta[..., 0:1])
    return torch.cat([one, 0.5 * theta], dim=-1)


def quat_to_mat(q):
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def quat_positify(q):
    """Flip sign so w >= 0 (canonical double-cover representative)."""
    return torch.where(q[..., 0:1] >= 0, q, -q)


def mat_to_quat(R):
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] wxyz (w>=0).

    Branch-free Shepperd extraction: all four candidates, the best-
    conditioned one selected per matrix."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(cand), 4(wxyz)]
    gather_idx = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(cands, -2, gather_idx)[..., 0, :]
    return quat_positify(quat_normalize(q))


def quat_left(q):
    """4x4 left-multiplication matrix: quat_mul(q, p) == quat_left(q) @ p."""
    w = q[..., 0]
    v = q[..., 1:4]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w[..., None], -v], dim=-1)[..., None, :]
    bottom = torch.cat([v[..., :, None], w[..., None, None] * eye + skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_right(p):
    """4x4 right-multiplication matrix: quat_mul(q, p) == quat_right(p) @ q."""
    w = p[..., 0]
    v = p[..., 1:4]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    top = torch.cat([w[..., None], -v], dim=-1)[..., None, :]
    bottom = torch.cat([v[..., :, None], w[..., None, None] * eye - skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_box_minus(q, q0):
    """Tangent-space difference 2*vec(q0^{-1} ⊗ q) with sign fix (w>=0)."""
    d = quat_positify(quat_mul(quat_conj(q0), q))
    return 2.0 * d[..., 1:4]


def so3_exp(theta):
    """Exact SO(3) exponential: axis-angle [..., 3] -> quaternion wxyz.

    Derivative-safe at theta=0 (the norm is guarded inside the branch and the
    small branch is the Taylor series), as the solver's forward-mode
    linearization evaluates it exactly there."""
    sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    small = sq < 1e-16
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(0.5 * angle) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(0.5 * angle))
    return torch.cat([w, k * theta], dim=-1)


def so3_log(q):
    """SO(3) log map: unit quaternion wxyz -> axis-angle [..., 3]."""
    q = quat_positify(q)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    sq = torch.sum(q[..., 1:4] * q[..., 1:4], dim=-1, keepdim=True)
    small = sq < 1e-16
    vnorm = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    angle = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-6), angle / vnorm)
    return scale * q[..., 1:4]


def R_to_ypr_deg(R):
    """Rotation matrix -> [yaw, pitch, roll] in degrees (reference R2ypr)."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1) * (180.0 / math.pi)


def ypr_deg_to_R(ypr):
    """[yaw, pitch, roll] degrees -> rotation matrix (Rz @ Ry @ Rx)."""
    rad = ypr * (math.pi / 180.0)
    y, p, r = rad[..., 0], rad[..., 1], rad[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    one = torch.ones_like(y)
    zero = torch.zeros_like(y)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    Rz = mat([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
    Ry = mat([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
    Rx = mat([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
    return Rz @ Ry @ Rx


def quat_from_two_vectors(a, b):
    """Shortest-arc quaternion rotating unit vector a onto unit vector b."""
    c = cross(a, b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    w = 1.0 + d
    ortho = torch.where(
        torch.abs(a[..., 0:1]) < 0.9,
        cross(a, _vec([1.0, 0.0, 0.0], a)),
        cross(a, _vec([0.0, 1.0, 0.0], a)),
    )
    q = torch.where(
        w < 1e-8,
        torch.cat([torch.zeros_like(w), ortho], dim=-1),
        torch.cat([w, c], dim=-1),
    )
    return quat_normalize(q)


def g2R(g):
    """World-aligning rotation: measured gravity direction -> +z with the yaw
    component removed (reference Utility::g2R)."""
    ng1 = g / torch.linalg.norm(g, dim=-1, keepdim=True)
    ng2 = _vec([0.0, 0.0, 1.0], g).expand_as(ng1)
    R0 = quat_to_mat(quat_from_two_vectors(ng1, ng2))
    yaw = R_to_ypr_deg(R0)[..., 0]
    zero = torch.zeros_like(yaw)
    return ypr_deg_to_R(torch.stack([-yaw, zero, zero], dim=-1)) @ R0


def tangent_basis(a):
    """2x3 orthonormal basis of the tangent plane at unit bearing(s) a,
    rows stacked as [..., 2, 3] (projection_factor.cpp:8-18 convention)."""
    zaxis = _vec([0.0, 0.0, 1.0], a)
    xaxis = _vec([1.0, 0.0, 0.0], a)
    is_z = torch.all(torch.abs(a - zaxis) < 1e-12, dim=-1, keepdim=True)
    tmp = torch.where(is_z, xaxis, zaxis)
    b1 = tmp - a * torch.sum(a * tmp, dim=-1, keepdim=True)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = cross(a, b1)
    return torch.stack([b1, b2], dim=-2)
