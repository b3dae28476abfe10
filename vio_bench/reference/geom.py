"""Quaternion and SO(3) helpers of the plain reference (Hamilton, [w, x, y, z];
yaw-pitch-roll in degrees), in plain torch, any dtype, batched over leading
dimensions."""

from __future__ import annotations

import math

import torch


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def qmul(q, p):
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack([qw * pw - qx * px - qy * py - qz * pz,
                        qw * px + qx * pw + qy * pz - qz * py,
                        qw * py - qx * pz + qy * pw + qz * px,
                        qw * pz + qx * py - qy * px + qz * pw], dim=-1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qmat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def qrot(q, v):
    """R(q) v, a matrix product (so a TF32 setting rounds it)."""
    return (qmat(q) @ v[..., None])[..., 0]


def small_angle(theta):
    """First-order quaternion exponential [1, θ/2] (not normalized)."""
    return torch.cat([torch.ones_like(theta[..., :1]), 0.5 * theta], dim=-1)


def so3_exp(theta):
    sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    small = sq < 1e-16
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(0.5 * angle) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(0.5 * angle))
    return torch.cat([w, k * theta], dim=-1)


def positify(q):
    return torch.where(q[..., :1] >= 0, q, -q)


def box_minus(q, q0):
    """2 vec(q0⁻¹ ⊗ q), the sign fixed so that w >= 0."""
    return 2.0 * positify(qmul(qconj(q0), q))[..., 1:]


def mat_to_quat(R):
    """Rotation matrix -> unit quaternion (w >= 0), Shepperd's method."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = torch.stack([
        torch.stack([1 + tr, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2], 1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2], m[..., 1, 2] + m[..., 2, 1]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1], 1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1),
    ], -2)
    idx = torch.argmax(torch.diagonal(cands, dim1=-2, dim2=-1), dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    return positify(qnormalize(q))


def R_to_ypr_deg(R):
    n, o, a = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
                    -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y))
    return torch.stack([y, p, r], dim=-1) * (180.0 / math.pi)


def ypr_deg_to_R(ypr):
    y, p, r = (ypr * (math.pi / 180.0)).unbind(-1)
    one, zero = torch.ones_like(y), torch.zeros_like(y)
    mat = lambda rows: torch.stack([torch.stack(row, -1) for row in rows], -2)
    Rz = mat([[torch.cos(y), -torch.sin(y), zero], [torch.sin(y), torch.cos(y), zero],
              [zero, zero, one]])
    Ry = mat([[torch.cos(p), zero, torch.sin(p)], [zero, one, zero],
              [-torch.sin(p), zero, torch.cos(p)]])
    Rx = mat([[one, zero, zero], [zero, torch.cos(r), -torch.sin(r)],
              [zero, torch.sin(r), torch.cos(r)]])
    return Rz @ Ry @ Rx


def tangent_basis(a):
    """2×3 orthonormal basis of the tangent plane at unit bearings a [..., 3]."""
    zaxis = torch.zeros_like(a)
    zaxis[..., 2] = 1.0
    xaxis = torch.zeros_like(a)
    xaxis[..., 0] = 1.0
    is_z = torch.all(torch.abs(a - zaxis) < 1e-12, dim=-1, keepdim=True)
    tmp = torch.where(is_z, xaxis, zaxis)
    b1 = tmp - a * torch.sum(a * tmp, dim=-1, keepdim=True)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    return torch.stack([b1, torch.linalg.cross(a, b1, dim=-1)], dim=-2)


def angle_between(q1, q2):
    """Rotation angle (rad) between unit quaternions."""
    return torch.linalg.norm(box_minus(q1, q2), dim=-1)
