"""4-DoF yaw-gauge fix (port of ``lfvio_tpu.backend.gauge``).

The sliding-window BA leaves global yaw and position unobservable; after
every solve the window is rotated and shifted so frame 0 keeps its
pre-solve yaw and position (double2vector, estimator.cpp:532-626), with
the full-rotation re-anchor near the Euler singularity (|pitch| ~ 90°).
"""

from __future__ import annotations

import torch

from ..geom import R_to_ypr_deg, mat_to_quat, quat_to_mat, ypr_deg_to_R
from .state import WindowState


def yaw_gauge_transform(out: WindowState, origin_p0, origin_q0):
    """(rot_diff, pivot) re-anchoring frame 0 to its pre-solve yaw/position."""
    R_origin = quat_to_mat(origin_q0)
    ypr_origin = R_to_ypr_deg(R_origin)
    R00 = quat_to_mat(out.q[0])
    ypr_new = R_to_ypr_deg(R00)
    y_diff = ypr_origin[0] - ypr_new[0]
    zero = torch.zeros_like(y_diff)
    rot_yaw = ypr_deg_to_R(torch.stack([y_diff, zero, zero]))
    singular = (torch.abs(torch.abs(ypr_origin[1]) - 90.0) < 1.0) | (
        torch.abs(torch.abs(ypr_new[1]) - 90.0) < 1.0
    )
    return torch.where(singular, R_origin @ R00.T, rot_yaw), out.p[0]


def yaw_gauge_fix(out: WindowState, origin_p0, origin_q0) -> WindowState:
    """Rotate/translate the solved window so frame 0 recovers the yaw and
    position it had before the solve (origin_p0 / origin_q0)."""
    rot_diff, pivot = yaw_gauge_transform(out, origin_p0, origin_q0)
    return out.replace(
        p=(out.p - pivot) @ rot_diff.T + origin_p0,
        q=mat_to_quat(rot_diff[None] @ quat_to_mat(out.q)),
        v=out.v @ rot_diff.T,
    )


def gauge_apply_pose(rot_diff, pivot, origin_p0, p, q):
    """Apply the window's gauge correction to an extra pose: the
    relocalization loop pose rides the same correction (the reference
    rotates relo_Pose with rot_diff in double2vector, estimator.cpp:605-611)."""
    return rot_diff @ (p - pivot) + origin_p0, mat_to_quat(rot_diff @ quat_to_mat(q))
