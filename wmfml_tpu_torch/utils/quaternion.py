"""Quaternion algebra in torch, scipy's ``xyzw`` component order
(``wmfml_tpu/utils/quaternion.py``).

ShapeNet3D's task augmentation turns each task's pose labels by per-task
Euler noise: its Z angle (elevation) plus ``ele`` degrees, its X angle
(azimuth) minus ``azi`` degrees, of the intrinsic ``ZYX`` decomposition.
With R = Rz(a) Ry(b) Rx(c) that is two products, Rz(d_z) R Rx(d_x), so
``task_augment_quat`` is two quaternion products, exact and branch-free,
and runs on the card with the rest of the step.
"""

from __future__ import annotations

import torch


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product in xyzw order: ``Rotation.from_quat(quat_mul(q1,
    q2)) == Rotation.from_quat(q1) * Rotation.from_quat(q2)``."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def quat_rot_z(angle_rad: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (xyzw) of a rotation by ``angle_rad`` about Z."""
    half = angle_rad / 2.0
    zeros = torch.zeros_like(half)
    return torch.stack([zeros, zeros, torch.sin(half), torch.cos(half)], -1)


def quat_rot_x(angle_rad: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (xyzw) of a rotation by ``angle_rad`` about X."""
    half = angle_rad / 2.0
    zeros = torch.zeros_like(half)
    return torch.stack([torch.sin(half), zeros, zeros, torch.cos(half)], -1)


def euler_zyx_to_quat(euler_deg: torch.Tensor) -> torch.Tensor:
    """Intrinsic ``ZYX`` Euler angles (degrees, [..., 3]) -> xyzw."""
    a, b, c = torch.deg2rad(euler_deg).unbind(-1)
    half = b / 2.0
    zeros = torch.zeros_like(half)
    qy = torch.stack([zeros, torch.sin(half), zeros, torch.cos(half)], -1)
    return quat_mul(quat_mul(quat_rot_z(a), qy), quat_rot_x(c))


def quat_to_euler_zyx(q: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """xyzw -> intrinsic ``ZYX`` Euler angles [..., 3] (a, b, c), from the
    rotation matrix of R = Rz(a) Ry(b) Rx(c): a = atan2(R10, R00), b =
    -asin(R20), c = atan2(R21, R22)."""
    x, y, z, w = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r10 = 2 * (x * y + w * z)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    e = torch.stack([torch.atan2(r10, r00),
                     -torch.asin(torch.clamp(r20, -1.0, 1.0)),
                     torch.atan2(r21, r22)], -1)
    return torch.rad2deg(e) if degrees else e


def task_augment_quat(q: torch.Tensor, noise_ele_deg: torch.Tensor,
                      noise_azi_deg: torch.Tensor) -> torch.Tensor:
    """Per-task pose noise on ``q`` [..., N, 4]: Z angle + ``noise_ele_deg``,
    X angle - ``noise_azi_deg`` ([...], broadcast over the N instances)."""
    d_z = torch.deg2rad(torch.as_tensor(noise_ele_deg, dtype=q.dtype,
                                        device=q.device))
    d_x = torch.deg2rad(-torch.as_tensor(noise_azi_deg, dtype=q.dtype,
                                         device=q.device))
    qz = quat_rot_z(d_z)[..., None, :]
    qx = quat_rot_x(d_x)[..., None, :]
    return quat_mul(quat_mul(qz, q), qx)


def quat_canonicalize(q: torch.Tensor) -> torch.Tensor:
    """The reference's semi-sphere: negate a quaternion whose component 1
    (y in xyzw) is negative."""
    return torch.where(q[..., 1:2] < 0, -q, q)
