"""Quaternion utilities, (x, y, z, w) layout (volprim_tpu.ops.quaternion)."""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) [..., 4] to unit length."""
    return q / torch.clamp(torch.sqrt(torch.sum(q * q, -1, keepdim=True)), min=eps)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) [..., 4] -> rotation matrices [..., 3, 3] whose
    columns are the rotated basis vectors (world-from-local)."""
    q = normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], -1),
        torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], -1),
        torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], -1),
    ]
    return torch.stack(rows, dim=-2)


def from_euler(euler_xyz_rad: torch.Tensor) -> torch.Tensor:
    """Euler angles [..., 3] (radians, intrinsic x-y-z order, Dr.Jit's
    ``euler_to_quat``) to quaternions (x, y, z, w)."""
    ex, ey, ez = (euler_xyz_rad[..., i] * 0.5 for i in range(3))
    cx, sx = torch.cos(ex), torch.sin(ex)
    cy, sy = torch.cos(ey), torch.sin(ey)
    cz, sz = torch.cos(ez), torch.sin(ez)
    qw = cx * cy * cz + sx * sy * sz
    qx = sx * cy * cz - cx * sy * sz
    qy = cx * sy * cz + sx * cy * sz
    qz = cx * cy * sz - sx * sy * cz
    return torch.stack([qx, qy, qz, qw], dim=-1)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions stored as (x, y, z, w)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )
