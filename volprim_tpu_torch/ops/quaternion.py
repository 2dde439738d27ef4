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
