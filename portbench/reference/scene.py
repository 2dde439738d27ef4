"""Primitives, cameras and small math of the plain reference.

Frozen copies of the port's plain code (the scene record, the padding and
the Morton clusters, the camera, the SH basis, the sRGB curve, the
quaternion rotation and the L1 loss), so that a change to the port cannot
change what the reference computes. Plain PyTorch; imports nothing of the
port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

_C1 = 0.4886025119029199


@dataclasses.dataclass
class Scene:
    centers: torch.Tensor  # [N, 3]
    scales: torch.Tensor  # [N, 3]
    quats: torch.Tensor  # [N, 4] (x, y, z, w)
    attrs: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    extent: float = 3.0

    @property
    def num_prims(self) -> int:
        return self.centers.shape[0]

    def select(self, idx: torch.Tensor) -> "Scene":
        return Scene(self.centers[idx], self.scales[idx], self.quats[idx],
                     {k: v[idx] for k, v in self.attrs.items()}, self.extent)

    def sh_coeffs_3d(self) -> torch.Tensor:
        sh = self.attrs["sh_coeffs"]
        return sh.reshape(sh.shape[0], -1, 3)


def pad_primitives(prims: Scene, multiple: int) -> Scene:
    """Inert padding to a multiple: unit scales, centers at 1e4, identity
    quats, zero attributes."""
    n_pad = (-prims.num_prims) % multiple
    if n_pad == 0:
        return prims
    c = prims.centers
    far = torch.full((n_pad, 3), 1e4, dtype=c.dtype, device=c.device)
    unit = torch.ones((n_pad, 3), dtype=prims.scales.dtype, device=c.device)
    qid = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=prims.quats.dtype,
                       device=c.device).expand(n_pad, 4)
    attrs = {k: torch.cat([v, v.new_zeros((n_pad,) + tuple(v.shape[1:]))])
             for k, v in prims.attrs.items()}
    return Scene(torch.cat([c, far]), torch.cat([prims.scales, unit]),
                 torch.cat([prims.quats, qid]), attrs, prims.extent)


def _spread_bits_10(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    parts = x.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def morton_codes(centers: torch.Tensor, num_real: int) -> torch.Tensor:
    """30-bit Morton codes quantized against the first ``num_real`` rows'
    bounding box."""
    ref = centers[:num_real]
    lo, hi = torch.amin(ref, dim=0), torch.amax(ref, dim=0)
    q = (centers - lo) / torch.clamp(hi - lo, min=1e-8)
    q = torch.clamp((q * 1023.0).to(torch.int32), 0, 1023)
    return (_spread_bits_10(q[:, 0]) | (_spread_bits_10(q[:, 1]) << 1)
            | (_spread_bits_10(q[:, 2]) << 2))


def build_clusters(prims: Scene, cs: int, num_real: int):
    """(Morton permutation, cluster sphere centers [Ncl, 3], radii [Ncl]):
    masked means and maxima over each cluster's real members."""
    n = prims.num_prims
    order = torch.argsort(morton_codes(prims.centers, num_real), stable=True)
    sp = prims.select(order)
    n_cl = n // cs
    real = (order < num_real).reshape(n_cl, cs)
    c = sp.centers.reshape(n_cl, cs, 3)
    prim_r = prims.extent * torch.amax(sp.scales, dim=-1).reshape(n_cl, cs)
    cnt = torch.clamp(torch.sum(real, dim=1), min=1)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    centers = _sum_in_order(torch.where(real[..., None], c, zero), 1) / cnt[:, None]
    v = c - centers[:, None, :]
    dist = torch.sqrt(torch.sum(v * v, dim=-1)) + prim_r
    radii = torch.amax(torch.where(real, dist, zero), dim=1)
    empty = torch.sum(real, dim=1) == 0
    centers = torch.where(empty[:, None], torch.full_like(centers, 1e7), centers)
    radii = torch.where(empty, torch.full_like(radii, 1e-3), radii)
    return order, centers, radii


def build_super_spheres(centers: torch.Tensor, radii: torch.Tensor, group: int):
    """Bounding spheres of ``group`` Morton-adjacent clusters; far padding
    clusters left out."""
    ncl = centers.shape[0]
    nsup = -(-ncl // group)
    pad = nsup * group - ncl
    c = torch.cat([centers, centers.new_full((pad, 3), 1e7)])
    r = torch.cat([radii, radii.new_full((pad,), 1e-3)])
    cg, rg = c.reshape(nsup, group, 3), r.reshape(nsup, group)
    near = torch.amax(torch.abs(cg), dim=-1) < 1e6
    cnt = torch.clamp(torch.sum(near, dim=1), min=1)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    sc = _sum_in_order(torch.where(near[..., None], cg, zero), 1) / cnt[:, None]
    v = cg - sc[:, None, :]
    dist = torch.sqrt(torch.sum(v * v, dim=-1)) + rg
    sr = torch.amax(torch.where(near, dist, zero), dim=1)
    empty = torch.sum(near, dim=1) == 0
    sc = torch.where(empty[:, None], torch.full_like(sc, 1e7), sc)
    sr = torch.where(empty, torch.full_like(sr, 1e-3), sr)
    return sc, sr


@dataclasses.dataclass
class Camera:
    """Pinhole camera, Mitsuba convention (x left, y up, z forward), the
    principal point at the film's center."""

    width: int
    height: int
    to_world: np.ndarray  # 4 x 4
    fov: float  # degrees, x axis

    @property
    def focal_length(self) -> float:
        return (self.width / 2.0) / np.tan(np.deg2rad(self.fov) * 0.5)


def camera_of(spec: dict) -> Camera:
    return Camera(int(spec["width"]), int(spec["height"]),
                  np.asarray(spec["to_world"], np.float64).reshape(4, 4), float(spec["fov"]))


def sh_basis_columns(x, y, z, degree: int, c0) -> list:
    """SH basis up to degree 1 (the configurations' k = 4), l-major."""
    if degree > 1:
        raise ValueError("the reference carries SH degrees 0 and 1")
    out = [torch.full_like(x, c0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    return out


def sh_degree(n: int) -> int:
    deg = int(n ** 0.5) - 1
    if (deg + 1) ** 2 != n:
        raise ValueError(f"invalid SH coefficient count {n}")
    return deg


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92,
                       ((torch.clamp(x, min=0.04045) + 0.055) / 1.055) ** 2.4)


def rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalised quaternions [..., 4] (x, y, z, w) -> [..., 3, 3],
    columns the rotated basis vectors."""
    q = q / torch.clamp(torch.sqrt(torch.sum(q * q, -1, keepdim=True)), min=1e-12)
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


def l1(reference: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(reference - image))
