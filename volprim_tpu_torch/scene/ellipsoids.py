"""EllipsoidScene: the primitive set as a dataclass of tensors
(volprim_tpu.scene.ellipsoids).

centers [N, 3], scales [N, 3], quats [N, 4] (x, y, z, w), named per-primitive
attributes [N, D] (opacities, sh_coeffs, ...), and ``extent``: the multiple
of the scales that bounds each traced ellipsoid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..ops import quaternion


@dataclasses.dataclass
class EllipsoidScene:
    centers: torch.Tensor  # [N, 3]
    scales: torch.Tensor  # [N, 3]
    quats: torch.Tensor  # [N, 4] (x, y, z, w)
    attrs: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    extent: float = 3.0

    @property
    def num_prims(self) -> int:
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def pack_data(self) -> torch.Tensor:
        """The N * 10 packed buffer: center, scale, quat per primitive."""
        return torch.cat([self.centers, self.scales, self.quats], dim=-1).reshape(-1)

    @staticmethod
    def from_packed_data(data: torch.Tensor, attrs=None, extent: float = 3.0):
        rec = data.reshape(-1, 10)
        return EllipsoidScene(centers=rec[:, 0:3], scales=rec[:, 3:6], quats=rec[:, 6:10],
                              attrs=dict(attrs or {}), extent=extent)

    def rotations(self) -> torch.Tensor:
        return quaternion.to_rotation_matrix(self.quats)

    def scale_prod(self) -> torch.Tensor:
        """sx * sy * sz per primitive [N]."""
        return self.scales[..., 0] * self.scales[..., 1] * self.scales[..., 2]

    def require_attrs(self, names):
        for n in names:
            if n not in self.attrs:
                raise KeyError(f"Requested ellipsoid attribute '{n}' not found")

    def select(self, idx: torch.Tensor) -> "EllipsoidScene":
        """Gather a subset (or permutation) of the primitives."""
        return EllipsoidScene(
            centers=self.centers[idx],
            scales=self.scales[idx],
            quats=self.quats[idx],
            attrs={k: v[idx] for k, v in self.attrs.items()},
            extent=self.extent,
        )

    def sh_coeffs_3d(self) -> torch.Tensor:
        """The 'sh_coeffs' attribute [N, 3K] viewed as [N, K, 3]."""
        sh = self.attrs["sh_coeffs"]
        return sh.reshape(sh.shape[0], -1, 3)


class EllipsoidsFactory:
    """Builds a primitive set one primitive at a time (tests, small
    scenes): ``add(mean, scale, euler_deg, **attrs)``, then ``build``."""

    def __init__(self):
        self._centers = []
        self._scales = []
        self._quats = []
        self._attrs: Dict[str, list] = {}

    def add(self, mean, scale, euler_deg=(0.0, 0.0, 0.0), **attrs):
        self._centers.append(np.broadcast_to(np.asarray(mean, np.float32), (3,)))
        self._scales.append(np.broadcast_to(np.asarray(scale, np.float32), (3,)))
        euler = np.deg2rad(np.asarray(euler_deg, np.float32))
        self._quats.append(quaternion.from_euler(torch.from_numpy(euler)).numpy())
        for k, v in attrs.items():
            self._attrs.setdefault(k, []).append(np.atleast_1d(np.asarray(v, np.float32)))

    def build(self, extent: float = 3.0, device=None) -> EllipsoidScene:
        """The scene on ``device`` (the card unless the caller asks for the
        CPU)."""
        from .. import as_device

        dev = as_device(device)
        n = len(self._centers)
        for k, vals in self._attrs.items():
            if len(vals) != n:
                raise ValueError(f"attribute '{k}' missing for some primitives")

        def t(rows):
            return torch.from_numpy(np.stack(rows)).to(dev)

        return EllipsoidScene(
            centers=t(self._centers), scales=t(self._scales), quats=t(self._quats),
            attrs={k: t(v) for k, v in self._attrs.items()}, extent=extent,
        )


def lattice_init(count: int, init_sigmat: float = 1e-4, init_albedo: float = 0.9,
                 extent: float = 3.0, device=None) -> EllipsoidScene:
    """count^3 isotropic Gaussians on a lattice in [-1, 1)^3 with scale
    1 / (2 count), sigma_t ``init_sigmat`` and albedo ``init_albedo``: the
    optimize_volume initialisation, on ``device`` (the card unless the
    caller asks for the CPU)."""
    from .. import as_device

    dev = as_device(device)
    delta = 1.0 / count
    ax = 2.0 * delta * np.arange(count, dtype=np.float32) - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    centers = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    n = centers.shape[0]
    quats = np.zeros((n, 4), np.float32)
    quats[:, 3] = 1.0
    f32 = torch.float32
    return EllipsoidScene(
        centers=torch.from_numpy(centers).to(dev),
        scales=torch.full((n, 3), delta / 2.0, dtype=f32, device=dev),
        quats=torch.from_numpy(quats).to(dev),
        attrs={
            "sigma_t": torch.full((n, 1), init_sigmat, dtype=f32, device=dev),
            "albedo": torch.full((n, 3), init_albedo, dtype=f32, device=dev),
        },
        extent=extent,
    )
