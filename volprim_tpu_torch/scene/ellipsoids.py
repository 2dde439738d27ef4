"""EllipsoidScene: the primitive set as a dataclass of tensors
(volprim_tpu.scene.ellipsoids).

centers [N, 3], scales [N, 3], quats [N, 4] (x, y, z, w), named per-primitive
attributes [N, D] (opacities, sh_coeffs, ...), and ``extent``: the multiple
of the scales that bounds each traced ellipsoid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


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
