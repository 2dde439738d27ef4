"""Shared model helpers (volprim_tpu.models.base)."""

from __future__ import annotations

import torch

from ..scene.ellipsoids import EllipsoidScene


def pad_primitives(prims: EllipsoidScene, multiple: int) -> EllipsoidScene:
    """Pad the primitive arrays to a multiple of ``multiple`` with inert
    primitives (unit scales, centers at 1e4, identity quats, zero
    attributes) so chunked stages have fixed shapes. The values are
    moderate on purpose: extreme centers or scales overflow the f32 quadric
    coefficients (b^2 -> inf) and validate as hits. Consumers must still
    mask by ``index < num_prims``."""
    n = prims.num_prims
    n_pad = (-n) % multiple
    if n_pad == 0:
        return prims
    dev = prims.device
    far = torch.full((n_pad, 3), 1e4, dtype=prims.centers.dtype, device=dev)
    unit = torch.ones((n_pad, 3), dtype=prims.scales.dtype, device=dev)
    qid = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=prims.quats.dtype, device=dev
    ).expand(n_pad, 4)
    attrs = {
        k: torch.cat([v, v.new_zeros((n_pad,) + tuple(v.shape[1:]))])
        for k, v in prims.attrs.items()
    }
    return EllipsoidScene(
        centers=torch.cat([prims.centers, far]),
        scales=torch.cat([prims.scales, unit]),
        quats=torch.cat([prims.quats, qid]),
        attrs=attrs,
        extent=prims.extent,
    )
