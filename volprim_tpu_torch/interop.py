"""Carry a scene across between the JAX package and the port as numpy.

Both packages then compute on the same parameters:

    scene_t = scene_from_arrays(
        np.asarray(jax_scene.centers), np.asarray(jax_scene.scales),
        np.asarray(jax_scene.quats),
        {k: np.asarray(v) for k, v in jax_scene.attrs.items()},
        jax_scene.extent, device="cuda")
"""

from __future__ import annotations

import numpy as np
import torch

from .scene.ellipsoids import EllipsoidScene


def scene_from_arrays(
    centers, scales, quats, attrs: dict, extent: float = 3.0, device=None
) -> EllipsoidScene:
    """Build the port's scene from float32 numpy arrays."""
    from . import as_device

    dev = as_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)  # a writable copy

    return EllipsoidScene(
        centers=t(centers), scales=t(scales), quats=t(quats),
        attrs={k: t(v) for k, v in attrs.items()}, extent=float(extent),
    )


def to_numpy(scene: EllipsoidScene) -> dict:
    """The scene's parameters as numpy arrays (the inverse of
    :func:`scene_from_arrays`): keys centers, scales, quats, attrs, extent."""

    def n(x: torch.Tensor):
        return x.detach().cpu().numpy()

    return dict(
        centers=n(scene.centers), scales=n(scene.scales), quats=n(scene.quats),
        attrs={k: n(v) for k, v in scene.attrs.items()}, extent=scene.extent,
    )
