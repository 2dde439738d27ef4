"""Carry a scene, a grid volume or the training parameters across between
the JAX package and the port as numpy.

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


TRAIN_KEYS = ("centers", "scales", "quats", "opacities", "sh_coeffs")
# the volume-fitting parameters (examples/optimize_volume.py)
VOLUME_KEYS = ("sigmat", "albedo")


def params_from_jax(arrays: dict, device=None) -> dict:
    """The training parameter dict (any of centers, scales, quats,
    opacities, sh_coeffs, and the volume fit's sigmat, albedo) from numpy
    arrays, e.g. ``{k: np.asarray(v)}`` of the JAX package's parameters:
    float32 leaf tensors that require grad, on ``device`` (the card unless
    the caller asks for the CPU)."""
    from . import as_device

    dev = as_device(device)
    unknown = set(arrays) - set(TRAIN_KEYS) - set(VOLUME_KEYS)
    if unknown:
        raise KeyError(f"not training parameters: {sorted(unknown)}")
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev).requires_grad_(True)
        for k, v in arrays.items()
    }


def params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`params_from_jax`: ``{key: numpy array}``."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def grid_from_arrays(data, bbox_min, bbox_max, device=None):
    """The port's GridVolume from float32 numpy arrays (``data`` [zres,
    yres, xres, C], the bbox corners [3]), on ``device`` (the card unless
    the caller asks for the CPU)."""
    from .scene.vol import GridVolume

    return GridVolume.from_arrays(data, bbox_min, bbox_max, device)
