"""Pure-math ops: quaternions, quadric forms, kernels, SH, emitters, film
filters and surface BSDFs (torch)."""

import torch

from . import bsdf, envmap, filters, kernels, quadric, quaternion, sh
from .kernels import Kernel
from .quadric import QuadricCoeffs, intersect_extent, ray_prim_coeffs


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB EOTF (volprim_tpu.ops.srgb_to_linear)."""
    return torch.where(
        x <= 0.04045,
        x / 12.92,
        ((torch.clamp(x, min=0.04045) + 0.055) / 1.055) ** 2.4,
    )


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """sRGB OETF, the inverse of :func:`srgb_to_linear`
    (volprim_tpu.ops.linear_to_srgb)."""
    return torch.where(
        x <= 0.0031308,
        x * 12.92,
        1.055 * torch.clamp(x, min=0.0031308) ** (1.0 / 2.4) - 0.055,
    )


__all__ = [
    "Kernel", "QuadricCoeffs", "bsdf", "envmap", "filters", "intersect_extent", "kernels",
    "linear_to_srgb", "quadric", "quaternion", "ray_prim_coeffs", "sh", "srgb_to_linear",
]
