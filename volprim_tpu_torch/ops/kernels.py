"""Closed-form kernel math on quadric coefficients (volprim_tpu.ops.kernels).

Only the Gaussian peak response the radiance-field integrators use is
ported; the Epanechnikov kernel and the segment integrals belong to the
tomography and path-tracer slices (ROADMAP.md §A).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .quadric import QuadricCoeffs


def gaussian_q_min(coeffs: QuadricCoeffs) -> torch.Tensor:
    """Minimum Mahalanobis^2 along the ray: q(t_peak), t_peak = -b/a."""
    a, b, c = coeffs
    return torch.clamp(c - (b * b) / a, min=0.0)


def gaussian_eval_q(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized Gaussian kernel value at Mahalanobis^2 = q."""
    return torch.exp(-0.5 * q)


@dataclass(frozen=True)
class Kernel:
    """Static kernel configuration; only ``type='gaussian'`` is ported (the
    peak response the rf integrators use needs no normalization knobs)."""

    type: str = "gaussian"

    def __post_init__(self):
        if self.type != "gaussian":
            raise NotImplementedError(
                f"kernel type {self.type!r} is not ported yet "
                "(ROADMAP.md §A: tomography / path-tracer slices)"
            )

    def eval_q(self, q: torch.Tensor) -> torch.Tensor:
        return gaussian_eval_q(q)

    def peak_response(self, coeffs: QuadricCoeffs) -> torch.Tensor:
        """Kernel value at the point of peak response along the ray."""
        return self.eval_q(gaussian_q_min(coeffs))
