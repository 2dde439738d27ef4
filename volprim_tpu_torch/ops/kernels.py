"""Closed-form kernel math on quadric coefficients (volprim_tpu.ops.kernels).

The Gaussian kernel is ported: the peak response the radiance-field
integrators use, and the pdf and line integrals the path tracer (prb)
uses. The Epanechnikov kernel belongs to the tomography slice and raises
``NotImplementedError`` (ROADMAP.md §A4).

Directions are assumed normalized, so the t-parameterized integrals equal
arc-length line integrals. Integrals follow the reference's scrubbing:
clamped >= 0, non-finite -> 0, inactive -> 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .quadric import QuadricCoeffs

_TWO_PI = 2.0 * math.pi
_INV_SQRT2 = 0.7071067811865476


def _scrub(x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, min=0.0)
    x = torch.where(torch.isfinite(x), x, 0.0)
    return torch.where(active, x, 0.0)


def gaussian_q_min(coeffs: QuadricCoeffs) -> torch.Tensor:
    """Minimum Mahalanobis^2 along the ray: q(t_peak), t_peak = -b/a."""
    a, b, c = coeffs
    return torch.clamp(c - (b * b) / a, min=0.0)


def gaussian_eval_q(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized Gaussian kernel value at Mahalanobis^2 = q."""
    return torch.exp(-0.5 * q)


def gaussian_pdf_q(q: torch.Tensor, s_prod: torch.Tensor) -> torch.Tensor:
    """Normalized 3-D Gaussian pdf at Mahalanobis^2 = q."""
    return torch.exp(-0.5 * q) / (_TWO_PI ** 1.5 * s_prod)


def gaussian_integral_full(
    coeffs: QuadricCoeffs, s_prod: torch.Tensor, active: torch.Tensor
) -> torch.Tensor:
    """Line integral of the normalized Gaussian pdf over t in (-inf, inf)."""
    a = coeffs.a
    val = torch.exp(-0.5 * gaussian_q_min(coeffs)) / (_TWO_PI * s_prod * torch.sqrt(a))
    return _scrub(val, active)


def gaussian_integral_segment(
    coeffs: QuadricCoeffs,
    s_prod: torch.Tensor,
    t0: torch.Tensor,
    t1: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """Line integral of the normalized Gaussian pdf over t in [t0, t1]; zero
    unless t0 < t1 and t1 > 0."""
    a, b, _ = coeffs
    active = active & (t0 < t1) & (t1 > 0.0)
    inv_sqrt_2a = _INV_SQRT2 / torch.sqrt(a)
    u0 = (a * t0 + b) * inv_sqrt_2a
    u1 = (a * t1 + b) * inv_sqrt_2a
    val = (
        torch.exp(-0.5 * gaussian_q_min(coeffs))
        / (2.0 * _TWO_PI * s_prod * torch.sqrt(a))
        * (torch.erf(u1) - torch.erf(u0))
    )
    return _scrub(val, active)


@dataclass(frozen=True)
class Kernel:
    """Static kernel configuration. Only ``type='gaussian'`` is ported, and
    of the JAX package's knobs only their defaults (not normalized, not
    full range), which the integrators use."""

    type: str = "gaussian"

    def __post_init__(self):
        if self.type != "gaussian":
            raise NotImplementedError(
                f"kernel type {self.type!r} is not ported yet "
                "(ROADMAP.md §A4: the Epanechnikov kernel comes with tomography)"
            )

    def eval_q(self, q: torch.Tensor) -> torch.Tensor:
        return gaussian_eval_q(q)

    def peak_response(self, coeffs: QuadricCoeffs) -> torch.Tensor:
        """Kernel value at the point of peak response along the ray."""
        return self.eval_q(gaussian_q_min(coeffs))

    def pdf_q(self, q: torch.Tensor, s_prod: torch.Tensor) -> torch.Tensor:
        return gaussian_pdf_q(q, s_prod)

    def density_integral(self, coeffs, s_prod, t0, t1, active):
        """Line integral of the kernel density along the ray: over the whole
        line when no bounds are given, else over [t0, t1]."""
        if t0 is None and t1 is None:
            return gaussian_integral_full(coeffs, s_prod, active)
        return gaussian_integral_segment(coeffs, s_prod, t0, t1, active)
