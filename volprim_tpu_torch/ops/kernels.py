"""Closed-form kernel math on quadric coefficients (volprim_tpu.ops.kernels).

Gaussian and Epanechnikov primitives: the peak response the radiance-field
integrators use, the pdfs, the line integrals (over the whole line or a
segment) the path tracer and tomography use, the free-flight inverse CDFs
and the peak-matched normalisation factors, dispatched by :class:`Kernel`
with the JAX package's ``normalized`` and ``full_range`` knobs, and the
batched segment depths of the path tracer's xla window walk
(:func:`gaussian_segment_taus`).

Directions are assumed normalized, so the t-parameterized integrals equal
arc-length line integrals. Integrals follow the reference's scrubbing:
clamped >= 0, non-finite -> 0, inactive -> 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .quadric import QuadricCoeffs, intersect_extent

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


def gaussian_peak_response(coeffs: QuadricCoeffs) -> torch.Tensor:
    """Unnormalized kernel value at the ray's peak point, exp(-q_min / 2)."""
    return torch.exp(-0.5 * gaussian_q_min(coeffs))


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


def gaussian_segment_taus(
    coeffs: QuadricCoeffs,
    s_prod: torch.Tensor,
    sigma_t: torch.Tensor,
    entry: torch.Tensor,
    exit_t: torch.Tensor,
    events: torch.Tensor,
) -> torch.Tensor:
    """Optical depth of every boundary segment ``[events[e], events[e+1])``
    summed over the K Gaussian pairs: coeffs, s_prod, sigma_t, entry, exit_t
    [R, K], events [R, E] ascending -> [R, E - 1]. The antiderivative of
    each pair is taken at the E shared boundaries, clamped into the pair's
    [entry, exit] (one erf per event and pair), so partial coverage of a
    segment integrates exactly. Non-finite (padding) events map to each
    pair's exit, so a segment ending at +inf adds F(exit) - F(lo) >= 0."""
    a, b, _ = coeffs
    inv_sqrt_2a = _INV_SQRT2 / torch.sqrt(a)
    pair_ok = torch.isfinite(entry) & torch.isfinite(exit_t)
    c_pair = (
        torch.exp(-0.5 * gaussian_q_min(coeffs))
        / (2.0 * _TWO_PI * s_prod * torch.sqrt(a))
        * sigma_t
    )
    c_pair = _scrub(c_pair, pair_ok)
    lo = torch.where(pair_ok, entry, 0.0)[:, None, :]
    hi = torch.where(pair_ok, exit_t, 0.0)[:, None, :]
    ev = torch.where(torch.isfinite(events), events, torch.inf)[:, :, None]
    tcl = torch.minimum(torch.maximum(ev, lo), hi)  # jnp.clip: max, then min
    f = torch.erf((a[:, None, :] * tcl + b[:, None, :]) * inv_sqrt_2a[:, None, :])
    return torch.sum(c_pair[:, None, :] * (f[:, 1:, :] - f[:, :-1, :]), dim=-1)


def gaussian_inv_cdf(
    coeffs: QuadricCoeffs,
    s_prod: torch.Tensor,
    sigma_t: torch.Tensor,
    chi: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """Free-flight distance through a single Gaussian: solves
    ``exp(-sigma_t * CDF(t)) = chi`` for t, CDF the pdf's line integral
    from -inf."""
    a, b, _ = coeffs
    peak = torch.exp(-0.5 * gaussian_q_min(coeffs))
    cval = -(2.0 * _TWO_PI * s_prod * torch.sqrt(a)) * torch.log(chi) / (sigma_t * peak) - 1.0
    t = math.sqrt(2.0) * torch.erfinv(cval) / torch.sqrt(a) - b / a
    return torch.where(active, t, 0.0)


def _mean_sq(scales: torch.Tensor) -> torch.Tensor:
    sx, sy, sz = scales[..., 0], scales[..., 1], scales[..., 2]
    return (sx * sx * sy * sy + sx * sx * sz * sz + sy * sy * sz * sz) / 3.0


def gaussian_normalization_factor(scales: torch.Tensor) -> torch.Tensor:
    """Peak-matched normalization: dividing the integral by it makes the
    best-case response about 1. scales [..., 3] -> [...]."""
    return 1.0 / (_TWO_PI * torch.sqrt(_mean_sq(scales)))


def epanechnikov_eval_q(q: torch.Tensor) -> torch.Tensor:
    """Kernel value at Mahalanobis^2 = q; the support is scaled by 3 as the
    reference scales it (dist^2 = q / 9)."""
    return torch.clamp(0.75 * (1.0 - q / 9.0), min=0.0)


def epanechnikov_pdf_q(q: torch.Tensor, s_prod: torch.Tensor) -> torch.Tensor:
    """Normalized Epanechnikov pdf, 15 / (8 pi sp) (1 - q) on q < 1."""
    return torch.clamp(15.0 / (8.0 * math.pi * s_prod) * (1.0 - q), min=0.0)


def epanechnikov_integral_segment(
    coeffs: QuadricCoeffs,
    s_prod: torch.Tensor,
    t0: torch.Tensor,
    t1: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """Closed-form cubic segment integral of the normalized Epanechnikov
    pdf. With tau = t - t0 in [0, T]:

        I = 15/(8 pi sp) * [ (1 - q(t0)) T - (a t0 + b) T^2 - a T^3 / 3 ].
    """
    a, b, c = coeffs
    active = active & (t0 < t1) & (t1 > 0.0)
    big_t = t1 - t0
    q0 = (a * t0 + 2.0 * b) * t0 + c
    b0 = a * t0 + b
    val = (
        15.0
        / (8.0 * math.pi * s_prod)
        * ((1.0 - q0) * big_t - b0 * big_t * big_t - a * big_t ** 3 / 3.0)
    )
    return _scrub(val, active)


def epanechnikov_inv_cdf(
    coeffs: QuadricCoeffs,
    s_prod: torch.Tensor,
    sigma_t: torch.Tensor,
    chi: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """Free-flight distance through a single Epanechnikov primitive: solves
    ``exp(-sigma_t * CDF(t)) = chi`` for t, CDF the normalized pdf's
    integral from the support entry, in closed form.

    With the entry ``tn = t* - |h|`` (t* the peak, |h| = sqrt((1 - q_min)
    / a)) the CDF is a depressed cubic in ``tau = u + |h|``; its root on
    the physical branch is ``u = 2|h| cos(2 arcsin(sqrt(eps / 2)) / 3 -
    2 pi / 3)`` with ``eps = 3 chi' / (2 a |h|^3)`` in [0, 2], ``chi' =
    -log(chi) / (sigma_t C)``, C = 15 / (8 pi sp). eps = 0 is the entry and
    eps = 2 (the whole mass, where larger samples clamp) the exit."""
    a, b, _ = coeffs
    q_min = gaussian_q_min(coeffs)
    inside = q_min < 1.0
    t_star = -b / a
    habs = torch.sqrt(torch.clamp((1.0 - q_min) / a, min=0.0))
    c_norm = 15.0 / (8.0 * math.pi * s_prod)
    chi_p = -torch.log(torch.clamp(chi, min=1e-30)) / torch.clamp(sigma_t * c_norm, min=1e-30)
    eps = torch.clamp(1.5 * chi_p / torch.clamp(a * habs ** 3, min=1e-30), 0.0, 2.0)
    theta = 2.0 * torch.arcsin(torch.sqrt(0.5 * eps))
    u = 2.0 * habs * torch.cos(theta / 3.0 - 2.0 * math.pi / 3.0)
    return torch.where(active & inside, t_star + u, 0.0)


def epanechnikov_normalization_factor(scales: torch.Tensor) -> torch.Tensor:
    """Gaussian-magnitude-matched anisotropic normalization."""
    return 5.0 / (_TWO_PI * torch.sqrt(_mean_sq(scales)))


@dataclass(frozen=True)
class Kernel:
    """Static kernel configuration: ``type`` 'gaussian' or 'epanechnikov';
    ``normalized`` divides integrals by the normalization factor and
    ``full_range`` integrates over the whole line (the Epanechnikov kernel
    over its extent ellipsoid's chord)."""

    type: str = "gaussian"
    normalized: bool = False
    full_range: bool = False

    def __post_init__(self):
        if self.type not in ("gaussian", "epanechnikov"):
            raise ValueError("Unknown kernel type; must be 'gaussian' or 'epanechnikov'")

    def eval_q(self, q: torch.Tensor) -> torch.Tensor:
        if self.type == "gaussian":
            return gaussian_eval_q(q)
        return epanechnikov_eval_q(q)

    def peak_response(self, coeffs: QuadricCoeffs) -> torch.Tensor:
        """Kernel value at the point of peak response along the ray."""
        return self.eval_q(gaussian_q_min(coeffs))

    def pdf_q(self, q: torch.Tensor, s_prod: torch.Tensor) -> torch.Tensor:
        if self.type == "gaussian":
            return gaussian_pdf_q(q, s_prod)
        return epanechnikov_pdf_q(q, s_prod)

    def normalization_factor(self, scales: torch.Tensor) -> torch.Tensor:
        if self.type == "gaussian":
            return gaussian_normalization_factor(scales)
        return epanechnikov_normalization_factor(scales)

    def density_integral(self, coeffs, s_prod, scales, extent, t0, t1, active):
        """Line integral of the kernel density along the ray: over the whole
        line when ``full_range`` or no bounds are given (the Epanechnikov
        kernel over its extent ellipsoid's chord), else over [t0, t1]."""
        full = self.full_range or (t0 is None and t1 is None)
        if self.type == "gaussian":
            if full:
                val = gaussian_integral_full(coeffs, s_prod, active)
            else:
                val = gaussian_integral_segment(coeffs, s_prod, t0, t1, active)
        else:
            if full:
                valid, t0, t1 = intersect_extent(coeffs, extent)
                active = active & valid
            val = epanechnikov_integral_segment(coeffs, s_prod, t0, t1, active)
        if self.normalized:
            val = val / self.normalization_factor(scales)
        return _scrub(val, active)

    def inv_cdf(self, coeffs, s_prod, sigma_t, chi, active) -> torch.Tensor:
        if self.type == "gaussian":
            return gaussian_inv_cdf(coeffs, s_prod, sigma_t, chi, active)
        return epanechnikov_inv_cdf(coeffs, s_prod, sigma_t, chi, active)
