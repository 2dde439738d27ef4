"""Real spherical harmonics basis, degrees 0..3 (volprim_tpu.ops.sh)."""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def degree_from_coeffs(n: int) -> int:
    """SH degree from the per-channel coefficient count."""
    deg = int(n**0.5) - 1
    if (deg + 1) ** 2 != n:
        raise ValueError(f"invalid SH coefficient count {n}")
    return deg


def basis_columns(x, y, z, degree: int, c0) -> list:
    """The basis as a list of tensors, l-major then m = -l..l. ``c0`` is the
    constant column: ``_C0`` for the true basis, 1.0 for the fused
    compositor's folded-DC table (see kernels.composite3)."""
    if not 0 <= degree <= 3:
        raise ValueError("SH degrees 0..3 supported")
    out = [torch.full_like(x, c0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            _C2[0] * x * y,
            _C2[1] * y * z,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * x * z,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * x * y * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return out


def eval_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis of unit directions ``d`` [..., 3] -> [..., (degree+1)^2]."""
    return torch.stack(
        basis_columns(d[..., 0], d[..., 1], d[..., 2], degree, _C0), dim=-1
    )


def eval_emission(sh_coeffs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """3DGS-style emission: the basis at ``d`` [..., 3] against the
    coefficients ``sh_coeffs`` [..., K, 3] (basis-major), plus the 0.5 DC
    offset, clamped at 0. Returns [..., 3]."""
    basis = eval_basis(d, degree_from_coeffs(sh_coeffs.shape[-2]))  # [..., K]
    emission = torch.sum(basis[..., :, None] * sh_coeffs, dim=-2)
    return torch.clamp(emission + 0.5, min=0.0)
