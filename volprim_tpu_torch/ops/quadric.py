"""Ray/primitive quadric-form coefficients (volprim_tpu.ops.quadric).

Along a ray ``o + t d`` a primitive (rotation R, scales s, center c) has the
Mahalanobis quadratic ``q(t) = a t^2 + 2 b t + c0`` with
``M = R diag(s)^-2 R^T``, ``a = d^T M d``, ``b = d^T M (o - c)``,
``c0 = (o - c)^T M (o - c)``. Ported: what the exact integrator
(models/rf.py), the path tracer (models/prb.py) and the v1 tile compositor
(:func:`prim_features` / :func:`ray_features`, rf_tiled ``backend='pallas'``,
and the path tracer's ``coeff_gemm`` scans through :func:`pair_coeffs_gemm`)
call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import quaternion


class QuadricCoeffs(NamedTuple):
    """Per-(ray, primitive) quadratic coefficients, each shaped [R, C]."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor


def ray_prim_coeffs(o, d, centers, scales, quats) -> QuadricCoeffs:
    """All-pairs coefficients: rays o, d [R, 3] x primitives [C, ...] -> [R, C].

    Written component-wise (no [R, C, 3] temporaries), like the reference."""
    rot = quaternion.to_rotation_matrix(quats)  # [C, 3, 3], world <- local
    inv_s2 = 1.0 / (scales * scales)  # [C, 3]
    a = torch.zeros((o.shape[0], centers.shape[0]), dtype=o.dtype, device=o.device)
    b = torch.zeros_like(a)
    c = torch.zeros_like(a)
    for i in range(3):
        r0 = rot[:, 0, i][None, :]
        r1 = rot[:, 1, i][None, :]
        r2 = rot[:, 2, i][None, :]
        w_i = d[:, 0:1] * r0 + d[:, 1:2] * r1 + d[:, 2:3] * r2
        p_i = (
            (o[:, 0:1] - centers[None, :, 0]) * r0
            + (o[:, 1:2] - centers[None, :, 1]) * r1
            + (o[:, 2:3] - centers[None, :, 2]) * r2
        )
        isi = inv_s2[None, :, i]
        a = a + w_i * w_i * isi
        b = b + w_i * p_i * isi
        c = c + p_i * p_i * isi
    return QuadricCoeffs(a, b, c)


def intersect_extent(coeffs: QuadricCoeffs, extent: float):
    """Intersect rays with the extent-scaled bounding ellipsoids
    (``q(t) = extent^2``). Returns (valid, t_near, t_far); ``valid`` needs a
    real root with t_far > 0."""
    a, b, c = coeffs
    e2 = extent * extent
    q_min = c - (b * b) / a
    disc = (e2 - q_min) / a
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_peak = -b / a
    t_near = t_peak - sq
    t_far = t_peak + sq
    valid = (disc >= 0.0) & (t_far > 0.0)
    return valid, t_near, t_far


def pair_coeffs(o, d, centers, scales, quats) -> QuadricCoeffs:
    """Coefficients for matched (ray, primitive) pairs; all arguments
    broadcast over leading dims (last dim 3, or 4 for quats)."""
    rot = quaternion.to_rotation_matrix(quats)  # [..., 3, 3]
    rel = o - centers

    def to_local(v):  # R^T v, summed in a fixed order (full f32)
        return torch.stack(
            [
                rot[..., 0, i] * v[..., 0]
                + rot[..., 1, i] * v[..., 1]
                + rot[..., 2, i] * v[..., 2]
                for i in range(3)
            ],
            dim=-1,
        )

    p_loc = to_local(rel) / scales
    w_loc = to_local(d) / scales
    a = torch.sum(w_loc * w_loc, dim=-1)
    b = torch.sum(w_loc * p_loc, dim=-1)
    c = torch.sum(p_loc * p_loc, dim=-1)
    return QuadricCoeffs(a, b, c)


def pair_coeffs_gathered(o, d, centers, scales, quats, ids) -> QuadricCoeffs:
    """Coefficients for per-ray primitive ids: rays o, d [R, 3], primitives
    [N, ...], ids [R, C] -> [R, C]. The three local axes are summed in the
    JAX package's order (w and p scaled by 1/s, then squared); the rotation
    is gathered one [R, C] column at a time, not as [R, C, 3, 3]."""
    rot = quaternion.to_rotation_matrix(quats)  # [N, 3, 3]
    ctr = centers[ids]  # [R, C, 3]
    px = o[:, 0:1] - ctr[..., 0]
    py = o[:, 1:2] - ctr[..., 1]
    pz = o[:, 2:3] - ctr[..., 2]
    a = torch.zeros(ids.shape, dtype=o.dtype, device=o.device)
    b = torch.zeros_like(a)
    c = torch.zeros_like(a)
    for i in range(3):
        r0, r1, r2 = rot[:, 0, i][ids], rot[:, 1, i][ids], rot[:, 2, i][ids]
        inv_s = (1.0 / scales[:, i])[ids]
        w = (d[:, 0:1] * r0 + d[:, 1:2] * r1 + d[:, 2:3] * r2) * inv_s
        p = (px * r0 + py * r1 + pz * r2) * inv_s
        a = a + w * w
        b = b + w * p
        c = c + p * p
    return QuadricCoeffs(a, b, c)


def pair_coeffs_gemm(rayf, pf: torch.Tensor) -> QuadricCoeffs:
    """All-pairs coefficients as three ``[R, 10] x [10, C]`` products of
    :func:`ray_features` and :func:`prim_features`. They must run in full
    f32: the package turns TF32 off, since ``q_min = c - b^2/a`` cancels
    and reduced-precision products wreck it."""
    fa, fb, fc = rayf
    return QuadricCoeffs(fa @ pf, fb @ pf, fc @ pf)


def prim_features(centers, scales, quats) -> torch.Tensor:
    """Primitives as a ``[10, C]`` feature matrix: rows (M11, M22, M33,
    2 M12, 2 M13, 2 M23, (Mc)_x, (Mc)_y, (Mc)_z, c^T M c) with
    ``M = R diag(s)^-2 R^T``. With :func:`ray_features` the coefficients are
    three 10-term dot products: ``a = fa . P``, ``b = fb . P``, ``c = fc . P``.
    Each sum is taken left to right; differentiable in all three inputs."""
    rot = quaternion.to_rotation_matrix(quats)  # [C, 3, 3]
    inv_s2 = 1.0 / (scales * scales)

    def m(i, j):  # M_ij = sum_k R_ik inv_s2_k R_jk
        return (
            rot[:, i, 0] * inv_s2[:, 0] * rot[:, j, 0]
            + rot[:, i, 1] * inv_s2[:, 1] * rot[:, j, 1]
            + rot[:, i, 2] * inv_s2[:, 2] * rot[:, j, 2]
        )

    mm = [[m(i, j) for j in range(3)] for i in range(3)]
    cx, cy, cz = centers[:, 0], centers[:, 1], centers[:, 2]
    mc = [mm[i][0] * cx + mm[i][1] * cy + mm[i][2] * cz for i in range(3)]
    cmc = cx * mc[0] + cy * mc[1] + cz * mc[2]
    return torch.stack(
        [
            mm[0][0], mm[1][1], mm[2][2],
            2.0 * mm[0][1], 2.0 * mm[0][2], 2.0 * mm[1][2],
            mc[0], mc[1], mc[2], cmc,
        ],
        dim=0,
    )


def ray_features(o: torch.Tensor, d: torch.Tensor):
    """Ray-side feature vectors (fa, fb, fc), each ``[R, 10]``, such that
    with ``P = prim_features(...)``: ``a = fa . P`` (d^T M d),
    ``b = fb . P`` (d^T M o - d^T M c), ``c = fc . P``
    (o^T M o - 2 o^T M c + c^T M c)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    zero = torch.zeros_like(ox)
    one = torch.ones_like(ox)
    fa = torch.stack(
        [dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz, zero, zero, zero, zero],
        dim=-1,
    )
    fb = torch.stack(
        [
            dx * ox, dy * oy, dz * oz,
            0.5 * (dx * oy + dy * ox), 0.5 * (dx * oz + dz * ox),
            0.5 * (dy * oz + dz * oy),
            -dx, -dy, -dz, zero,
        ],
        dim=-1,
    )
    fc = torch.stack(
        [ox * ox, oy * oy, oz * oz, ox * oy, ox * oz, oy * oz,
         -2.0 * ox, -2.0 * oy, -2.0 * oz, one],
        dim=-1,
    )
    return fa, fb, fc
