"""Ray-tile cone culling (volprim_tpu.accel.tiles).

Each film tile's rays share an origin and span a small cone; bounding
spheres are culled per cone with a conservative angular-sum test written
without transcendentals:

    theta <= half + rho
    <=> (half + rho >= pi) OR cos(theta) >= cos(half)cos(rho) - sin(half)sin(rho)

Keys are the view depth along the cone axis for spheres that meet the
cone, +inf otherwise; a negative radius marks an inert slot.
"""

from __future__ import annotations

import torch


def _keys(depth, dist, radii, cos_half):
    """Shared tail of the cone tests; all arguments broadcast to [..., K]."""
    safe = torch.clamp(dist, min=1e-8)
    cos_theta = depth / safe
    sin_rho = torch.clamp(radii / safe, 0.0, 1.0)
    cos_rho = torch.sqrt(torch.clamp(1.0 - sin_rho * sin_rho, min=0.0))
    ch = torch.clamp(cos_half, -1.0, 1.0)
    sh = torch.sqrt(torch.clamp(1.0 - ch * ch, min=0.0))
    wraps = cos_rho <= -ch  # half + rho >= pi: the cone covers everything
    inside = wraps | (cos_theta >= ch * cos_rho - sh * sin_rho)
    in_front = depth + radii > 1e-4  # cull spheres entirely behind the origin
    contains = dist <= radii  # a sphere containing the origin always meets it
    hit = ((inside & in_front) | contains) & (radii >= 0.0)
    return torch.where(hit, depth, torch.full_like(depth, float("inf")))


def cone_cull_keys_batch(origin, axes, cos_half, centers, radii) -> torch.Tensor:
    """Keys of T cones (axes [T, 3], cos_half [T]) against N spheres
    (centers [N, 3], radii [N]) -> [T, N]. Per-sphere terms are computed once
    as [N] columns; the per-pair depth is one [T, 3] x [3, N] product."""
    v = centers - origin  # [N, 3]
    dist = torch.sqrt(torch.sum(v * v, dim=-1))
    depth = torch.matmul(axes, v.T)  # [T, N], full f32 (TF32 is off)
    return _keys(depth, dist[None, :], radii[None, :], cos_half[:, None])


def cone_cull_keys_cols(origin, axis, cos_half, cx, cy, cz, radii) -> torch.Tensor:
    """Cone keys on pre-gathered sphere columns (the two-level cull's
    per-tile refinement): axis [..., 3], cos_half [...], columns [..., K]."""
    vx = cx - origin[0]
    vy = cy - origin[1]
    vz = cz - origin[2]
    dist = torch.sqrt(vx * vx + vy * vy + vz * vz)
    depth = vx * axis[..., 0:1] + vy * axis[..., 1:2] + vz * axis[..., 2:3]
    return _keys(depth, dist, radii, cos_half[..., None])


def shortlist(keys: torch.Tensor, max_candidates: int):
    """The ``max_candidates`` nearest culled entries per row: keys [T, N] ->
    (ids [T, S] depth-ascending, valid [T, S]).

    ``lax.top_k`` in the JAX package breaks ties by the lower index; a
    stable ascending sort gives the same order (ties matter: every +inf
    key ties, and finite depths can tie too), which ``torch.topk`` does not
    promise."""
    order = torch.argsort(keys, dim=-1, stable=True)[:, :max_candidates]
    return order, torch.isfinite(torch.gather(keys, 1, order))
