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


def tile_cones(o: torch.Tensor, d: torch.Tensor, tile_rays: int):
    """Bounding cones of consecutive tiles of ``tile_rays`` rays that share
    one origin (o, d [R, 3], R a multiple of ``tile_rays``). Returns
    (origins [T, 3], unit axes [T, 3], cos_half [T])."""
    t = o.shape[0] // tile_rays
    dt = d.reshape(t, tile_rays, 3)
    axis = dt.mean(dim=1)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    cos_half = torch.amin(torch.sum(dt * axis[:, None, :], dim=-1), dim=1)
    return o.reshape(t, tile_rays, 3)[:, 0], axis, torch.clamp(cos_half, -1.0, 1.0)


def cone_cull_keys(origin, axis, cos_half, centers, radii) -> torch.Tensor:
    """Keys of one cone (origin [3], axis [3], cos_half []) against N
    spheres (centers [N, 3], radii [N]) -> [N]."""
    v = centers - origin
    dist = torch.sqrt(torch.sum(v * v, dim=-1))
    depth = v[:, 0] * axis[0] + v[:, 1] * axis[1] + v[:, 2] * axis[2]
    return _keys(depth, dist, radii, torch.as_tensor(cos_half, dtype=depth.dtype,
                                                     device=depth.device))


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


def shortlist_approx(keys: torch.Tensor, max_candidates: int, recall: float = 0.95):
    """:func:`shortlist` under the JAX package's name for its coarse cull,
    where ``lax.approx_max_k`` gives up exactness for speed on a TPU. Here
    the selection is exact (recall 1, above any ``recall`` asked for)."""
    del recall
    return shortlist(keys, max_candidates)
