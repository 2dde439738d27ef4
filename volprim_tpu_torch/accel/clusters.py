"""Morton-ordered primitive clusters: the culling hierarchy
(volprim_tpu.accel.clusters).

The scene is sorted once along a Morton curve and cut into fixed-size
clusters with bounding spheres; tiles cull clusters (and superclusters of
``group`` Morton-adjacent clusters) instead of scanning every primitive.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..scene.ellipsoids import EllipsoidScene


def _spread_bits_10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x with two zero bits between each (int32)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` left to right, the order XLA reduces in: masked
    means of mixed-sign coordinates cancel, and another order moves the
    result by several ulps."""
    parts = x.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def morton_codes(centers: torch.Tensor, num_real: Optional[int] = None) -> torch.Tensor:
    """30-bit Morton codes of positions [N, 3] -> [N] int32, quantized
    against the bounding box of the first ``num_real`` rows (inert padding
    far outside the scene clamps to the max code and sorts last)."""
    ref = centers if num_real is None else centers[:num_real]
    lo = torch.amin(ref, dim=0)
    hi = torch.amax(ref, dim=0)
    q = (centers - lo) / torch.clamp(hi - lo, min=1e-8)
    q = torch.clamp((q * 1023.0).to(torch.int32), 0, 1023)
    return (
        _spread_bits_10(q[:, 0])
        | (_spread_bits_10(q[:, 1]) << 1)
        | (_spread_bits_10(q[:, 2]) << 2)
    )


class ClusterIndex(NamedTuple):
    """Morton-sorted scene + cluster bounding spheres."""

    prims: EllipsoidScene  # primitives reordered along the Morton curve
    perm: torch.Tensor  # [N] original index of each sorted primitive
    centers: torch.Tensor  # [Ncl, 3] cluster bounding-sphere centers
    radii: torch.Tensor  # [Ncl]
    cluster_size: int


def build_clusters(
    prims: EllipsoidScene, cluster_size: int = 64, num_real: Optional[int] = None
) -> ClusterIndex:
    """Sort along the Morton curve and bound groups of ``cluster_size``.
    ``prims.num_prims`` must be a multiple of ``cluster_size`` (pad first
    with models.base.pad_primitives and pass the unpadded count as
    ``num_real``, so padding neither distorts the quantization nor inflates
    the bounds of the cluster it shares with real primitives)."""
    n = prims.num_prims
    if n % cluster_size:
        raise ValueError("pad primitives to a cluster multiple first")
    nr = n if num_real is None else num_real
    # stable, like jnp.argsort: equal codes keep their input order
    order = torch.argsort(morton_codes(prims.centers, nr), stable=True)
    sorted_prims = prims.select(order)
    n_cl = n // cluster_size
    real = (order < nr).reshape(n_cl, cluster_size)
    c = sorted_prims.centers.reshape(n_cl, cluster_size, 3)
    prim_r = prims.extent * torch.amax(sorted_prims.scales, dim=-1).reshape(
        n_cl, cluster_size
    )
    # masked mean/max so padding members don't blow up the bounds; clusters
    # with no real members get a far tiny bound (never culled in)
    cnt = torch.clamp(torch.sum(real, dim=1), min=1)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    centers = _sum_in_order(torch.where(real[..., None], c, zero), 1) / cnt[:, None]
    dist = _norm3(c - centers[:, None, :]) + prim_r
    radii = torch.amax(torch.where(real, dist, zero), dim=1)
    empty = torch.sum(real, dim=1) == 0
    centers = torch.where(empty[:, None], torch.full_like(centers, 1e7), centers)
    radii = torch.where(empty, torch.full_like(radii, 1e-3), radii)
    return ClusterIndex(sorted_prims, order, centers, radii, cluster_size)


def build_super_spheres(centers: torch.Tensor, radii: torch.Tensor, group: int):
    """Bounding spheres of ``group`` consecutive (Morton-adjacent) clusters:
    the third cull level. Far/empty padding clusters (centers ~1e7) are
    left out of a super's bound; a super with no near member gets the same
    far, tiny, never-culled-in bound. Returns (centers [Nsup, 3], radii)."""
    ncl = centers.shape[0]
    nsup = -(-ncl // group)
    pad = nsup * group - ncl
    c = torch.cat([centers, centers.new_full((pad, 3), 1e7)])
    r = torch.cat([radii, radii.new_full((pad,), 1e-3)])
    cg = c.reshape(nsup, group, 3)
    rg = r.reshape(nsup, group)
    near = torch.amax(torch.abs(cg), dim=-1) < 1e6
    cnt = torch.clamp(torch.sum(near, dim=1), min=1)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    sc = _sum_in_order(torch.where(near[..., None], cg, zero), 1) / cnt[:, None]
    dist = _norm3(cg - sc[:, None, :]) + rg
    sr = torch.amax(torch.where(near, dist, zero), dim=1)
    empty = torch.sum(near, dim=1) == 0
    sc = torch.where(empty[:, None], torch.full_like(sc, 1e7), sc)
    sr = torch.where(empty, torch.full_like(sr, 1e-3), sr)
    return sc, sr


def expand_cluster_ids(cluster_ids: torch.Tensor, cluster_valid: torch.Tensor,
                       cluster_size: int):
    """[T, K] cluster shortlist -> ([T, K*cs] primitive ids, valid) into the
    Morton-sorted arrays (a cluster is a contiguous range of primitives)."""
    t, k = cluster_ids.shape
    offs = torch.arange(cluster_size, dtype=cluster_ids.dtype, device=cluster_ids.device)
    ids = (cluster_ids[..., None] * cluster_size + offs).reshape(t, k * cluster_size)
    valid = cluster_valid[..., None].expand(t, k, cluster_size).reshape(t, k * cluster_size)
    return ids, valid
