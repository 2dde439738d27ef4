"""Spherical-harmonics fitting by spherical quadrature
(volprim_tpu.tooling.sh_fit).

Composite-Simpson product quadrature over the sphere with the sin(theta)
Jacobian folded into the weights, made in f64 numpy and cast to f32 once;
coefficient fitting and reconstruction for scalar and color functions; a
batched fit under a ray budget; and the per-vertex fit of a mesh's
outgoing radiance through a :class:`~volprim_tpu_torch.tooling.
radiance_cache.RadianceCache`. The SH basis is ``ops.sh``'s.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import sh


def composite_simpson(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes and weights of the composite Simpson rule on [0, 1] with n
    points (n odd >= 3)."""
    assert n >= 3 and n % 2 == 1, "composite Simpson needs an odd point count"
    x = np.linspace(0.0, 1.0, n)
    h = 1.0 / (n - 1)
    w = np.ones(n)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    w *= h / 3.0
    return x, w


def spherical_quadrature(res: int = 31, device=None):
    """Product quadrature over the sphere: (directions [M, 3], weights [M])
    in f32 on ``device`` such that sum(w_i f(d_i)) approximates the
    integral of f over the sphere (solid-angle measure)."""
    from .. import as_device

    xt, wt = composite_simpson(res)
    xp, wp = composite_simpson(2 * res - 1)
    theta = xt * np.pi
    phi = xp * 2.0 * np.pi
    tg, pg = np.meshgrid(theta, phi, indexing="ij")
    st = np.sin(tg)
    d = np.stack([st * np.sin(pg), np.cos(tg), -st * np.cos(pg)], axis=-1).reshape(-1, 3)
    w = (wt[:, None] * np.pi) * (wp[None, :] * 2.0 * np.pi) * st
    dev = as_device(device)
    return (torch.from_numpy(d.astype(np.float32)).to(dev),
            torch.from_numpy(w.reshape(-1).astype(np.float32)).to(dev))


def fit_sh(fn, degree: int = 3, res: int = 31, device=None) -> torch.Tensor:
    """Project a spherical function onto the real SH basis.

    ``fn`` maps directions [M, 3] to values [M] or [M, C]. Returns the
    coefficients [(degree+1)^2] or [(degree+1)^2, C].
    """
    d, w = spherical_quadrature(res, device)
    vals = fn(d)
    wb = w[:, None] * sh.eval_basis(d, degree)  # [M, K]
    if vals.dim() == 1:
        return torch.einsum("mk,m->k", wb, vals)
    return torch.einsum("mk,mc->kc", wb, vals)


def eval_sh(coeffs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Reconstruct the fitted function at directions d [..., 3]."""
    basis = sh.eval_basis(d, sh.degree_from_coeffs(coeffs.shape[0]))
    return basis @ coeffs


def fit_sh_batched(fn, points: torch.Tensor, degree: int = 3, res: int = 15,
                   ray_budget: int = 2**22) -> torch.Tensor:
    """Per-point SH of a field ``fn(points, dirs) -> [P, M, C]``, the points
    in batches of at most ``ray_budget // M`` (M quadrature directions).
    Returns [P, K, C]; the quadrature lives on the points' device."""
    d, w = spherical_quadrature(res, points.device)
    m = d.shape[0]
    wb = w[:, None] * sh.eval_basis(d, degree)  # [M, K]
    batch = max(1, ray_budget // m)
    outs = []
    for i in range(0, points.shape[0], batch):
        vals = fn(points[i:i + batch], d)  # [P, M, C]
        outs.append(torch.einsum("mk,pmc->pkc", wb, vals))
    return torch.cat(outs, dim=0)


def fit_sh_on_mesh(
    cache,
    mesh,
    degree: int = 3,
    res: int = 15,
    ray_budget: int = 2**20,
    generator: Optional[torch.Generator] = None,
    offset: float = 1e-3,
) -> torch.Tensor:
    """Per-vertex SH fit of a mesh's outgoing radiance: for every vertex,
    Lo(v, d) is path-traced from just off the surface back toward the
    vertex over a spherical quadrature in the shading frame, and projected
    onto the SH basis. Returns [V, K, 3] coefficients. Without a generator
    one seeded with 0 on the mesh's device is used."""
    from ..ops import bsdf as bsdf_ops

    verts = mesh.vertices
    normals = mesh.vertex_normals()
    if generator is None:
        generator = torch.Generator(device=verts.device).manual_seed(0)

    def lo_field(pts_idx, d_local):
        p = verts[pts_idx]
        n = normals[pts_idx]
        m = d_local.shape[0]
        pn = p.shape[0]
        d_world = bsdf_ops.to_world(n[:, None, :], d_local[None].expand(pn, m, 3))
        o = (p + n * offset)[:, None, :] + d_world * offset
        li = cache.query(o.reshape(-1, 3), (-d_world).reshape(-1, 3), generator)
        return li.reshape(pn, m, 3)

    idx = torch.arange(verts.shape[0], device=verts.device)
    return fit_sh_batched(lo_field, idx, degree=degree, res=res, ray_budget=ray_budget)
