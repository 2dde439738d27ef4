"""Exact-order radiance-field integrator (volprim_tpu.models.rf).

Every ray composites its ``max_depth`` nearest entered bounding ellipsoids
in entry-t order: 3DGRT peak transmittance ``1 - min(opac * K(peak),
0.9999)`` (K the Gaussian or the Epanechnikov kernel) and SH emission
``max(basis . sh + 0.5, 0)``, front to back, with the beta > 0.01 kill; an
emitter, when given, adds ``beta * emitter.eval(d)`` as the escaped light
(the JAX package's ``white_background``). This is the port's quality oracle for the tiled
renderer (models/rf_tiled.py), which approximates the per-ray order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import quadric, sh, srgb_to_linear
from ..ops.kernels import Kernel
from ..scene.ellipsoids import EllipsoidScene
from . import register_integrator
from .base import pad_primitives


@dataclasses.dataclass(frozen=True)
class RFConfig:
    max_depth: int = 64  # max composited primitives per ray
    rr_depth: int = -1  # Russian-roulette start depth
    kernel_type: str = "gaussian"
    srgb_primitives: bool = True  # sRGB -> linear on the result
    chunk_size: int = 2048

    @property
    def kernel(self) -> Kernel:
        return Kernel(self.kernel_type, normalized=True, full_range=True)

    @property
    def use_rr(self) -> bool:
        return self.rr_depth >= 0 and (
            self.rr_depth < self.max_depth or self.max_depth == -1
        )


def gather_hits(
    primitives: EllipsoidScene,
    o: torch.Tensor,
    d: torch.Tensor,
    k: int,
    chunk_size: int,
    t_min: float = 0.0,
    ray_tile: int = 16384,
):
    """Per-ray k nearest entered bounding ellipsoids, sorted by entry t.

    A streaming top-k over primitive chunks (and over ray tiles, so the
    [rays, chunk] coefficient buffers stay bounded). Returns (t [R, k]
    ascending with +inf padding, ids [R, k])."""
    r = o.shape[0]
    if r > ray_tile:
        parts = [
            gather_hits(
                primitives, o[i:i + ray_tile], d[i:i + ray_tile], k,
                chunk_size, t_min, ray_tile,
            )
            for i in range(0, r, ray_tile)
        ]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    prims = pad_primitives(primitives, chunk_size)
    n = prims.num_prims
    c = min(chunk_size, n)
    best_t = torch.full((r, k), float("inf"), dtype=o.dtype, device=o.device)
    best_id = torch.zeros((r, k), dtype=torch.int64, device=o.device)
    for start in range(0, n, c):
        sl = slice(start, start + c)
        coeffs = quadric.ray_prim_coeffs(
            o, d, prims.centers[sl], prims.scales[sl], prims.quats[sl]
        )
        valid, t_near, _ = quadric.intersect_extent(coeffs, prims.extent)
        is_real = torch.arange(start, start + c, device=o.device) < primitives.num_prims
        valid = valid & (t_near > t_min) & is_real[None, :]
        t_near = torch.where(valid, t_near, torch.full_like(t_near, float("inf")))
        # the k nearest within the chunk, then a merge with the running
        # buffer (keeps each selection at [R, c] then [R, 2k])
        neg_t, idx = torch.topk(-t_near, min(k, c), dim=-1)
        cand_t = torch.cat([best_t, -neg_t], dim=-1)
        cand_id = torch.cat([best_id, start + idx], dim=-1)
        neg_t2, sel = torch.topk(-cand_t, k, dim=-1)
        best_t = -neg_t2
        best_id = torch.gather(cand_id, 1, sel)
    return best_t, best_id


@register_integrator("volprim_rf")
def radiance(
    primitives: EllipsoidScene,
    emitter,
    o: torch.Tensor,
    d: torch.Tensor,
    cfg: RFConfig,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Radiance for a wavefront of rays: o, d [R, 3] -> [R, 3].

    ``generator`` drives Russian roulette when ``cfg.rr_depth >= 0``. An
    ``emitter`` lights the escaped rays: ``L += beta * emitter.eval(d)``."""
    primitives.require_attrs(["opacities", "sh_coeffs"])
    kern = cfg.kernel
    k = cfg.max_depth if cfg.max_depth > 0 else 256
    # the hit search only selects (its t values reach no output), so it runs
    # outside autograd: under it every chunk's [rays, chunk] buffers would be
    # held until the search ends
    with torch.no_grad():
        hit_t, hit_id = gather_hits(primitives, o, d, k, cfg.chunk_size)
    # empty slots (t = inf) may name padding ids; they are masked below
    hit_id = torch.clamp(hit_id, max=primitives.num_prims - 1)

    sh_coeffs = primitives.sh_coeffs_3d()  # [N, K, 3]
    basis = sh.eval_basis(d, sh.degree_from_coeffs(sh_coeffs.shape[1]))  # [R, K]
    opac = primitives.attrs["opacities"][:, 0]

    r = o.shape[0]
    l_acc = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
    beta = torch.ones((r, 3), dtype=o.dtype, device=o.device)
    active = torch.ones((r,), dtype=torch.bool, device=o.device)
    for step in range(k):
        t_h, id_h = hit_t[:, step], hit_id[:, step]
        active = active & torch.isfinite(t_h)
        coeffs = quadric.pair_coeffs(
            o, d, primitives.centers[id_h], primitives.scales[id_h],
            primitives.quats[id_h],
        )
        density = kern.peak_response(coeffs)
        transmission = 1.0 - torch.clamp(opac[id_h] * density, max=0.9999)
        emission = torch.sum(basis[:, :, None] * sh_coeffs[id_h], dim=1)
        emission = torch.clamp(emission + 0.5, min=0.0)
        le = beta * (1.0 - transmission)[:, None] * emission
        le = torch.where(torch.isfinite(le), le, torch.zeros_like(le))
        mask = active[:, None]
        l_acc = l_acc + torch.where(mask, le, torch.zeros_like(le))
        beta = torch.where(mask, beta * transmission[:, None], beta)
        beta_max = torch.amax(beta, dim=-1)
        active = active & (beta_max > 0.01)
        if cfg.use_rr:
            sample_rr = torch.rand(
                (r,), generator=generator, device=o.device, dtype=o.dtype
            )
            rr_prob = torch.clamp(beta_max, min=0.1)
            rr_active = (step + 1 >= cfg.rr_depth) & (beta_max < 0.1)
            beta = torch.where(
                (rr_active & active)[:, None], beta / rr_prob[:, None], beta
            )
            active = active & (~rr_active | (sample_rr < rr_prob))

    if emitter is not None:
        l_acc = l_acc + beta * emitter.eval(d)
    if cfg.srgb_primitives:
        l_acc = srgb_to_linear(l_acc)
    return l_acc
