"""Absorption-only tomography integrator (volprim_tpu.models.tomography).

With the full-range line integral a ray's transmittance does not depend on
the order of the primitives it crosses:

    beta = exp(- sum over hit primitives j of sigma_t_j * D_j(ray)),

so the integrator is a masked sum over (ray, primitive) pairs. A primitive
counts when its extent ellipsoid is entered in front of the ray origin
(rays starting inside a primitive skip it); a ray that hits more than
``max_depth`` primitives is black (-1: no limit); ``hide_emitters`` blanks
rays that hit nothing; without an emitter the result is zeros.

The primitives are padded to a multiple of ``chunk_size`` and summed chunk
after chunk, as in the JAX package; q's minimum along a ray is formed from
the closest point (:func:`_chunk_tau`). The rays go in blocks of at most
``_TOMO_PAIRS`` (ray, primitive) pairs a step, each step under
``torch.utils.checkpoint`` when autograd records, so that the backward
holds one step's intermediates at a time. A ray's sum is formed in the
same order whatever the block (:func:`_row_sum`), so the radiance does not
depend on ``_TOMO_PAIRS``; a primitive's gradient sums over the blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import register_integrator
from ..ops import kernels, quaternion
from ..ops.kernels import Kernel
from ..scene.ellipsoids import EllipsoidScene
from .base import pad_primitives

# (ray, primitive) pairs of one step: the memory knob. About 40 f32 [R, C]
# temporaries of a step live at once under the backward's recomputation.
_TOMO_PAIRS = 1 << 26


@dataclasses.dataclass(frozen=True)
class TomographyConfig:
    max_depth: int = 64  # -1 = unlimited
    kernel_type: str = "gaussian"
    hide_emitters: bool = False
    chunk_size: int = 1024

    @property
    def kernel(self) -> Kernel:
        # forced by the integrator
        return Kernel(self.kernel_type, normalized=False, full_range=True)


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by halving folds (an odd column is carried to
    the next fold): one fixed order, whatever the number of rows."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 else y
    return x[..., 0]


def _chunk_tau(o, d, ctr, scl, qt, sig, is_real, extent: float, kern: Kernel):
    """Optical depth [R] and hit count [R] of rays o, d over one chunk.

    The integrals are the JAX package's (``Kernel.density_integral`` at
    ``full_range``, unnormalized), but q's minimum along the ray is formed
    from the closest point, q_min = |p + t* w|^2 in the scaled local frame
    (t* = -b / a), not as c - b^2 / a: the latter cancels in f32, which put
    the f32 scale gradients 1e-4 of their maximum from an f64 run and made
    them depend on how the rays were blocked (the former: ~1e-6)."""
    rot = quaternion.to_rotation_matrix(qt)  # [C, 3, 3], world <- local
    inv_s = 1.0 / scl
    w, p = [], []
    for i in range(3):
        r0, r1, r2 = rot[:, 0, i][None, :], rot[:, 1, i][None, :], rot[:, 2, i][None, :]
        w.append((d[:, 0:1] * r0 + d[:, 1:2] * r1 + d[:, 2:3] * r2) * inv_s[None, :, i])
        p.append(((o[:, 0:1] - ctr[None, :, 0]) * r0 + (o[:, 1:2] - ctr[None, :, 1]) * r1
                  + (o[:, 2:3] - ctr[None, :, 2]) * r2) * inv_s[None, :, i])
    a = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    t_star = -(w[0] * p[0] + w[1] * p[1] + w[2] * p[2]) / a
    q_min = sum((p[i] + t_star * w[i]) ** 2 for i in range(3))
    e2 = extent * extent
    disc = (e2 - q_min) / a
    half = torch.sqrt(torch.clamp(disc, min=0.0))
    # the extent ellipsoid is hit, and entered in front of the ray origin
    valid = (disc >= 0.0) & (t_star + half > 0.0) & (t_star - half > 0.0) & is_real[None, :]
    s_prod = (scl[:, 0] * scl[:, 1] * scl[:, 2])[None, :]
    if kern.type == "gaussian":  # over the whole line
        dens = torch.exp(-0.5 * q_min) / (2.0 * math.pi * s_prod * torch.sqrt(a))
    else:  # (1 - q) over the extent chord [t* - half, t* + half]
        dens = (15.0 / (8.0 * math.pi * s_prod) * 2.0 * half
                * (1.0 - e2 / 3.0 - (2.0 / 3.0) * q_min))
    dens = kernels._scrub(dens, valid)
    tau = _row_sum(dens * sig[None, :])
    count = torch.sum(valid, dim=-1, dtype=torch.int32)
    return tau, count


@register_integrator("volprim_tomography")
def radiance(
    primitives: EllipsoidScene,
    emitter,
    o: torch.Tensor,
    d: torch.Tensor,
    cfg: TomographyConfig,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Radiance for a wavefront of rays, o, d [R, 3] -> [R, 3]; it draws
    nothing from ``generator``."""
    del generator
    primitives.require_attrs(["sigma_t"])
    kern = cfg.kernel
    prims = pad_primitives(primitives, cfg.chunk_size)
    n = prims.num_prims
    c = min(cfg.chunk_size, n)
    sigma_t = prims.attrs["sigma_t"].reshape(n)
    real = torch.arange(n, device=o.device) < primitives.num_prims
    record = torch.is_grad_enabled()
    rb = max(1, _TOMO_PAIRS // c)
    taus, counts = [], []
    for r0 in range(0, o.shape[0], rb):
        ob, db = o[r0:r0 + rb], d[r0:r0 + rb]
        tau = torch.zeros(ob.shape[0], dtype=o.dtype, device=o.device)
        count = torch.zeros(ob.shape[0], dtype=torch.int32, device=o.device)
        for c0 in range(0, n, c):
            part = slice(c0, c0 + c)
            args = (ob, db, prims.centers[part], prims.scales[part], prims.quats[part],
                    sigma_t[part], real[part], prims.extent, kern)
            if record:
                dtau, dcount = checkpoint(_chunk_tau, *args, use_reentrant=False)
            else:
                dtau, dcount = _chunk_tau(*args)
            tau = tau + dtau
            count = count + dcount
        taus.append(tau)
        counts.append(count)
    tau, count = torch.cat(taus), torch.cat(counts)

    beta = torch.exp(-tau)
    env = (emitter.eval(d) if emitter is not None
           else torch.zeros(d.shape[:-1] + (3,), dtype=o.dtype, device=o.device))
    live = count <= cfg.max_depth if cfg.max_depth >= 0 else torch.ones_like(count, dtype=torch.bool)
    if cfg.hide_emitters:
        live = live & (count > 0)
    return torch.where(live[:, None], beta[:, None] * env, 0.0)
