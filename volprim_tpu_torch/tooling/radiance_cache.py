"""Radiance cache and the radiosity-equation loss
(volprim_tpu.tooling.radiance_cache).

A cache wraps a scene (primitives, optionally a triangle mesh with vertex
BSDF attributes) and an integrator, and answers radiance queries along
arbitrary rays, outside any film or sensor:

- ``eval_lo``: outgoing radiance at surface points, path-traced toward the
  point from just off the surface;
- ``eval_li_mat``: cosine-sampled incident radiance over the hemisphere,
  divided by the sampling pdf;
- :func:`compute_loss`: the radiosity residual
  ``|| (Lo - Le) - (1/W) sum_i Li_i f(x, wi_i -> wo) ||^2``.

Every query runs under ``torch.no_grad()``: no graph is built through the
integrator, and the loss's gradient reaches only the trainable vertex
attributes, through the BSDF's ``eval``. Random draws come from one
``torch.Generator`` on the cache's device, in the JAX package's order
(points, then incident directions and their queries, then per outgoing
direction its draws and query).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..models import prb, rf
from ..ops import bsdf as bsdf_ops
from ..scene import mesh as mesh_mod
from ..scene.ellipsoids import EllipsoidScene, EllipsoidsFactory


def _inert_medium(device) -> EllipsoidScene:
    """A single zero-density primitive: prb requires a medium scene."""
    f = EllipsoidsFactory()
    f.add(mean=[0.0, 0.0, 0.0], scale=0.1, sigma_t=0.0, albedo=0.0)
    return f.build(device=device)


@dataclasses.dataclass
class RadianceCache:
    """Incident / outgoing radiance of a scene along arbitrary rays.

    ``integrator='rf'`` queries the radiance field (``models.rf``);
    ``'prb'`` path-traces, with meshes carrying ground-truth vertex BSDFs
    (the radiosity setup). Without primitives the cache's medium is one
    zero-density primitive on the mesh's device (the card without a mesh).
    """

    primitives: Optional[EllipsoidScene] = None
    cfg: object = None
    emitter: Optional[object] = None
    mesh: Optional[mesh_mod.TriangleMesh] = None
    bsdf: Optional[object] = None
    integrator: str = "rf"
    spp: int = 1

    def __post_init__(self):
        from .. import as_device

        if self.cfg is None:
            self.cfg = (
                rf.RFConfig(max_depth=64)
                if self.integrator == "rf"
                else prb.PRBConfig(
                    max_overlaps=8, max_windows=2, bounce_cap=6,
                    chunk_size=64, cluster_size=8,
                )
            )
        if self.primitives is None:
            self.primitives = _inert_medium(
                self.mesh.device if self.mesh is not None else as_device(None))

    @property
    def device(self) -> torch.device:
        return self.primitives.device

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generator

    @torch.no_grad()
    def query(self, o: torch.Tensor, d: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Radiance arriving at o from direction d, [R, 3]; ``spp``
        path-traced samples averaged (prb). Without a generator one seeded
        with 0 is used."""
        generator = self._generator(generator)
        if self.integrator == "rf":
            return rf.radiance(self.primitives, self.emitter, o, d, self.cfg, generator)
        out = 0.0
        for _ in range(self.spp):
            out = out + prb.radiance(
                self.primitives, self.emitter, o, d, self.cfg, generator,
                mesh=self.mesh, bsdf=self.bsdf,
            )
        return out / self.spp

    # ---- radiosity-equation terms -----------------------------------------

    def eval_le(self, n_points: int) -> torch.Tensor:
        """Surface emission: zero (the scenes' surfaces do not emit)."""
        return torch.zeros((n_points, 3), device=self.device)

    def eval_lo(self, p, n, wo_local, generator=None, offset: float = 1e-3):
        """Outgoing radiance at points p (normals n) in local directions
        wo_local: spawned along wo, traced back toward the point."""
        wo_world = bsdf_ops.to_world(n, wo_local)
        o = p + n * 1e-4 + wo_world * offset
        return self.query(o, -wo_world, generator)

    def eval_li_mat(self, p, n, generator, num_wi: int):
        """Cosine-sampled incident radiance divided by the pdf. Returns
        (li_over_pdf [P, W, 3], wi_local [P, W, 3])."""
        pn = p.shape[0]
        u = torch.rand((pn, num_wi), generator=generator, device=p.device)
        v = torch.rand((pn, num_wi), generator=generator, device=p.device)
        r = torch.sqrt(u)
        phi = 2.0 * math.pi * v
        wi_local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(1.0 - u)],
                               dim=-1)
        pdf = torch.clamp(wi_local[..., 2] / math.pi, min=1e-6)
        wi_world = bsdf_ops.to_world(n[:, None, :], wi_local)
        o = (p + n * 1e-3)[:, None, :].expand(wi_world.shape)
        li = self.query(o.reshape(-1, 3), wi_world.reshape(-1, 3), generator)
        return li.reshape(pn, num_wi, 3) / pdf[..., None], wi_local

    def incident_hemisphere(self, p, n, generator, num_wi: int):
        """(wi_local [P, W, 3], Li [P, W, 3]): cosine-distributed directions
        and their incident radiance, without the 1/pdf weighting."""
        li_w, wi = self.eval_li_mat(p, n, generator, num_wi)
        pdf = torch.clamp(wi[..., 2] / math.pi, min=1e-6)
        return wi, li_w * pdf[..., None]


def compute_loss(
    cache: RadianceCache,
    train_mesh: mesh_mod.TriangleMesh,
    train_attrs: Dict[str, torch.Tensor],
    train_bsdf,
    generator: torch.Generator,
    num_points: int = 64,
    num_wi: int = 64,
    num_wo: int = 1,
) -> torch.Tensor:
    """Radiosity residual over random surface points of ``train_mesh``.

    ``train_attrs`` maps vertex-attribute names to [V, k] tensors, the
    trainable parameters; everything the cache returns is detached.
    """
    with torch.no_grad():
        pts, normals, fid, bary, _ = mesh_mod.sample_surface(train_mesh, generator, num_points)

    # the trainable attributes at the sampled points
    tm = mesh_mod.TriangleMesh(train_mesh.vertices, train_mesh.faces, train_attrs)
    attrs_pt = {}
    for name in train_bsdf.attr_names():
        v = tm.interpolate(name, fid, bary)
        attrs_pt[name] = v if v.shape[-1] > 1 else v[:, 0]

    li_w, wi_local = cache.eval_li_mat(pts, normals, generator, num_wi)

    loss = 0.0
    for _ in range(num_wo):
        u = torch.rand((num_points, 2), generator=generator, device=pts.device)
        r = torch.sqrt(u[:, 0])
        phi = 2.0 * math.pi * u[:, 1]
        wo_local = torch.stack(
            [r * torch.cos(phi), r * torch.sin(phi),
             torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))], dim=-1,
        )
        lo = cache.eval_lo(pts, normals, wo_local, generator)
        lhs = lo - cache.eval_le(num_points)
        # reciprocity: eval with si.wi = wo and the query direction wi
        wide = {k: torch.repeat_interleave(v, num_wi, dim=0) for k, v in attrs_pt.items()}
        f = train_bsdf.eval(
            wide, torch.repeat_interleave(wo_local, num_wi, dim=0), wi_local.reshape(-1, 3),
        ).reshape(num_points, num_wi, 3)
        rhs = torch.mean(li_w * f, dim=1)
        loss = loss + 0.5 * torch.mean(torch.sum(torch.square(lhs - rhs), dim=-1)) / num_wo
    return loss
