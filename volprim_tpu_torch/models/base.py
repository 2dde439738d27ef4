"""Shared model helpers and the wavefront render loop
(volprim_tpu.models.base).

``render`` generates jittered camera rays per sample, evaluates a radiance
function over the whole wavefront and splats the result onto the film;
``render_batch`` does the same for N same-sized cameras side by side on
one wide film (the reference's batch sensor).
Randomness comes from one explicit ``torch.Generator`` on the render's
device: the film jitter and then the radiance function's own draws, sample
after sample. It does not reproduce ``jax.random`` bits.

With ``mesh`` (a :class:`volprim_tpu_torch.parallel.Mesh` of W ranks, each
holding the same primitives and a generator in the same state), every rank
draws the whole wavefront's film jitter from the shared generator, takes
its contiguous block of the rays (``parallel.shard_rays``), evaluates their
radiance and splats it into a full-size film of its own; the films' sums
and weights are then summed over the ranks (``parallel.sum_parts``, whose
backward passes the cotangent through) before they are developed. On W > 1
ranks the radiance function draws from a stream of the rank's own
(``parallel.rank_generator``: seeded from a hash of the shared generator's
state and the rank, the shared generator not advanced); on one rank it
draws from the shared generator, as without a mesh. Deterministic integrators (``rf`` without Russian roulette,
``tomography``) give the single process's image up to the order of the
film sums; ``prb`` gives an image of the same distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops import filters
from ..parallel.mesh import rank_generator, shard_rays, sum_parts
from ..scene.cameras import CameraSpecs, film_coords, rays_from_pixels
from ..scene.ellipsoids import EllipsoidScene


@dataclasses.dataclass
class Film:
    """Accumulated splats + filter weights."""

    img: torch.Tensor  # [H, W, 3]
    wgt: torch.Tensor  # [H, W]

    def develop(self) -> torch.Tensor:
        return filters.develop(self.img, self.wgt)


def pad_primitives(prims: EllipsoidScene, multiple: int) -> EllipsoidScene:
    """Pad the primitive arrays to a multiple of ``multiple`` with inert
    primitives (unit scales, centers at 1e4, identity quats, zero
    attributes) so chunked stages have fixed shapes. The values are
    moderate on purpose: extreme centers or scales overflow the f32 quadric
    coefficients (b^2 -> inf) and validate as hits. Consumers must still
    mask by ``index < num_prims``."""
    n = prims.num_prims
    n_pad = (-n) % multiple
    if n_pad == 0:
        return prims
    dev = prims.device
    far = torch.full((n_pad, 3), 1e4, dtype=prims.centers.dtype, device=dev)
    unit = torch.ones((n_pad, 3), dtype=prims.scales.dtype, device=dev)
    qid = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=prims.quats.dtype, device=dev
    ).expand(n_pad, 4)
    attrs = {
        k: torch.cat([v, v.new_zeros((n_pad,) + tuple(v.shape[1:]))])
        for k, v in prims.attrs.items()
    }
    return EllipsoidScene(
        centers=torch.cat([prims.centers, far]),
        scales=torch.cat([prims.scales, unit]),
        quats=torch.cat([prims.quats, qid]),
        attrs=attrs,
        extent=prims.extent,
    )


RadianceFn = Callable[..., torch.Tensor]


def render(
    primitives: EllipsoidScene,
    camera: CameraSpecs,
    radiance_fn: Callable[..., torch.Tensor],
    cfg: Any,
    emitter=None,
    spp: int = 1,
    generator: torch.Generator = None,
    rfilter: str = "box",
    mesh=None,
    spp_group: int = 1,
) -> torch.Tensor:
    """Render one camera on the primitives' device. Returns [H, W, 3].

    ``radiance_fn(primitives, emitter, o, d, cfg, generator) -> [R, 3]``;
    ``generator`` is a ``torch.Generator`` on that device and is required.
    ``rfilter="tent"`` splats bilinearly, any other value into the
    containing pixel (box).
    ``spp_group`` folds that many samples into one wavefront (their film
    jitters drawn one after another, then one radiance call over the
    stacked rays): the estimator is unchanged, memory grows with the group.
    The largest divisor of ``spp`` not above it is used.
    ``mesh`` shards the wavefront's rays over its ranks (module docstring).
    """
    if generator is None:
        raise ValueError("render needs an explicit torch.Generator on the render's device")
    splat = _splat(rfilter)
    dev = primitives.device
    h, w = camera.height, camera.width
    g = max(1, min(int(spp_group), spp))
    while spp % g:
        g -= 1
    ray_gen = rank_generator(mesh, generator)
    film = Film(torch.zeros((h, w, 3), device=dev), torch.zeros((h, w), device=dev))
    for _ in range(spp // g):
        coords = [film_coords(camera, generator, device=dev) for _ in range(g)]
        px = torch.cat([c[0] for c in coords])
        py = torch.cat([c[1] for c in coords])
        px, py = shard_rays(mesh, px, py)
        o, d = rays_from_pixels(camera, px, py)
        radiance = radiance_fn(primitives, emitter, o, d, cfg, ray_gen)
        img, wgt = splat(radiance, px, py, w, h)
        film = Film(film.img + img, film.wgt + wgt)
    return _develop(mesh, film)


def _develop(mesh, film: Film) -> torch.Tensor:
    """The film summed over the mesh's ranks, developed."""
    return Film(sum_parts(mesh, film.img), sum_parts(mesh, film.wgt)).develop()


def _splat(rfilter: str):
    """The tent splat for ``"tent"``, the box splat for anything else."""
    return filters.splat_tent if rfilter == "tent" else filters.splat_box


def batch_rays(cameras: Sequence[CameraSpecs], px: torch.Tensor, py: torch.Tensor):
    """Rays of N cameras through their film coordinates px, py [N, R]:
    (o, d) [N * R, 3], camera after camera."""
    dev = px.device
    f32 = torch.float32
    rot = torch.as_tensor(np.stack([c.to_world[:3, :3] for c in cameras]), dtype=f32,
                          device=dev)
    origin = torch.as_tensor(np.stack([c.to_world[:3, 3] for c in cameras]), dtype=f32,
                             device=dev)
    focal = torch.tensor([c.focal_length for c in cameras], dtype=f32, device=dev)[:, None]
    ppx = torch.tensor([c.width / 2.0 - c.cx for c in cameras], dtype=f32, device=dev)[:, None]
    ppy = torch.tensor([c.height / 2.0 - c.cy for c in cameras], dtype=f32, device=dev)[:, None]
    dl = torch.stack([-(px - ppx) / focal, -(py - ppy) / focal, torch.ones_like(px)], dim=-1)
    d = torch.einsum("nij,nrj->nri", rot, dl)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = origin[:, None, :].expand(d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def render_batch(
    primitives: EllipsoidScene,
    cameras: Sequence[CameraSpecs],
    radiance_fn: Callable[..., torch.Tensor],
    cfg: Any,
    emitter=None,
    spp: int = 1,
    generator: torch.Generator = None,
    rfilter: str = "box",
    mesh=None,
) -> torch.Tensor:
    """Render N same-resolution cameras side by side into one wide film,
    camera i in columns [i W, (i + 1) W): [H, N W, 3] on the primitives'
    device, splatted as :func:`render` splats for ``rfilter``. Every
    sample draws the jitter of all N films from
    ``generator`` (required, on that device), then evaluates all their rays
    in one wavefront, which ``mesh`` shards over its ranks (module
    docstring)."""
    if generator is None:
        raise ValueError("render_batch needs an explicit torch.Generator on the render's device")
    splat = _splat(rfilter)
    h, w = cameras[0].height, cameras[0].width
    if any((c.height, c.width) != (h, w) for c in cameras):
        raise ValueError("the batch sensor needs cameras of one film size")
    n = len(cameras)
    dev = primitives.device
    px0 = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w).reshape(-1)
    py0 = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w).reshape(-1)
    shift = (torch.arange(n, dtype=torch.float32, device=dev) * w)[:, None]
    ray_gen = rank_generator(mesh, generator)
    film = Film(torch.zeros((h, n * w, 3), device=dev), torch.zeros((h, n * w), device=dev))
    for _ in range(spp):
        off = torch.rand((n, h * w, 2), generator=generator, device=dev)
        px, py = px0 + off[..., 0], py0 + off[..., 1]
        o, d = batch_rays(cameras, px, py)
        wide_px, wide_py = (px + shift).reshape(-1), py.reshape(-1)
        o, d, wide_px, wide_py = shard_rays(mesh, o, d, wide_px, wide_py)
        radiance = radiance_fn(primitives, emitter, o, d, cfg, ray_gen)
        img, wgt = splat(radiance, wide_px, wide_py, n * w, h)
        film = Film(film.img + img, film.wgt + wgt)
    return _develop(mesh, film)


class _SppGrad(torch.autograd.Function):
    """The image of ``run(scene, spp)`` whose VJP is that of
    ``run(scene, spp_grad)``; the scene is rebuilt from its flat tensors."""

    @staticmethod
    def forward(ctx, run, rebuild, spp, spp_grad, *tensors):
        ctx.run, ctx.rebuild, ctx.spp_grad = run, rebuild, spp_grad
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return run(rebuild(tensors), spp)

    @staticmethod
    def backward(ctx, grad_img):
        tensors = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(tensors, ctx.needs_input_grad[4:])]
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            img = ctx.run(ctx.rebuild(leaves), ctx.spp_grad)
            grads = iter(torch.autograd.grad(img, wanted, grad_img, allow_unused=True))
        return (None, None, None, None) + tuple(
            next(grads) if t.requires_grad else None for t in leaves)


def render_with_spp_grad(
    camera,
    radiance_fn: Callable[..., torch.Tensor],
    cfg: Any,
    emitter=None,
    spp: int = 8,
    spp_grad: int = 1,
    seed: int = 0,
    rfilter: str = "box",
    mesh=None,
):
    """A primal / adjoint split of the sample count (``mi.render(...,
    spp, spp_grad)``): returns ``f(primitives) -> [H, W, 3]`` whose forward
    renders ``spp`` samples and whose VJP re-renders ``spp_grad`` samples
    and takes that render's VJP. Each render draws from a fresh
    ``torch.Generator`` on the primitives' device seeded with ``seed``, so
    ``spp_grad == spp`` gives plain autograd's gradients. ``camera`` may be
    a list of same-size cameras (:func:`render_batch`)."""
    batch = isinstance(camera, (list, tuple))

    def run(prims: EllipsoidScene, n: int) -> torch.Tensor:
        gen = torch.Generator(device=prims.device)
        gen.manual_seed(seed)
        if batch:
            return render_batch(prims, camera, radiance_fn, cfg, emitter, spp=n, generator=gen,
                                rfilter=rfilter, mesh=mesh)
        return render(prims, camera, radiance_fn, cfg, emitter, spp=n, generator=gen,
                      rfilter=rfilter, mesh=mesh)

    def f(prims: EllipsoidScene) -> torch.Tensor:
        keys = list(prims.attrs)

        def rebuild(t):
            return EllipsoidScene(centers=t[0], scales=t[1], quats=t[2],
                                  attrs=dict(zip(keys, t[3:])), extent=prims.extent)

        return _SppGrad.apply(run, rebuild, spp, spp_grad, prims.centers, prims.scales,
                              prims.quats, *(prims.attrs[k] for k in keys))

    return f
