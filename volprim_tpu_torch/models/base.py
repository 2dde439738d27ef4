"""Shared model helpers and the wavefront render loop
(volprim_tpu.models.base).

``render`` generates jittered camera rays per sample, evaluates a radiance
function over the whole wavefront and splats the result onto the film.
Randomness comes from one explicit ``torch.Generator`` on the render's
device: the film jitter and then the radiance function's own draws, sample
after sample. It does not reproduce ``jax.random`` bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..ops import filters
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
    """
    if generator is None:
        raise ValueError("render needs an explicit torch.Generator on the render's device")
    if rfilter != "box":
        raise NotImplementedError(f"rfilter={rfilter!r} is not ported (ROADMAP.md §A5)")
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported (ROADMAP.md §A7)")
    if spp_group != 1:
        raise NotImplementedError("spp_group != 1 is not ported (ROADMAP.md §A5)")
    dev = primitives.device
    h, w = camera.height, camera.width
    film = Film(torch.zeros((h, w, 3), device=dev), torch.zeros((h, w), device=dev))
    for _ in range(spp):
        px, py = film_coords(camera, generator, device=dev)
        o, d = rays_from_pixels(camera, px, py)
        radiance = radiance_fn(primitives, emitter, o, d, cfg, generator)
        img, wgt = filters.splat_box(radiance, px, py, w, h)
        film = Film(film.img + img, film.wgt + wgt)
    return film.develop()
