"""Renderers of heterogeneous grid volumes (volprim_tpu.models.gridvol):
the ground truth of tomographic fitting.

- :func:`radiance`: the absorption-only ray marcher, exp(-sigma_scale *
  integral of the grid) times the emitter (ones without one).
- :func:`radiance_scattering`: the multiple-scattering path tracer
  (sigma_t = sigma_scale * grid, constant albedo, isotropic phase, an
  environment emitter): Woodcock delta tracking against the grid maximum
  for free flight, ``bounce_cap`` bounces of at most ``tracking_steps``
  tracking steps each (a path that exhausts them counts as escaped),
  next-event estimation with a transmittance marched in ``shadow_steps``
  steps, MIS on escape, and the ``beta > 0.003`` kill. Every loop runs its
  full count, as the JAX package's scans do. Its variates come from the
  ``torch.Generator``; they do not reproduce ``jax.random`` bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..scene.vol import GridVolume


@dataclasses.dataclass(frozen=True)
class GridVolumeConfig:
    sigma_scale: float = 5.0  # sigma_t per unit of grid density
    num_steps: int = 256  # ray-marching steps through the bbox
    to_world_scale: tuple = (1.0, 2.0, 1.0)  # grid transform: scale, then translate
    to_world_translate: tuple = (-0.5, -1.0, -0.5)
    # the scattering path tracer
    albedo: float = 0.6  # constant single-scattering albedo
    bounce_cap: int = 32  # path length bound
    tracking_steps: int = 128  # delta-tracking iterations per free flight
    shadow_steps: int = 128  # ray-march steps for the NEE transmittance


def transform_grid(grid: GridVolume, cfg: GridVolumeConfig) -> GridVolume:
    """The grid with its bbox scaled, then translated (the unit cube's
    to_world)."""
    dev = grid.device
    scale = torch.tensor(cfg.to_world_scale, dtype=torch.float32, device=dev)
    trans = torch.tensor(cfg.to_world_translate, dtype=torch.float32, device=dev)
    return GridVolume(data=grid.data, bbox_min=grid.bbox_min * scale + trans,
                      bbox_max=grid.bbox_max * scale + trans)


def _bbox_intersect(grid: GridVolume, o, d):
    """Slab test: (t_near clamped to >= 0, t_far); the bbox is hit where
    t_far > t_near."""
    inv_d = torch.where(torch.abs(d) > 1e-9, 1.0 / d, 1e9)
    t0 = (grid.bbox_min - o) * inv_d
    t1 = (grid.bbox_max - o) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return torch.clamp(t_near, min=0.0), t_far


def _march(grid: GridVolume, o, d, t_near, dt, steps: int):
    """Midpoint sum of the grid's density along the rays, step after step."""
    tau = torch.zeros(o.shape[0], dtype=o.dtype, device=o.device)
    for i in range(steps):
        t = t_near + (i + 0.5) * dt
        tau = tau + grid.sample(o + d * t[:, None])[..., 0] * dt
    return tau


def radiance(grid: GridVolume, emitter, o, d, cfg: GridVolumeConfig,
             generator: Optional[torch.Generator] = None):
    """Transmittance-through-grid radiance for a wavefront of rays [R, 3]."""
    del generator
    t_near, t_far = _bbox_intersect(grid, o, d)
    hit = t_far > t_near
    tau = _march(grid, o, d, t_near, (t_far - t_near) / cfg.num_steps, cfg.num_steps)
    beta = torch.exp(-cfg.sigma_scale * torch.where(hit, tau, 0.0))
    env = (emitter.eval(d) if emitter is not None
           else torch.ones(d.shape[:-1] + (3,), dtype=o.dtype, device=o.device))
    return beta[:, None] * env


def _transmittance(grid: GridVolume, o, d, cfg: GridVolumeConfig):
    """exp(-sigma_scale * integral of the grid) along the rays, marched in
    ``shadow_steps`` steps."""
    t_near, t_far = _bbox_intersect(grid, o, d)
    dt = torch.where(t_far > t_near, (t_far - t_near) / cfg.shadow_steps, 0.0)
    return torch.exp(-cfg.sigma_scale * _march(grid, o, d, t_near, dt, cfg.shadow_steps))


def radiance_scattering(grid: GridVolume, emitter, o, d, cfg: GridVolumeConfig,
                        generator: Optional[torch.Generator] = None):
    """Multiple-scattering radiance through the grid for rays o, d [R, 3],
    drawing from ``generator`` (a ``torch.Generator`` on their device,
    required)."""
    if generator is None:
        raise ValueError("radiance_scattering needs an explicit torch.Generator on the rays' device")
    r, dev, dt_ = o.shape[0], o.device, o.dtype
    majorant = cfg.sigma_scale * torch.clamp(torch.max(grid.data), min=1e-6)
    inv_maj = 1.0 / majorant
    iso_pdf = 1.0 / (4.0 * math.pi)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev, dtype=dt_)

    def free_flight(o_c, d_c, active):
        """Delta tracking from the bbox entry: (found, t)."""
        t, t_far = _bbox_intersect(grid, o_c, d_c)
        done = ~active | (t_far <= t)
        real_hit = torch.zeros(r, dtype=torch.bool, device=dev)
        for _ in range(cfg.tracking_steps):
            u1 = 1e-7 + (1.0 - 1e-7) * uniform(r)
            u2 = uniform(r)
            t_new = t - torch.log(u1) * inv_maj
            inside = t_new <= t_far
            sig = cfg.sigma_scale * grid.sample(o_c + d_c * t_new[:, None])[..., 0]
            newly = ~done & inside & (u2 < sig * inv_maj)
            t = torch.where(done, t, t_new)
            done = done | newly | ~inside
            real_hit = real_hit | newly
        # paths that exhaust the budget without a real collision escape
        return active & real_hit, t

    o_c, d_c = o, d
    beta = torch.ones((r, 3), dtype=dt_, device=dev)
    l_acc = torch.zeros((r, 3), dtype=dt_, device=dev)
    active = torch.ones(r, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(r, dtype=dt_, device=dev)
    for i in range(cfg.bounce_cap):
        found, t_s = free_flight(o_c, d_c, active)
        escaped = active & ~found

        # the environment, MIS-weighted after the first bounce
        em_pdf = emitter.pdf_direction(d_c) if i > 0 else torch.zeros(r, dtype=dt_, device=dev)
        l_acc = l_acc + torch.where(
            escaped[:, None], beta * _mis(prev_pdf, em_pdf)[:, None] * emitter.eval(d_c), 0.0)

        p_int = o_c + d_c * torch.where(found, t_s, 0.0)[:, None]
        beta = torch.where(found[:, None], beta * cfg.albedo, beta)

        # next-event estimation
        ds_dir, ds_val, ds_pdf = emitter.sample_direction(uniform(r, 2))
        tr = _transmittance(grid, p_int, ds_dir, cfg)
        lr_nee = (beta * iso_pdf * _mis(ds_pdf, torch.full_like(ds_pdf, iso_pdf))[:, None]
                  * tr[:, None] * ds_val / torch.clamp(ds_pdf, min=1e-30)[:, None])
        l_acc = l_acc + torch.where((found & (ds_pdf > 0.0))[:, None], lr_nee, 0.0)

        # isotropic phase sampling
        z = 1.0 - 2.0 * uniform(r)
        rxy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * math.pi * uniform(r)
        wo = torch.stack([rxy * torch.cos(phi), rxy * torch.sin(phi), z], dim=-1)
        o_c = torch.where(found[:, None], p_int, o_c)
        d_c = torch.where(found[:, None], wo, d_c)
        prev_pdf = torch.where(found, iso_pdf, prev_pdf)
        active = found & torch.any(beta > 0.003, dim=-1)
    return l_acc


def _mis(pdf_a, pdf_b):
    """Power heuristic."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-30)
    return torch.where(pdf_a > 0.0, w, 0.0)
