"""Environment emitters: constant and equirectangular env-map
(volprim_tpu.ops.envmap).

Bilinear radiance lookup, importance sampling from a row (marginal) and a
per-row (conditional) CDF table, and the solid-angle pdf, as the path
tracer's NEE and MIS use them. Sampling takes its uniforms as a tensor, so
that tests can feed both packages the same numbers. Tensors live on the
device the emitter was built on.

Direction convention (Mitsuba, Y up):
    u = atan2(d.x, -d.z) / (2 pi)  (wrapped to [0, 1)),  v = acos(d.y) / pi.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np
import torch


@dataclasses.dataclass
class ConstantEmitter:
    """Uniform radiance over the sphere."""

    radiance: torch.Tensor  # [3]

    def eval(self, d: torch.Tensor) -> torch.Tensor:
        return self.radiance.expand(d.shape[:-1] + (3,))

    def sample_direction(self, sample2: torch.Tensor):
        """Uniform sphere sampling. Returns (directions, radiance, pdf)."""
        z = 1.0 - 2.0 * sample2[..., 0]
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * math.pi * sample2[..., 1]
        d = torch.stack([r * torch.cos(phi), z, -r * torch.sin(phi)], dim=-1)
        pdf = torch.full(sample2.shape[:-1], 1.0 / (4.0 * math.pi), device=sample2.device)
        return d, self.eval(d), pdf

    def pdf_direction(self, d: torch.Tensor) -> torch.Tensor:
        return torch.full(d.shape[:-1], 1.0 / (4.0 * math.pi), device=d.device)


def _dir_to_uv(d: torch.Tensor):
    u = torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * math.pi)
    u = torch.where(u < 0.0, u + 1.0, u)
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def _uv_to_dir(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    theta = v * math.pi
    phi = u * 2.0 * math.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)], dim=-1)


@dataclasses.dataclass
class EnvironmentMap:
    """Equirectangular environment map with CDF-table importance sampling."""

    data: torch.Tensor  # [H, W, 3]
    row_cdf: torch.Tensor  # [H] inclusive marginal CDF over rows
    cond_cdf: torch.Tensor  # [H, W] inclusive conditional CDF per row
    lum: torch.Tensor  # [H, W] sin-weighted luminance (sampling density)
    lum_integral: torch.Tensor  # [] total of lum

    @staticmethod
    def from_array(data, device=None) -> "EnvironmentMap":
        """The map of an [H, W, 3] array, on ``device`` (the card unless the
        caller asks for the CPU)."""
        from .. import as_device

        data = torch.as_tensor(np.asarray(data, np.float32)).to(as_device(device))
        h = data.shape[0]
        lum = torch.mean(data, dim=-1)
        theta = (torch.arange(h, dtype=torch.float32, device=data.device) + 0.5) / h * math.pi
        lum = torch.clamp(lum * torch.sin(theta)[:, None], min=1e-12)
        cond = torch.cumsum(lum, dim=1)
        row_cdf = torch.cumsum(cond[:, -1], dim=0)
        return EnvironmentMap(
            data=data, row_cdf=row_cdf / row_cdf[-1], cond_cdf=cond / cond[:, -1:],
            lum=lum, lum_integral=row_cdf[-1],
        )

    def eval(self, d: torch.Tensor) -> torch.Tensor:
        """Bilinear radiance lookup for unit directions [..., 3]."""
        h, w = self.data.shape[0], self.data.shape[1]
        u, v = _dir_to_uv(d)
        fx = u * w - 0.5
        fy = v * h - 0.5
        x0 = torch.floor(fx).to(torch.int64)
        y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, h - 1)
        tx = (fx - x0)[..., None]
        ty = torch.clamp(fy - y0, 0.0, 1.0)[..., None]
        x0w = torch.remainder(x0, w)
        x1w = torch.remainder(x0 + 1, w)  # wrap in azimuth
        y1 = torch.clamp(y0 + 1, max=h - 1)
        c00 = self.data[y0, x0w]
        c10 = self.data[y0, x1w]
        c01 = self.data[y1, x0w]
        c11 = self.data[y1, x1w]
        return (
            c00 * (1 - tx) * (1 - ty)
            + c10 * tx * (1 - ty)
            + c01 * (1 - tx) * ty
            + c11 * tx * ty
        )

    def _pdf_uv(self, y, x, v):
        """Solid-angle pdf of the texel (y, x) at polar coordinate v."""
        h, w = self.lum.shape
        pmf = self.lum[y, x] / self.lum_integral
        sin_theta = torch.clamp(torch.sin(v * math.pi), min=1e-6)
        # texel solid angle = (2 pi / w) * (pi / h) * sin(theta)
        return pmf * (h * w) / (2.0 * math.pi * math.pi * sin_theta)

    def sample_direction(self, sample2: torch.Tensor):
        """Importance-sample directions proportional to sin-weighted
        luminance. sample2 [R, 2] -> (directions, radiance, pdf). The CDF
        remainders become the offsets inside the texel, so directions are
        not quantised to texel centers."""
        h, w = self.lum.shape
        s0, s1 = sample2[..., 0].contiguous(), sample2[..., 1].contiguous()
        y = torch.clamp(torch.searchsorted(self.row_cdf, s0), 0, h - 1)
        cond = self.cond_cdf[y]  # [R, W]
        x = torch.searchsorted(cond, s1[:, None])[:, 0]
        x = torch.clamp(x, 0, w - 1)
        row_prev = torch.where(y > 0, self.row_cdf[torch.clamp(y - 1, min=0)], 0.0)
        row_pmf = torch.clamp(self.row_cdf[y] - row_prev, min=1e-12)
        rem_y = torch.clamp((s0 - row_prev) / row_pmf, 0.0, 1.0 - 1e-6)
        cond_cdf_x = torch.gather(cond, 1, x[:, None])[:, 0]
        cond_prev = torch.where(
            x > 0, torch.gather(cond, 1, torch.clamp(x - 1, min=0)[:, None])[:, 0], 0.0
        )
        cond_pmf = torch.clamp(cond_cdf_x - cond_prev, min=1e-12)
        rem_x = torch.clamp((s1 - cond_prev) / cond_pmf, 0.0, 1.0 - 1e-6)
        u = (x + rem_x) / w
        v = (y + rem_y) / h
        d = _uv_to_dir(u, v)
        return d, self.eval(d), self._pdf_uv(y, x, v)

    def pdf_direction(self, d: torch.Tensor) -> torch.Tensor:
        h, w = self.lum.shape
        u, v = _dir_to_uv(d)
        x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
        y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
        return self._pdf_uv(y, x, v)


Emitter = Union[ConstantEmitter, EnvironmentMap]


def procedural_sky(h: int = 128, w: int = 256, device=None) -> EnvironmentMap:
    """The JAX package's procedural dusk sky (a horizon gradient plus a
    bright sun disk), built with numpy, on ``device``."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    horizon = np.exp(-(((t - np.pi / 2) / 0.35) ** 2))
    sky = np.clip(np.cos(t), 0.0, 1.0)
    sun_dir = np.array([np.sin(1.4) * np.sin(1.0), np.cos(1.4), -np.sin(1.4) * np.cos(1.0)])
    d = np.stack([np.sin(t) * np.sin(p), np.cos(t), -np.sin(t) * np.cos(p)], axis=-1)
    cos_sun = np.clip(d @ sun_dir, 0.0, 1.0)
    sun = np.power(cos_sun, 2000.0) * 500.0
    img = np.stack(
        [
            0.25 * sky + 0.9 * horizon + sun,
            0.3 * sky + 0.45 * horizon + 0.9 * sun,
            0.5 * sky + 0.25 * horizon + 0.7 * sun,
        ],
        axis=-1,
    ).astype(np.float32)
    return EnvironmentMap.from_array(img, device=device)
