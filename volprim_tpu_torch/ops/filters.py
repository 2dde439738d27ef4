"""Film accumulation (volprim_tpu.ops.filters): samples are splatted into
the pixel grid with scatter-adds (box or tent filter) and normalized by the
accumulated filter weight."""

from __future__ import annotations

import torch


def splat_box(values: torch.Tensor, px: torch.Tensor, py: torch.Tensor, width: int,
              height: int):
    """Accumulate samples [S, C] at continuous film coords px, py [S] into
    their containing pixel. Returns (image [H, W, C], weights [H, W])."""
    xi = torch.clamp(px.to(torch.int64), 0, width - 1)
    yi = torch.clamp(py.to(torch.int64), 0, height - 1)
    flat = yi * width + xi
    c = values.shape[-1]
    img = values.new_zeros((height * width, c)).index_add_(0, flat, values)
    wgt = values.new_zeros((height * width,)).index_add_(0, flat, torch.ones_like(px))
    return img.reshape(height, width, c), wgt.reshape(height, width)


def splat_tent(values: torch.Tensor, px: torch.Tensor, py: torch.Tensor, width: int,
               height: int):
    """Bilinear (tent, radius 1) splat of samples [S, C] onto the pixel
    centres (integer + 0.5) around film coords px, py [S]; weights outside
    the film are dropped. Returns (image [H, W, C], weights [H, W])."""
    fx, fy = px - 0.5, py - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx, ty = fx - x0, fy - y0
    c = values.shape[-1]
    img = values.new_zeros((height * width, c))
    wgt = values.new_zeros((height * width,))
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        w = (tx if dx else 1.0 - tx) * (ty if dy else 1.0 - ty)
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        flat = torch.clamp(yi, 0, height - 1) * width + torch.clamp(xi, 0, width - 1)
        w = torch.where(inside, w, 0.0).to(values.dtype)
        img.index_add_(0, flat, values * w[:, None])
        wgt.index_add_(0, flat, w)
    return img.reshape(height, width, c), wgt.reshape(height, width)


def develop(img: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Normalize splatted radiance by filter weights."""
    return img / torch.clamp(wgt[..., None], min=1e-8)
