"""Film accumulation (volprim_tpu.ops.filters): samples are splatted into
the pixel grid with scatter-adds and normalized by the accumulated filter
weight. Only the box filter is ported; the tent filter raises in
``models.base.render`` (ROADMAP.md §A5)."""

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


def develop(img: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Normalize splatted radiance by filter weights."""
    return img / torch.clamp(wgt[..., None], min=1e-8)
