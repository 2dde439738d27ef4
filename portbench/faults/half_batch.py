"""A fault planted in the program: the loss over half of the batch, the L1
mean over the first half of the cameras' columns, the rest left out. A
training cell's comparison has to catch it."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def plant():
    from volprim_tpu_torch import train
    from volprim_tpu_torch.examples import optimize_volume

    saved = train.l1, optimize_volume.l1

    def half(ref, img):
        w = img.shape[1] // 2
        return torch.mean(torch.abs(ref[:, :w] - img[:, :w]))

    train.l1 = optimize_volume.l1 = half
    try:
        yield
    finally:
        train.l1, optimize_volume.l1 = saved
