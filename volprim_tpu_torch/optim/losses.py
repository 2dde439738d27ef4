"""Loss functions (volprim_tpu.optim.losses)."""

import math

import torch


def l1(reference: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return torch.mean(torch.abs(reference - image))


def l2(reference: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return torch.mean((reference - image) ** 2)


def psnr(reference: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, peak = 1: -10 log10(l2)."""
    return -10.0 * torch.log(l2(reference, image)) / math.log(10.0)
