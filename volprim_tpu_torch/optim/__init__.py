"""Optimizers and losses (volprim_tpu.optim)."""

from .bounded_adam import BoundedAdam, KeyState, load_state, save_state
from .losses import l1, l2, psnr

__all__ = ["BoundedAdam", "KeyState", "l1", "l2", "load_state", "psnr", "save_state"]
