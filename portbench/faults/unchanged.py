"""A fault planted in the program: an optimizer step that returns the
parameters unchanged (its moments still move). A training cell's
comparison has to catch it."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def plant():
    from volprim_tpu_torch.optim import bounded_adam

    step = bounded_adam.BoundedAdam.step

    def keep(self, params, *a, **k):
        before = {key: p.detach().clone() for key, p in params.items()}
        step(self, params, *a, **k)
        with torch.no_grad():
            for key, p in params.items():
                p.copy_(before[key])

    bounded_adam.BoundedAdam.step = keep
    try:
        yield
    finally:
        bounded_adam.BoundedAdam.step = step
