"""Timing of one run, as the example CLIs print it
(volprim_tpu.utils.benchmark.single_run).

The block's work is queued on the card asynchronously, so the timer stops
only after ``torch.cuda.synchronize()``: the time is the host's wall clock
from entering the block to the device finishing what it queued.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


@contextmanager
def single_run(label: str = "", device=None):
    """Print ``<label>: <ms> ms`` for one run of the block. ``device`` (a
    CUDA device, or None for the current one when a card is present) is
    synchronised before the clock stops; a CPU device is not."""
    dev = torch.device(device) if device is not None else None
    sync = torch.cuda.is_available() and (dev is None or dev.type == "cuda")
    t0 = time.perf_counter()
    yield
    if sync:
        torch.cuda.synchronize(dev)
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
