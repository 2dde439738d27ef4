"""Small helpers (volprim_tpu.utils.misc)."""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np


def concatenate_images(images) -> np.ndarray:
    """Same-height images side by side (numpy arrays or tensors), the
    layout of the batch sensor's wide film."""
    return np.concatenate(
        [im.detach().cpu().numpy() if hasattr(im, "detach") else np.asarray(im)
         for im in images],
        axis=1,
    )


@contextmanager
def time_operation(label: str):
    """Print the host wall time of the block."""
    t0 = time.perf_counter()
    yield
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")


# the reference's name (volprim.utils.concatenate_tensors)
concatenate_tensors = concatenate_images
