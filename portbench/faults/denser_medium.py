"""A fault planted in the program: the path tracer's medium 1% denser, its
sigma_t times 1.01. The path-traced cell's comparison has to catch it."""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def plant():
    from volprim_tpu_torch.models import prb

    radiance = prb.radiance

    def denser(primitives, *a, **k):
        attrs = dict(primitives.attrs, sigma_t=primitives.attrs["sigma_t"] * 1.01)
        return radiance(dataclasses.replace(primitives, attrs=attrs), *a, **k)

    prb.radiance = denser
    try:
        yield
    finally:
        prb.radiance = radiance
