"""A fault planted in the program: a path-traced frame altered where it is
produced, the 16 x 16 pixels at its center set to 0. The path-traced
cell's comparison has to catch it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def plant():
    from volprim_tpu_torch import models

    render = models.render

    def altered(*a, **k):
        img = render(*a, **k).clone()
        h, w = img.shape[0] // 2, img.shape[1] // 2
        img[h - 8:h + 8, w - 8:w + 8] = 0.0
        return img

    models.render = altered
    try:
        yield
    finally:
        models.render = render
