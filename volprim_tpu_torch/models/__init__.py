"""Integrators: the exact-order rf oracle, the tiled fused renderer and the
volumetric path tracer (prb), with the wavefront render loop."""

from . import base, prb, rf, rf_tiled
from .base import Film, render, render_batch
from .prb import PRBConfig

__all__ = ["Film", "PRBConfig", "base", "prb", "render", "render_batch", "rf", "rf_tiled"]
