"""Hand-written CUDA kernels (sources in ../csrc), each with its plain
PyTorch version and a launch counter on its wrapper."""

from . import composite, composite2, composite3, composite_vjp, ffwalk

__all__ = ["composite", "composite2", "composite3", "composite_vjp", "ffwalk"]
