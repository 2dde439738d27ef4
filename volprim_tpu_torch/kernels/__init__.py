"""Hand-written CUDA kernels (sources in ../csrc), each with its plain
PyTorch version and a launch counter on its wrapper."""

from . import clone, composite, composite2, composite3, composite_vjp, ffwalk

__all__ = ["clone", "composite", "composite2", "composite3", "composite_vjp", "ffwalk"]
