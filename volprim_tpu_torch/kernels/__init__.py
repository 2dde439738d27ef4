"""Hand-written CUDA kernels (sources in ../csrc), each with its plain
PyTorch version and a launch counter on its wrapper."""

from . import composite3, ffwalk

__all__ = ["composite3", "ffwalk"]
