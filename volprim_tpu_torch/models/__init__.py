"""Integrators: the exact-order rf oracle and the tiled fused renderer."""

from . import base, rf, rf_tiled

__all__ = ["base", "rf", "rf_tiled"]
