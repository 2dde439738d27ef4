"""Acceleration: Morton clusters and ray-tile cone culling."""

from . import clusters, tiles

__all__ = ["clusters", "tiles"]
