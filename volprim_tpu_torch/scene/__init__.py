"""Scene representation: primitives, cameras, synthetic scenes, PLY and
asset I/O."""

from . import asset, cameras, ellipsoids, ply, synthetic
from .asset import load_asset, save_asset
from .cameras import (
    CameraSpecs, JSONCameraSpecsIO, KRTCameraSpecsIO, fov2focal, generate_rays, look_at,
    rays_from_pixels,
)
from .ellipsoids import EllipsoidScene
from .ply import load_ply, save_ply

__all__ = [
    "CameraSpecs", "EllipsoidScene", "JSONCameraSpecsIO", "KRTCameraSpecsIO", "asset",
    "cameras", "ellipsoids", "fov2focal", "generate_rays", "load_asset", "load_ply", "look_at",
    "ply", "rays_from_pixels", "save_asset", "save_ply", "synthetic",
]
