"""Scene representation: primitives, cameras, synthetic scenes, grid
volumes, PLY and asset I/O (and the reference toolchain's Python assets)."""

from . import asset, asset_interop, cameras, ellipsoids, ply, synthetic, vol
from .asset import load_asset, save_asset
from .cameras import (
    CameraSpecs, JSONCameraSpecsIO, KRTCameraSpecsIO, fov2focal, generate_rays, look_at,
    rays_from_pixels,
)
from .ellipsoids import EllipsoidScene, EllipsoidsFactory, lattice_init
from .ply import load_ply, save_ply
from .vol import GridVolume, load_vol, procedural_smoke, save_vol

__all__ = [
    "CameraSpecs", "EllipsoidScene", "EllipsoidsFactory", "GridVolume", "JSONCameraSpecsIO",
    "KRTCameraSpecsIO", "asset", "asset_interop", "cameras", "ellipsoids", "fov2focal",
    "generate_rays", "lattice_init", "load_asset", "load_ply", "load_vol", "look_at", "ply",
    "procedural_smoke", "rays_from_pixels", "save_asset", "save_ply", "save_vol", "synthetic",
    "vol",
]
