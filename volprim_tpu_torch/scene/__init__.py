"""Scene representation: primitives, cameras, synthetic scenes."""

from . import cameras, ellipsoids, synthetic
from .cameras import CameraSpecs, fov2focal, generate_rays, look_at, rays_from_pixels
from .ellipsoids import EllipsoidScene

__all__ = [
    "CameraSpecs", "EllipsoidScene", "cameras", "ellipsoids", "fov2focal",
    "generate_rays", "look_at", "rays_from_pixels", "synthetic",
]
