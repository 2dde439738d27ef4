"""Image I/O, timing and small helpers (volprim_tpu.utils)."""

from . import benchmark, image, misc, spans
from .misc import concatenate_images, time_operation

__all__ = ["benchmark", "concatenate_images", "image", "misc", "spans", "time_operation"]
