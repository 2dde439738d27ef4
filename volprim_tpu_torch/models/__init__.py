"""Integrators and the wavefront render loop.

``REGISTRY`` maps the reference's integrator names to radiance functions
``radiance(primitives, emitter, o, d, cfg, generator) -> [R, 3]`` and
``CONFIGS`` to their config classes, as the JAX package's do:

- ``volprim_tomography``: absorption only (models/tomography.py);
- ``volprim_rf``: the exact-order radiance-field oracle (models/rf.py);
- ``volprim_prb``: the volumetric path tracer (models/prb.py). Its config
  defaults to ``walk_backend="xla"``, which is not ported and raises,
  naming ROADMAP.md §A5: an asset must ask for ``walk_backend="pallas"``.

The tiled renderer (rf_tiled) and the grid-volume renderers (gridvol) are
not registered, as in the JAX package.
"""

REGISTRY = {}


def register_integrator(name):
    def deco(fn):
        REGISTRY[name] = fn
        return fn

    return deco


from . import base, gridvol, prb, rf, rf_tiled, tomography  # noqa: E402
from .base import Film, render, render_batch, render_with_spp_grad  # noqa: E402
from .prb import PRBConfig  # noqa: E402
from .rf import RFConfig  # noqa: E402
from .tomography import TomographyConfig  # noqa: E402

CONFIGS = {
    "volprim_tomography": TomographyConfig,
    "volprim_rf": RFConfig,
    "volprim_prb": PRBConfig,
}

__all__ = [
    "CONFIGS", "Film", "PRBConfig", "REGISTRY", "RFConfig", "TomographyConfig", "base",
    "gridvol", "prb", "register_integrator", "render", "render_batch", "render_with_spp_grad",
    "rf", "rf_tiled", "tomography",
]
