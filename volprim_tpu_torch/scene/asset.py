"""Scene assets (volprim_tpu.scene.asset), the ``volprim_tpu_asset_v1``
format: a directory holding

    scene.json        integrator and emitter configs, camera specs
    primitives.ply    the ellipsoids as a 3DGS-convention PLY
    <name>.npy        extra array payloads

Optimizer state is not saved (optim.save_state does that).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from . import ply as ply_io
from .cameras import CameraSpecs
from .ellipsoids import EllipsoidScene

FORMAT = "volprim_tpu_asset_v1"


def save_asset(
    folder: str,
    primitives: EllipsoidScene,
    cameras: Optional[List[CameraSpecs]] = None,
    integrator: Optional[Dict[str, Any]] = None,
    emitters: Optional[Dict[str, Any]] = None,
    arrays: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    os.makedirs(folder, exist_ok=True)
    ply_io.save_ply(primitives, os.path.join(folder, "primitives.ply"))
    meta: Dict[str, Any] = {
        "format": FORMAT,
        "extent": float(primitives.extent),
        "integrator": integrator or {},
        "emitters": emitters or {},
        "sensors": [c.to_dict() for c in (cameras or [])],
        "arrays": [],
    }
    for name, arr in (arrays or {}).items():
        np.save(os.path.join(folder, f"{name}.npy"), np.asarray(arr))
        meta["arrays"].append(name)
    with open(os.path.join(folder, "scene.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_asset(folder: str, device=None) -> Dict[str, Any]:
    """The asset in ``folder``: primitives (on ``device``, the card unless
    the caller asks for the CPU), cameras, integrator, emitters, arrays."""
    with open(os.path.join(folder, "scene.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{folder}: unknown asset format {meta.get('format')!r}")
    primitives = ply_io.load_ply(os.path.join(folder, "primitives.ply"),
                                 extent=meta.get("extent", 3.0), device=device)
    return {
        "primitives": primitives,
        "cameras": [CameraSpecs.from_dict(d) for d in meta.get("sensors", [])],
        "integrator": meta.get("integrator", {}),
        "emitters": meta.get("emitters", {}),
        "arrays": {name: np.load(os.path.join(folder, f"{name}.npy"))
                   for name in meta.get("arrays", [])},
    }
