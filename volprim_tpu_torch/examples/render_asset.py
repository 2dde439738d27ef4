"""Render one camera of a saved asset directory.

The port's counterpart of the JAX package's ``examples/render_asset.py``,
with its flags and ``--device`` (the card unless ``--device cpu``)::

    python -m volprim_tpu_torch.examples.render_asset ASSET_DIR --spp 4 \\
        --output out.exr

A directory with an ``__init__.py`` is a reference-format Python asset
(``scene.asset_interop``); any other is a ``scene.json`` asset
(``scene.asset``). The integrator and its config come from
``models.REGISTRY`` / ``CONFIGS`` by the asset's integrator name
(``volprim_tomography`` when it names none); constant and envmap emitters
are supported. A ``volprim_prb`` asset renders only when its integrator
asks for ``walk_backend="pallas"``: the path tracer's xla walk is not
ported (ROADMAP.md §A5) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import as_device, io
from ..models import CONFIGS, REGISTRY, render
from ..ops.envmap import ConstantEmitter, EnvironmentMap
from ..scene import CameraSpecs, asset_interop, look_at
from ..utils import image
from ..utils.benchmark import single_run


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Render a saved asset",
        epilog="A volprim_prb asset needs walk_backend='pallas' in its integrator: the "
        "path tracer's xla walk is not ported (ROADMAP.md §A5) and raises.")
    ap.add_argument("asset", type=str, help="Path to the asset directory")
    ap.add_argument("--cam_index", type=int, default=0)
    ap.add_argument("--cam_scale", type=float, default=1.0)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--output", type=str, default="output.exr")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    return ap


def _config(name: str, integ: dict):
    cfg_cls = CONFIGS[name]
    return cfg_cls(**{k: v for k, v in integ.items() if k in cfg_cls.__dataclass_fields__})


def main(argv=None) -> torch.Tensor:
    args = parser().parse_args(argv)
    dev = as_device(args.device)
    if os.path.exists(os.path.join(args.asset, "__init__.py")):
        ref = asset_interop.load_reference_asset(args.asset, device=dev)
        prims = ref["primitives"]
        if prims is None:
            raise SystemExit(f"{args.asset}: no ellipsoid object found in the asset's "
                             "OBJECTS dictionary: nothing to render")
        cams = ref["cameras"] or [CameraSpecs(
            name="default", width=512, height=512,
            to_world=look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), fov=45.0)]
        camera = cams[args.cam_index].scaled(args.cam_scale)
        name = ref["integrator"] or "volprim_tomography"
        cfg = _config(name, dict(ref["raw"].get("integrator") or {}))
        emitter = ref["emitter"]
    else:
        asset = io.load_asset(args.asset, device=dev)
        prims = asset["primitives"]
        camera = asset["cameras"][args.cam_index].scaled(args.cam_scale)
        integ = dict(asset["integrator"])
        name = integ.pop("type", "volprim_tomography")
        cfg = _config(name, integ)
        emitter = None
        if asset["emitters"]:
            spec = next(iter(asset["emitters"].values()))
            if spec.get("type") == "constant":
                emitter = ConstantEmitter(radiance=torch.full(
                    (3,), float(spec.get("radiance", 1.0)), device=dev))
            elif spec.get("type") == "envmap" and spec.get("array") in asset["arrays"]:
                emitter = EnvironmentMap.from_array(asset["arrays"][spec["array"]], device=dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad(), single_run("Rendering", dev):
        img = render(prims, camera, REGISTRY[name], cfg, emitter, spp=args.spp, generator=gen)

    print(f"Writing rendered image to {args.output}")
    image.write_image(args.output, img)
    if args.output.endswith(".exr"):
        image.write_image(os.path.splitext(args.output)[0] + ".png", img)
    return img


if __name__ == "__main__":
    main()
