"""Render a volumetric-primitive medium with the path tracer (PRB, NEE)
under an environment map.

The port's counterpart of the JAX package's ``examples/render_volume.py``,
with its flags and ``--device`` (the card unless ``--device cpu``)::

    python -m volprim_tpu_torch.examples.render_volume --output smoke.exr \\
        [--volume medium.ply] [--envmap sky.exr] [--walk_backend xla|pallas] \\
        [--auto_budget] [--spp 64] [--width 512 --height 512]

``--volume`` reads a PLY of primitives with ``sigma_t`` and ``albedo``
attributes, whose sigma_t is multiplied by ``--sigmat_scale`` (default
10, the JAX CLI's). Without it the CLI renders the ``make_medium(4096,
seed=0)`` plume (``scene.synthetic``), whose densities are already at
scale (``--sigmat_scale`` defaults to 1 there). ``--envmap`` takes an EXR
or a ``.npy`` [H, W, 3] array; the default is ``procedural_sky()``. The
camera is the reference scene's (fov 40, looking along +x). The render
is timed (``utils.benchmark.single_run``) and written as EXR (or PNG) and,
for an EXR, a PNG beside it. The render's generator is seeded with 0, and
the path tracer's per-ray random streams make the image the same whatever
``ray_chunk`` is.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import as_device
from ..models import prb, render
from ..ops.envmap import EnvironmentMap, procedural_sky
from ..scene import generate_rays, load_ply, synthetic
from ..utils import image
from ..utils.benchmark import single_run


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Render volume")
    ap.add_argument("--output", type=str, default="smoke.exr")
    ap.add_argument("--volume", type=str, default=None,
                    help="PLY of primitives (default: the make_medium(4096, seed=0) plume)")
    ap.add_argument("--envmap", type=str, default=None, help="EXR/npy envmap")
    ap.add_argument("--sigmat_scale", type=float, default=None,
                    help="sigma_t multiplier (default 10 for --volume, 1 for the plume)")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max_depth", type=int, default=-1)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument(
        "--auto_budget", action="store_true",
        help="size collect_budget/max_windows from the measured per-ray interval need "
        "(prb.suggest_budgets) instead of the defaults")
    ap.add_argument(
        "--walk_backend", type=str, default="xla", choices=["xla", "pallas"],
        help="free-flight window walk: 'pallas' runs the fused walk kernel "
        "(csrc/ffwalk.cu on the card)")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: the card)")
    return ap


def main(argv=None) -> torch.Tensor:
    args = parser().parse_args(argv)
    dev = as_device(args.device)
    if args.volume:
        scene = load_ply(args.volume, device=dev)
        scale = 10.0 if args.sigmat_scale is None else args.sigmat_scale
    else:
        scene = synthetic.make_medium(4096, seed=0, device=dev)
        scale = 1.0 if args.sigmat_scale is None else args.sigmat_scale
    scene.attrs["sigma_t"] = scene.attrs["sigma_t"] * scale
    print(f"Loaded {scene.num_prims} primitives")

    if args.envmap:
        if args.envmap.endswith(".exr"):
            data = image.read_exr(args.envmap)
        else:
            data = np.load(args.envmap)
        emitter = EnvironmentMap.from_array(data, device=dev)
    else:
        emitter = procedural_sky(device=dev)

    camera = synthetic.medium_camera(args.width, args.height)
    cfg = prb.PRBConfig(max_depth=args.max_depth, walk_backend=args.walk_backend)
    if args.auto_budget:
        o_c, d_c = generate_rays(camera, jitter=False, device=dev)
        cfg = prb.suggest_budgets(scene, o_c, d_c, cfg)
        print(f"auto budgets: collect_budget={cfg.collect_budget} "
              f"max_windows={cfg.max_windows} (p99.9 of measured per-ray need)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad(), single_run("Rendering", dev):
        img = render(scene, camera, prb.radiance, cfg, emitter, spp=args.spp, generator=gen)

    print(f"Writing rendered image to {args.output}")
    image.write_image(args.output, img)
    if args.output.endswith(".exr"):
        image.write_image(os.path.splitext(args.output)[0] + ".png", img)
    return img


if __name__ == "__main__":
    main()
