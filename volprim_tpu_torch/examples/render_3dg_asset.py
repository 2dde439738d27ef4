"""Render a 3DGS asset (a PLY and its cameras.json) with the rf integrator.

The port's counterpart of the JAX package's ``examples/render_3dg_asset.py``,
with its flags and ``--device`` (the card unless ``--device cpu``)::

    python -m volprim_tpu_torch.examples.render_3dg_asset --ply point_cloud.ply \\
        --cameras cameras.json --spp 2 --max_depth 128 [--renderer tiled]

``--renderer exact`` composites every ray in entry order (models/rf.py);
``--renderer tiled`` renders through the tiled renderer, with the fused
compositor and its compaction for the Gaussian kernel and the xla backend
for the Epanechnikov kernel (the compositor kernels are Gaussian). Writes
``output.exr`` and ``output.png`` into ``--output``.
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import as_device
from ..models import render, rf, rf_tiled
from ..ops.envmap import ConstantEmitter
from ..scene import JSONCameraSpecsIO, load_ply
from ..utils import image
from ..utils.benchmark import single_run


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Render 3DG asset")
    ap.add_argument("--ply", type=str, required=True, help="Path to PLY 3DG file")
    ap.add_argument("--cameras", type=str, required=True, help="Path to cameras.json")
    ap.add_argument("--output", type=str, default="output", help="Output folder")
    ap.add_argument("--cam_index", type=int, default=0)
    ap.add_argument("--cam_scale", type=float, default=1.0)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--max_depth", type=int, default=128)
    ap.add_argument("--rr_depth", type=int, default=128)
    ap.add_argument("--kernel", type=str, default="gaussian")
    ap.add_argument("--white_background", action="store_true")
    ap.add_argument("--renderer", choices=("exact", "tiled"), default="exact",
                    help="'exact': per-ray entry order; 'tiled': the tiled renderer")
    ap.add_argument("--cluster_sort", action="store_true",
                    help="tiled, Gaussian: per-frame intra-cluster entry-distance sort")
    ap.add_argument("--order_band", type=int, default=0,
                    help="tiled: banded per-ray entry-order correction")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    return ap


def tiled_config(camera, max_depth, kernel, cluster_sort=False, order_band=0):
    """The CLI's tiled configuration for ``camera``: tiles of the largest
    divisors <= 16 of the film, the fused compositor with compaction for
    the Gaussian kernel, the xla backend for the Epanechnikov one."""
    th = max(d for d in range(1, 17) if camera.height % d == 0)
    tw = max(d for d in range(1, 17) if camera.width % d == 0)
    fused = kernel == "gaussian"
    return rf_tiled.RFTiledConfig(
        max_depth=max_depth, kernel_type=kernel, tile_pixels=th * tw, tile_shape=(th, tw),
        max_candidates=2048, segment=256, cluster_size=16, use_clusters=True,
        early_exit=True, backend="fused" if fused else "xla", kernel_compact=fused,
        cluster_sort=fused and cluster_sort, order_band=order_band,
        coarse_group=4, coarse_factor=8, super_group=4,
    )


def main(argv=None) -> torch.Tensor:
    args = parser().parse_args(argv)
    dev = as_device(args.device)
    scene = load_ply(args.ply, device=dev)
    print(f"Loaded {scene.num_prims} primitives from {args.ply}")
    camera = JSONCameraSpecsIO.load(args.cameras)[args.cam_index].scaled(args.cam_scale)
    print(f"Camera {camera.name}: {camera.width}x{camera.height}")
    emitter = (ConstantEmitter(radiance=torch.ones(3, device=dev))
               if args.white_background else None)
    with torch.no_grad():
        if args.renderer == "tiled":
            tcfg = tiled_config(camera, args.max_depth, args.kernel, args.cluster_sort,
                                args.order_band)
            state = rf_tiled.build_state(scene, tcfg)
            with single_run("Rendering (tiled)", dev):
                img = rf_tiled.render_state(state, camera, tcfg, emitter, spp=args.spp, seed=0)
        else:
            cfg = rf.RFConfig(max_depth=args.max_depth, rr_depth=args.rr_depth,
                              kernel_type=args.kernel)
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            with single_run("Rendering", dev):
                img = render(scene, camera, rf.radiance, cfg, emitter, spp=args.spp,
                             generator=gen)
    os.makedirs(args.output, exist_ok=True)
    out = os.path.join(args.output, "output.exr")
    print(f"Writing rendered image to {out}")
    image.write_image(out, img)
    image.write_image(os.path.join(args.output, "output.png"), img)
    return img


if __name__ == "__main__":
    main()
