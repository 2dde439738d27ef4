"""Refine a 3DGS asset against multi-view images.

The port's counterpart of the JAX package's
``examples/refine_3dg_dataset.py``, with its flags and ``--device`` (the
card unless ``--device cpu``)::

    python -m volprim_tpu_torch.examples.refine_3dg_dataset --ply X.ply \\
        --cameras cameras.json --images refs/ --output out/ --renderer tiled

It takes ``--cam_count`` evenly strided cameras scaled by ``--cam_scale``,
renders them side by side (the batch sensor's [H, N W, 3] film) and
optimizes opacities, SH coefficients and centers with BoundedAdam (the
opacities bounded to [1e-6, 1 - 1e-6]) on the L1 loss against the
reference: ``--images`` holds one ``<camera name>.npy`` per camera, else
(``--selfref``) the initial model rendered at ``--ref_spp``.
``--renderer tiled`` trains through the tiled renderer (the fused
compositor's forward and backward kernels for the Gaussian kernel, the xla
backend for the Epanechnikov kernel), ``exact`` through the exact-order
integrator. Prints one line per step and writes the refined asset to
``<output>/refined_asset``; ``main`` returns the losses, PSNRs and seconds
of the steps and of the final exact render at ``--ref_spp``, and on the card
the peak of allocated memory read after the steps, before that render.
"""

from __future__ import annotations

import argparse
import os
import time
from os.path import join

import numpy as np
import torch

from .. import as_device, train
from ..models import render_batch, rf, rf_tiled
from ..optim import l1, psnr
from ..scene import JSONCameraSpecsIO, load_ply, save_asset
from ..utils import concatenate_images, image


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Refine 3DG dataset")
    ap.add_argument("--ply", type=str, required=True)
    ap.add_argument("--cameras", type=str, required=True)
    ap.add_argument("--images", type=str, default=None, help="photo dir (.npy per view)")
    ap.add_argument("--selfref", action="store_true")
    ap.add_argument("--output", type=str, required=True)
    ap.add_argument("--cam_count", type=int, default=8)
    ap.add_argument("--cam_scale", type=float, default=0.125)
    ap.add_argument("--ref_spp", type=int, default=32)
    ap.add_argument("--opt_spp", type=int, default=1)
    ap.add_argument("--max_depth", type=int, default=128)
    ap.add_argument("--kernel", type=str, default="epanechnikov")
    ap.add_argument("--iterations", type=int, default=64)
    ap.add_argument("--opacities_lr", type=float, default=0.05)
    ap.add_argument("--sh_lr", type=float, default=0.01)
    ap.add_argument("--centers_lr", type=float, default=0.0)
    ap.add_argument("--global_lr", type=float, default=1.0)
    ap.add_argument("--write_image_every", type=int, default=8)
    ap.add_argument("--renderer", choices=("exact", "tiled"), default="exact",
                    help="'tiled' trains through the tiled renderer")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    return ap


def select_cameras(all_cams, cam_count, cam_scale):
    """``cam_count`` evenly strided cameras, scaled by ``cam_scale``."""
    stride = max(1, len(all_cams) // cam_count)
    return [c.scaled(cam_scale) for c in all_cams[::stride][:cam_count]]


def tiled_config(camera, max_depth, kernel):
    """The refine CLI's tiled configuration: the fused compositor (early
    exit) for the Gaussian kernel, the xla backend for the Epanechnikov one."""
    th = max(d for d in range(1, 17) if camera.height % d == 0)
    tw = max(d for d in range(1, 17) if camera.width % d == 0)
    fused = kernel == "gaussian"
    return rf_tiled.RFTiledConfig(
        max_depth=max_depth, kernel_type=kernel, tile_pixels=th * tw, tile_shape=(th, tw),
        max_candidates=2048, segment=256, cluster_size=16,
        backend="fused" if fused else "xla", early_exit=fused,
        coarse_group=4, coarse_factor=8, super_group=4,
    )


def _batch(scene, cameras, cfg, spp, seed):
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(seed)
    return render_batch(scene, cameras, rf.radiance, cfg, None, spp=spp, generator=gen)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = as_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    prims = load_ply(args.ply, device=dev)
    print(f"Loaded {prims.num_prims} primitives")
    cameras = select_cameras(JSONCameraSpecsIO.load(args.cameras), args.cam_count,
                             args.cam_scale)
    print(f"Using {len(cameras)} cameras at {cameras[0].width}x{cameras[0].height}")
    cfg = rf.RFConfig(max_depth=args.max_depth, kernel_type=args.kernel)

    if args.images:
        refs = [np.load(join(args.images, f"{c.name}.npy")) for c in cameras]
        ref_image = torch.from_numpy(concatenate_images(refs).astype(np.float32)).to(dev)
    else:
        if not args.selfref:
            print("No --images given; falling back to --selfref mode")
        with torch.no_grad():
            ref_image = _batch(prims, cameras, cfg, args.ref_spp, 999)
    image.write_image(join(args.output, "reference.png"), ref_image)

    opt = train.make_optimizer(args.opacities_lr, args.sh_lr, args.centers_lr, args.global_lr)
    params = {
        "opacities": prims.attrs["opacities"].clone().requires_grad_(True),
        "sh_coeffs": prims.attrs["sh_coeffs"].clone().requires_grad_(True),
        "centers": prims.centers.clone().requires_grad_(True),
    }
    if args.renderer == "tiled":
        tcfg = tiled_config(cameras[0], args.max_depth, args.kernel)

        def render_train(scene, seed):
            return train.render_cameras(scene, cameras, tcfg, spp=args.opt_spp, seed=seed)
    else:

        def render_train(scene, seed):
            return _batch(scene, cameras, cfg, args.opt_spp, seed)

    print("Run optimization:")
    losses, psnrs, step_seconds = [], [], []
    for it in range(args.iterations):
        t0 = time.perf_counter()
        for p in params.values():
            p.grad = None
        img = render_train(train.to_scene(params, prims), it)
        loss = l1(ref_image, img)
        loss.backward()
        img = img.detach()
        opt.step(params)
        losses.append(float(loss.detach()))
        psnrs.append(float(psnr(ref_image, img)))
        step_seconds.append(time.perf_counter() - t0)  # the reads above wait for the step
        if (it + 1) % args.write_image_every == 0:
            image.write_image(join(args.output, f"frame_{it:04d}.png"), img)
        print(f"-- step {it + 1}/{args.iterations} | psnr={psnrs[-1]:.4f} "
              f"| loss={losses[-1]:.6f}", flush=True)
    print("Done")
    train_peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    result = train.to_scene({k: v.detach() for k, v in params.items()}, prims)
    save_asset(join(args.output, "refined_asset"), result, cameras,
               integrator={"type": "volprim_rf", "max_depth": args.max_depth,
                           "kernel_type": args.kernel})
    t0 = time.perf_counter()
    with torch.no_grad():
        final = _batch(result, cameras, cfg, args.ref_spp, 1000)
    final_psnr = float(psnr(ref_image, final))
    final_seconds = time.perf_counter() - t0
    image.write_image(join(args.output, "refined.png"), final)
    print(f"PSNR: {final_psnr:.4f}")
    return dict(losses=losses, psnrs=psnrs, final_psnr=final_psnr, step_seconds=step_seconds,
                final_seconds=final_seconds, train_peak_bytes=train_peak_bytes)


if __name__ == "__main__":
    main()
