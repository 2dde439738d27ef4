"""Tomographic reconstruction of a grid volume with volumetric primitives.

The port's counterpart of the JAX package's ``examples/optimize_volume.py``,
with its flags and ``--device`` (the card unless ``--device cpu``)::

    python -m volprim_tpu_torch.examples.optimize_volume --output out/ \\
        [--cam_count 8 --cam_res 256 --volprim_count 16 --iterations 64]

A ring of ``--cam_count`` cameras with randomised elevations (numpy's
legacy generator seeded 0, the JAX script's draws) looks at a grid volume
(``--volume_grid`` a ``.vol`` file, else ``procedural_smoke()``) under a
constant white emitter. Reference images come from the multiple-scattering
path tracer (``--ref_mode scattering``) or the absorption marcher
(``absorption``), clipped to [0, 1]. A ``--volprim_count``^3 lattice of
Gaussians is fitted to them through the tomography integrator on the batch
sensor, with BoundedAdam (per-key rates and bounds) on the L1 loss;
``--grad_spp`` renders the adjoint with its own sample count
(``models.render_with_spp_grad``). Then primitives with sigma_t <= 1e-6 or
a scale <= 1e-4 are pruned and the result is saved as an asset whose
integrator is ``volprim_tomography``.

Writes into ``--output``: reference / initial / optimized images, frames,
``optimized_asset/``, ``curves.json`` (the loss and PSNR per step) and,
where matplotlib imports, ``loss.png`` and ``psnr.png``.
"""

from __future__ import annotations

import argparse
import json
import os
from os.path import join

import numpy as np
import torch

from .. import as_device
from ..models import gridvol, render_batch, render_with_spp_grad, tomography
from ..ops.envmap import ConstantEmitter
from ..optim import BoundedAdam, l1, psnr
from ..scene import CameraSpecs, EllipsoidScene, lattice_init, load_vol, procedural_smoke, save_asset
from ..scene.cameras import look_at, rotate_x, rotate_y
from ..utils import image
from ..utils.spans import span, spanned


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Optimize volumetric primitives from 3D grid")
    ap.add_argument("--output", type=str, required=True)
    ap.add_argument("--volume_grid", type=str, default=None, help=".vol file")
    ap.add_argument("--cam_count", type=int, default=8)
    ap.add_argument("--cam_res", type=int, default=256)
    ap.add_argument("--ref_spp", type=int, default=32)
    ap.add_argument("--ref_mode", type=str, default="scattering",
                    choices=["scattering", "absorption"],
                    help="ground truth: the multiple-scattering path tracer or the "
                    "absorption-only marcher")
    ap.add_argument("--ref_albedo", type=float, default=0.6,
                    help="medium albedo of the scattering reference")
    ap.add_argument("--opt_spp", type=int, default=1)
    ap.add_argument("--grad_spp", type=int, default=0, help="adjoint spp; 0 = opt_spp")
    ap.add_argument("--max_depth", type=int, default=-1)
    ap.add_argument("--kernel", type=str, default="gaussian")
    ap.add_argument("--iterations", type=int, default=64)
    ap.add_argument("--volprim_count", type=int, default=16)
    ap.add_argument("--init_albedo", type=float, default=0.9)
    ap.add_argument("--init_sigmat", type=float, default=0.0001)
    ap.add_argument("--no_prune", action="store_true")
    ap.add_argument("--write_image_every", type=int, default=4)
    ap.add_argument("--global_lr", type=float, default=1.0)
    ap.add_argument("--centers_lr", type=float, default=0.015)
    ap.add_argument("--scales_lr", type=float, default=0.0001)
    ap.add_argument("--quats_lr", type=float, default=0.0001)
    ap.add_argument("--sigmat_lr", type=float, default=0.0001)
    ap.add_argument("--albedo_lr", type=float, default=0.0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    return ap


def ring_cameras(cam_count: int, cam_res: int):
    """``cam_count`` cameras on a half ring at distance 4, each raised by a
    random elevation in [-45, 45) degrees, fov 40."""
    rng = np.random.RandomState(0)  # the draws of np.random.seed(0)
    cameras = []
    for i in range(cam_count):
        angle = 180.0 / cam_count * i - 90.0
        to_world = (rotate_y(angle) @ rotate_x(90.0 * rng.rand() - 45.0)
                    @ look_at(origin=[0, 0, 4], target=[0, 0, 0], up=[0, 1, 0]))
        cameras.append(CameraSpecs(name=f"cam_{i:04d}", width=cam_res, height=cam_res,
                                   to_world=to_world, fov=40.0))
    return cameras


def reference_image(grid, cameras, args, emitter, dev) -> torch.Tensor:
    """The grid rendered in ``args.ref_mode`` at ``args.ref_spp``, clipped
    to [0, 1]: [H, N W, 3]."""
    gcfg = gridvol.GridVolumeConfig(sigma_scale=5.0, albedo=args.ref_albedo)
    ref_fn = gridvol.radiance_scattering if args.ref_mode == "scattering" else gridvol.radiance
    with torch.no_grad():
        img = render_batch(gridvol.transform_grid(grid, gcfg), cameras, ref_fn, gcfg, emitter,
                           spp=args.ref_spp, generator=_generator(dev, 0))
    return torch.clamp(img, 0.0, 1.0)


def make_optimizer(args) -> BoundedAdam:
    """BoundedAdam with the per-key rates and bounds of the fit."""
    opt = BoundedAdam()
    opt.set_learning_rate({
        "centers": args.global_lr * args.centers_lr,
        "scales": args.global_lr * args.scales_lr,
        "quats": args.global_lr * args.quats_lr,
        "sigmat": args.global_lr * args.sigmat_lr,
        "albedo": args.global_lr * args.albedo_lr,
    })
    opt.set_bounds("scales", lower=1e-6)
    opt.set_bounds("sigmat", lower=1e-8, upper=1e-3)
    opt.set_bounds("albedo", lower=1e-8, upper=1.0)
    return opt


def volume_params(prims: EllipsoidScene) -> dict:
    """The fitted parameters as leaf tensors that require grad."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in (
        ("centers", prims.centers), ("scales", prims.scales), ("quats", prims.quats),
        ("sigmat", prims.attrs["sigma_t"]), ("albedo", prims.attrs["albedo"]))}


def to_scene(p: dict, extent: float) -> EllipsoidScene:
    return EllipsoidScene(centers=p["centers"], scales=p["scales"], quats=p["quats"],
                          attrs={"sigma_t": p["sigmat"], "albedo": p["albedo"]}, extent=extent)


def _generator(dev, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


@spanned("optimize_volume.step")
def train_step(params, opt, cameras, cfg, emitter, ref_image, args, seed: int, extent: float):
    """One step: render (with ``args.grad_spp`` adjoint samples where they
    differ from ``args.opt_spp``), L1 against the reference, backward,
    BoundedAdam. Returns (loss, psnr, image) of the step's render."""
    for p in params.values():
        p.grad = None
    scene = to_scene(params, extent)
    if args.grad_spp and args.grad_spp != args.opt_spp:
        img = render_with_spp_grad(cameras, tomography.radiance, cfg, emitter,
                                   spp=args.opt_spp, spp_grad=args.grad_spp, seed=seed)(scene)
    else:
        dev = params["centers"].device
        img = render_batch(scene, cameras, tomography.radiance, cfg, emitter,
                           spp=args.opt_spp, generator=_generator(dev, seed))
    loss = l1(ref_image, img)
    with span("autograd.backward"):
        loss.backward()
    img = img.detach()
    opt.step(params)
    return float(loss.detach()), float(psnr(ref_image, img)), img


def _plots(out_dir: str, curves: dict) -> None:
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: the curves are in curves.json only")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for key, label in (("loss", "Loss"), ("psnr", "PSNR")):
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.plot(curves[key])
        ax.set_xlabel("Iteration")
        plt.ylabel(label)
        plt.title(label + " plot")
        plt.savefig(join(out_dir, f"{key}.png"))
        plt.close(fig)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = as_device(args.device)
    os.makedirs(join(args.output, "frames"), exist_ok=True)

    cameras = ring_cameras(args.cam_count, args.cam_res)
    grid = (load_vol(args.volume_grid, device=dev) if args.volume_grid
            else procedural_smoke(device=dev))
    emitter = ConstantEmitter(radiance=torch.ones(3, device=dev))
    print(f"Rendering reference images ({args.ref_mode}):")
    ref_image = reference_image(grid, cameras, args, emitter, dev)
    image.write_image(join(args.output, "reference.png"), ref_image)
    image.write_image(join(args.output, "reference.exr"), ref_image)

    prims = lattice_init(args.volprim_count, args.init_sigmat, args.init_albedo, device=dev)
    cfg = tomography.TomographyConfig(max_depth=args.max_depth, kernel_type=args.kernel)
    with torch.no_grad():
        init_img = render_batch(prims, cameras, tomography.radiance, cfg, emitter,
                                spp=args.ref_spp, generator=_generator(dev, 0))
    image.write_image(join(args.output, "initial.png"), init_img)

    opt = make_optimizer(args)
    params = volume_params(prims)
    print("Run optimization:")
    losses, psnrs = [], []
    for it in range(args.iterations):
        loss, psnr_db, img = train_step(params, opt, cameras, cfg, emitter, ref_image, args,
                                        it, prims.extent)
        losses.append(loss)
        psnrs.append(psnr_db)
        if (it + 1) % args.write_image_every == 0:
            image.write_image(join(args.output, "frames", f"image_{it:04d}.png"), img)
        print(f"-- step {it + 1}/{args.iterations} | psnr={psnr_db:.4f} | loss={loss:.4f}",
              flush=True)
    print("Done with optimization")

    params = {k: v.detach() for k, v in params.items()}
    result = to_scene(params, prims.extent)
    if not args.no_prune:
        valid = (params["sigmat"][:, 0] > 1e-6) & torch.all(params["scales"] > 1e-4, dim=-1)
        idx = torch.nonzero(valid)[:, 0]
        print(f"Pruning {result.num_prims - idx.shape[0]} volumetric primitives "
              f"out of {result.num_prims}")
        result = result.select(idx)

    with torch.no_grad():
        final = render_batch(result, cameras, tomography.radiance, cfg, emitter,
                             spp=args.ref_spp, generator=_generator(dev, 0))
    image.write_image(join(args.output, "optimized.png"), final)
    image.write_image(join(args.output, "optimized.exr"), final)
    asset_dir = join(args.output, "optimized_asset")
    save_asset(asset_dir, result, cameras,
               integrator={"type": "volprim_tomography", "max_depth": args.max_depth},
               emitters={"environment": {"type": "constant"}})
    final_psnr = float(psnr(ref_image, final))
    print(f"PSNR: {final_psnr:.4f}")

    curves = {"loss": losses, "psnr": psnrs}
    with open(join(args.output, "curves.json"), "w") as f:
        json.dump(curves, f, indent=1)
    _plots(args.output, curves)
    return dict(losses=losses, psnrs=psnrs, final_psnr=final_psnr, asset=asset_dir,
                num_prims=result.num_prims)


if __name__ == "__main__":
    main()
