"""Recover vertex BSDF attributes with the radiosity-equation loss.

The port's counterpart of the JAX package's ``examples/fit_radiosity_bsdf.py``,
with its flags; ``--device`` picks the torch device (the card by default)
and ``--cpu`` means ``--device cpu``::

    python -m volprim_tpu_torch.examples.fit_radiosity_bsdf \\
        [--bsdf diffuse|principled] [--iterations 60] [--output radiosity_fit]

A synthetic mesh scene with known ("ground truth") vertex BSDF attributes
under the procedural sky is path-traced through a
:class:`~volprim_tpu_torch.tooling.radiance_cache.RadianceCache`; trainable
vertex attributes start flat and are fitted by minimising the radiosity
residual

    || Lo(x, wo) - Le(x) - (1/W) sum_i Li(x, wi_i) f(x, wi_i -> wo) ||^2

with gradients flowing only into the BSDF attributes (an eager step:
``compute_loss``, ``backward()``, ``BoundedAdam.step``). Prints the
base_color error every 5 iterations and writes the fitted attributes as
``<output>.npz``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import as_device
from ..ops import bsdf as bsdf_ops
from ..ops import envmap
from ..optim import BoundedAdam
from ..scene import mesh as mesh_mod
from ..tooling import radiance_cache as rc


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Fit vertex BSDF attributes")
    ap.add_argument("--output", type=str, default="radiosity_fit")
    ap.add_argument("--iterations", type=int, default=60)
    ap.add_argument("--num_points", type=int, default=64)
    ap.add_argument("--num_wi", type=int, default=96)
    ap.add_argument("--num_wo", type=int, default=1)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--bsdf", type=str, default="diffuse", choices=["diffuse", "principled"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: the card)")
    return ap


def build_scene(model, device=None) -> mesh_mod.TriangleMesh:
    """Ground-truth scene: a two-tone floor and a colored icosphere."""
    floor_a = mesh_mod.make_rect(
        [-1.5, 0.0, 0.0], [1.5, 0, 0], [0, 0, -3.0],
        attrs={"base_color": [0.8, 0.25, 0.2], "roughness": [0.8], "metallic": [0.0]},
        device=device,
    )
    floor_b = mesh_mod.make_rect(
        [1.5, 0.0, 0.0], [1.5, 0, 0], [0, 0, -3.0],
        attrs={"base_color": [0.2, 0.35, 0.8], "roughness": [0.4], "metallic": [0.0]},
        device=device,
    )
    ball = mesh_mod.make_icosphere(
        [0.0, 0.8, 0.0], 0.7, subdiv=1,
        attrs={"base_color": [0.25, 0.7, 0.3], "roughness": [0.5], "metallic": [0.3]},
        device=device,
    )
    m = mesh_mod.merge([floor_a, floor_b, ball])
    if isinstance(model, bsdf_ops.Diffuse):
        m.attrs.pop("roughness")
        m.attrs.pop("metallic")
    return m


def setup(args, device):
    """(model, ground-truth mesh, cache, trainable attributes, optimizer) of
    the parsed ``args`` on ``device``."""
    model = (bsdf_ops.Diffuse() if args.bsdf == "diffuse"
             else bsdf_ops.Principled(has_metallic=True))
    mesh_gt = build_scene(model, device)
    em = envmap.procedural_sky(h=32, w=64, device=device)
    cache = rc.RadianceCache(emitter=em, mesh=mesh_gt, bsdf=model, integrator="prb")

    # trainable attributes: flat init
    nv = mesh_gt.num_vertices
    train_attrs = {"base_color": torch.full((nv, 3), 0.5, device=device)}
    if args.bsdf == "principled":
        train_attrs["roughness"] = torch.full((nv, 1), 0.6, device=device)
        train_attrs["metallic"] = torch.full((nv, 1), 0.1, device=device)
    for v in train_attrs.values():
        v.requires_grad_(True)

    opt = BoundedAdam(lr=args.lr)
    for k in train_attrs:
        opt.set_bounds(k, lower=1e-3, upper=1.0 - 1e-3)
    return model, mesh_gt, cache, train_attrs, opt


def step(cache, mesh_gt, model, train_attrs, opt, generator, args) -> torch.Tensor:
    """One optimizer step; returns the loss (detached)."""
    for v in train_attrs.values():
        v.grad = None
    loss = rc.compute_loss(cache, mesh_gt, train_attrs, model, generator,
                           num_points=args.num_points, num_wi=args.num_wi,
                           num_wo=args.num_wo)
    loss.backward()
    opt.step(train_attrs)
    return loss.detach()


def base_color_mae(train_attrs, mesh_gt) -> float:
    return float(torch.mean(torch.abs(train_attrs["base_color"].detach()
                                      - mesh_gt.attrs["base_color"])))


def main(argv=None) -> float:
    args = parser().parse_args(argv)
    dev = as_device("cpu" if args.cpu else args.device)
    model, mesh_gt, cache, train_attrs, opt = setup(args, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    err = base_color_mae(train_attrs, mesh_gt)
    for it in range(args.iterations):
        loss = step(cache, mesh_gt, model, train_attrs, opt, gen, args)
        err = base_color_mae(train_attrs, mesh_gt)
        if it % 5 == 0 or it == args.iterations - 1:
            print(f"iter {it:3d}  loss {float(loss):.5f}  base_color MAE {err:.4f}", flush=True)

    out = {k: v.detach().cpu().numpy() for k, v in train_attrs.items()}
    np.savez(args.output + ".npz", **out)
    print(f"wrote {args.output}.npz (final base_color MAE {err:.4f})")
    return err


if __name__ == "__main__":
    main()
