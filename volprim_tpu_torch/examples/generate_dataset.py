"""Generate a synthetic 3DGS / NeRF training dataset from a primitive scene.

The port's counterpart of the JAX package's ``examples/generate_dataset.py``,
with its flags and ``--device`` (the card unless ``--device cpu``)::

    python -m volprim_tpu_torch.examples.generate_dataset --ply scene.ply \\
        --output dataset [--resolution 256] [--subdivisions 1] [--spp 8] \\
        [--points 100000]

Cameras sit on an icosphere of ``--radius`` around the primitives' mean
center (12 at ``--subdivisions 0``, 42 at 1); the first
``--test_fraction`` of them (at least one) form the test split. Each camera
is rendered through the exact-order integrator (``models.rf``) with a
generator seeded by its index in its split, and timed. The output holds
``images/<name>.png`` and ``.npy``, ``transforms_{train,test}.json`` and
``points3d.npz`` (``--points`` seeds sampled from the primitives).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import as_device
from ..models import render, rf
from ..scene import load_ply
from ..tooling import dataset
from ..utils.benchmark import single_run


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Generate 3DGS training dataset")
    ap.add_argument("--ply", type=str, required=True, help="3DGS PLY scene")
    ap.add_argument("--output", type=str, required=True)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--fov", type=float, default=45.0)
    ap.add_argument("--subdivisions", type=int, default=1)
    ap.add_argument("--test_fraction", type=float, default=0.15)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--max_depth", type=int, default=64)
    ap.add_argument("--points", type=int, default=100000)
    ap.add_argument("--device", type=str, default=None, help="torch device (default: the card)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = as_device(args.device)
    prims = load_ply(args.ply, device=dev)
    print(f"Loaded {prims.num_prims} primitives")

    center = prims.centers.mean(dim=0).cpu().numpy().astype(np.float64)
    cams = dataset.icosphere_rig(
        center, args.radius, width=args.resolution, height=args.resolution,
        fov=args.fov, subdivisions=args.subdivisions,
    )
    n_test = max(1, int(len(cams) * args.test_fraction))
    train_cams, test_cams = cams[n_test:], cams[:n_test]
    print(f"{len(train_cams)} train / {len(test_cams)} test cameras")

    cfg = rf.RFConfig(max_depth=args.max_depth)

    def render_fn(cam, i):
        gen = torch.Generator(device=dev).manual_seed(i)
        with torch.no_grad(), single_run(f"Rendering {cam.name}", dev):
            img = render(prims, cam, rf.radiance, cfg, None, args.spp, gen)
        return img

    pc = dataset.sample_point_cloud(prims, args.points,
                                    torch.Generator(device=dev).manual_seed(0))
    dataset.generate(args.output, render_fn, train_cams, test_cams, point_cloud=pc)
    print(f"Dataset written to {args.output}")
    return dict(train=train_cams, test=test_cams, points=pc)


if __name__ == "__main__":
    main()
