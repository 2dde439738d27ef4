"""The tiled renderer's approximation bound at 1M splats by candidate
budget: the TRUE scene rendered tiled against refine_truck's exact ground
truth on its held-out views.

The port of tools/truck_bound.py, with its flags and defaults: the bench
scene of ``--n_splats`` splats (``scene.synthetic.make_scene``, bit-equal to
bench.make_scene) rendered through the tiled renderer's ``xla`` backend
(max_depth 128, Gaussian, 256-pixel tiles, clusters of 16, coarse group 4,
coarse factor 16, super group 4) at each of ``--mc`` candidate budgets, two
held-out views at ``--spp`` (view i seeded 1000 + i), each scored against
``<images>/test_0i.npy``. Its two cameras are on the ring of 8 at
elevation 0.6 (``studies.ring_cam``), half a step past training cameras 0
and 1: refine_truck's held-out views only when it ran with ``--train_cams
8`` (its default), as in the root script, which reads the images as they
are. The images must be of ``--res`` (refine_truck's ``--res``).

Each time is printed beside the card's name and power limit; the last line
is one JSON object with ``bound_mc{mc}_db``, the mean PSNR of the two views
at each budget, and the details.

Usage: python -m volprim_tpu_torch.tools.truck_bound [--cpu] [--mc 2048 8192]
       [--n_splats 1048576] [--res 256] [--spp 4]
       [--images $TMPDIR/refine_truck/images]
(the card unless --cpu; refine_truck makes the images, in its default
workdir unless given another).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import refine_truck, studies

RING, ELEV, TEST_VIEWS = 8, 0.6, 2


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mc", type=int, nargs="*", default=[2048, 8192])
    ap.add_argument("--n_splats", type=int, default=1 << 20)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--images", default=None,
                    help="default: refine_truck's default workdir's images")
    return ap


def cameras(res: int) -> list:
    """The two held-out cameras (tools/truck_bound.py:44-52)."""
    return [studies.ring_cam(f"test_{i:02d}", i + 0.5, RING, ELEV, res)
            for i in range(TEST_VIEWS)]


def config(mc: int):
    """The bound's xla configuration at ``mc`` candidates
    (tools/truck_bound.py:56-61)."""
    from ..models import rf_tiled

    return rf_tiled.RFTiledConfig(
        max_depth=128, kernel_type="gaussian", tile_pixels=256, max_candidates=mc,
        segment=256, cluster_size=16, backend="xla", coarse_group=4, coarse_factor=16,
        super_group=4,
    )


@torch.no_grad()
def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    images = args.images or os.path.join(refine_truck.default_workdir(), "images")
    dev = studies.device_of(args.cpu)
    card = studies.card_line(dev)
    from ..models import rf_tiled
    from ..scene import synthetic

    scene_true = synthetic.make_scene(args.n_splats, device=dev)
    cams = cameras(args.res)
    gt = {c.name: torch.from_numpy(np.load(os.path.join(images, f"{c.name}.npy"))).to(dev)
          for c in cams}
    bad = {k: tuple(v.shape) for k, v in gt.items() if tuple(v.shape) != (args.res, args.res, 3)}
    if bad:
        raise SystemExit(f"images of shape {bad} in {images}, expected "
                         f"({args.res}, {args.res}, 3): pass refine_truck's --res")
    res = dict(tool="truck_bound", n_splats=args.n_splats, res=args.res, spp=args.spp,
               device=dev.type, card=card, views={})
    for mc in args.mc:
        cfg = config(mc)
        t0 = studies.clock(dev)
        st = rf_tiled.build_state(scene_true, cfg)
        build_s = studies.clock(dev) - t0
        vals = []
        for i, cam in enumerate(cams):
            t0 = studies.clock(dev)
            img = rf_tiled.render_state(st, cam, cfg, None, spp=args.spp, seed=1000 + i)
            secs = studies.clock(dev) - t0
            vals.append(studies.psnr(img, gt[cam.name]))
            res["views"][f"mc{mc}_{cam.name}"] = dict(psnr_db=vals[-1], seconds=secs)
            print(f"mc{mc} {cam.name}: {vals[-1]:.2f} dB ({secs:.1f}s, {card})", flush=True)
        del st
        res[f"bound_mc{mc}_db"] = round(float(np.mean(vals)), 2)
        res[f"build_state_mc{mc}_s"] = build_s
    return studies.emit(res)


if __name__ == "__main__":
    main()
