"""Does training through the tiled (ordering-approximate) renderer hurt
converged quality?

The port of tools/convergence_eval.py, with its protocol and defaults: a
ground-truth scene of ``--prims`` splats on a unit shell (numpy generator
seeded 0) renders reference views of ``--res`` square from six cameras on
a ring with the EXACT per-ray-order integrator (models/rf.py, max_depth
64, linear primitives). A perturbed copy (noisy opacities and SH, jittered
centers, drawn from the same generator) is optimized against the first
five views for ``--iters`` steps (BoundedAdam, lr 5e-3, opacities bounded
to [1e-4, 1 - 1e-4], L1, one camera a step in turn) twice: through the
tiled renderer (256-pixel tiles, 1024 candidates, 128-column segments,
clusters of 16; the ``--backend`` compositor, ``xla`` as in the JAX
package's script or ``fused``, whose forward and backward are the CUDA
kernels csrc/composite3_fwd.cu and composite3_bwd.cu on the card) and
through the exact renderer. Both results, and the initial scene, are
scored with the exact renderer on the held-out sixth view. ``--band`` also
trains through the cluster-entry resort with order_band 16.

It prints the JAX script's lines (the loss every 25 steps, each training's
seconds, the PSNRs and their difference), each time beside the card's name
and power limit, then one JSON line: the PSNRs, each loss curve's first
and last cycle of five steps (one step per training camera), ms per step
(the median over the steps after the first, the loss read back every
step), and on the card the compositor kernels' launches during the tiled
training.

Usage: python -m volprim_tpu_torch.tools.convergence_eval [--iters 150]
       [--prims 2000] [--res 64] [--backend xla|fused] [--band] [--cpu]
(the card unless --cpu).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from . import studies

# the exact renderer of the references, the training and the scoring
EXACT = dict(max_depth=64, srgb_primitives=False, chunk_size=512)
# the tiled renderer (tools/convergence_eval.py:102-106)
TILED = dict(max_depth=64, srgb_primitives=False, tile_pixels=256, max_candidates=1024,
             segment=128, cluster_size=16, use_clusters=True)
LR = 5e-3
OPACITY_BOUNDS = (1e-4, 1.0 - 1e-4)
TRAIN_CAMERAS = 5


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--prims", type=int, default=2000)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--backend", choices=("xla", "fused"), default="xla")
    ap.add_argument("--band", action="store_true",
                    help="also train through the csort+band16 quality mode")
    ap.add_argument("--cpu", action="store_true")
    return ap


def ground_truth(n: int, rng: np.random.Generator, device):
    """The ground-truth scene: n splats near the unit sphere, drawn from
    ``rng`` in the JAX script's order."""
    from ..scene.ellipsoids import EllipsoidsFactory

    f = EllipsoidsFactory()
    for _ in range(n):
        p = rng.normal(size=3)
        p /= np.linalg.norm(p)
        f.add(
            mean=p * rng.uniform(0.9, 1.1),
            scale=rng.uniform(0.03, 0.1, size=3),
            euler_deg=rng.uniform(-90, 90, size=3),
            opacities=rng.uniform(0.3, 0.95),
            sh_coeffs=rng.normal(size=3).astype(np.float32) * 0.4,
        )
    return f.build(device=device)


def cameras(res: int) -> list:
    """Six cameras on a ring of radius 3.5 at height 0.3, fov 45."""
    from ..scene import CameraSpecs, look_at

    return [
        CameraSpecs(
            name=f"c{i}", width=res, height=res,
            to_world=look_at([3.5 * np.sin(th), 0.3, -3.5 * np.cos(th)], [0, 0, 0],
                             [0, 1, 0]),
            fov=45.0,
        )
        for i, th in enumerate(np.linspace(0, 2 * np.pi, 6, endpoint=False))
    ]


def perturb(gt, rng: np.random.Generator) -> dict:
    """The initial parameters: opacities plus N(0, 0.25) clipped to [1e-3,
    1 - 1e-3], SH plus N(0, 0.3), centers plus N(0, 0.01), drawn from
    ``rng`` in that order."""
    n = gt.num_prims

    def noise(sigma, cols):
        return torch.from_numpy(rng.normal(0, sigma, (n, cols)).astype(np.float32)).to(
            gt.centers.device)

    return {
        "opacities": torch.clamp(gt.attrs["opacities"] + noise(0.25, 1), 1e-3, 1.0 - 1e-3),
        "sh_coeffs": gt.attrs["sh_coeffs"] + noise(0.3, 3),
        "centers": gt.centers + noise(0.01, 3),
    }


def to_scene(p: dict, gt):
    """The scene of the trained parameters, scales and quats from ``gt``."""
    from ..scene.ellipsoids import EllipsoidScene

    return EllipsoidScene(
        centers=p["centers"], scales=gt.scales, quats=gt.quats,
        attrs={"opacities": p["opacities"], "sh_coeffs": p["sh_coeffs"]}, extent=gt.extent,
    )


def render_exact(prims, cam):
    """The exact renderer's [res, res, 3] frame at pixel centers."""
    from ..models import rf
    from ..scene import generate_rays

    o, d = generate_rays(cam, jitter=False, device=prims.centers.device)
    return rf.radiance(prims, None, o, d, rf.RFConfig(**EXACT)).reshape(
        cam.height, cam.width, 3)


def tiled_configs(backend: str):
    """(the tiled config, the band config) of ``backend``."""
    from ..models import rf_tiled

    tcfg = rf_tiled.RFTiledConfig(backend=backend, **TILED)
    return tcfg, dataclasses.replace(tcfg, prim_resort="cluster-entry", order_band=16)


def render_tiled(prims, cam, cfg):
    """The tiled renderer's 1-spp frame at pixel centers, its state built
    from ``prims`` under autograd."""
    from ..models import rf_tiled

    st = rf_tiled.build_state(prims, cfg)
    return rf_tiled.render_state(st, cam, cfg, None, spp=1, seed=0, jitter=False)


def train(renderer: str, init: dict, refs: list, train_cams: list, gt, iters: int, cfg,
          card: str, log=print):
    """``iters`` steps through ``renderer`` ("exact", or "tiled" / "band"
    with the tiled ``cfg``): (trained parameters, losses, seconds a step)."""
    from ..optim import BoundedAdam, l1

    dev = gt.centers.device
    opt = BoundedAdam(lr=LR)
    opt.set_bounds("opacities", lower=OPACITY_BOUNDS[0], upper=OPACITY_BOUNDS[1])
    params = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()}
    losses, secs = [], []
    t_start = studies.clock(dev)
    for it in range(iters):
        ci = it % len(train_cams)
        t0 = studies.clock(dev)
        prims = to_scene(params, gt)
        if renderer == "exact":
            img = render_exact(prims, train_cams[ci])
        else:
            img = render_tiled(prims, train_cams[ci], cfg)
        loss = l1(refs[ci], img)
        for p in params.values():
            p.grad = None
        loss.backward()
        opt.step(params)
        losses.append(float(loss.detach()))
        secs.append(studies.clock(dev) - t0)
        if it % 25 == 0:
            log(f"  [{renderer}] iter {it} loss {losses[-1]:.5f}", flush=True)
    total = studies.clock(dev) - t_start
    log(f"  [{renderer}] {total:.0f} s, {1e3 * step_ms(secs):.1f} ms a step ({card})",
        flush=True)
    return {k: v.detach() for k, v in params.items()}, losses, secs


def step_ms(secs: list) -> float:
    """Seconds a step: the median of the steps after the first (which
    builds the kernels on first use), the only one if there is one."""
    return float(np.median(secs[1:] if len(secs) > 1 else secs))


def curve_ends(losses: list, cycle: int = TRAIN_CAMERAS) -> dict:
    """The mean loss of the first and of the last cycle of ``cycle`` steps
    (one step per training camera), and the last loss."""
    return dict(start=float(np.mean(losses[:cycle])), end=float(np.mean(losses[-cycle:])),
                last=float(losses[-1]))


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = studies.device_of(args.cpu)
    card = studies.card_line(dev)
    from ..kernels import composite3

    rng = np.random.default_rng(0)
    gt = ground_truth(args.prims, rng, dev)
    cams = cameras(args.res)
    train_cams, test_cam = cams[:TRAIN_CAMERAS], cams[TRAIN_CAMERAS]
    with torch.no_grad():
        refs = [render_exact(gt, c) for c in train_cams]
        ref_test = render_exact(gt, test_cam)
    init = perturb(gt, rng)
    tcfg, bcfg = tiled_configs(args.backend)

    def psnr_exact(p):
        with torch.no_grad():
            return studies.psnr(render_exact(to_scene(p, gt), test_cam), ref_test)

    res = dict(tool="convergence_eval", backend=args.backend, iters=args.iters,
               prims=args.prims, res=args.res, device=dev.type, card=card)
    res["psnr_init"] = psnr_exact(init)
    print(f"init held-out PSNR (exact render): {res['psnr_init']:.2f} dB", flush=True)
    losses, ms = {}, {}
    runs = ["tiled"] + (["band"] if args.band else []) + ["exact"]
    for renderer in runs:
        before = (composite3.composite_tiles3.launches, composite3.composite_tiles3_bwd.launches)
        cfg = bcfg if renderer == "band" else tcfg
        p, losses[renderer], secs = train(renderer, init, refs, train_cams, gt, args.iters,
                                          cfg, card)
        ms[renderer] = 1e3 * step_ms(secs)
        if renderer == "tiled":
            res["launches_fwd"] = composite3.composite_tiles3.launches - before[0]
            res["launches_bwd"] = composite3.composite_tiles3_bwd.launches - before[1]
        res[f"psnr_{renderer}"] = psnr_exact(p)
        label = {"tiled": "tiled-trained", "band": "band-trained (csort+band16)",
                 "exact": "exact-trained"}[renderer]
        print(f"{label}, exact-evaluated: {res[f'psnr_{renderer}']:.2f} dB", flush=True)
    res["delta_tiled"] = res["psnr_tiled"] - res["psnr_exact"]
    print(f"delta (tiled-trained - exact-trained): {res['delta_tiled']:+.2f} dB", flush=True)
    if args.band:
        res["delta_band"] = res["psnr_band"] - res["psnr_exact"]
        print(f"delta (band-trained - exact-trained): {res['delta_band']:+.2f} dB", flush=True)
    res["loss"] = {k: curve_ends(v) for k, v in losses.items()}
    res["ms_per_step"] = ms
    return studies.emit(res)


if __name__ == "__main__":
    main()
