"""Attribute the 2M-splat quality gap to its sources: budget, depth order
and pooling.

The port of tools/diag2m.py, with its protocol and defaults: the bench
scene of 2,097,152 splats (``scene.synthetic.make_scene``, bit-equal to
bench.make_scene) at 512^2 through the TILED pipeline with the ``xla``
backend, one 1-spp frame at pixel centers per configuration, each scored
against an exact reference made on the same device: the exact-order
integrator (models/rf, max_depth 512, which covers the largest observed
218 hits a ray) on a fixed 4,096-ray subsample (numpy generator seeded 42).

Configurations (``CONFIGS``; the default runs ceiling, ordering, budget,
pool and pool-hi): ``gc`` the coarse group (0: every cluster culled per
tile), ``mc`` the candidates, ``resort`` the shortlist's resort, ``band``
the order band. Two more entries: ``hits`` (the subsample's primitive hits
a ray: p50, p90, p99, max, mean) and ``noise`` (the exact reference with
the primitives permuted, generator seeded 7: the floor of f32 summation
order).

Memory: the xla route composites the film in vectorised steps of
``rf_tiled.xla_step_tiles`` tiles, the renderer's own rule; on the card
each configuration prints that step, the free memory ``torch.cuda.
mem_get_info`` reports before it and the peak ``torch.cuda.
max_memory_allocated`` reached during it. Each time is printed beside the
card's name and power limit; the last line is one JSON object of the
results.

Usage: python -m volprim_tpu_torch.tools.diag2m [config ...] [--cpu]
       [--prims 2097152] [--width 512]
(the card unless --cpu; --prims and --width shrink the study).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import studies

N2M = 2097152
MD_REF = 512  # covers the max observed 218 hits/ray
SUBSAMPLE_SEED = 42  # the seed of the exact reference's 4,096-ray subsample

CONFIGS = {
    "ceiling": dict(gc=0, mc=65536, resort=True, md=MD_REF),
    "ordering": dict(gc=0, mc=65536, resort=False, md=MD_REF),
    "csort": dict(gc=0, mc=65536, resort="cluster", md=MD_REF),
    "csort-entry": dict(gc=0, mc=65536, resort="cluster-entry", md=MD_REF),
    "entry": dict(gc=0, mc=65536, resort="entry", md=MD_REF),
    "budget": dict(gc=0, mc=2048, resort=False, md=MD_REF),
    "pool": dict(gc=4, mc=2048, resort=False, md=MD_REF),
    "pool-hi": dict(gc=4, mc=8192, resort=False, md=MD_REF),
    "mc16k": dict(gc=0, mc=16384, resort=False, md=MD_REF),
    "mc32k": dict(gc=0, mc=32768, resort=False, md=MD_REF),
    "mc64k": dict(gc=0, mc=65536, resort=False, md=MD_REF),
    # the banded per-ray order correction
    "csort-band16": dict(gc=0, mc=65536, resort="cluster-entry", md=MD_REF, band=16),
    "csort-band64": dict(gc=0, mc=65536, resort="cluster-entry", md=MD_REF, band=64),
    "band64": dict(gc=0, mc=65536, resort=False, md=MD_REF, band=64),
    "band255": dict(gc=0, mc=65536, resort=False, md=MD_REF, band=255),
    # entry resort + band
    "entry-band64": dict(gc=0, mc=65536, resort="entry", md=MD_REF, band=64),
    "entry-band255": dict(gc=0, mc=65536, resort="entry", md=MD_REF, band=255),
}
DEFAULT = ("ceiling", "ordering", "budget", "pool", "pool-hi")
PROBES = ("hits", "noise")
TILE_PIXELS = 256


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*",
                    help=f"configurations ({', '.join(list(CONFIGS) + list(PROBES))}); "
                         f"default {' '.join(DEFAULT)}")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--prims", type=int, default=N2M, help="the scene's primitives")
    ap.add_argument("--width", type=int, default=512, help="the film's side")
    return ap


def exact_reference(scene, o, d, md: int = MD_REF):
    """The exact-order integrator at max_depth ``md`` on rays o, d."""
    from ..models import rf

    return rf.radiance(scene, None, o, d, rf.RFConfig(
        max_depth=md, srgb_primitives=True, chunk_size=4096))


def config(p: dict):
    """The tiled xla configuration of a CONFIGS entry."""
    from ..models import rf_tiled

    return rf_tiled.RFTiledConfig(
        max_depth=p["md"], tile_pixels=TILE_PIXELS, max_candidates=p["mc"],
        segment=min(256, p["mc"]), cluster_size=16, backend="xla", coarse_group=p["gc"],
        coarse_factor=8, super_group=4, refine_fraction=0.0, prim_resort=p["resort"],
        srgb_primitives=True, order_band=p.get("band", 0),
    )


def count_hits(scene, o, d, chunk: int = 65536) -> torch.Tensor:
    """Primitives each ray enters ahead of its origin: q's minimum within
    extent^2 and the closest approach at t > 0 [R], over chunks of
    primitives."""
    from ..ops import quadric

    ext2 = float(scene.extent) ** 2
    acc = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
    for i in range(0, scene.num_prims, chunk):
        sl = slice(i, i + chunk)
        c = quadric.pair_coeffs(o[:, None, :], d[:, None, :], scene.centers[None, sl],
                                scene.scales[None, sl], scene.quats[None, sl])
        qmin = c.c - c.b * c.b / c.a
        acc += ((qmin < ext2) & (-c.b / c.a > 0)).sum(dim=1)
    return acc


@torch.no_grad()
def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    names = args.configs or list(DEFAULT)
    unknown = [n for n in names if n not in CONFIGS and n not in PROBES]
    if unknown:
        raise SystemExit(f"unknown configurations {unknown}; they are "
                         f"{', '.join(list(CONFIGS) + list(PROBES))}")
    dev = studies.device_of(args.cpu)
    card = studies.card_line(dev)
    from ..models import rf_tiled
    from ..scene import generate_rays, synthetic

    scene = synthetic.make_scene(args.prims, device=dev)
    camera = synthetic.headline_camera(args.width)
    n_tiles = args.width * args.width // TILE_PIXELS
    sel = studies.subsample(args.width * args.width, SUBSAMPLE_SEED)
    idx = torch.from_numpy(sel).to(dev)
    o, d = generate_rays(camera, jitter=False, device=dev)
    o_s, d_s = o[idx], d[idx]
    t0 = studies.clock(dev)
    exact = exact_reference(scene, o_s, d_s)
    exact_s = studies.clock(dev) - t0
    res = dict(tool="diag2m", prims=args.prims, width=args.width, rays=int(sel.size),
               device=dev.type, card=card, exact=dict(max_depth=MD_REF, seconds=exact_s),
               configs={})
    print(f"exact reference: {sel.size} rays at max_depth {MD_REF} in {exact_s:.2f} s"
          f" ({card})", flush=True)

    for name in names:
        t0 = studies.clock(dev)
        if name == "hits":
            hits = torch.cat([count_hits(scene, o_s[i:i + 512], d_s[i:i + 512])
                              for i in range(0, o_s.shape[0], 512)]).cpu().numpy()
            q = np.percentile(hits, [50, 90, 99, 100])
            secs = studies.clock(dev) - t0
            res["hits"] = dict(p50=float(q[0]), p90=float(q[1]), p99=float(q[2]),
                               max=float(q[3]), mean=float(hits.mean()), seconds=secs)
            print(f"hits: p50={q[0]:.0f} p90={q[1]:.0f} p99={q[2]:.0f} max={q[3]:.0f} "
                  f"mean={hits.mean():.0f} ({secs:.0f} s, {card})", flush=True)
            continue
        if name == "noise":
            noise_db = studies.psnr(exact_reference(studies.permuted(scene), o_s, d_s), exact)
            secs = studies.clock(dev) - t0
            res["noise"] = dict(psnr_db=noise_db, seconds=secs)
            print(f"noise: exact(permuted) vs exact = {noise_db:.2f} dB ({secs:.0f} s, "
                  f"{card})", flush=True)
            continue
        p = CONFIGS[name]
        s = min(p["mc"], args.prims)
        row = dict(gc=p["gc"], mc=p["mc"], md=p["md"], resort=p["resort"],
                   band=p.get("band", 0))
        cfg = config(p)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            free, _ = torch.cuda.mem_get_info(dev)
            g = rf_tiled.xla_step_tiles(n_tiles, TILE_PIXELS, s, cfg)
            row.update(step_tiles=g, free_gib=free / 2**30)
            print(f"{name}: steps of {g} of {n_tiles} tiles (free {free / 2**30:.1f} GiB)",
                  flush=True)
        state = rf_tiled.build_state(scene, cfg)
        img = rf_tiled.render_state(state, camera, cfg, None, spp=1, seed=0, jitter=False)
        sub = img.reshape(-1, 3)[idx]
        secs = studies.clock(dev) - t0
        row.update(psnr_db=studies.psnr(sub, exact), seconds=secs)
        if dev.type == "cuda":
            row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        del state, img
        res["configs"][name] = row
        peak = f", peak {row['peak_gib']:.1f} GiB" if "peak_gib" in row else ""
        print(f"{name:9s} gc={p['gc']} mc={p['mc']} md={p['md']} resort={p['resort']}: "
              f"PSNR {row['psnr_db']:.2f} dB ({secs:.0f} s{peak}, {card})", flush=True)
    return studies.emit(res)


if __name__ == "__main__":
    main()
