"""Pick the order band's quality point at 262k: budget x ordering through
the tiled renderer's xla route, scored against the exact order.

The port of tools/band262k.py, with its protocol and defaults: the bench
scene of 262,144 splats (``scene.synthetic.make_scene``, bit-equal to
bench.make_scene) seen by the headline camera at 512^2, one 1-spp frame at
pixel centers per configuration through the TILED pipeline with the
``xla`` backend (max_depth 128, 256-pixel tiles, clusters of 16, coarse
factor 8, super group 4, no refinement, sRGB primitives), each scored
against the exact-order integrator (models/rf, max_depth 128) on a fixed
4,096-ray subsample (numpy generator seeded 42), made on the same device
as the frames (analyze_rf's reference; the root script's
/tmp/band262k_exact.npz cache is not kept).

Configurations (``CONFIGS``; all by default): ``gc`` the coarse group (4:
the headline's supercluster pool), ``mc`` the candidates, ``resort`` the
shortlist's resort, ``band`` the order band. Budget classes exist only on
the fused backend, so the headline's budget ladder is approximated by its
single-budget neighbours (mc2048, mc4096): compare rows with each other,
not with the fused headline.

Each time is printed beside the card's name and power limit; the last line
is one JSON object of the results.

Usage: python -m volprim_tpu_torch.tools.band262k [config ...] [--cpu]
       [--prims 262144] [--width 512]
(the card unless --cpu; --prims and --width shrink the study).
"""

from __future__ import annotations

import argparse

import torch

from . import analyze_rf, diag2m, studies

N = 262144
MD = 128  # 262k per-ray hit counts sit far below this
SUBSAMPLE_SEED = 42  # the seed of the exact reference's 4,096-ray subsample

# gc=4 mirrors the headline's supercluster pool (cf=8/sg=4 defaults).
CONFIGS = {
    # truncation floors without ordering fixes
    "mc2048": dict(gc=4, mc=2048, resort=False),
    "mc4096": dict(gc=4, mc=4096, resort=False),
    # ordering fixes at each budget
    "mc2048-csort": dict(gc=4, mc=2048, resort="cluster-entry"),
    "mc2048-csort-band16": dict(gc=4, mc=2048, resort="cluster-entry", band=16),
    "mc4096-csort-band16": dict(gc=4, mc=4096, resort="cluster-entry", band=16),
    # half-band candidates: the band's work scales with its width
    "mc4096-csort-band8": dict(gc=4, mc=4096, resort="cluster-entry", band=8),
    "mc8192-csort-band8": dict(gc=4, mc=8192, resort="cluster-entry", band=8),
    "mc8192-csort-band16": dict(gc=4, mc=8192, resort="cluster-entry", band=16),
}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", help=f"configurations ({', '.join(CONFIGS)}); "
                                               "default all")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--prims", type=int, default=N, help="the scene's primitives")
    ap.add_argument("--width", type=int, default=512, help="the film's side")
    return ap


def config(p: dict):
    """The tiled xla configuration of a CONFIGS entry (tools/band262k.py:
    117-123): diag2m's at max_depth MD."""
    return diag2m.config(dict(p, md=MD))


@torch.no_grad()
def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    names = args.configs or list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        raise SystemExit(f"unknown configurations {unknown}; they are {', '.join(CONFIGS)}")
    dev = studies.device_of(args.cpu)
    card = studies.card_line(dev)
    from ..models import rf_tiled
    from ..scene import generate_rays, synthetic

    scene = synthetic.make_scene(args.prims, device=dev)
    camera = synthetic.headline_camera(args.width)
    sel = studies.subsample(args.width * args.width, SUBSAMPLE_SEED)
    idx = torch.from_numpy(sel).to(dev)
    o, d = generate_rays(camera, jitter=False, device=dev)
    t0 = studies.clock(dev)
    exact = analyze_rf.exact_reference(scene, o[idx], d[idx])
    exact_s = studies.clock(dev) - t0
    res = dict(tool="band262k", prims=args.prims, width=args.width, rays=int(sel.size),
               device=dev.type, card=card, exact=dict(max_depth=MD, seconds=exact_s),
               configs={})
    print(f"exact reference: {sel.size} rays at max_depth {MD} in {exact_s:.2f} s ({card})",
          flush=True)
    for name in names:
        p = CONFIGS[name]
        band = p.get("band", 0)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = studies.clock(dev)
        cfg = config(p)
        state = rf_tiled.build_state(scene, cfg)
        img = rf_tiled.render_state(state, camera, cfg, None, spp=1, seed=0, jitter=False)
        secs = studies.clock(dev) - t0
        row = dict(gc=p["gc"], mc=p["mc"], resort=p["resort"], band=band,
                   psnr_db=studies.psnr(img.reshape(-1, 3)[idx], exact), seconds=secs)
        if dev.type == "cuda":
            row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        del state, img
        res["configs"][name] = row
        peak = f", peak {row['peak_gib']:.1f} GiB" if "peak_gib" in row else ""
        print(f"{name:22s} gc={p['gc']} mc={p['mc']} resort={p['resort']} band={band}: "
              f"PSNR {row['psnr_db']:.2f} dB ({secs:.0f} s{peak}, {card})", flush=True)
    return studies.emit(res)


if __name__ == "__main__":
    main()
