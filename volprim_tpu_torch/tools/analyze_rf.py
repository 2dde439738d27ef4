"""Where the tiled renderer's cluster budget binds, on the headline scene.

The port of tools/analyze_rf.py, with its protocol and defaults: the
262,144-primitive surface scene (``scene.synthetic.make_scene``, bit-equal
to bench.make_scene) seen by the headline camera at 512^2, state built for
the fused backend at ``--mc`` candidates, ``--tp``-pixel tiles and clusters
of ``--cs``. It prints:

1. the per-tile cluster need: how many clusters' spheres meet each tile's
   cone (``n_finite``, the exact cull against every cluster), against the
   per-tile budget ``mc / cs``;
2. subtile survival: the share of a tile's clusters that each of its four
   quarter tiles' cones still meets;
3. primitive survival inside the culled-in clusters (the tile's first
   K_COV clusters): the share of their primitives' spheres that meet the
   tile's cone, or its quarters';
4. quality by budget: 1-spp frames at pixel centers at ``mc`` and ``4 mc``
   candidates, scored against the exact-order integrator (models/rf,
   max_depth 128, sRGB) on a fixed 4,096-pixel subsample (numpy generator
   seeded 0, the subsample of chip_smoke.py's quality phase), rendered on
   the same device as the frames; the noise floor of that reference (the
   same render with the primitives in a permuted order, generator seeded
   7); the share of the recoverable MSE (mc minus 4 mc, per tile, from
   the tile's subsample pixels) that the worst tiles hold, and how much of
   it the need signals find.

The JAX script scored its frames against a TPU-made golden of the whole
film (tests/golden/bench_exact512.npy). This port never reads a golden:
its reference is made where the frames are, so the per-tile attribution
rests on the about four subsample pixels a 256-pixel tile holds. The TPU
layout knob ``kernel_batch`` has no counterpart (ROADMAP.md §D).

Each time is printed beside the card's name and power limit; the last line
is one JSON object of the results. ``--save FILE`` writes the per-tile
arrays (n_fin, n_fin_sub, mse_b, mse_g) as .npz.

Usage: python -m volprim_tpu_torch.tools.analyze_rf [--cpu] [--tp 256]
       [--mc 2048] [--cs 16] [--save FILE] [--prims 262144] [--width 512]
(the card unless --cpu; --prims and --width shrink the study for the
CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import studies

# clusters per tile in the primitive-survival study (covers the largest
# need the JAX package observed; a scene of fewer clusters takes them all)
K_COV = 512
# the exact reference's depth and the seed of its pixel subsample
EXACT_DEPTH, SUBSAMPLE_SEED = 128, 0
FRACTIONS = (0.05, 0.125, 0.25, 0.5)
FRAME_REPS = 5  # timed frames a budget (host clock, synchronised; the median)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--prims", type=int, default=262144, help="the scene's primitives")
    ap.add_argument("--width", type=int, default=512, help="the film's side")
    ap.add_argument("--tp", type=int, default=256)
    ap.add_argument("--mc", type=int, default=2048)
    ap.add_argument("--cs", type=int, default=16)
    ap.add_argument("--save", help="write the per-tile arrays to this .npz file")
    return ap


def config(mc: int, tp: int, cs: int):
    """The study's fused configuration at ``mc`` candidates."""
    from ..models import rf_tiled

    return rf_tiled.RFTiledConfig(
        max_depth=128, tile_pixels=tp, max_candidates=mc, segment=min(256, mc),
        cluster_size=cs, backend="fused", early_exit=True, coarse_group=4,
        refine_fraction=0.0, refine_factor=4, coarse_factor=8, super_group=4,
    )


def tile_grid(h: int, w: int, tp: int) -> tuple:
    """(tile height, tile width, tile rows, tile columns) of ``tp``-pixel
    tiles, as rf_tiled lays them out."""
    th = int(tp ** 0.5)
    while tp % th or h % th:
        th -= 1
    tw = tp // th
    return th, tw, h // th, w // tw


def tile_rays(d: torch.Tensor, h: int, w: int, tp: int, sub: bool) -> torch.Tensor:
    """The row-major film's directions [H W, 3] per tile [T, RT, 3], tiles
    row-major; with ``sub`` per quarter tile [4 T, RT / 4, 3], a tile's four
    quarters consecutive."""
    th, tw, n_ty, n_tx = tile_grid(h, w, tp)
    if sub:
        sh_, sw_ = th // 2, tw // 2
        return (d.reshape(n_ty, 2, sh_, n_tx, 2, sw_, 3).permute(0, 3, 1, 4, 2, 5, 6)
                .reshape(n_ty * n_tx * 4, sh_ * sw_, 3))
    return d.reshape(n_ty, th, n_tx, tw, 3).permute(0, 2, 1, 3, 4).reshape(n_ty * n_tx, tp, 3)


def cones(dt: torch.Tensor) -> tuple:
    """Each tile's cone: the unit mean direction and the cosine of the
    widest ray from it (no margin)."""
    ax = dt.mean(dim=1)
    axis = ax / torch.linalg.norm(ax, dim=-1, keepdim=True)
    return axis, torch.amin(torch.einsum("tri,ti->tr", dt, axis), dim=1)


def need(state, origin, axis, cos_half) -> torch.Tensor:
    """Clusters whose sphere meets each cone (finite cull keys) [T]."""
    from ..accel import tiles

    keys = tiles.cone_cull_keys_batch(origin, axis, cos_half, state.cull_centers,
                                      state.cull_radii)
    return torch.isfinite(keys).sum(dim=-1)


def prim_survival(state, origin, d, h, w, tp, sub: bool, k_cov: int = K_COV) -> tuple:
    """(live, total) [T] or [4 T]: of the primitives of each tile's first
    ``k_cov`` culled clusters (the tile cone's shortlist), those whose
    sphere (extent x the largest scale) meets the tile's cone, or with
    ``sub`` each quarter's cone."""
    from ..accel import tiles

    axis_t, cos_t = cones(tile_rays(d, h, w, tp, False))
    axis, cos_half = cones(tile_rays(d, h, w, tp, True)) if sub else (axis_t, cos_t)
    keys = tiles.cone_cull_keys_batch(origin, axis_t, cos_t, state.cull_centers,
                                      state.cull_radii)
    k_cov = min(k_cov, keys.shape[1])
    cl_ids, cl_valid = tiles.shortlist(keys, k_cov)
    if sub:
        cl_ids = torch.repeat_interleave(cl_ids, 4, dim=0)
        cl_valid = torch.repeat_interleave(cl_valid, 4, dim=0)
    cs = state.cluster_size
    pids = (cl_ids[..., None] * cs + torch.arange(cs, device=cl_ids.device)).reshape(
        cl_ids.shape[0], k_cov * cs)
    pval = torch.repeat_interleave(cl_valid, cs, dim=-1)
    prims = state.prims
    prim_r = float(prims.extent) * torch.amax(prims.scales, dim=-1)
    c = prims.centers
    pr = torch.where(pval, prim_r[pids], -1.0)
    pkeys = tiles.cone_cull_keys_cols(origin, axis, cos_half, c[:, 0][pids], c[:, 1][pids],
                                      c[:, 2][pids], pr)
    return torch.isfinite(pkeys).sum(dim=-1), pval.sum(dim=-1)


def exact_reference(scene, o, d, chunk: int = 2048):
    """The exact-order integrator at max_depth EXACT_DEPTH on rays o, d."""
    from ..models import rf

    return rf.radiance(scene, None, o, d, rf.RFConfig(
        max_depth=EXACT_DEPTH, srgb_primitives=True, chunk_size=chunk))


def tile_mse(err2: np.ndarray, sel: np.ndarray, h: int, w: int, tp: int) -> np.ndarray:
    """Per-tile mean squared error [T] from the subsample pixels ``sel``
    (row-major indices) and their squared errors [n, 3]; 0 for a tile with
    no subsample pixel."""
    th, tw, n_ty, n_tx = tile_grid(h, w, tp)
    tid = (sel // w) // th * n_tx + (sel % w) // tw
    n = n_ty * n_tx
    s = np.bincount(tid, weights=err2.sum(axis=1), minlength=n)
    cnt = np.bincount(tid, minlength=n) * 3
    return np.divide(s, cnt, out=np.zeros(n), where=cnt > 0)


@torch.no_grad()
def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = studies.device_of(args.cpu)
    card = studies.card_line(dev)
    from ..models import rf_tiled
    from ..scene import generate_rays, synthetic

    scene = synthetic.make_scene(args.prims, device=dev)
    camera = synthetic.headline_camera(args.width)
    h = w = args.width
    tp = args.tp
    cfg = config(args.mc, tp, args.cs)
    state = rf_tiled.build_state(scene, cfg)
    _, _, n_ty, n_tx = tile_grid(h, w, tp)
    n_tiles = n_ty * n_tx
    k_cl = args.mc // args.cs
    origin = torch.as_tensor(camera.to_world[:3, 3], dtype=torch.float32, device=dev)
    o, d = generate_rays(camera, jitter=False, device=dev)
    res = dict(tool="analyze_rf", prims=args.prims, width=args.width, tp=tp, mc=args.mc,
               cs=args.cs, device=dev.type, card=card)

    # ---- per-tile need against the budget ----------------------------------
    n_fin = need(state, origin, *cones(tile_rays(d, h, w, tp, False))).cpu().numpy()
    q = np.percentile(n_fin, [10, 50, 90, 99])
    res["need"] = dict(k_cl=k_cl, mean=float(n_fin.mean()), p10=float(q[0]), p50=float(q[1]),
                       p90=float(q[2]), p99=float(q[3]), max=int(n_fin.max()),
                       over_budget=float((n_fin > k_cl).mean()), sum=int(n_fin.sum()),
                       budget_sum=k_cl * n_tiles)
    print(f"n_finite clusters/tile (k_cl budget {k_cl}): mean {n_fin.mean():.0f}"
          f" p10 {q[0]:.0f} p50 {q[1]:.0f} p90 {q[2]:.0f} p99 {q[3]:.0f}"
          f" max {n_fin.max()} | tiles over budget: {(n_fin > k_cl).mean():.1%}"
          f" | sum {n_fin.sum()} vs budget sum {k_cl * n_tiles}", flush=True)

    # ---- subtile survival --------------------------------------------------
    n_fin_sub = need(state, origin, *cones(tile_rays(d, h, w, tp, True))).cpu().numpy()
    surv = n_fin_sub.reshape(n_tiles, 4).sum(axis=1) / np.maximum(4 * n_fin, 1)
    big = n_fin > 8
    res["subtile"] = dict(
        survival_mean=float(surv[big].mean()) if big.any() else None,
        n_fin_sub_mean=float(n_fin_sub.mean()),
        n_fin_sub_p90=float(np.percentile(n_fin_sub, 90)),
        pair_ratio=float(n_fin_sub.sum() / max(4 * n_fin.sum(), 1)))
    sub = res["subtile"]
    print(f"subtile(8x8) survival of tile clusters: mean"
          f" {sub['survival_mean'] if big.any() else float('nan'):.1%} (tiles with n_fin>8);"
          f" subtile n_fin mean {sub['n_fin_sub_mean']:.0f}"
          f" p90 {sub['n_fin_sub_p90']:.0f}"
          f" | pair ratio subtile/tile {sub['pair_ratio']:.2f}", flush=True)

    # ---- primitive survival inside the culled-in clusters -----------------
    live_t, tot_t = (x.cpu().numpy() for x in prim_survival(state, origin, d, h, w, tp, False))
    live_s, _ = (x.cpu().numpy() for x in prim_survival(state, origin, d, h, w, tp, True))
    res["prims_in_clusters"] = dict(
        tile=float(live_t.sum() / max(tot_t.sum(), 1)), live_tile_mean=float(live_t.mean()),
        total_tile_mean=float(tot_t.mean()), subtile=float(live_s.sum() / max(4 * tot_t.sum(), 1)),
        live_subtile_mean=float(live_s.mean()))
    pc = res["prims_in_clusters"]
    print(f"prim-in-cluster survival: tile {pc['tile']:.1%}"
          f" (live/tile mean {live_t.mean():.0f} of {tot_t.mean():.0f});"
          f" subtile(8x8) {pc['subtile']:.1%} (live/subtile mean {live_s.mean():.0f})",
          flush=True)

    # ---- quality by budget, against an exact reference made here ----------
    sel = studies.subsample(h * w, SUBSAMPLE_SEED)
    idx = torch.from_numpy(sel).to(dev)
    t0 = studies.clock(dev)
    exact = exact_reference(scene, o[idx], d[idx])
    exact_s = studies.clock(dev) - t0
    noise_db = studies.psnr(exact_reference(studies.permuted(scene), o[idx], d[idx]), exact)
    res["exact"] = dict(pixels=int(sel.size), max_depth=EXACT_DEPTH, seconds=exact_s,
                        noise_floor_db=noise_db)
    print(f"exact reference: {sel.size} pixels at max_depth {EXACT_DEPTH} in {exact_s:.2f} s"
          f" ({card}); noise floor (permuted primitives) {noise_db:.2f} dB", flush=True)

    def render(mc):
        """The frame's subsample pixels and the median ms of FRAME_REPS
        frames after it."""
        c = config(mc, tp, args.cs)
        st = rf_tiled.build_state(scene, c)
        img = rf_tiled.render_state(st, camera, c, None, spp=1, seed=0, jitter=False)
        ms = []
        for _ in range(FRAME_REPS):
            t0 = studies.clock(dev)
            rf_tiled.render_state(st, camera, c, None, spp=1, seed=0, jitter=False)
            ms.append(1e3 * (studies.clock(dev) - t0))
        return img.reshape(-1, 3)[idx], float(np.median(ms))

    (img_b, ms_b), (img_g, ms_g) = render(args.mc), render(4 * args.mc)
    exact_np = exact.cpu().numpy()
    mse_b = tile_mse((img_b.cpu().numpy() - exact_np) ** 2, sel, h, w, tp)
    mse_g = tile_mse((img_g.cpu().numpy() - exact_np) ** 2, sel, h, w, tp)
    delta = mse_b - mse_g  # quality recoverable with 4x budget
    tot = delta.sum()
    csum = np.cumsum(delta[np.argsort(-delta)]) / max(tot, 1e-12)
    top = {}
    for frac in FRACTIONS:
        m = max(1, int(n_tiles * frac))
        top[str(frac)] = float(csum[m - 1])
        print(f"top {frac:.0%} tiles hold {csum[m - 1]:.0%} of the recoverable MSE",
              flush=True)
    psnr_b, psnr_g = studies.psnr(img_b, exact), studies.psnr(img_g, exact)
    res["quality"] = {"psnr_db": {str(args.mc): psnr_b, str(4 * args.mc): psnr_g},
                      "frame_ms": {str(args.mc): ms_b, str(4 * args.mc): ms_g},
                      "top_tiles_share": top}
    print(f"PSNR vs exact: mc{args.mc} {psnr_b:.2f} dB | mc{4 * args.mc} {psnr_g:.2f} dB"
          f" (frames {ms_b:.1f} / {ms_g:.1f} ms, {card})", flush=True)
    signals = {}
    for name, sig in (
        ("n_finite", n_fin.astype(np.float64)),
        ("n_fin_over_budget", np.maximum(n_fin - k_cl, 0).astype(np.float64)),
    ):
        hit = delta[np.argsort(-sig)[: max(1, n_tiles // 8)]].sum() / max(tot, 1e-12)
        signals[name] = float(hit)
        print(f"signal {name}: top-12.5% tiles capture {hit:.0%} of recoverable MSE",
              flush=True)
    res["quality"]["signal_capture"] = signals
    if args.save:
        np.savez(args.save, n_fin=n_fin, n_fin_sub=n_fin_sub, mse_b=mse_b, mse_g=mse_g)
    return studies.emit(res)


if __name__ == "__main__":
    main()
