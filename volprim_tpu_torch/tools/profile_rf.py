"""Per-stage timing of the tiled rf frame on the bench workload.

The port of tools/profile_rf.py. It splits the bench frame (512^2, spp 2,
the 262,144-primitive synthetic surface scene, fused backend) into:

  full           the whole render_state frame
  in_cull_nosel  the frame stopped after the cull, with the shortlist's
                 top-k replaced by the first k (in_cull minus this is the
                 selection's cost)
  in_cull, in_pack, in_gather_pf, in_gather
                 the frame stopped after that stage (rf_tiled._DEBUG_STOP)
  nokernel       the frame with the compositor replaced by a stub that keeps
                 its inputs alive (cull + pack + gathers + refine plumbing)
  cull           the two-level cone cull alone (shortlists of every tile)
  cull_coarse    its strip stage alone (supercluster keys + shortlist)
  gather         the cluster gathers of one frame's shortlists alone
  kernel         composite3.composite_tiles3 alone over the gathered blocks
                 (early exit on, no compaction, as JAX's kernel stage)
  clone          the DMA-floor probe of the same call shape (kernels/clone)
  segstats       the compositor's walked and live segments per tile
  abl_<name>     the kernel stage with one of the TPU kernel's timing
                 ablations compiled into the CUDA forward
                 (composite3.ABLATIONS: nodepth, noemis, notrans, nocum,
                 noop, noop2, static, fori); on the card only, and their
                 results are wrong by design

Each stage runs once to warm up, then ``--reps`` times with a new seed each
time, ``torch.cuda.synchronize()`` around each rep; the minimum is
reported. Runs on the card, or with ``--cpu`` on the CPU.

Usage: python -m volprim_tpu_torch.tools.profile_rf [--reps 4]
       [--stages full,nokernel,...] [--cpu] [...]

What is not ported exits with its ROADMAP.md item: ``--feat_major`` and
``--kernel_batch`` other than 1 (TPU layout knobs).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..kernels.composite3 import ABLATIONS
from . import studies

# the bench scene and film (tests shrink them)
N_PRIMS = 262144
WIDTH = 512

STAGES = ("full", "in_cull_nosel", "in_cull", "in_pack", "in_gather_pf", "in_gather",
          "nokernel", "cull", "cull_coarse", "gather", "kernel", "clone", "segstats")
# the kernel stage with a timing ablation compiled in (card only)
ABL_STAGES = tuple(f"abl_{name}" for name in ABLATIONS)


def _timeit(fn, seeds, reps, dev):
    """(min seconds, all seconds) of fn(seed) over reps seeds, each run
    ended by a device synchronisation and a host read of its scalar."""
    ts = []
    for i in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(seeds + i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        float(out)
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts)), ts


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--stages", default="full,nokernel,cull,gather,kernel")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tile_pixels", type=int, default=256)
    ap.add_argument("--max_candidates", type=int, default=2048)
    ap.add_argument("--cluster_size", type=int, default=16)
    ap.add_argument("--refine", type=float, default=0.125)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--kernel_batch", type=int, default=1)
    ap.add_argument("--coarse_group", type=int, default=4)
    ap.add_argument("--coarse_factor", type=int, default=8)
    ap.add_argument("--super_group", type=int, default=4)
    ap.add_argument("--segment", type=int, default=0)
    ap.add_argument("--compact", action="store_true")
    ap.add_argument("--classes", default="",
                    help="budget classes 'frac:k,...' (bench.py BENCH_CLASSES syntax)")
    ap.add_argument("--feat_major", action="store_true",
                    help="TPU layout knob; not ported")
    return ap


def config(args):
    """The frame's RFTiledConfig for the parsed ``args``."""
    from ..models import rf_tiled

    classes = tuple(
        (float(p.split(":")[0]), int(p.split(":")[1])) for p in args.classes.split(",") if p
    )
    return rf_tiled.RFTiledConfig(
        max_depth=128, tile_pixels=args.tile_pixels,
        max_candidates=args.max_candidates,
        segment=(args.segment or min(256, args.max_candidates)),
        cluster_size=args.cluster_size, backend="fused", early_exit=True,
        coarse_group=args.coarse_group,
        refine_fraction=0.0 if classes else args.refine,
        refine_factor=4, coarse_factor=args.coarse_factor, super_group=args.super_group,
        kernel_compact=args.compact, budget_classes=classes,
    )


@torch.no_grad()
def main(argv=None) -> dict:
    """Run the requested stages; returns {stage: ms}."""
    args = _parser().parse_args(argv)
    stages = [st for st in args.stages.split(",") if st]
    for st in stages:
        if st in ABL_STAGES and args.cpu:
            raise SystemExit(
                f"stage {st} times a variant of the CUDA kernel "
                "(csrc/composite3_fwd_abl.cu) and needs the card: drop --cpu"
            )
        if st not in STAGES + ABL_STAGES:
            raise SystemExit(f"unknown stage {st!r}; the stages are "
                             f"{', '.join(STAGES + ABL_STAGES)}")
    if args.feat_major:
        raise SystemExit("--feat_major is a TPU layout knob with no counterpart in the "
                         "port (ROADMAP.md §D)")
    if args.kernel_batch != 1:
        raise SystemExit("--kernel_batch is a TPU grid knob with no counterpart in the "
                         "port (ROADMAP.md §D)")
    dev = studies.device_of(args.cpu)

    from ..accel import tiles as tiling
    from ..kernels import clone as clone_mod
    from ..kernels import composite3
    from ..models import rf_tiled
    from ..scene import generate_rays, synthetic

    cfg = config(args)
    cam = synthetic.headline_camera(WIDTH)
    scene = synthetic.make_scene(N_PRIMS, device=dev)
    state = rf_tiled.build_state(scene, cfg)
    spp = args.spp
    results = {}

    def report(name, sec, ts):
        results[name] = sec * 1e3
        print(f"{name:10s} {sec * 1e3:8.1f} ms   (reps: "
              + ", ".join(f"{t * 1e3:.1f}" for t in ts) + ")", flush=True)

    def frame_sum(s):
        return rf_tiled.render_state(state, cam, cfg, None, spp=spp, seed=s).sum()

    def timed_frame(name, seeds):
        frame_sum(0)
        report(name, *_timeit(frame_sum, seeds, args.reps, dev))

    if "full" in stages:
        timed_frame("full", 100)

    if "in_cull_nosel" in stages:
        # the cull with its top-k replaced by the first k
        real_sl = tiling.shortlist
        rf_tiled._DEBUG_STOP = "cull"
        try:
            tiling.shortlist = lambda keys, k: (
                torch.arange(k, device=keys.device).expand(keys.shape[:-1] + (k,)),
                torch.isfinite(keys[..., :k]),
            )
            timed_frame("in_cull_nosel", 800)
        finally:
            tiling.shortlist = real_sl
            rf_tiled._DEBUG_STOP = None

    # ---- in-frame stage stops (the real pipeline, stopped early) ---------
    for stop in ("cull", "pack", "gather_pf", "gather"):
        if f"in_{stop}" in stages:
            rf_tiled._DEBUG_STOP = stop
            try:
                timed_frame(f"in_{stop}", 700)
            finally:
                rf_tiled._DEBUG_STOP = None

    if "nokernel" in stages:
        real = composite3.composite_tiles3

        def stub(d8, pf, sh3, n_seg_t, *a, **k):
            t, _, rt = d8.shape
            # cheap, but keeps pf/sh3/d8/n_seg_t alive as inputs
            l0 = (pf.sum(dim=(1, 2)) * 1e-12 + sh3.float().sum(dim=(1, 2)) * 1e-12
                  + d8.sum(dim=(1, 2)) * 1e-12 + n_seg_t.float() * 1e-12)
            return (l0[:, None, None].expand(t, rt, 3),
                    torch.ones((t, rt), dtype=torch.float32, device=d8.device))

        composite3.composite_tiles3 = stub
        try:
            timed_frame("nokernel", 200)
        finally:
            composite3.composite_tiles3 = real

    # ---- shared geometry for the standalone stages -----------------------
    h = w = cam.width
    tp = cfg.tile_pixels
    th = int(tp ** 0.5)
    while tp % th or h % th:
        th -= 1
    tw = tp // th
    n_ty, n_tx = h // th, w // tw
    n_tiles = n_ty * n_tx
    origin = torch.as_tensor(cam.to_world[:3, 3], dtype=torch.float32, device=dev)
    cs = cfg.cluster_size
    k_cl = max(1, cfg.max_candidates // cs)
    gc = cfg.coarse_group
    n_coarse = n_tiles // gc

    def tile_cones(seed):
        """Row-major tiles' ray directions [T, RT, 3], unit axes and cosines
        of their half-angles, and their strips' axes and cosines."""
        _, d = generate_rays(cam, jitter=False, device=dev)
        d = d + float(seed) * 1e-12
        d = d.reshape(n_ty, th, n_tx, tw, 3).permute(0, 2, 1, 3, 4).reshape(n_tiles, tp, 3)
        ax = d.mean(dim=1)
        axis = ax / torch.linalg.norm(ax, dim=-1, keepdim=True)
        cos_half = torch.amin(torch.einsum("tri,ti->tr", d, axis), dim=1)
        ax_g = axis.reshape(n_coarse, gc, 3)
        c_axis = ax_g.mean(dim=1)
        c_axis = c_axis / torch.linalg.norm(c_axis, dim=-1, keepdim=True)
        cosb = torch.einsum("cgi,ci->cg", ax_g, c_axis)
        ang = torch.arccos(torch.clamp(cosb, -1, 1)) + torch.arccos(
            torch.clamp(cos_half.reshape(n_coarse, gc), -1, 1)
        )
        return d, axis, cos_half, c_axis, torch.cos(torch.amax(ang, dim=1))

    def strip_shortlists(c_axis, c_cos):
        keys_s = tiling.cone_cull_keys_batch(origin, c_axis, c_cos, state.sup_centers,
                                             state.sup_radii)
        k_sup = min(max(1, -(-cfg.coarse_factor * k_cl // state.super_group)),
                    state.sup_centers.shape[0])
        return tiling.shortlist(keys_s, k_sup)

    def cull(seed):
        """Two-level cone cull (the shapes of rf_tiled's). Returns (cl_ids
        [T, K], cl_valid [T, K], axis [T, 3], d [T, RT, 3])."""
        d, axis, cos_half, c_axis, c_cos = tile_cones(seed)
        sup_ids, sup_valid = strip_shortlists(c_axis, c_cos)
        sg = state.super_group
        ncl_total = state.cull_centers.shape[0]
        k_sup = sup_ids.shape[1]
        offs_s = torch.arange(sg, device=dev)
        cl_c = (sup_ids[..., None] * sg + offs_s).reshape(n_coarse, k_sup * sg)
        cl_cv = sup_valid[..., None].expand(n_coarse, k_sup, sg).reshape(
            n_coarse, k_sup * sg) & (cl_c < ncl_total)
        cl_c = torch.clamp(cl_c, max=ncl_total - 1)
        cc = [state.cull_centers[:, i][cl_c] for i in range(3)]
        ccr = torch.where(cl_cv, state.cull_radii[cl_c], -1.0)

        def rep_(a):
            return torch.repeat_interleave(a, gc, dim=0)

        keys = tiling.cone_cull_keys_cols(origin, axis, cos_half, *(rep_(c) for c in cc),
                                          rep_(ccr))
        loc_ids, cl_valid = tiling.shortlist(keys, min(k_cl, k_sup * sg))
        return torch.gather(rep_(cl_c), 1, loc_ids), cl_valid, axis, d

    if "cull" in stages:
        def cull_sum(s):
            ci, cv, _, _ = cull(s)
            return ci.sum() + cv.sum()

        cull_sum(0)
        report("cull", *_timeit(cull_sum, 300, args.reps, dev))

    if "cull_coarse" in stages:
        # the coarse strip stage alone (keys + shortlist)
        def coarse_sum(s):
            sup_ids, sup_valid = strip_shortlists(*tile_cones(s)[3:])
            return sup_ids.sum() + sup_valid.sum()

        coarse_sum(0)
        report("cull_coarse", *_timeit(coarse_sum, 600, args.reps, dev))

    abl_stages = [st for st in stages if st in ABL_STAGES]
    if {"gather", "kernel", "clone", "segstats"} & set(stages) or abl_stages:
        # real culled shortlists for one frame, gathered once
        ci, cv, _, d_t = cull(0)
        ptab = composite3.pack_fused_features(state.prims, origin)
        ncl = state.prims.num_prims // cs
        s_here = k_cl * cs
        neutral = composite3.neutral_fused_row(dev)
        ptab_rows = ptab.reshape(16, ncl, cs).permute(1, 0, 2).reshape(ncl, 16 * cs)

        def gather(ci, cv, seed):
            ci = ci + (seed - seed)  # seed-dependence for the timer
            valid_row = torch.repeat_interleave(cv, cs, dim=-1)
            pf_t = (ptab_rows[ci.reshape(-1)].reshape(n_tiles, k_cl, 16, cs)
                    .permute(0, 2, 1, 3).reshape(n_tiles, 16, s_here))
            pf_t = torch.where(valid_row[:, None, :], pf_t, neutral[None, :, None])
            k_live = state.sh_k
            sh_t = (state.shrows[ci.reshape(-1)].reshape(n_tiles, k_cl, 3 * k_live, cs)
                    .permute(0, 2, 1, 3).reshape(n_tiles, 3 * k_live, s_here))
            return pf_t, sh_t

        if "gather" in stages:
            def gather_sum(s):
                pf_t, sh_t = gather(ci, cv, s)
                return pf_t.sum() + sh_t.float().sum()

            gather_sum(0)
            report("gather", *_timeit(gather_sum, 500, args.reps, dev))

        pf_t, sh_t = gather(ci, cv, 0)
        n_seg_t = (-(-(cv.sum(dim=-1) * cs) // cfg.segment)).to(torch.int32)
        d8 = torch.cat([d_t.permute(0, 2, 1), torch.zeros((n_tiles, 5, tp), device=dev)],
                       dim=1).contiguous()
        # JAX's kernel stage: early exit on, no compaction (tools/profile_rf.py:372-376)
        kw = dict(seg=cfg.segment, extent2=9.0, max_depth=128, beta_kill=0.01,
                  sh_k=state.sh_k, early_exit=True)

    if "kernel" in stages:
        def kern(s):
            l, beta = composite3.composite_tiles3(d8 + float(s) * 1e-12, pf_t, sh_t,
                                                  n_seg_t, **kw)
            return l.sum() + beta.sum()

        kern(0)
        report("kernel", *_timeit(kern, 400, args.reps, dev))

    for st in abl_stages:
        def kern_abl(s, abl=st[len("abl_"):]):
            l, beta, _, _ = composite3.forward3_ablated(abl, d8 + float(s) * 1e-12, pf_t, sh_t,
                                                        n_seg_t, **kw)
            return l.sum() + beta.sum()

        kern_abl(0)
        report(st, *_timeit(kern_abl, 450, args.reps, dev))

    if "clone" in stages:
        ut = torch.triu(torch.ones((cfg.segment, cfg.segment), device=dev))

        def clone_sum(s):
            return clone_mod.clone(n_seg_t, d8 + float(s) * 1e-12, pf_t, sh_t, ut).sum()

        clone_sum(0)
        report("clone", *_timeit(clone_sum, 350, args.reps, dev))

    if "segstats" in stages:
        if "kernel" not in stages:
            raise SystemExit("segstats needs the kernel stage data")
        _, beta, walked, live = composite3.forward3(d8, pf_t, sh_t, n_seg_t, **kw)
        walked, live = walked.cpu().numpy(), live.cpu().numpy()
        unsat = (beta > 0.01).float().mean(dim=1).cpu().numpy()
        print(
            f"segstats: walked mean {walked.mean():.2f} p50"
            f" {np.percentile(walked, 50):.0f} p90"
            f" {np.percentile(walked, 90):.0f} max {walked.max():.0f} |"
            f" live mean {live.mean():.2f} | walked/live"
            f" {walked.sum() / max(live.sum(), 1):.2%} |"
            f" unsat rays/tile mean {unsat.mean():.2%}",
            flush=True,
        )

    print("summary:", {k: round(v, 1) for k, v in results.items()}, flush=True)
    return results


if __name__ == "__main__":
    main()
