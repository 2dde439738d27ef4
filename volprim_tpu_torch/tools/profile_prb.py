"""Cost decomposition of the path-traced plume frame.

The port of tools/profile_prb.py. The scene is the 4096-primitive plume
(``scene.synthetic.make_medium``, sigma_t x 10) under
``ops.envmap.procedural_sky()``, seen by JAX's profiler camera (from
(-4, -0.3, 0), fov 40) at ``--res`` square, 1 spp, with JAX's base
configuration (bounce_cap 32, max_overlaps 8, max_windows 16,
collect_budget 128, brute collection). It prints one line a row:

  the configuration sweep, each the whole frame (models.render with
  prb.radiance): full (bench cfg), walk=pallas, walk=pallas exact,
  coeff=gemm, no_nee, windows=4, overlaps=4, budget=64, bounces=8,
  bounces=16, solver=disabled, compact=2048, compact=4096 (``--quick``:
  the first only). The walk=pallas rows launch the walk kernel
  csrc/ffwalk.cu on CUDA tensors and print kernels.ffwalk.walk's launches
  in their timed runs; compact_chunk is the JAX package's static-shape
  compaction, which the port does not have, so the compact rows time the
  base frame again;
  the stages alone on the camera rays: collect_65k (interval collection),
  transmittance_65k, free_flight_65k (xi uniform in [1e-7, 1) from a
  seeded torch.Generator), ff_allescape_65k (xi = 1e-30: every ray
  escapes in closed form) and ff_allcross_65k (xi = 1 - 1e-7: every ray
  is walked);
  window stats bounce 0: the intervals open per camera ray (p50, p90,
  max), the rays still unresolved entering each window of the xla walk,
  and the share found;
  summary: every row's minimum in ms.

Each row runs once to warm up, then ``--reps`` times with a new seed each
time, ``torch.cuda.synchronize()`` around each rep and a host read of its
scalar; the minimum is reported. Runs on the card, or with ``--cpu`` on
the CPU (shrink ``--res`` there).

Usage: python -m volprim_tpu_torch.tools.profile_prb [--reps 3] [--quick]
       [--res 256] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from . import studies
from .profile_rf import _timeit

# JAX's profiler configuration (tools/profile_prb.py:53-56)
BASE = dict(max_depth=-1, bounce_cap=32, max_overlaps=8, max_windows=16, collect_budget=128,
            use_clusters=False)
# the configuration sweep: (row name, fields over BASE)
SWEEP = (
    ("full (bench cfg)", {}),
    ("walk=pallas", dict(walk_backend="pallas")),
    ("walk=pallas exact", dict(walk_backend="pallas", max_overlaps=128, max_windows=1)),
    ("coeff=gemm", dict(coeff_gemm=True)),
    ("no_nee", dict(use_nee=False)),
    ("windows=4", dict(max_windows=4)),
    ("overlaps=4", dict(max_overlaps=4)),
    ("budget=64", dict(collect_budget=64)),
    ("bounces=8", dict(bounce_cap=8)),
    ("bounces=16", dict(bounce_cap=16)),
    ("solver=disabled", dict(solver_type="disabled")),
    ("compact=2048", dict(compact_chunk=2048)),
    ("compact=4096", dict(compact_chunk=4096)),
)
STAGES = ("collect_65k", "transmittance_65k", "free_flight_65k", "ff_allescape_65k",
          "ff_allcross_65k")


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--res", type=int, default=256,
                    help="film side; shrink for runs on the CPU")
    ap.add_argument("--rows", default="",
                    help="comma-separated sweep rows to run after the first (default: all, "
                         "or none with --quick)")
    return ap


def plume(dev):
    """The profiled medium: the plume with sigma_t x 10."""
    from ..scene import synthetic

    medium = synthetic.make_medium(4096, seed=0, device=dev)
    return dataclasses.replace(
        medium, attrs={**medium.attrs, "sigma_t": medium.attrs["sigma_t"] * 10.0})


def camera(res):
    """JAX's profiler camera at ``res`` square."""
    from ..scene import CameraSpecs, look_at

    return CameraSpecs(name="prb", width=res, height=res,
                       to_world=look_at([-4.0, -0.3, 0.0], [0, 0, 0], [0, 1, 0]), fov=40.0)


def uniform_xi(r, dev, seed=0):
    """xi uniform in [1e-7, 1) from a seeded generator, as prb draws it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return 1e-7 + (1.0 - 1e-7) * torch.rand((r,), generator=gen, device=dev)


def flight_sum(out):
    """A scalar that reads every output of free_flight."""
    found, _, t_samp, albedo, s1, s2 = out
    return (torch.sum(torch.where(found, t_samp, 0.0)) + albedo.sum() + s1.sum() + s2.sum())


@torch.no_grad()
def main(argv=None) -> dict:
    """Run the rows; returns {row: ms}, with the window statistics under
    "window_stats" and the walk kernel's launches per walk=pallas row under
    "walk_launches"."""
    args = _parser().parse_args(argv)
    dev = studies.device_of(args.cpu)
    from ..kernels import ffwalk
    from ..models import prb, render
    from ..ops import envmap
    from ..scene import generate_rays

    medium = plume(dev)
    sky = envmap.procedural_sky(device=dev)
    pcam = camera(args.res)
    results, launches = {}, {}

    def run_cfg(name, **kw):
        cfg = prb.PRBConfig(**{**BASE, **kw})

        def frame_sum(s):
            gen = torch.Generator(device=dev).manual_seed(int(s))
            return render(medium, pcam, prb.radiance, cfg, sky, spp=1, generator=gen).sum()

        t0 = time.perf_counter()
        float(frame_sum(0))
        first = time.perf_counter() - t0
        ffwalk.walk.launches = 0
        sec, ts = _timeit(frame_sum, 1, args.reps, dev)
        results[name] = sec * 1e3
        extra = ""
        if cfg.walk_backend == "pallas":
            launches[name] = ffwalk.walk.launches
            extra = f"  ffwalk.walk launches {ffwalk.walk.launches}"
        print(f"{name:28s} {sec * 1e3:8.1f} ms  (first {first:.1f} s; reps: "
              + ", ".join(f"{t * 1e3:.1f}" for t in ts) + ")" + extra, flush=True)

    rows = [name for name, _ in SWEEP]
    if args.rows:
        wanted = [r_ for r_ in args.rows.split(",") if r_]
        unknown = set(wanted) - set(rows)
        if unknown:
            raise SystemExit(f"unknown rows {sorted(unknown)}; the rows are {', '.join(rows)}")
        rows = [rows[0]] + [r_ for r_ in rows[1:] if r_ in wanted]
    elif args.quick:
        rows = rows[:1]
    for name, kw in SWEEP:
        if name in rows:
            run_cfg(name, **kw)

    # ---- the stages alone on the camera rays --------------------------------
    o, d = generate_rays(pcam, jitter=False, device=dev)
    r = o.shape[0]
    cfg = prb.PRBConfig(**BASE)
    active = torch.ones((r,), dtype=torch.bool, device=dev)

    def collect(s):
        e, _, _, tb, _ = prb._collect_intervals(medium, None, o + s * 1e-12, d, cfg)
        return (torch.sum(torch.where(torch.isfinite(e), e, 0.0))
                + torch.sum(torch.where(torch.isfinite(tb), tb, 0.0)))

    def trans(s):
        return prb.transmittance(medium, o + s * 1e-12, d, cfg).sum()

    xi_rand = uniform_xi(r, dev)

    def flight(xi):
        return lambda s: flight_sum(prb.free_flight(medium, o + s * 1e-12, d, xi, cfg, active))

    stage_fns = {
        "collect_65k": collect, "transmittance_65k": trans, "free_flight_65k": flight(xi_rand),
        "ff_allescape_65k": flight(torch.full((r,), 1e-30, device=dev)),
        "ff_allcross_65k": flight(torch.full((r,), 1.0 - 1e-7, device=dev)),
    }
    for name in STAGES:
        fn = stage_fns[name]
        float(fn(0))
        sec, ts = _timeit(fn, 1, args.reps, dev)
        results[name] = sec * 1e3
        print(f"{name:28s} {sec * 1e3:8.1f} ms  (reps: "
              + ", ".join(f"{t * 1e3:.1f}" for t in ts) + ")", flush=True)

    stats = window_stats(prb, medium, o, d, xi_rand, cfg)
    print("window stats bounce 0:", stats, flush=True)
    print("summary:", {k: round(v, 1) for k, v in results.items()}, flush=True)
    return dict(results, window_stats=stats, walk_launches=launches)


def window_stats(prb, prims, o, d, xi, cfg) -> dict:
    """free_flight's window loop on the sequential walk from t = 0 (the xla
    walk's windows over one collection): the intervals open per ray, the
    rays still unresolved entering each window, the share found (JAX's
    window_stats, the adaptive-capacity signal)."""
    from ..ops import quadric

    r = o.shape[0]
    k = cfg.max_overlaps
    sig_all = prims.attrs["sigma_t"][:, 0]
    sprod_all = prims.scale_prod()
    entry_all, exit_all, ids_all, t_budget, _ = prb._collect_intervals(prims, None, o, d, cfg)
    n_open = torch.isfinite(entry_all).sum(dim=1).cpu().numpy()
    t_min = torch.zeros((r,), dtype=o.dtype, device=o.device)
    trans = torch.ones_like(t_min)
    resolved = torch.zeros((r,), dtype=torch.bool, device=o.device)
    found = torch.zeros_like(resolved)
    active_per_window = []
    for _ in range(cfg.max_windows):
        active_per_window.append(int((~resolved).sum()))
        active = ~resolved
        entry, exit_t, sel, valid_sel, t_limit, has_more = prb._window_from_collected(
            entry_all, exit_all, t_min, k)
        ids = torch.gather(ids_all, 1, sel)
        coeffs = quadric.pair_coeffs_gathered(o, d, prims.centers, prims.scales, prims.quats,
                                              ids)
        sigma_t = torch.where(valid_sel, sig_all[ids], 0.0)
        t_limit = torch.minimum(t_limit, t_budget)
        full = has_more | torch.isfinite(t_budget)
        trans, found_w, _, _ = prb._free_flight_window(
            cfg.kernel, entry, exit_t, coeffs, sigma_t, sprod_all[ids], t_limit, trans, xi,
            active, cfg.solver_max_iterations, cfg.solver_type)
        new_found = active & found_w
        resolved = resolved | new_found | (active & ~found_w & ~full)
        t_min = torch.where(active & ~resolved, t_limit, t_min)
        found = found | new_found
    return {
        "intervals_open_p50": float(np.percentile(n_open, 50)),
        "intervals_open_p90": float(np.percentile(n_open, 90)),
        "intervals_open_max": float(n_open.max()),
        "active_entering_window": active_per_window,
        "found_frac": float(found.float().mean()),
    }


if __name__ == "__main__":
    main()
