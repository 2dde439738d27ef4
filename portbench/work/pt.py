"""Operations and bytes of a path-traced frame, from the counts that
``reference.pt.trace`` takes on its own rays (per bounce the live rays,
the shadow rays, the rays walked and the walk's work), scaled from the
sampled rays to the frame.

- ``OPS_PT_PAIR``: f32 operations per (ray, primitive) pair of the optical
  depth and of the interval collection: tomography's pair (``work/tomo``'s
  ``OPS_TOMO_PAIR``: the local frame, a and t*, q_min, the extent test, the
  integral and its scrub, the weighted sum) plus the segment's bounds: 1 /
  sqrt(2a) 2, the two erf arguments 6, two erff at ``OPS_ERFF`` each and
  their difference 1. Of these, ``OPS_PT_TEST`` (the local frame 45, a and
  t* 12, q_min 11, the extent test 11) is needed on every pair: every live
  ray's escape test and every shadow ray meet every primitive, and so does
  every walked ray's collection. The rest, ``OPS_PT_HIT``, only on the
  pairs whose extents meet ahead of the ray, as the reference counts them:
  a kernel that skips the misses needs no more. The sort of the
  collection is not counted.
- The walk (``csrc/ffwalk.cu``; the constants of the port's chip_smoke.py):
  per interval its selection scans ``OPS_SELECT``, per erf term
  ``OPS_ERF_TERM``: two terms per selected interval, and in the window
  where a ray is found bisect_iters + 1 + 1 + solver_iters terms per
  selected interval. Bytes: entry and exit of the longest prefix of each
  row that a window scans, cp, alpha and beta of the intervals a window
  selects, four [R] floats and the active byte read once; four flag bytes
  and t_samp written once.

The frame's bytes outside the walk (each ray's origin and direction, the
4,096 primitives) are some MB, far below its operations' time.
"""

from . import least_time
from .tomo import OPS_TOMO_PAIR

OPS_ERFF = 20
OPS_PT_PAIR = OPS_TOMO_PAIR + 2 + 6 + 2 * OPS_ERFF + 1
OPS_PT_TEST = 45 + 12 + 11 + 11
OPS_PT_HIT = OPS_PT_PAIR - OPS_PT_TEST
OPS_SELECT = 3
OPS_ERF_TERM = OPS_ERFF + 8
BISECT_ITERS = 22


def walk_bound(work: dict, rays: float, solver_iters: int, scale: float) -> dict:
    """The least time of one bounce's walk: ``work`` as ``reference.pt.walk``
    counts it over ``rays`` walked rays, times ``scale``."""
    nbytes = (work.get("scanned_max", 0) * 2 * 4 + work.get("selected_union", 0) * 3 * 4
              + rays * (4 * 4 + 1) + rays * (4 + 4))
    per_found = BISECT_ITERS + 1 + 1 + solver_iters
    ops = (work.get("scanned", 0) * OPS_SELECT
           + (2 * work.get("selected", 0) + per_found * work.get("selected_found", 0))
           * OPS_ERF_TERM)
    return least_time(ops * scale, nbytes * scale)


def frame_work(counts: dict, scale: float, n_prims: int, integrator: dict) -> dict:
    """{"pt_frame", "ffwalk"} least times of one frame from
    ``reference.pt.trace``'s counts on a sample of its rays, each sampled
    ray standing for ``scale`` rays. The walk's is the sum over bounces of
    each bounce's walk (a launch or more a bounce)."""
    bounces = counts.get("bounces", [])
    walks = [walk_bound(b, b["walked"], integrator["solver_max_iterations"], scale)
             for b in bounces if b["walked"]]
    walk = {key: sum(w[key] for w in walks) for key in ("seconds", "ops", "bytes")}
    walk["bound_by"] = "bytes" if sum(
        w["seconds"] for w in walks if w["bound_by"] == "bytes") >= walk["seconds"] / 2 \
        else "operations"
    pairs = sum((b["live"] + b["shadow"] + b["walked"]) * n_prims for b in bounces) * scale
    hits = sum(b["live_hits"] + b["shadow_hits"] + b["walked_hits"] for b in bounces) * scale
    rays = sum(b["live"] + b["shadow"] for b in bounces) * scale
    pair = least_time(pairs * OPS_PT_TEST + hits * OPS_PT_HIT, rays * 6 * 4 + n_prims * 14 * 4)
    frame = {"seconds": pair["seconds"] + walk["seconds"], "ops": pair["ops"] + walk["ops"],
             "bytes": pair["bytes"] + walk["bytes"], "pairs": pairs, "hits": hits,
             "ray_bounces": sum(b["live"] for b in bounces) * scale}
    return {"pt_frame": frame, "ffwalk": walk}


def total(works: list) -> dict:
    """The sum over the traced frames of :func:`frame_work`'s least times."""
    out = {}
    for w in works:
        for key, part in w.items():
            acc = out.setdefault(key, {})
            for k, v in part.items():
                acc[k] = acc.get(k, 0) + v if not isinstance(v, str) else v
    return out
