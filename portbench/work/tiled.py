"""Operations and bytes of the fused compositor's forward and backward,
from the counts that ``reference.tiled`` takes over its own shortlists.

The constants are those of the port's chip_smoke.py (its ``work``), with
their reasons:

- ``OPS_PAIR``: f32 operations per (ray, column) pair that a tile needs,
  its rays against the columns that meet its ray cone, the pair math every
  such pair runs: a 11, b 5, t* 1, p 6, q 14, the clamp 1, the hit
  test 2.
- per hit under the cap, the forward adds alpha 3, the cap 1, w 2,
  emission 6k + 9 and log1p 2 (``ops_hit_fwd``: 17 + 6k);
- the backward adds alpha 3, emission 6k + 3, g_w and w 7, the carries 4,
  g_alpha, g_raw and g_q 9, the p, t*, a, b adjoints 31, the 13 rows 28,
  SH 3 + 3k, the sum over rays 13 + 3k and log1p 2 (``ops_hit_bwd``:
  103 + 12k).

Bytes: each input byte once and each output byte once. The rays' rows
(8 f32 a ray, one int32 a tile) and each live column once (16 f32 rows
and 3k bf16 SH rows); the forward writes L and beta (4 f32 a ray), the
backward reads L's and beta's cotangents (4 f32 a ray) and writes every
column's adjoints (16 f32 and 3k bf16).
"""

from . import least_time

OPS_PAIR = 40


def ops_hit_fwd(k: int) -> int:
    return 17 + 6 * k


def ops_hit_bwd(k: int) -> int:
    return 103 + 12 * k


def launch_bounds(call: dict) -> dict:
    """{"fwd": least_time, "bwd": least_time} of one compositor call's
    counts (``reference.tiled.render``'s ``counts`` entries)."""
    t, r, s, k = call["t"], call["r"], call["s"], call["sh_k"]
    col_bytes = 16 * 4 + 3 * k * 2
    rays_in = t * 8 * r * 4 + t * 4
    fwd_bytes = rays_in + call["fwd_live"] * col_bytes + t * r * 4 * 4
    bwd_bytes = rays_in + call["bwd_live"] * col_bytes + t * r * 4 * 4 + t * s * col_bytes
    fwd_ops = call["fwd_stream"] * r * OPS_PAIR + call["fwd_hits"] * ops_hit_fwd(k)
    bwd_ops = call["bwd_stream"] * r * OPS_PAIR + call["bwd_hits"] * ops_hit_bwd(k)
    return {"fwd": least_time(fwd_ops, fwd_bytes), "bwd": least_time(bwd_ops, bwd_bytes)}


def total(calls: list, kind: str) -> dict:
    """The least time of ``kind`` ("fwd" or "bwd") summed over calls, and
    what bounds most of it."""
    parts = [launch_bounds(c)[kind] for c in calls]
    secs = sum(p["seconds"] for p in parts)
    by_ops = sum(p["seconds"] for p in parts if p["bound_by"] == "operations")
    return {"seconds": secs, "bound_by": "operations" if by_ops >= secs / 2 else "bytes",
            "launches": len(parts), "ops": sum(p["ops"] for p in parts),
            "bytes": sum(p["bytes"] for p in parts)}
