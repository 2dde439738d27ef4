"""Volumetric-primitive path tracer with NEE (volprim_tpu.models.prb).

The JAX package's physically based scattering integrator, every
configuration of it. Per bounce, on the rays still alive:

1. **Surfaces** (with a ``mesh``): the nearest triangle hit caps the march
   (``scene.mesh.intersect``).
2. **Free flight** (:func:`free_flight`): a medium interaction is sampled
   by the exact inverse CDF of the multi-primitive density. Two paths:

   - the **jump path** (default: the unnormalized Gaussian kernel, brute
     collection, ``jump=True``): the complete optical depth F along each
     ray (:func:`optical_depth`) decides escape in closed form (chi =
     -log xi >= F). Only the rays that will cross, or hit a surface, are
     walked: their K' nearest [entry, exit) intervals are collected
     (:func:`_gather_intervals`), the walk jumps to the interval block
     where the cumulative whole-interval depth first reaches chi, and runs
     ``jump_windows`` windows from there;
   - the **sequential walk** (``jump=False``, ``use_clusters`` or a
     non-Gaussian kernel): the K' nearest intervals are collected once
     from t = 0 (:func:`_collect_intervals`: the brute streaming scan, or
     the Morton clusters of :func:`build_ff_index`), ``max_windows``
     windows walk them from t = 0, and rays pinned at the collection
     budget resume in up to ``collect_rounds - 1`` re-collection rounds
     from where they stopped (xla walk only).

   The windows run through one of two backends: ``walk_backend="xla"``
   (:func:`_run_windows`: per window, selection, gathers, the segment
   depths of :func:`_free_flight_window` and its bisection, all
   differentiable) or ``"pallas"`` (:func:`_run_windows_pallas`: the fused
   walk of ``kernels.ffwalk``, a hand-written CUDA kernel for CUDA
   tensors, whose stop-gradient decisions are followed by a differentiable
   post-pass at the sample point). The fused walk is for the Gaussian
   kernel only: every other kernel walks the xla path, as in the JAX
   package.
3. **Emitter hit** with MIS against the NEE pdf for escaping rays.
4. **NEE** from the medium or surface vertex: an emitter direction, its
   transmittance along the shadow ray (times the mesh's visibility), the
   phase function or BSDF value, MIS.
5. **Phase sampling** of the next direction, or **BSDF sampling** at a
   surface; Russian roulette; throughput kill.

Compaction is PyTorch's: each bounce indexes the live rays, free flight the
needy rays, each window of the xla walk the rays still walking, each
re-collection round the pending rays, directly, and scatters the results
back (the JAX package keeps static shapes with sorted fixed-size chunks and
skipped ``lax.cond``s; every ray's result is independent of its chunk, and a
skipped ray's carries stay as they were). The ``ray_chunk`` knob bounds the
[R, C] and [R, 2K - 1, K] temporaries.

Random numbers are counter-based (``ops.streams``): ``radiance`` takes one
key from its ``torch.Generator`` (on the device, no host read), and every
uniform a path uses is a hash of (key, the ray's index in the call, the
bounce, the slot): xi in [1e-7, 1) for free flight (slot 0), 2 uniforms for
NEE (1-2), 2 for the phase (3-4), 1 for Russian roulette (5) and 3 for the
BSDF's ``sample`` at a surface vertex (6-8). A ray's draws are therefore
the same bits whatever ``ray_chunk`` is, whichever other rays are live, and
on the CPU or the card; :func:`radiance_keyed` traces rays [a, b) of a call
given its key and a. They do not reproduce ``jax.random`` bits; everything
downstream of them is deterministic.

Spans (``utils.spans``, recorded only while a profiler runs):
``prb.radiance``, ``prb.bounce``, ``prb.free_flight``, ``prb.optical_depth``
(the escape test's and the shadow rays'), ``prb.collect`` (interval
collection), ``prb.walk`` (either window walk with its kernel launch) and
``prb.nee``; counters ``prb.ray_bounces`` (live rays entering each bounce),
``prb.depth_pairs`` (rows x primitives that :func:`optical_depth` evaluates,
padding included) and ``prb.walked_rays`` (rays handed to a walk).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..kernels import ffwalk
from ..ops import bsdf as bsdf_ops
from ..ops import kernels as kernel_ops
from ..ops import quadric, streams
from ..ops.kernels import Kernel
from ..scene import mesh as mesh_mod
from ..scene.ellipsoids import EllipsoidScene
from ..utils import spans
from . import register_integrator
from .base import pad_primitives

_BIG_T = 1e7  # effective infinity for shadow-ray segment integrals

# a bounce's uniforms by slot (module docstring): xi, NEE (2), phase (2),
# Russian roulette, the BSDF's lobe choice and direction (2)
_XI, _NEE, _PHASE, _RR, _BSDF1, _BSDF2 = 0, 1, 3, 5, 6, 7
N_SLOTS = 9

# Stage stop of free_flight for the stage profilers (tools/ff_attrib.py):
# None, or the stage after which free_flight returns early with
# :func:`_ff_stop_out`'s outputs: "collect" (the jump path's optical depth,
# or the sequential walk's interval collection), "escape" (the closed-form
# escape decision) or "sort" (the needy-ray compaction). Read at each call.
_FF_STOP = None


@dataclasses.dataclass(frozen=True)
class PRBConfig:
    """The JAX package's PRBConfig: every field, with the same defaults.
    See that class for what each field does."""

    max_depth: int = -1  # -1 = unlimited, capped by bounce_cap
    rr_depth: int = -1
    use_nee: bool = True
    use_indirect: bool = True
    hide_emitters: bool = False
    kernel_type: str = "gaussian"
    max_overlaps: int = 32  # interval-window size k
    max_windows: int = 8  # window continuations over the collected set
    solver_max_iterations: int = 4
    solver_type: str = "bisection"  # 'bisection' | 'disabled'
    phase: str = "isotropic"
    phase_g: float = 0.0  # Henyey-Greenstein g when phase == 'hg'
    bounce_cap: int = 64  # static bound when max_depth == -1
    chunk_size: int = 1024  # primitives per chunk of the streaming scans
    ray_chunk: int = 65536  # rays path-traced together
    compact_chunk: int = 1024  # (the JAX package's static-shape compaction)
    use_clusters: bool = False
    cluster_size: int = 32
    cluster_candidates: int = 0
    collect_budget: int = 0  # K'; 0 = max(256, max_overlaps * max_windows)
    collect_rounds: int = 8  # (non-jump walk only)
    tail_after: int = 1
    tail_overlaps: int = 0
    tail_windows: int = 0
    tail_budget: int = 0
    jump: bool = True
    jump_windows: int = 4
    ff_chunk: int = 8192  # (the JAX package's static-shape compaction)
    walk_backend: str = "xla"
    coeff_gemm: bool = False

    def tail_cfg(self) -> "PRBConfig":
        if not (self.tail_overlaps or self.tail_windows or self.tail_budget):
            return self
        return dataclasses.replace(
            self,
            max_overlaps=self.tail_overlaps or self.max_overlaps,
            max_windows=self.tail_windows or self.max_windows,
            collect_budget=self.tail_budget or self.collect_budget,
        )

    @property
    def kernel(self) -> Kernel:
        return Kernel(self.kernel_type, normalized=False, full_range=False)

    @property
    def num_bounces(self) -> int:
        return self.max_depth if self.max_depth > 0 else self.bounce_cap

    @property
    def interval_budget(self) -> int:
        """Intervals collected per ray per bounce (K')."""
        return self.collect_budget or max(256, self.max_overlaps * self.max_windows)

    @property
    def use_rr(self) -> bool:
        return 0 <= self.rr_depth < (self.max_depth if self.max_depth > 0 else 2**31)


def _mis_weight(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-30)
    return torch.where(pdf_a > 0.0, w, 0.0)


def _score_ratio(x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """``x / detach(x)``: numerically 1, but carries the score gradient
    ``grad(x) / x`` of a sampling density or survival probability."""
    safe = torch.where(active, x, 1.0)
    return torch.where(active, safe / torch.clamp(safe.detach(), min=1e-30), 1.0)


def _safe_rcp(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x != 0.0, 1.0 / torch.where(x == 0.0, 1.0, x), 0.0)


def _padded_chunks(prims: EllipsoidScene, chunk_size: int):
    """The primitives padded to a whole number of chunks of at most
    ``chunk_size`` (rounded to a 256 tile, not a whole chunk), and that
    chunk width."""
    eff = min(chunk_size, -(-prims.num_prims // 256) * 256)
    padded = pad_primitives(prims, eff)
    return padded, min(eff, padded.num_prims)


def _chunk_coeffs(o, d, padded: EllipsoidScene, sl: slice, gemm):
    """Coefficients of all rays against the primitives ``sl`` of ``padded``:
    elementwise, or (``gemm`` = (ray features, [10, N] primitive features))
    as three products."""
    if gemm is not None:
        rayf, pf = gemm
        return quadric.pair_coeffs_gemm(rayf, pf[:, sl])
    return quadric.ray_prim_coeffs(o, d, padded.centers[sl], padded.scales[sl], padded.quats[sl])


def _gemm_features(o, d, padded: EllipsoidScene, coeff_gemm: bool):
    if not coeff_gemm:
        return None
    return quadric.ray_features(o, d), quadric.prim_features(
        padded.centers, padded.scales, padded.quats)


def _gather_intervals(
    prims: EllipsoidScene,
    o: torch.Tensor,
    d: torch.Tensor,
    t_min: torch.Tensor,
    k: int,
    chunk_size: int,
    kern: Optional[Kernel] = None,
    coeff_gemm: bool = False,
):
    """Per-ray k nearest [entry, exit) extent-ellipsoid intervals with exit
    > t_min, entries clamped to t_min.

    Returns (entry [R, k] ascending, exit [R, k], ids [R, k], count [R],
    full_tau [R, k] or None). The order is (entry, primitive id) ascending,
    with +inf entries (id 0, exit +inf) padding the end: a stable sort of
    [best | chunk] per chunk, which breaks ties as the JAX package's
    ``lax.top_k`` does. With ``kern`` (the Gaussian kernel), ``full_tau``
    carries each interval's whole optical depth sigma_t * D(entry, exit).
    ``coeff_gemm`` forms the coefficients by :func:`quadric.pair_coeffs_gemm`.
    """
    padded, c = _padded_chunks(prims, chunk_size)
    n = padded.num_prims
    r = o.shape[0]
    dev = o.device
    inf = torch.inf
    with_tau = kern is not None
    sig_all = padded.attrs["sigma_t"][:, 0] if with_tau else None
    sprod_all = padded.scale_prod()
    gemm = _gemm_features(o, d, padded, coeff_gemm)
    best_t = torch.full((r, k), inf, dtype=o.dtype, device=dev)
    best_exit = torch.full_like(best_t, inf)
    best_id = torch.zeros((r, k), dtype=torch.int64, device=dev)
    best_tau = torch.zeros_like(best_t)
    for start in range(0, n, c):
        sl = slice(start, start + c)
        coeffs = _chunk_coeffs(o, d, padded, sl, gemm)
        valid, t_near, t_far = quadric.intersect_extent(coeffs, padded.extent)
        ids = torch.arange(start, start + c, device=dev)
        valid = valid & (ids < prims.num_prims)[None, :]
        # sampling geometry carries no parameter derivatives
        t_near, t_far = t_near.detach(), t_far.detach()
        entry = torch.maximum(t_near, t_min[:, None])
        valid = valid & (t_far > t_min[:, None])
        entry = torch.where(valid, entry, inf)
        cand_t = torch.cat([best_t, entry], dim=1)
        cand_exit = torch.cat([best_exit, torch.where(valid, t_far, inf)], dim=1)
        cand_id = torch.cat([best_id, ids[None, :].expand(r, c)], dim=1)
        sel = torch.sort(cand_t, dim=1, stable=True).indices[:, :k]
        if with_tau:
            # finite bounds on invalid pairs (zero either way): an infinite
            # entry makes the chain rule's 0 * inf NaN in the gradients
            tau_c = sig_all[sl][None, :] * kernel_ops.gaussian_integral_segment(
                coeffs, sprod_all[sl][None, :], torch.where(valid, entry, t_far), t_far, valid
            )
            best_tau = torch.gather(torch.cat([best_tau, tau_c], dim=1), 1, sel)
        best_t = torch.gather(cand_t, 1, sel)
        best_exit = torch.gather(cand_exit, 1, sel)
        best_id = torch.gather(cand_id, 1, sel)
    count = torch.sum(torch.isfinite(best_t), dim=1)
    return best_t, best_exit, best_id, count, (best_tau if with_tau else None)


def _kern_fast(kern: Kernel) -> bool:
    """The unnormalized Gaussian: the kernel of the jump path and the fused
    walk (its segment depths are an erf antiderivative)."""
    return kern.type == "gaussian" and not kern.normalized and not kern.full_range


def _smallest(keys: torch.Tensor, k: int):
    """The k smallest keys per row, ascending, and their positions, ties to
    the lower position (``lax.top_k`` of the negated keys)."""
    vals, sel = torch.sort(keys, dim=1, stable=True)
    return vals[:, :k], sel[:, :k]


@spans.spanned("prb.collect")
def _collect_intervals(primitives: EllipsoidScene, index, o, d, cfg: "PRBConfig",
                       t_start: Optional[torch.Tensor] = None):
    """The K' = ``cfg.interval_budget`` nearest [entry, exit) intervals per
    ray with exit > t_start (entries clamped to it), collected once per
    bounce (or re-collection round): by the brute streaming scan, or with
    ``cfg.use_clusters`` through the Morton clusters of ``index`` (each
    ray's nearest intersected cluster spheres, their members' exact
    quadrics, a running top-K' over groups of ~256 candidates).

    Returns (entry [R, K'] ascending, exit, ids [R, K'] into the work scene
    (``index.prims`` with clusters), t_budget [R], full_tau [R, K'] or
    None). ``t_budget`` is the distance beyond which the collection is
    incomplete: the K'-th entry when the budget filled, or the entry bound
    of the nearest cluster left out; +inf when the collection is
    complete."""
    kp = cfg.interval_budget
    r = o.shape[0]
    inf = torch.inf
    if t_start is None:
        t_start = torch.zeros((r,), dtype=o.dtype, device=o.device)
    if not cfg.use_clusters:
        kern = cfg.kernel
        entry, exit_t, ids, count, full_tau = _gather_intervals(
            primitives, o, d, t_start, kp, cfg.chunk_size,
            kern=kern if _kern_fast(kern) else None, coeff_gemm=cfg.coeff_gemm,
        )
        return entry, exit_t, ids, torch.where(count >= kp, entry[:, -1], inf), full_tau

    prims = index.prims
    cs = index.cluster_size
    ncl = index.centers.shape[0]
    # cluster culling, component-wise (no [R, Ncl, 3] temporary)
    vx = index.centers[None, :, 0] - o[:, 0:1]
    vy = index.centers[None, :, 1] - o[:, 1:2]
    vz = index.centers[None, :, 2] - o[:, 2:3]
    depth = vx * d[:, 0:1] + vy * d[:, 1:2] + vz * d[:, 2:3]
    closest2 = vx * vx + vy * vy + vz * vz - depth * depth
    radii = index.radii[None, :]
    ts = t_start[:, None]
    hit = (closest2 <= radii * radii) & (depth + radii > ts)
    ekey = torch.where(hit, torch.maximum(depth - radii, ts), inf)
    # Candidate clusters per ray: enough to cover the budget (~3 K' / cs)
    # and at least 4096 / cs, so that a re-collection round can advance
    # past every cluster sphere straddling its start (JAX prb.py:423-441).
    k_cl = cfg.cluster_candidates or max(8, -(-3 * kp // cs), -(-4096 // cs))
    k_cl = min(k_cl, ncl)
    kk = min(k_cl + 1, ncl)  # one more learns the overflow bound
    keys_sorted, sel_all = _smallest(ekey, kk)
    cl_sel = sel_all[:, :k_cl]
    cl_valid = torch.isfinite(keys_sorted[:, :k_cl])
    if kk > k_cl:
        # the entry bound of the nearest cluster left out bounds its members'
        t_budget_cl = keys_sorted[:, k_cl]
    else:
        t_budget_cl = torch.full((r,), inf, dtype=o.dtype, device=o.device)

    # exact intervals, streamed over groups of clusters (bounded memory)
    g = max(1, 256 // cs)
    n_groups = -(-k_cl // g)
    pad_k = n_groups * g - k_cl
    if pad_k:
        cl_sel = torch.nn.functional.pad(cl_sel, (0, pad_k))
        cl_valid = torch.nn.functional.pad(cl_valid, (0, pad_k))
    offs = torch.arange(cs, dtype=cl_sel.dtype, device=o.device)
    entry_k = torch.full((r, kp), inf, dtype=o.dtype, device=o.device)
    exit_k = torch.full_like(entry_k, inf)
    ids_k = torch.zeros((r, kp), dtype=torch.int64, device=o.device)
    for gi in range(n_groups):
        sel_g = cl_sel[:, gi * g:(gi + 1) * g]
        val_g = cl_valid[:, gi * g:(gi + 1) * g]
        cand = (sel_g[..., None] * cs + offs).reshape(r, g * cs)
        cand_valid = val_g[..., None].expand(r, g, cs).reshape(r, g * cs)
        coeffs = quadric.pair_coeffs_gathered(o, d, prims.centers, prims.scales, prims.quats,
                                              cand)
        valid, t_near, t_far = quadric.intersect_extent(coeffs, prims.extent)
        t_near, t_far = t_near.detach(), t_far.detach()
        valid = valid & cand_valid & (t_far > ts)
        entry = torch.where(valid, torch.maximum(t_near, ts), inf)
        cat_e = torch.cat([entry_k, entry], dim=1)
        cat_x = torch.cat([exit_k, torch.where(valid, t_far, inf)], dim=1)
        cat_i = torch.cat([ids_k, cand], dim=1)
        entry_k, sel = _smallest(cat_e, kp)
        exit_k = torch.gather(cat_x, 1, sel)
        ids_k = torch.gather(cat_i, 1, sel)
    count = torch.sum(torch.isfinite(entry_k), dim=1)
    t_budget = torch.minimum(torch.where(count >= kp, entry_k[:, kp - 1], inf), t_budget_cl)
    return entry_k, exit_k, ids_k, t_budget, None


def _window_from_collected(entry_all, exit_all, t_min, k: int):
    """One window of k intervals from the collected set: the first k open
    intervals (exit > t_min) in entry order.

    Returns (entry [R, k] clamped to t_min, exit [R, k], sel [R, k]
    positions into the collected arrays, valid_sel [R, k], t_limit [R],
    has_more [R])."""
    kp = entry_all.shape[1]
    inf = torch.inf
    open_ = torch.isfinite(entry_all) & (exit_all > t_min[:, None])
    pos = torch.cumsum(open_.to(torch.int32), dim=1)
    rank = torch.where(open_, pos, kp + 2)
    selkey = torch.where(rank <= k, rank, kp + 2)
    key, sel = _smallest(selkey, k)  # ranks 1..k ascending
    valid_sel = key <= k
    entry_w = torch.where(
        valid_sel, torch.maximum(torch.gather(entry_all, 1, sel), t_min[:, None]), inf
    )
    exit_w = torch.where(valid_sel, torch.gather(exit_all, 1, sel), inf)
    nxt = torch.amin(torch.where(rank == k + 1, entry_all, inf), dim=1)
    has_more = torch.isfinite(nxt)
    min_exit = torch.amin(exit_w, dim=1)
    t_limit = torch.where(has_more, torch.where(nxt > t_min, nxt, min_exit), inf)
    return entry_w, exit_w, sel, valid_sel, t_limit, has_more


def _free_flight_window(
    kern: Kernel,
    entry: torch.Tensor,
    exit_t: torch.Tensor,
    coeffs: quadric.QuadricCoeffs,
    sigma_t: torch.Tensor,
    s_prod: torch.Tensor,
    t_limit: torch.Tensor,
    trans: torch.Tensor,
    xi: torch.Tensor,
    active: torch.Tensor,
    solver_iters: int,
    solver_type: str,
):
    """Walk the sorted boundary segments of one window of K intervals
    (entry ascending, exit, coeffs, sigma_t, s_prod [R, K]), capped at
    t_limit [R], from the running transmittance trans [R], for the sample
    xi [R].

    All 2K - 1 segments' depths are taken at once: the Gaussian kernel by
    the shared-boundary antiderivative (:func:`kernel_ops.
    gaussian_segment_taus`), any other kernel by its segment integral
    broadcast over [R, 2K - 1, K] with midpoint coverage. The first segment
    where T falls below xi is selected, and a ``solver_iters``-step
    bisection finds the distance in it (``solver_type="disabled"``: its
    midpoint).

    Returns (trans_out, found, t_samp (+inf where not found), trans at the
    sample): the transmittance at the end of the window, or at the start of
    the crossing segment; the last is differentiable, for the score."""
    events = torch.sort(torch.cat([entry, exit_t], dim=1), dim=1).values
    tl = t_limit[:, None]
    # clamp the segments at the window end (it may fall inside a segment: a
    # cluster budget bound or a surface hit)
    t0s = torch.minimum(events[:, :-1], tl)
    t1s = torch.minimum(events[:, 1:], tl)
    valid_seg = torch.isfinite(t1s) & (t1s > t0s) & active[:, None]
    fast = _kern_fast(kern)
    if fast:
        ev = torch.minimum(events, tl)
        tau_seg = torch.where(
            valid_seg,
            torch.clamp(kernel_ops.gaussian_segment_taus(coeffs, s_prod, sigma_t, entry, exit_t,
                                                         ev), min=0.0),
            0.0,
        )

        def tau_partial(t0, tt):
            # the same clamped antiderivative: the in-segment CDF integrates
            # exactly to the segment total used for selection
            return kernel_ops.gaussian_segment_taus(
                coeffs, s_prod, sigma_t, entry, exit_t, torch.stack([t0, tt], dim=-1))[:, 0]
    else:
        mids = 0.5 * (t0s + t1s)
        cover = (entry[:, None, :] <= mids[:, :, None]) & (exit_t[:, None, :] >= mids[:, :, None])
        c3 = quadric.QuadricCoeffs(coeffs.a[:, None, :], coeffs.b[:, None, :],
                                   coeffs.c[:, None, :])
        # finite bounds on invalid segments (masked below; infinite ones make
        # the gradients NaN)
        t0g = torch.where(valid_seg, t0s, 0.0)
        t1g = torch.where(valid_seg, t1s, 0.0)
        dens = kern.density_integral(c3, s_prod[:, None, :], None, 0.0, t0g[:, :, None],
                                     t1g[:, :, None], cover)
        tau_seg = torch.where(valid_seg, torch.sum(dens * sigma_t[:, None, :], dim=-1), 0.0)

    cum_excl = torch.cumsum(tau_seg, dim=1) - tau_seg
    t_start = trans[:, None] * torch.exp(-cum_excl)  # T at each segment's start
    t_end = t_start * torch.exp(-tau_seg)
    success = valid_seg & (t_end.detach() < xi[:, None])
    found = torch.any(success, dim=1)
    sel = torch.argmax(success.to(torch.int32), dim=1)  # the first crossing segment
    trans_out = torch.where(active, trans * torch.exp(-torch.sum(tau_seg, dim=1)), trans)

    rows = torch.arange(entry.shape[0], device=entry.device)
    t0, t1 = t0s[rows, sel], t1s[rows, sel]
    trans_c = t_start[rows, sel]
    chi = -torch.log(torch.clamp(xi / torch.clamp(trans_c.detach(), min=1e-30), min=1e-30))
    if not fast:
        cover_sel = cover[rows, sel]

        def tau_partial(t0_, tt):
            dpart = kern.density_integral(coeffs, s_prod, None, 0.0, t0_[:, None], tt[:, None],
                                          cover_sel)
            return torch.sum(dpart * sigma_t, dim=-1)

    with torch.no_grad():  # the sampled distance is stop-gradient
        if solver_type == "disabled":
            ts = 0.5 * (t0 + t1)
        else:
            ts = 0.5 * (t0 + t1)
            for i in range(solver_iters):
                tau = tau_partial(t0, ts)
                step = (t1 - t0) / (2.0 ** (i + 2.0))
                ts = torch.where(tau > chi, ts - step, ts + step)
                ts = torch.minimum(torch.maximum(ts, t0), t1)
        ts = torch.where(found, ts, 0.0)
    # the differentiable partial transmittance T(0 -> t_s), for the score
    # (an empty segment where nothing was found: t0 may be +inf there)
    trans_samp = torch.where(
        found, trans_c * torch.exp(-tau_partial(torch.where(found, t0, ts), ts)), 1.0)
    t_samp = torch.where(found, ts, torch.inf)
    trans_out = torch.where(found, trans_c, trans_out)
    return trans_out, found, t_samp, trans_samp


def _albedo3(prims: EllipsoidScene) -> torch.Tensor:
    """The albedo as [N, 3]: a grey [N, 1] albedo is broadcast (the JAX
    package reads its channels 1 and 2 clamped to 0)."""
    alb = prims.attrs["albedo"]
    return alb.expand(-1, 3) if alb.shape[-1] == 1 else alb


def _scatter(base: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``base`` with rows ``idx`` replaced by ``values`` (differentiable)."""
    return base.index_copy(0, idx, values.to(base.dtype))


@spans.spanned("prb.walk")
def _run_windows(work, cfg, o, d, xi, entry_all, exit_all, ids_all, t_budget, t_cap, act, t_min0,
                 trans0, n_windows):
    """The xla window walk over a collected table (entry_all, exit_all,
    ids_all [R, K'] into ``work``): up to ``n_windows`` windows of k =
    ``cfg.max_overlaps`` intervals from t_min0 [R] with transmittance trans0
    [R]. Each window runs on the rays still walking (compacted); the others
    keep their carries. The window end is capped by t_budget (rays pinned
    there die, unless a re-collection round resumes them) and by the
    surface cap t_cap (rays reaching it resolve).

    Returns (found, resolved, bdead, t_samp, albedo [R, 3], density at the
    sample, trans, t_stop): ``trans`` is integrated exactly to ``t_stop``,
    the stop position of every unresolved ray, where a re-collection round
    resumes."""
    k = cfg.max_overlaps
    kern = cfg.kernel
    r = o.shape[0]
    dev = o.device
    spans.count("prb.walked_rays", r)
    sig_all = work.attrs["sigma_t"][:, 0]
    alb_all = _albedo3(work)
    sprod_all = work.scale_prod()
    t_min, trans = t_min0, trans0
    found = torch.zeros((r,), dtype=torch.bool, device=dev)
    resolved = torch.zeros_like(found)
    bdead = torch.zeros_like(found)
    t_samp = torch.full((r,), torch.inf, dtype=o.dtype, device=dev)
    albedo = torch.zeros((r, 3), dtype=o.dtype, device=dev)
    density = torch.ones((r,), dtype=o.dtype, device=dev)
    for _ in range(n_windows):
        idx = torch.nonzero(act & ~resolved & ~bdead)[:, 0]
        if not idx.numel():
            break  # every later window would skip too
        o_w, d_w, tm, tb, tc = o[idx], d[idx], t_min[idx], t_budget[idx], t_cap[idx]
        entry, exit_t, sel, valid_sel, t_limit, has_more = _window_from_collected(
            entry_all[idx], exit_all[idx], tm, k)
        ids = torch.gather(ids_all[idx], 1, sel)
        coeffs = quadric.pair_coeffs_gathered(o_w, d_w, work.centers, work.scales, work.quats,
                                              ids)
        sigma_t = torch.where(valid_sel, sig_all[ids], 0.0)
        s_prod = sprod_all[ids]
        # the walk may not pass the collection budget (density beyond it is
        # unknown); a surface cap instead resolves the ray when reached
        t_limit = torch.minimum(t_limit, tb)
        hit_cap = t_limit >= tc
        t_limit = torch.minimum(t_limit, tc)
        full = has_more | torch.isfinite(tb)
        trans_new, found_w, ts_w, trans_samp = _free_flight_window(
            kern, entry, exit_t, coeffs, sigma_t, s_prod, t_limit, trans[idx], xi[idx],
            torch.ones_like(idx, dtype=torch.bool), cfg.solver_max_iterations, cfg.solver_type,
        )
        # albedo at the interaction: the sigma_t-pdf weighted average over the
        # covering intervals. q is taken at a finite stand-in where nothing
        # was found (the JAX package takes it at +inf, where the chain rule's
        # 0 * inf makes the geometry gradients NaN)
        ts = torch.where(found_w, ts_w, 1.0)[:, None]
        q_at = (coeffs.a * ts + 2.0 * coeffs.b) * ts + coeffs.c
        cover = (entry <= ts) & (exit_t >= ts)
        pdf_j = torch.where(cover, kern.pdf_q(q_at, s_prod) * sigma_t, 0.0)
        accum_pdf = torch.sum(pdf_j, dim=1)
        accum_alb = torch.stack(
            [torch.sum(pdf_j * alb_all[:, ch][ids], dim=1) for ch in range(3)], dim=-1)
        alb_w = accum_alb * _safe_rcp(accum_pdf)[:, None]
        res_w = found_w | (~found_w & (~full | hit_cap))
        # pinned at the budget: no progress is possible within this collection
        bdead_w = ~found_w & full & ~hit_cap & (t_limit >= tb)
        trans = _scatter(trans, idx, trans_new)
        t_samp = _scatter(t_samp, idx, torch.where(found_w, ts_w, t_samp[idx]))
        albedo = _scatter(albedo, idx, torch.where(found_w[:, None], alb_w, albedo[idx]))
        # the sampling density sum_j sigma_t_j pdf_j(t_s) T(0 -> t_s)
        density = _scatter(density, idx,
                           torch.where(found_w, accum_pdf * trans_samp, density[idx]))
        found = _scatter(found, idx, found_w)
        resolved = _scatter(resolved, idx, res_w)
        bdead = _scatter(bdead, idx, bdead_w)
        # unresolved rays advance, newly pinned ones too: trans is integrated
        # to t_limit either way
        t_min = _scatter(t_min, idx, torch.where(res_w, tm, t_limit))
    return found, resolved, bdead, t_samp, albedo, density, trans, t_min


def _walk_columns(prims: EllipsoidScene, o, d, entry, ids):
    """The walk's per-interval antiderivative columns [R, K']: the depth of
    interval j over [x, y] is cp_j (erf(alpha_j y + beta_j) - erf(alpha_j x
    + beta_j)). Padding intervals are neutral (cp 0, alpha 1, beta 0).
    Differentiable here; the walk detaches its copies."""
    fin = torch.isfinite(entry)
    coeffs = quadric.pair_coeffs_gathered(o, d, prims.centers, prims.scales, prims.quats, ids)
    sig = torch.where(fin, prims.attrs["sigma_t"][:, 0][ids], 0.0)
    sp = prims.scale_prod()[ids]
    a = coeffs.a
    cp = torch.where(
        fin,
        torch.exp(-0.5 * kernel_ops.gaussian_q_min(coeffs))
        / (4.0 * math.pi * sp * torch.sqrt(a)) * sig,
        0.0,
    )
    alpha = torch.where(fin, torch.sqrt(0.5 * a), 1.0)
    beta = torch.where(fin, coeffs.b / torch.sqrt(2.0 * a), 0.0)
    return cp, alpha, beta


def _f_exact_at(prims, o, d, entry, exit_t, ids, tau_fin, t_pt, k: int):
    """Exact F(t) at a point: the entered intervals' whole depths minus the
    still-open intervals' tails beyond t (the open set is the <= k intervals
    a window would select; beyond k overlaps the tail is dropped, as the
    walk drops their density)."""
    fin = torch.isfinite(entry)
    entered = fin & (entry < t_pt[:, None])
    f_entered = torch.sum(torch.where(entered, tau_fin, 0.0), dim=1)
    _, _, sel, valid, _, _ = _window_from_collected(entry, exit_t, t_pt, k)
    raw_entry = torch.gather(entry, 1, sel)
    opened = valid & (raw_entry < t_pt[:, None])
    # a finite entry where nothing is open: the JAX package integrates from
    # +inf there, where the chain rule's 0 * inf makes gradients NaN
    raw_entry = torch.where(opened, raw_entry, t_pt[:, None])
    ids_s = torch.gather(ids, 1, sel)
    coeffs = quadric.pair_coeffs_gathered(o, d, prims.centers, prims.scales, prims.quats, ids_s)
    sig = torch.where(opened, prims.attrs["sigma_t"][:, 0][ids_s], 0.0)
    sp = prims.scale_prod()[ids_s]
    tau_full = torch.where(opened, torch.gather(tau_fin, 1, sel), 0.0)
    tau_part = sig * kernel_ops.gaussian_integral_segment(
        coeffs, sp, raw_entry, t_pt[:, None].expand_as(raw_entry), opened
    )
    return f_entered - torch.sum(torch.clamp(tau_full - tau_part, min=0.0), dim=1)


@spans.spanned("prb.walk")
def _run_windows_pallas(prims, cfg, o, d, xi, entry, exit_t, ids, t_budget, t_cap, act, t_min0,
                        trans0, n_windows):
    """The fused window walk over a collected table, then the
    differentiable post-pass at the sample point (albedo, sampling
    density) and at the resolve point (escape transmittance).

    Returns what :func:`_run_windows` returns. The escape transmittance
    assumes the table holds the density from t = 0, so re-collection
    rounds (tables from a later start) are off for this backend; the kernel
    does not report its stop position, and ``t_stop`` is t_budget where
    budget-dead, +inf elsewhere."""
    k = cfg.max_overlaps
    spans.count("prb.walked_rays", o.shape[0])
    fin = torch.isfinite(entry)
    cp, alpha, beta = _walk_columns(prims, o, d, entry, ids)
    chi = torch.log(torch.clamp(trans0.detach(), min=1e-30)) - torch.log(
        torch.clamp(xi.detach(), min=1e-30)
    )
    found, resolved, bdead, capres, t_samp = ffwalk.walk(
        entry, exit_t, cp, alpha, beta, chi, t_budget, t_cap, act, t_min0,
        k=k, n_windows=n_windows, solver_iters=cfg.solver_max_iterations,
        solver_disabled=cfg.solver_type == "disabled",
    )
    found, resolved, bdead = found & act, resolved & act, bdead & act

    # differentiable whole-interval depths (what collection's full_tau holds)
    e_safe = torch.where(fin, entry, 0.0)
    x_safe = torch.where(fin, exit_t, 0.0)
    tau_fin = torch.where(
        fin,
        torch.clamp(cp * (torch.erf(alpha * x_safe + beta) - torch.erf(alpha * e_safe + beta)),
                    min=0.0),
        0.0,
    )

    # albedo and sampling density at the sample point (the sigma_t-pdf
    # weighted average over the covering window)
    ts_safe = torch.where(found, t_samp, 1.0)
    entry_s, exit_s, sel_s, valid_s, _, _ = _window_from_collected(entry, exit_t, ts_safe, k)
    ids_s = torch.gather(ids, 1, sel_s)
    coeffs_s = quadric.pair_coeffs_gathered(
        o, d, prims.centers, prims.scales, prims.quats, ids_s
    )
    sig_s = torch.where(valid_s, prims.attrs["sigma_t"][:, 0][ids_s], 0.0)
    sp_s = prims.scale_prod()[ids_s]
    ts = ts_safe[:, None]
    q_at = (coeffs_s.a * ts + 2.0 * coeffs_s.b) * ts + coeffs_s.c
    cover = (entry_s <= ts) & (exit_s >= ts)
    pdf_j = torch.where(cover, cfg.kernel.pdf_q(q_at, sp_s) * sig_s, 0.0)
    accum_pdf = torch.sum(pdf_j, dim=1)
    alb_all = _albedo3(prims)
    accum_alb = torch.stack(
        [torch.sum(pdf_j * alb_all[:, ch][ids_s], dim=1) for ch in range(3)], dim=-1
    )
    alb_w = accum_alb * _safe_rcp(accum_pdf)[:, None]
    f_ts = _f_exact_at(prims, o, d, entry, exit_t, ids, tau_fin, ts_safe, k)
    trans_samp = torch.exp(-torch.clamp(f_ts, min=0.0))
    density_at_sample = torch.where(found, accum_pdf * trans_samp, 1.0)
    albedo = torch.where(found[:, None], alb_w, 0.0)

    # escape transmittance: F at the resolve point (t_cap for capped rays,
    # beyond every interval for full escapes)
    esc = resolved & ~found
    t_res = torch.where(capres, t_cap, 1e15)
    f_res = _f_exact_at(
        prims, o, d, entry, exit_t, ids, tau_fin, torch.where(esc, t_res, 1.0), k
    )
    trans = torch.where(esc, torch.exp(-torch.clamp(f_res, min=0.0)), 1.0)
    return (found, resolved, bdead, torch.where(found, t_samp, torch.inf), albedo,
            density_at_sample, trans, torch.where(bdead, t_budget, torch.inf))


def _ff_stop_out(o, *vals):
    """free_flight's outputs at a stage stop (JAX's ``_ff_stop_out``): the
    six tensors of its return structure, none found or dead, t_samp = +inf
    and the first score 1, each plus the checksum of ``vals`` (the sum of
    their finite values), so that the stage's results are read; albedo 0
    and the second score 1."""
    r = o.shape[0]
    chk = sum(torch.sum(torch.where(torch.isfinite(v), v, 0.0)) for v in vals)
    z = torch.zeros((r,), dtype=torch.bool, device=o.device)
    return (z, z, torch.full((r,), torch.inf, dtype=o.dtype, device=o.device) + chk,
            torch.zeros((r, 3), dtype=o.dtype, device=o.device),
            torch.ones((r,), dtype=o.dtype, device=o.device) + chk,
            torch.ones((r,), dtype=o.dtype, device=o.device))


def _jump_walk(work, cfg, run_windows, o, d, xi, entry, exit_t, ids, tau_fin, t_budget, t_cap,
               needy):
    """Block jump + windows for a set of rays: start the walk at the first
    interval block whose cumulative whole-interval depth could reach chi."""
    k = cfg.max_overlaps
    kp = entry.shape[1]
    n_blocks = max(1, kp // k)
    cum = torch.cumsum(tau_fin, dim=1)  # inclusive, entry order
    bidx = torch.arange(1, n_blocks, device=o.device) * k
    f_ub = cum[:, bidx - 1]  # depth bound at the entry of interval j*k
    chi = -torch.log(torch.clamp(xi.detach(), min=1e-30))
    jb = torch.sum(f_ub <= chi[:, None], dim=1)
    count = torch.sum(torch.isfinite(entry), dim=1)
    jb = torch.minimum(jb, torch.clamp(torch.div(count - 1, k, rounding_mode="floor"), min=0))
    b_t = torch.gather(entry, 1, torch.clamp(jb * k, max=kp - 1)[:, None])[:, 0]
    b_t = torch.where((jb > 0) & torch.isfinite(b_t), b_t, 0.0)
    b_t = torch.minimum(b_t, torch.minimum(t_cap, t_budget))
    b_t = torch.clamp(b_t, min=0.0)
    f_b = _f_exact_at(work, o, d, entry, exit_t, ids, tau_fin, b_t, k)
    trans0 = torch.exp(-torch.clamp(f_b, min=0.0))
    return run_windows(
        work, cfg, o, d, xi, entry, exit_t, ids, t_budget, t_cap, needy, b_t, trans0,
        min(cfg.max_windows, cfg.jump_windows),
    )


def build_ff_index(primitives: EllipsoidScene, cfg: "PRBConfig"):
    """The Morton-cluster index of free flight's cluster collection (built
    once per scene and bounce loop, not per window)."""
    from ..accel import clusters as cl

    return cl.build_clusters(pad_primitives(primitives, cfg.cluster_size), cfg.cluster_size,
                             num_real=primitives.num_prims)


@spans.spanned("prb.free_flight")
def free_flight(
    primitives: EllipsoidScene,
    o: torch.Tensor,
    d: torch.Tensor,
    xi: torch.Tensor,
    cfg: PRBConfig,
    active: torch.Tensor,
    index=None,
    t_max: Optional[torch.Tensor] = None,
):
    """Sample a medium interaction along each ray (exact inverse CDF over
    the multi-primitive density), on the jump path or the sequential walk
    (see the module docstring), through ``cfg.walk_backend``'s windows.

    Returns (found [R], dead [R], t_samp [R], albedo [R, 3], score_found [R],
    score_escape [R]). ``dead`` marks rays that ran out of collection budget
    or windows before resolving. The score factors are numerically 1 but
    carry the gradients of the sampling density and survival probability.
    With ``_FF_STOP`` set it returns :func:`_ff_stop_out` after that stage,
    with JAX's checksums, except at "sort": the port compacts the needy rays
    with ``torch.nonzero`` where JAX stable-sorts all rays (a permutation of
    0..R-1), so that stop's checksum holds the needy rays' indices, not
    JAX's order.
    ``index`` is :func:`build_ff_index`'s (built here when
    ``cfg.use_clusters`` and none is given). ``t_max`` [R] (optional) caps
    the march at a surface: rays reaching it unresolved escape with the
    transmittance of [0, t_max].
    """
    primitives.require_attrs(["sigma_t", "albedo"])
    r = o.shape[0]
    dev = o.device
    kp = cfg.interval_budget
    if cfg.use_clusters and index is None:
        index = build_ff_index(primitives, cfg)
    work = index.prims if cfg.use_clusters else primitives
    t_cap = torch.full((r,), torch.inf, dtype=o.dtype, device=dev) if t_max is None else t_max
    fast = _kern_fast(cfg.kernel)
    run_windows = _run_windows_pallas if cfg.walk_backend == "pallas" and fast else _run_windows
    if not (cfg.jump and not cfg.use_clusters and fast):
        return _sequential_flight(primitives, index, work, cfg, run_windows, o, d, xi, active,
                                  t_cap)

    chi = -torch.log(torch.clamp(xi.detach(), min=1e-30))
    f_total = optical_depth(primitives, o, d, cfg)
    if _FF_STOP == "collect":  # the decision pass (jump path)
        return _ff_stop_out(o, f_total, chi)
    surface_capped = torch.isfinite(t_cap)
    will_cross = f_total.detach() > chi
    no_cross = active & ~will_cross & ~surface_capped
    trans_jump = torch.exp(-torch.clamp(f_total, min=0.0))
    needy = active & (will_cross | surface_capped)
    if _FF_STOP == "escape":
        return _ff_stop_out(o, f_total, trans_jump, needy.to(o.dtype))

    found = torch.zeros_like(needy)
    resolved = no_cross
    t_samp = torch.full((r,), torch.inf, dtype=o.dtype, device=dev)
    albedo = torch.zeros((r, 3), dtype=o.dtype, device=dev)
    density_at_sample = torch.ones((r,), dtype=o.dtype, device=dev)
    trans = trans_jump
    idx = torch.nonzero(needy)[:, 0]
    if _FF_STOP == "sort":
        return _ff_stop_out(o, idx.to(o.dtype), trans_jump)
    if idx.numel():
        o_n, d_n, xi_n, tc_n = o[idx], d[idx], xi[idx], t_cap[idx]
        with spans.span("prb.collect"):
            entry, exit_t, ids, count, full_tau = _gather_intervals(
                primitives, o_n, d_n, torch.zeros_like(xi_n), kp, cfg.chunk_size,
                kern=cfg.kernel, coeff_gemm=cfg.coeff_gemm,
            )
        t_budget = torch.where(count >= kp, entry[:, -1], torch.inf)
        tau_fin = torch.where(torch.isfinite(entry), full_tau, 0.0)
        w_found, w_res, _, w_ts, w_alb, w_dens, w_trans, _ = _jump_walk(
            primitives, cfg, run_windows, o_n, d_n, xi_n, entry, exit_t, ids, tau_fin, t_budget,
            tc_n, torch.ones_like(idx, dtype=torch.bool),
        )
        found = _scatter(found, idx, w_found)
        resolved = _scatter(resolved, idx, w_res)
        t_samp = _scatter(t_samp, idx, w_ts)
        albedo = _scatter(albedo, idx, w_alb)
        density_at_sample = _scatter(density_at_sample, idx, w_dens)
        trans = _scatter(trans, idx, w_trans)

    dead = active & ~resolved  # collection or window budget exhausted
    escaped = active & resolved & ~found
    return (found, dead, t_samp, albedo, _score_ratio(density_at_sample, found),
            _score_ratio(trans, escaped))


def _sequential_flight(primitives, index, work, cfg, run_windows, o, d, xi, active, t_cap):
    """The sequential walk: one collection from t = 0, ``max_windows``
    windows from there, then (xla walk only) up to ``collect_rounds - 1``
    re-collection rounds on the pending rays: those the walk left
    unresolved at a finite stop position. A round collects from that
    position (straddling intervals re-enter with clamped entries) and walks
    on with the carried transmittance; a ray whose stop position does not
    advance leaves the rounds and dies."""
    r = o.shape[0]
    dev = o.device
    entry, exit_t, ids, t_budget, _ = _collect_intervals(primitives, index, o, d, cfg)
    if _FF_STOP == "collect":
        return _ff_stop_out(o, entry, exit_t, t_budget)
    found, resolved, _, t_samp, albedo, density, trans, t_stop = run_windows(
        work, cfg, o, d, xi, entry, exit_t, ids, t_budget, t_cap, active,
        torch.zeros((r,), dtype=o.dtype, device=dev), torch.ones((r,), dtype=o.dtype, device=dev),
        cfg.max_windows,
    )
    n_extra = max(0, int(cfg.collect_rounds) - 1) if run_windows is _run_windows else 0
    pending = active & ~resolved & torch.isfinite(t_stop)
    t_from = t_stop
    for _ in range(n_extra):
        idx = torch.nonzero(pending)[:, 0]
        if not idx.numel():
            break  # every later round would skip too
        o_p, d_p, tf = o[idx], d[idx], t_from[idx]
        e2, x2, i2, tb2, _ = _collect_intervals(primitives, index, o_p, d_p, cfg, t_start=tf)
        f2, res2, _, ts2, alb2, dens2, tr2, tstop2 = run_windows(
            work, cfg, o_p, d_p, xi[idx], e2, x2, i2, tb2, t_cap[idx],
            torch.ones_like(idx, dtype=torch.bool), tf, trans[idx], cfg.max_windows,
        )
        found = _scatter(found, idx, f2)
        resolved = _scatter(resolved, idx, res2)
        t_samp = _scatter(t_samp, idx, torch.where(f2, ts2, t_samp[idx]))
        albedo = _scatter(albedo, idx, torch.where(f2[:, None], alb2, albedo[idx]))
        density = _scatter(density, idx, torch.where(f2, dens2, density[idx]))
        trans = _scatter(trans, idx, tr2)
        still = ~res2 & (tstop2 > tf)
        t_from = _scatter(t_from, idx, torch.where(still, tstop2, tf))
        pending = _scatter(pending, idx, still)
    dead = active & ~resolved  # collection or window budget exhausted
    escaped = active & resolved & ~found
    return found, dead, t_samp, albedo, _score_ratio(density, found), _score_ratio(trans, escaped)


def count_intervals(primitives: EllipsoidScene, o: torch.Tensor, d: torch.Tensor,
                    chunk_size: int = 65536, coeff_gemm: bool = False) -> torch.Tensor:
    """Per-ray count [R] (int32) of the extent ellipsoids a ray enters
    (exit > 0): the quantity ``collect_budget`` caps. A counting scan with
    no sort and no gather, used to size the budgets
    (:func:`suggest_budgets`)."""
    padded, c = _padded_chunks(primitives, chunk_size)
    gemm = _gemm_features(o, d, padded, coeff_gemm)
    acc = torch.zeros((o.shape[0],), dtype=torch.int32, device=o.device)
    for start in range(0, padded.num_prims, c):
        coeffs = _chunk_coeffs(o, d, padded, slice(start, start + c), gemm)
        valid, _, t_far = quadric.intersect_extent(coeffs, padded.extent)
        is_real = torch.arange(start, start + c, device=o.device) < primitives.num_prims
        valid = valid & is_real[None, :] & (t_far > 0.0)
        acc = acc + torch.sum(valid, dim=1, dtype=torch.int32)
    return acc


def suggest_budgets(primitives: EllipsoidScene, o: torch.Tensor, d: torch.Tensor,
                    cfg: PRBConfig, percentile: float = 99.9, sample_rays: int = 4096,
                    seed: int = 0) -> PRBConfig:
    """A copy of ``cfg`` with budgets sized from the measured per-ray need
    (:func:`count_intervals`) on a subsample of ``sample_rays`` rays, drawn
    by ``np.random.default_rng(seed).choice`` as the JAX package draws it:
    ``collect_budget`` the need's ``percentile``, rounded up to a multiple
    of 16 (at least 16), and ``max_windows`` enough windows to walk the
    whole budget (ceil(budget / max_overlaps) + 2, at least the
    config's)."""
    r = o.shape[0]
    if r > sample_rays:
        idx = torch.from_numpy(np.random.default_rng(seed).choice(r, sample_rays, False))
        idx = idx.to(o.device)
        o, d = o[idx], d[idx]
    need = count_intervals(primitives, o, d, cfg.chunk_size, coeff_gemm=cfg.coeff_gemm)
    b = int(np.percentile(need.cpu().numpy(), percentile))
    budget = max(16, -(-b // 16) * 16)
    windows = max(cfg.max_windows, -(-budget // cfg.max_overlaps) + 2)
    return dataclasses.replace(cfg, collect_budget=budget, max_windows=windows)


@spans.spanned("prb.optical_depth")
def optical_depth(
    primitives: EllipsoidScene,
    o: torch.Tensor,
    d: torch.Tensor,
    cfg: PRBConfig,
    t_max: float = _BIG_T,
) -> torch.Tensor:
    """Total optical depth F along [0, t_max]: an order-independent sum over
    every primitive, streamed in chunks of ``cfg.chunk_size`` (coefficients
    by :func:`quadric.pair_coeffs_gemm` with ``cfg.coeff_gemm``).
    Differentiable."""
    kern = cfg.kernel
    prims, c = _padded_chunks(primitives, cfg.chunk_size)
    r = o.shape[0]
    spans.count("prb.depth_pairs", r * prims.num_prims)
    t0 = torch.zeros((r, 1), dtype=o.dtype, device=o.device)
    t1 = torch.full((r, 1), t_max, dtype=o.dtype, device=o.device)
    tau = torch.zeros((r,), dtype=o.dtype, device=o.device)
    sprod_all = prims.scale_prod()
    gemm = _gemm_features(o, d, prims, cfg.coeff_gemm)
    for start in range(0, prims.num_prims, c):
        sl = slice(start, start + c)
        coeffs = _chunk_coeffs(o, d, prims, sl, gemm)
        valid, _, t_far = quadric.intersect_extent(coeffs, prims.extent)
        is_real = torch.arange(start, start + c, device=o.device) < primitives.num_prims
        valid = valid & (t_far > 0.0) & is_real[None, :]
        dens = kern.density_integral(coeffs, sprod_all[sl][None, :], prims.scales[sl][None],
                                     prims.extent, t0, t1, valid)
        tau = tau + torch.sum(dens * prims.attrs["sigma_t"][sl, 0][None, :], dim=1)
    return tau


def transmittance(primitives, o, d, cfg: PRBConfig, t_max: float = _BIG_T) -> torch.Tensor:
    """Transmittance along [0, t_max]: exp(-optical_depth)."""
    return torch.exp(-optical_depth(primitives, o, d, cfg, t_max))


def _hg_pdf(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * math.pi * denom * torch.sqrt(torch.clamp(denom, min=1e-12)))


def _sample_phase(u: torch.Tensor, d_in: torch.Tensor, cfg: PRBConfig):
    """Sample an outgoing direction from uniforms u [R, 2]. Returns (wo,
    phase_pdf); the phase weight is 1 for both isotropic and HG."""
    u1, u2 = u[:, 0], u[:, 1]
    if cfg.phase == "isotropic":
        z = 1.0 - 2.0 * u1
        pdf = torch.full_like(u1, 1.0 / (4.0 * math.pi))
    else:  # Henyey-Greenstein
        g = cfg.phase_g
        if abs(g) < 1e-3:
            z = 1.0 - 2.0 * u1
        else:
            sq = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
            z = (1.0 + g * g - sq * sq) / (2.0 * g)
        # z is cos(theta) to the forward direction; _hg_pdf takes it to wi
        pdf = _hg_pdf(-z, g)
    r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    local = torch.stack([r_xy * torch.cos(phi), r_xy * torch.sin(phi), z], dim=-1)
    return _to_frame(d_in, local), pdf


def eval_phase_pdf(d_in: torch.Tensor, wo: torch.Tensor, cfg: PRBConfig):
    if cfg.phase == "isotropic":
        return torch.full(d_in.shape[:-1], 1.0 / (4.0 * math.pi), device=d_in.device)
    return _hg_pdf(torch.sum(d_in * wo, dim=-1), cfg.phase_g)


def _to_frame(n: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """Local coordinates (z along n) to world, by a branchless ONB."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return local[..., 0:1] * t + local[..., 1:2] * bt + local[..., 2:3] * n


@dataclasses.dataclass
class _Surfaces:
    """A triangle mesh with its shading normals as the attribute ``_vn``,
    and the BSDF whose attributes are interpolated from it."""

    mesh: object
    bsdf: object
    attr_names: list

    @classmethod
    def of(cls, mesh, bsdf):
        bsdf = bsdf_ops.Diffuse() if bsdf is None else bsdf
        mesh_sh = mesh_mod.TriangleMesh(mesh.vertices, mesh.faces,
                                        {**mesh.attrs, "_vn": mesh.vertex_normals()})
        names = getattr(bsdf, "attr_names", lambda: ["base_color"])()
        return cls(mesh_sh, bsdf, names)


def _bounce(primitives, emitter, cfg, cfg_b, i, o, d, beta, l_acc, prev_pdf, u,
            ff_index=None, surf: Optional[_Surfaces] = None):
    """Bounce ``i`` of live rays, on their uniforms u [R, N_SLOTS]. Returns
    (o, d, beta, l_acc, prev_pdf, active)."""
    rl = o.shape[0]
    dev = o.device
    xi = 1e-7 + (1.0 - 1e-7) * u[:, _XI]
    active = torch.ones(rl, dtype=torch.bool, device=dev)

    # the nearest surface hit caps the march
    if surf is not None:
        s_valid, t_surf, fid, uv = mesh_mod.intersect(surf.mesh, o, d, t_min=1e-4)
        t_cap = torch.where(s_valid, t_surf, torch.inf)
    else:
        s_valid = torch.zeros(rl, dtype=torch.bool, device=dev)
        t_cap = None

    found, dead, t_samp, albedo, score_found, score_escape = free_flight(
        primitives, o, d, xi, cfg_b, active, index=ff_index, t_max=t_cap
    )
    escaped = active & ~found & ~dead
    at_surface = escaped & s_valid
    escaped_env = escaped & ~s_valid
    active_medium = active & found
    if cfg.max_depth > 0:
        active_medium = active_medium & ((i + 1) < cfg.max_depth)
        at_surface = at_surface & ((i + 1) < cfg.max_depth)

    # environment hit with MIS
    if cfg.use_indirect:
        if cfg.use_nee and i > 0:
            emitter_pdf = emitter.pdf_direction(d)
        else:
            emitter_pdf = torch.zeros(rl, device=dev)
        if not (i == 0 and cfg.hide_emitters):
            lr_dir = (
                beta * score_escape[:, None] * _mis_weight(prev_pdf, emitter_pdf)[:, None]
                * emitter.eval(d)
            )
            l_acc = l_acc + torch.where(escaped_env[:, None], lr_dir, 0.0)

    # collision albedo + sampling-density score
    beta = torch.where(active_medium[:, None], beta * albedo * score_found[:, None], beta)
    p_int = o + d * torch.where(found, t_samp, 0.0)[:, None]

    # the surface vertex: the transmittance-to-surface score, shading frame,
    # interpolated attributes
    if surf is not None:
        beta = torch.where(at_surface[:, None], beta * score_escape[:, None], beta)
        n_sh = surf.mesh.interpolate("_vn", fid, uv)
        n_sh = n_sh / torch.clamp(torch.linalg.norm(n_sh, dim=-1, keepdim=True), min=1e-12)
        p_surf = o + d * torch.where(s_valid, t_surf, 0.0)[:, None] + 1e-4 * n_sh
        wi_loc = bsdf_ops.to_local(n_sh, -d)
        attrs_s = {}
        for name in surf.attr_names:
            v = surf.mesh.interpolate(name, fid, uv)
            attrs_s[name] = v if v.shape[-1] > 1 else v[:, 0]

    # NEE from the medium or surface vertex
    if cfg.use_nee:
        with spans.span("prb.nee"):
            ds_dir, ds_val, ds_pdf = emitter.sample_direction(u[:, _NEE:_NEE + 2])
            p_nee = torch.where(at_surface[:, None], p_surf, p_int) if surf is not None else p_int
            need_tr = (active_medium | at_surface) & (ds_pdf > 0.0)
            tr = torch.zeros(rl, dtype=o.dtype, device=dev)
            idx = torch.nonzero(need_tr)[:, 0]
            if idx.numel():
                t = transmittance(primitives, p_nee[idx], ds_dir[idx], cfg)
                if surf is not None:
                    t = t * (~mesh_mod.occluded(surf.mesh, p_nee[idx], ds_dir[idx])).to(t.dtype)
                tr = _scatter(tr, idx, t)
            phase_val = eval_phase_pdf(-d, ds_dir, cfg)
            nee_val = phase_val[:, None] * torch.ones((rl, 3), device=dev)
            nee_pdf = phase_val
            if surf is not None:
                wl = bsdf_ops.to_local(n_sh, ds_dir)
                b_val = surf.bsdf.eval(attrs_s, wi_loc, wl, at_surface)
                b_pdf = surf.bsdf.pdf(attrs_s, wi_loc, wl, at_surface)
                nee_val = torch.where(at_surface[:, None], b_val, nee_val)
                nee_pdf = torch.where(at_surface, b_pdf, nee_pdf)
            nee_pdf_mis = nee_pdf if cfg.use_indirect else torch.zeros_like(nee_pdf)
            lr_nee = (
                beta * nee_val * _mis_weight(ds_pdf, nee_pdf_mis)[:, None] * tr[:, None]
                * ds_val / torch.clamp(ds_pdf, min=1e-30)[:, None]
            )
            l_acc = l_acc + torch.where(need_tr[:, None], lr_nee, 0.0)

    # phase sampling
    wo, phase_pdf = _sample_phase(u[:, _PHASE:_PHASE + 2], d, cfg)
    o = torch.where(active_medium[:, None], p_int, o)
    d = torch.where(active_medium[:, None], wo, d)
    prev_pdf = torch.where(active_medium, phase_pdf, prev_pdf)
    active = active_medium

    # BSDF sampling at the surface vertex
    if surf is not None:
        wo_l, bs_pdf, bs_w = surf.bsdf.sample(attrs_s, wi_loc, u[:, _BSDF1],
                                              u[:, _BSDF2:_BSDF2 + 2], at_surface)
        surf_cont = at_surface & (bs_pdf > 0.0)
        o = torch.where(surf_cont[:, None], p_surf, o)
        d = torch.where(surf_cont[:, None], bsdf_ops.to_world(n_sh, wo_l), d)
        beta = torch.where(surf_cont[:, None], beta * bs_w, beta)
        prev_pdf = torch.where(surf_cont, bs_pdf, prev_pdf)
        active = active | surf_cont

    # Russian roulette + throughput kill
    if cfg.use_rr:
        q = torch.clamp(torch.amax(beta, dim=-1), max=0.99)
        if (i + 1) > cfg.rr_depth:
            active = active & (u[:, _RR] < q)
            beta = beta / torch.clamp(q, min=1e-6)[:, None]
    active = active & torch.any(beta > 0.005, dim=-1)
    return o, d, beta, l_acc, prev_pdf, active


@register_integrator("volprim_prb")
def radiance(
    primitives: EllipsoidScene,
    emitter,
    o: torch.Tensor,
    d: torch.Tensor,
    cfg: PRBConfig,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    bsdf=None,
) -> torch.Tensor:
    """Path-traced radiance [R, 3] for rays o, d [R, 3] on their device,
    whose random streams hang off one key drawn from ``generator`` (a
    ``torch.Generator`` on that device, required): :func:`radiance_keyed`
    with that key and ray indices 0..R-1.

    ``mesh`` (a :class:`scene.mesh.TriangleMesh`) adds opaque surfaces: the
    march is capped at the nearest hit and the path continues with a BSDF
    vertex. ``bsdf`` is an :mod:`ops.bsdf` model (default ``Diffuse``),
    whose attributes are interpolated from the mesh's vertex attributes."""
    if generator is None:
        raise ValueError("radiance needs an explicit torch.Generator on the rays' device")
    return radiance_keyed(primitives, emitter, o, d, cfg, streams.draw_key(generator, o.device),
                          mesh=mesh, bsdf=bsdf)


@spans.spanned("prb.radiance")
def radiance_keyed(primitives: EllipsoidScene, emitter, o: torch.Tensor, d: torch.Tensor,
                   cfg: PRBConfig, key: torch.Tensor, first: int = 0, mesh=None,
                   bsdf=None) -> torch.Tensor:
    """:func:`radiance` on the streams of ``key`` (``ops.streams.draw_key``'s
    [1] int64 tensor), ray j drawing as ray ``first + j``: rays [a, b) of a
    call given its key and ``first=a`` give rows [a, b) of the whole call's
    radiance. Rays are traced in chunks of ``cfg.ray_chunk``."""
    if emitter is None:
        raise ValueError("the path tracer needs an environment emitter")
    ff_index = build_ff_index(primitives, cfg) if cfg.use_clusters else None
    surf = _Surfaces.of(mesh, bsdf) if mesh is not None else None
    table = streams.bounce_table(key, cfg.num_bounces, N_SLOTS)
    r = o.shape[0]
    ids = torch.arange(first, first + r, dtype=torch.int64, device=o.device)
    rc = cfg.ray_chunk if cfg.ray_chunk and r > cfg.ray_chunk else r
    return torch.cat([
        _radiance_chunk(primitives, emitter, o[s:s + rc], d[s:s + rc], ids[s:s + rc], cfg, table,
                        ff_index, surf)
        for s in range(0, r, rc)
    ])


def _radiance_chunk(primitives, emitter, o, d, ids, cfg, table, ff_index, surf):
    r = o.shape[0]
    dev = o.device
    beta = torch.ones((r, 3), dtype=o.dtype, device=dev)
    l_acc = torch.zeros((r, 3), dtype=o.dtype, device=dev)
    prev_pdf = torch.ones((r,), dtype=o.dtype, device=dev)
    active = torch.ones((r,), dtype=torch.bool, device=dev)
    o_c, d_c = o.contiguous(), d.contiguous()
    cfg_tail = cfg.tail_cfg()
    for i in range(cfg.num_bounces):
        idx = torch.nonzero(active)[:, 0]
        if not idx.numel():
            break
        spans.count("prb.ray_bounces", idx.numel())
        with spans.span("prb.bounce"):
            cfg_b = cfg if i < cfg.tail_after else cfg_tail
            o_n, d_n, beta_n, l_n, p_n, a_n = _bounce(
                primitives, emitter, cfg, cfg_b, i, o_c[idx], d_c[idx], beta[idx], l_acc[idx],
                prev_pdf[idx], streams.uniforms(table, i, ids[idx]), ff_index=ff_index,
                surf=surf,
            )
            o_c, d_c = _scatter(o_c, idx, o_n), _scatter(d_c, idx, d_n)
            beta, l_acc = _scatter(beta, idx, beta_n), _scatter(l_acc, idx, l_n)
            prev_pdf = _scatter(prev_pdf, idx, p_n)
            active = _scatter(active, idx, a_n)
    return l_acc
