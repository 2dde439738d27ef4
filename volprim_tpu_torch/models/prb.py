"""Volumetric-primitive path tracer with NEE (volprim_tpu.models.prb).

The forward render of the JAX package's physically based scattering
integrator, in its ``walk_backend="pallas"`` configuration: the free-flight
window walk runs through ``kernels.ffwalk`` (a hand-written CUDA kernel for
CUDA tensors). Per bounce, on the rays still alive:

1. **Free flight** (:func:`free_flight`, the jump path): the complete
   optical depth F along each ray (:func:`optical_depth`, an
   order-independent chunked sum over every primitive) decides escape in
   closed form (chi = -log xi >= F). Only the rays that will cross are
   walked: their K' nearest [entry, exit) intervals are collected
   (:func:`_gather_intervals`), the walk jumps to the interval block where
   the cumulative whole-interval depth first exceeds chi, and the fused
   window walk samples the interaction distance. Albedo, sampling density
   and transmittance are then recomputed differentiably at the sample
   point; the walk's decisions are stop-gradient.
2. **Emitter hit** with MIS against the NEE pdf for escaping rays.
3. **NEE**: an emitter direction, its transmittance along the shadow ray.
4. **Phase sampling** of the next direction, throughput kill.

Compaction is PyTorch's: each bounce indexes the live rays, and free flight
the needy rays, directly and scatters the results back (the JAX package
keeps static shapes with sorted fixed-size chunks and skipped
``lax.cond``s; every ray's result is independent of its chunk). The
``ray_chunk`` knob still bounds the [R, C] temporaries.

Random numbers come from one ``torch.Generator`` on the render's device.
Per bounce, for the live rays in order: xi in [1e-7, 1) for free flight,
2 uniforms for NEE, 2 for the phase, 1 for Russian roulette (when on). They
do not reproduce ``jax.random`` bits; everything downstream of them is
deterministic.

Not ported here, each raising ``NotImplementedError`` that names its
ROADMAP item: ``walk_backend="xla"``, ``jump=False`` and the re-collection
rounds, ``use_clusters``, ``coeff_gemm``, ``count_intervals`` /
``suggest_budgets``, surfaces (``mesh`` / ``bsdf``), the Epanechnikov
kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..kernels import ffwalk
from ..ops import kernels as kernel_ops
from ..ops import quadric
from ..ops.kernels import Kernel
from ..scene.ellipsoids import EllipsoidScene
from .base import pad_primitives

_BIG_T = 1e7  # effective infinity for shadow-ray segment integrals


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


def _check_ported(cfg: PRBConfig) -> None:
    """Raise for the configurations this slice does not port."""
    if cfg.walk_backend != "pallas":
        raise NotImplementedError(
            f"walk_backend={cfg.walk_backend!r}: only the fused walk "
            "(walk_backend='pallas') is ported (ROADMAP.md §A5)"
        )
    if not cfg.jump:
        raise NotImplementedError(
            "jump=False (the sequential walk and its re-collection rounds) is "
            "not ported (ROADMAP.md §A5)"
        )
    if cfg.use_clusters:
        raise NotImplementedError("use_clusters is not ported (ROADMAP.md §A5)")
    if cfg.coeff_gemm:
        raise NotImplementedError("coeff_gemm is not ported (ROADMAP.md §A5)")
    if cfg.kernel.type != "gaussian":
        # JAX sends every kernel but the unnormalized Gaussian down its
        # general walk, not the fused one this slice ports
        raise NotImplementedError(
            f"kernel_type={cfg.kernel_type!r}: the path tracer's general walk for "
            "non-Gaussian kernels is not ported (ROADMAP.md §A5)"
        )


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


def _gather_intervals(
    prims: EllipsoidScene,
    o: torch.Tensor,
    d: torch.Tensor,
    t_min: torch.Tensor,
    k: int,
    chunk_size: int,
    kern: Optional[Kernel] = None,
):
    """Per-ray k nearest [entry, exit) extent-ellipsoid intervals with exit
    > t_min, entries clamped to t_min.

    Returns (entry [R, k] ascending, exit [R, k], ids [R, k], count [R],
    full_tau [R, k] or None). The order is (entry, primitive id) ascending,
    with +inf entries (id 0, exit +inf) padding the end: a stable sort of
    [best | chunk] per chunk, which breaks ties as the JAX package's
    ``lax.top_k`` does. With ``kern`` (the Gaussian kernel), ``full_tau``
    carries each interval's whole optical depth sigma_t * D(entry, exit).
    """
    padded, c = _padded_chunks(prims, chunk_size)
    n = padded.num_prims
    r = o.shape[0]
    dev = o.device
    inf = torch.inf
    with_tau = kern is not None
    sig_all = padded.attrs["sigma_t"][:, 0] if with_tau else None
    sprod_all = padded.scale_prod()
    best_t = torch.full((r, k), inf, dtype=o.dtype, device=dev)
    best_exit = torch.full_like(best_t, inf)
    best_id = torch.zeros((r, k), dtype=torch.int64, device=dev)
    best_tau = torch.zeros_like(best_t)
    for start in range(0, n, c):
        sl = slice(start, start + c)
        coeffs = quadric.ray_prim_coeffs(
            o, d, padded.centers[sl], padded.scales[sl], padded.quats[sl]
        )
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
            tau_c = sig_all[sl][None, :] * kernel_ops.gaussian_integral_segment(
                coeffs, sprod_all[sl][None, :], entry, t_far, valid
            )
            best_tau = torch.gather(torch.cat([best_tau, tau_c], dim=1), 1, sel)
        best_t = torch.gather(cand_t, 1, sel)
        best_exit = torch.gather(cand_exit, 1, sel)
        best_id = torch.gather(cand_id, 1, sel)
    count = torch.sum(torch.isfinite(best_t), dim=1)
    return best_t, best_exit, best_id, count, (best_tau if with_tau else None)


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
    key, sel = torch.sort(selkey, dim=1, stable=True)  # ranks 1..k ascending
    key, sel = key[:, :k], sel[:, :k]
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
    ids_s = torch.gather(ids, 1, sel)
    coeffs = quadric.pair_coeffs_gathered(o, d, prims.centers, prims.scales, prims.quats, ids_s)
    sig = torch.where(opened, prims.attrs["sigma_t"][:, 0][ids_s], 0.0)
    sp = prims.scale_prod()[ids_s]
    tau_full = torch.where(opened, torch.gather(tau_fin, 1, sel), 0.0)
    tau_part = sig * kernel_ops.gaussian_integral_segment(
        coeffs, sp, raw_entry, t_pt[:, None].expand_as(raw_entry), opened
    )
    return f_entered - torch.sum(torch.clamp(tau_full - tau_part, min=0.0), dim=1)


def _run_windows_pallas(prims, cfg, o, d, xi, entry, exit_t, ids, t_budget, t_cap, act, t_min0,
                 trans0, n_windows):
    """The fused window walk over a collected table, then the
    differentiable post-pass at the sample point (albedo, sampling
    density) and at the resolve point (escape transmittance).

    Returns (found, resolved, t_samp, albedo [R, 3], density_at_sample,
    trans); a ray neither found nor resolved ran out of budget."""
    k = cfg.max_overlaps
    fin = torch.isfinite(entry)
    cp, alpha, beta = _walk_columns(prims, o, d, entry, ids)
    chi = torch.log(torch.clamp(trans0.detach(), min=1e-30)) - torch.log(
        torch.clamp(xi.detach(), min=1e-30)
    )
    found, resolved, _, capres, t_samp = ffwalk.walk(
        entry, exit_t, cp, alpha, beta, chi, t_budget, t_cap, act, t_min0,
        k=k, n_windows=n_windows, solver_iters=cfg.solver_max_iterations,
        solver_disabled=cfg.solver_type == "disabled",
    )
    found, resolved = found & act, resolved & act

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
    alb_all = prims.attrs["albedo"]
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
    return found, resolved, t_samp, albedo, density_at_sample, trans


def _jump_walk(prims, cfg, o, d, xi, entry, exit_t, ids, tau_fin, t_budget, t_cap, needy):
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
    f_b = _f_exact_at(prims, o, d, entry, exit_t, ids, tau_fin, b_t, k)
    trans0 = torch.exp(-torch.clamp(f_b, min=0.0))
    return _run_windows_pallas(
        prims, cfg, o, d, xi, entry, exit_t, ids, t_budget, t_cap, needy, b_t, trans0,
        min(cfg.max_windows, cfg.jump_windows),
    )


def _scatter(base: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``base`` with rows ``idx`` replaced by ``values`` (differentiable)."""
    return base.index_copy(0, idx, values.to(base.dtype))


def free_flight(
    primitives: EllipsoidScene,
    o: torch.Tensor,
    d: torch.Tensor,
    xi: torch.Tensor,
    cfg: PRBConfig,
    active: torch.Tensor,
    t_max: Optional[torch.Tensor] = None,
):
    """Sample a medium interaction along each ray (exact inverse CDF over
    the multi-primitive density), on the jump path with the fused walk.

    Returns (found [R], dead [R], t_samp [R], albedo [R, 3], score_found [R],
    score_escape [R]). ``dead`` marks rays that ran out of collection budget
    or windows before resolving. The score factors are numerically 1 but
    carry the gradients of the sampling density and survival probability.
    ``t_max`` [R] (optional) caps the march at a surface: rays reaching it
    unresolved escape with the transmittance of [0, t_max].
    """
    primitives.require_attrs(["sigma_t", "albedo"])
    _check_ported(cfg)
    r = o.shape[0]
    dev = o.device
    kp = cfg.interval_budget
    t_cap = torch.full((r,), torch.inf, dtype=o.dtype, device=dev) if t_max is None else t_max

    chi = -torch.log(torch.clamp(xi.detach(), min=1e-30))
    f_total = optical_depth(primitives, o, d, cfg)
    surface_capped = torch.isfinite(t_cap)
    will_cross = f_total.detach() > chi
    no_cross = active & ~will_cross & ~surface_capped
    trans_jump = torch.exp(-torch.clamp(f_total, min=0.0))
    needy = active & (will_cross | surface_capped)

    found = torch.zeros_like(needy)
    resolved = no_cross
    t_samp = torch.full((r,), torch.inf, dtype=o.dtype, device=dev)
    albedo = torch.zeros((r, 3), dtype=o.dtype, device=dev)
    density_at_sample = torch.ones((r,), dtype=o.dtype, device=dev)
    trans = trans_jump
    idx = torch.nonzero(needy)[:, 0]
    if idx.numel():
        o_n, d_n, xi_n, tc_n = o[idx], d[idx], xi[idx], t_cap[idx]
        entry, exit_t, ids, count, full_tau = _gather_intervals(
            primitives, o_n, d_n, torch.zeros_like(xi_n), kp, cfg.chunk_size, kern=cfg.kernel
        )
        t_budget = torch.where(count >= kp, entry[:, -1], torch.inf)
        tau_fin = torch.where(torch.isfinite(entry), full_tau, 0.0)
        w_found, w_res, w_ts, w_alb, w_dens, w_trans = _jump_walk(
            primitives, cfg, o_n, d_n, xi_n, entry, exit_t, ids, tau_fin, t_budget, tc_n,
            torch.ones_like(idx, dtype=torch.bool),
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


def optical_depth(
    primitives: EllipsoidScene,
    o: torch.Tensor,
    d: torch.Tensor,
    cfg: PRBConfig,
    t_max: float = _BIG_T,
) -> torch.Tensor:
    """Total optical depth F along [0, t_max]: an order-independent sum over
    every primitive, streamed in chunks of ``cfg.chunk_size``.
    Differentiable."""
    kern = cfg.kernel
    prims, c = _padded_chunks(primitives, cfg.chunk_size)
    r = o.shape[0]
    t0 = torch.zeros((r, 1), dtype=o.dtype, device=o.device)
    t1 = torch.full((r, 1), t_max, dtype=o.dtype, device=o.device)
    tau = torch.zeros((r,), dtype=o.dtype, device=o.device)
    sprod_all = prims.scale_prod()
    for start in range(0, prims.num_prims, c):
        sl = slice(start, start + c)
        coeffs = quadric.ray_prim_coeffs(
            o, d, prims.centers[sl], prims.scales[sl], prims.quats[sl]
        )
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


def _bounce(primitives, emitter, cfg, cfg_b, i, o, d, beta, l_acc, prev_pdf, generator):
    """One bounce of live rays. Returns (o, d, beta, l_acc, prev_pdf,
    active)."""
    rl = o.shape[0]
    dev = o.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    xi = 1e-7 + (1.0 - 1e-7) * uniform(rl)
    u_nee = uniform(rl, 2) if cfg.use_nee else None
    u_phase = uniform(rl, 2)
    u_rr = uniform(rl) if cfg.use_rr else None
    active = torch.ones(rl, dtype=torch.bool, device=dev)

    found, dead, t_samp, albedo, score_found, score_escape = free_flight(
        primitives, o, d, xi, cfg_b, active
    )
    escaped = active & ~found & ~dead
    active_medium = active & found
    if cfg.max_depth > 0:
        active_medium = active_medium & ((i + 1) < cfg.max_depth)

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
            l_acc = l_acc + torch.where(escaped[:, None], lr_dir, 0.0)

    # collision albedo + sampling-density score
    beta = torch.where(active_medium[:, None], beta * albedo * score_found[:, None], beta)
    p_int = o + d * torch.where(found, t_samp, 0.0)[:, None]

    # NEE
    if cfg.use_nee:
        ds_dir, ds_val, ds_pdf = emitter.sample_direction(u_nee)
        need_tr = active_medium & (ds_pdf > 0.0)
        tr = torch.zeros(rl, dtype=o.dtype, device=dev)
        idx = torch.nonzero(need_tr)[:, 0]
        if idx.numel():
            tr = _scatter(tr, idx, transmittance(primitives, p_int[idx], ds_dir[idx], cfg))
        phase_val = eval_phase_pdf(-d, ds_dir, cfg)
        nee_val = phase_val[:, None] * torch.ones((rl, 3), device=dev)
        nee_pdf_mis = phase_val if cfg.use_indirect else torch.zeros_like(phase_val)
        lr_nee = (
            beta * nee_val * _mis_weight(ds_pdf, nee_pdf_mis)[:, None] * tr[:, None]
            * ds_val / torch.clamp(ds_pdf, min=1e-30)[:, None]
        )
        l_acc = l_acc + torch.where(need_tr[:, None], lr_nee, 0.0)

    # phase sampling
    wo, phase_pdf = _sample_phase(u_phase, d, cfg)
    o = torch.where(active_medium[:, None], p_int, o)
    d = torch.where(active_medium[:, None], wo, d)
    prev_pdf = torch.where(active_medium, phase_pdf, prev_pdf)
    active = active_medium

    # Russian roulette + throughput kill
    if cfg.use_rr:
        q = torch.clamp(torch.amax(beta, dim=-1), max=0.99)
        if (i + 1) > cfg.rr_depth:
            active = active & (u_rr < q)
            beta = beta / torch.clamp(q, min=1e-6)[:, None]
    active = active & torch.any(beta > 0.005, dim=-1)
    return o, d, beta, l_acc, prev_pdf, active


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
    drawing from ``generator`` (a ``torch.Generator`` on that device,
    required). Rays are traced in chunks of ``cfg.ray_chunk``."""
    if emitter is None:
        raise ValueError("the path tracer needs an environment emitter")
    if generator is None:
        raise ValueError("radiance needs an explicit torch.Generator on the rays' device")
    if mesh is not None or bsdf is not None:
        raise NotImplementedError("surfaces (mesh, bsdf) are not ported (ROADMAP.md §A5)")
    _check_ported(cfg)
    r = o.shape[0]
    rc = cfg.ray_chunk
    if rc and r > rc:
        sub = dataclasses.replace(cfg, ray_chunk=0)
        return torch.cat([
            radiance(primitives, emitter, o[s:s + rc], d[s:s + rc], sub, generator)
            for s in range(0, r, rc)
        ])
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
        cfg_b = cfg if i < cfg.tail_after else cfg_tail
        o_n, d_n, beta_n, l_n, p_n, a_n = _bounce(
            primitives, emitter, cfg, cfg_b, i, o_c[idx], d_c[idx], beta[idx], l_acc[idx],
            prev_pdf[idx], generator,
        )
        o_c, d_c = _scatter(o_c, idx, o_n), _scatter(d_c, idx, d_n)
        beta, l_acc = _scatter(beta, idx, beta_n), _scatter(l_acc, idx, l_n)
        prev_pdf = _scatter(prev_pdf, idx, p_n)
        active = _scatter(active, idx, a_n)
    return l_acc
