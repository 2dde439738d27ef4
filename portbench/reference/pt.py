"""The plain reference of the path-traced cell: volumetric path tracing with
NEE through Gaussian primitives, as the port's ``models/prb`` states it
for the cell's configuration (the jump path, the Gaussian kernel, the
fused walk's semantics, no surfaces, the isotropic phase, NEE on, Russian
roulette off, max_depth -1 capped at ``bounce_cap``), and the film it
develops.

Per bounce every ray is traced alone, masked, in float32:

- the escape test: the optical depth F over [0, 1e7] of every primitive in
  one plain sum (``optical_depth``), chi = -log(xi), escape where chi >= F;
- otherwise the K' nearest [entry, exit) intervals of all primitives (one
  stable sort by entry, ties to the lower primitive id), the jump to the
  first block of k intervals whose cumulative depth could reach chi, and
  the window walk from there (``walk``: windows of the first k open
  intervals, the depth through the shared erf antiderivative, a bisection
  of ``BISECT_ITERS`` steps snapped to the tightest enclosing boundaries,
  a midpoint solve of the program's ``solver_max_iterations`` steps); rays
  past the collection budget or out of windows die;
- the albedo at the sample (the sigma_t-pdf weighted average over the
  covering window), the environment hit with MIS against the NEE pdf, NEE
  with its shadow ray's transmittance exp(-F), isotropic phase sampling,
  the throughput kill at ``KILL``.

Every uniform is the port's counter-based hash of (key, ray index, bounce,
slot) (``ops/streams``), the key and the film jitter drawn from a
generator in the state the program's frame started from, as
``models.render`` draws them. There are no kernels, no compaction and no
chunk streaming: the departures from the program are the plain sums over
all primitives (the program sums 1,024-primitive chunks), the plain walk
in place of ``csrc/ffwalk.cu`` (a warp's sums in another order), and rows
of ``ROW_BLOCK`` rays at a time for memory. ``PAIR_DTYPE`` is the pair
math's working precision; a control sets a lower one. :func:`trace` runs
with TF32 off. Plain PyTorch; imports nothing of the port.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .scene import Camera, rotation_matrix

PAIR_DTYPE = torch.float32
ROW_BLOCK = 8192  # rays of one block of all-pairs math (memory)
BIG_T = 1e7  # the shadow rays' and the escape test's end
BIG = 3.0e37  # the walk's finite stand-in for +inf
BISECT_ITERS = 22
KILL = 0.005
N_SLOTS = 9  # xi, NEE (2), phase (2), Russian roulette, the BSDF's three
M32 = 0xFFFFFFFF
KEY_RANGE = 1 << 62
SLOT_STRIDE = 64
_INV_SQRT2 = 0.7071067811865476
_TWO_PI = 2.0 * math.pi


# the integrator fields this reference follows, at the values it follows
SUPPORTED = dict(jump=True, kernel_type="gaussian", solver_type="bisection", phase="isotropic",
                 use_nee=True, use_indirect=True, hide_emitters=False, rr_depth=-1,
                 walk_backend="pallas")


def supported(cfg: dict) -> None:
    """Raise unless the configuration's integrator is the one traced here."""
    off = {k: cfg.get(k) for k, v in SUPPORTED.items() if cfg.get(k) != v}
    if off:
        raise ValueError(f"the path-traced reference does not follow {off}")


# ---- the streams -----------------------------------------------------------

def pcg(v: torch.Tensor) -> torch.Tensor:
    """PCG's hash of 32-bit words held in int64."""
    state = (v * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def bounce_table(key: torch.Tensor, n_bounces: int) -> torch.Tensor:
    """[n_bounces, 1 + N_SLOTS] words of one key."""
    b = torch.arange(n_bounces, dtype=torch.int64, device=key.device)[:, None]
    s = torch.arange(N_SLOTS + 1, dtype=torch.int64, device=key.device)[None, :]
    k0, k1 = key & M32, (key >> 32) & M32
    return pcg(pcg(pcg(b * SLOT_STRIDE + s) ^ k0) ^ k1)


def uniforms(rows: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """[R, N_SLOTS] uniforms of rays ``index`` [R] from their own table rows
    [R, 1 + N_SLOTS] of one bounce."""
    h = pcg(index ^ rows[:, 0])
    w = pcg(h[:, None] ^ rows[:, 1:])
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))


# ---- the environment map ---------------------------------------------------

class Sky:
    """The equirectangular map with its CDF tables: bilinear lookup,
    importance sampling by sin-weighted luminance, the solid-angle pdf."""

    def __init__(self, data: np.ndarray, dev):
        self.data = torch.as_tensor(np.asarray(data, np.float32)).to(dev)
        h = self.data.shape[0]
        lum = torch.mean(self.data, dim=-1)
        theta = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * math.pi
        lum = torch.clamp(lum * torch.sin(theta)[:, None], min=1e-12)
        cond = torch.cumsum(lum, dim=1)
        row = torch.cumsum(cond[:, -1], dim=0)
        self.row_cdf, self.cond_cdf = row / row[-1], cond / cond[:, -1:]
        self.lum, self.lum_integral = lum, row[-1]

    @staticmethod
    def _uv(d):
        u = torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * math.pi)
        u = torch.where(u < 0.0, u + 1.0, u)
        return u, torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi

    def eval(self, d):
        h, w = self.data.shape[0], self.data.shape[1]
        u, v = self._uv(d)
        fx, fy = u * w - 0.5, v * h - 0.5
        x0 = torch.floor(fx).to(torch.int64)
        y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, h - 1)
        tx = (fx - x0)[..., None]
        ty = torch.clamp(fy - y0, 0.0, 1.0)[..., None]
        x0w, x1w = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        return (self.data[y0, x0w] * (1 - tx) * (1 - ty) + self.data[y0, x1w] * tx * (1 - ty)
                + self.data[y1, x0w] * (1 - tx) * ty + self.data[y1, x1w] * tx * ty)

    def _pdf(self, y, x, v):
        h, w = self.lum.shape
        pmf = self.lum[y, x] / self.lum_integral
        sin_theta = torch.clamp(torch.sin(v * math.pi), min=1e-6)
        return pmf * (h * w) / (2.0 * math.pi * math.pi * sin_theta)

    def sample(self, s2):
        """(directions, radiance, pdf) of uniforms s2 [R, 2]."""
        h, w = self.lum.shape
        s0, s1 = s2[..., 0].contiguous(), s2[..., 1].contiguous()
        y = torch.clamp(torch.searchsorted(self.row_cdf, s0), 0, h - 1)
        cond = self.cond_cdf[y]
        x = torch.clamp(torch.searchsorted(cond, s1[:, None])[:, 0], 0, w - 1)
        row_prev = torch.where(y > 0, self.row_cdf[torch.clamp(y - 1, min=0)], 0.0)
        row_pmf = torch.clamp(self.row_cdf[y] - row_prev, min=1e-12)
        rem_y = torch.clamp((s0 - row_prev) / row_pmf, 0.0, 1.0 - 1e-6)
        cond_x = torch.gather(cond, 1, x[:, None])[:, 0]
        cond_prev = torch.where(
            x > 0, torch.gather(cond, 1, torch.clamp(x - 1, min=0)[:, None])[:, 0], 0.0)
        rem_x = torch.clamp((s1 - cond_prev) / torch.clamp(cond_x - cond_prev, min=1e-12),
                            0.0, 1.0 - 1e-6)
        u, v = (x + rem_x) / w, (y + rem_y) / h
        theta, phi = v * math.pi, u * 2.0 * math.pi
        st = torch.sin(theta)
        d = torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)], dim=-1)
        return d, self.eval(d), self._pdf(y, x, v)

    def pdf(self, d):
        h, w = self.lum.shape
        u, v = self._uv(d)
        x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
        y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
        return self._pdf(y, x, v)


# ---- the medium --------------------------------------------------------------

class Medium:
    """The primitives (float32 tensors on one device) and their extent."""

    def __init__(self, arrays: dict, extent: float, dev):
        t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev) for k, v in arrays.items()}
        self.centers, self.scales, self.quats = t["centers"], t["scales"], t["quats"]
        self.sigma = t["sigma_t"][:, 0]
        alb = t["albedo"]
        self.albedo = alb.expand(-1, 3) if alb.shape[-1] == 1 else alb
        self.sprod = self.scales[:, 0] * self.scales[:, 1] * self.scales[:, 2]
        self.rot = rotation_matrix(self.quats)
        self.extent = extent

    @property
    def n(self) -> int:
        return self.centers.shape[0]


def _coeffs(o, d, m: Medium, dt):
    """(a, b, c) [R, N] of every ray against every primitive in ``dt``."""
    o, d = o.to(dt), d.to(dt)
    rot, ctr = m.rot.to(dt), m.centers.to(dt)
    inv_s2 = 1.0 / (m.scales.to(dt) * m.scales.to(dt))
    a = b = c = 0.0
    for i in range(3):
        r0, r1, r2 = rot[:, 0, i][None, :], rot[:, 1, i][None, :], rot[:, 2, i][None, :]
        w = d[:, 0:1] * r0 + d[:, 1:2] * r1 + d[:, 2:3] * r2
        p = ((o[:, 0:1] - ctr[None, :, 0]) * r0 + (o[:, 1:2] - ctr[None, :, 1]) * r1
             + (o[:, 2:3] - ctr[None, :, 2]) * r2)
        isi = inv_s2[None, :, i]
        a, b, c = a + w * w * isi, b + w * p * isi, c + p * p * isi
    return a, b, c


def _coeffs_of(o, d, m: Medium, ids):
    """(a, b, c) [R, K] of each ray against its primitives ``ids`` [R, K]."""
    ctr = m.centers[ids]
    px, py, pz = o[:, 0:1] - ctr[..., 0], o[:, 1:2] - ctr[..., 1], o[:, 2:3] - ctr[..., 2]
    a = b = c = 0.0
    for i in range(3):
        r0, r1, r2 = m.rot[:, 0, i][ids], m.rot[:, 1, i][ids], m.rot[:, 2, i][ids]
        inv_s = (1.0 / m.scales[:, i])[ids]
        w = (d[:, 0:1] * r0 + d[:, 1:2] * r1 + d[:, 2:3] * r2) * inv_s
        p = (px * r0 + py * r1 + pz * r2) * inv_s
        a, b, c = a + w * w, b + w * p, c + p * p
    return a, b, c


def _extent_hits(a, b, c, extent: float):
    q_min = c - (b * b) / a
    disc = (extent * extent - q_min) / a
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_peak = -b / a
    return (disc >= 0.0) & (t_peak + sq > 0.0), t_peak - sq, t_peak + sq


def _scrub(x, active):
    x = torch.clamp(x, min=0.0)
    x = torch.where(torch.isfinite(x), x, 0.0)
    return torch.where(active, x, 0.0)


def _segment(a, b, c, sprod, t0, t1, active):
    """The normalized Gaussian's line integral over [t0, t1]."""
    active = active & (t0 < t1) & (t1 > 0.0)
    inv = _INV_SQRT2 / torch.sqrt(a)
    q_min = torch.clamp(c - (b * b) / a, min=0.0)
    val = (torch.exp(-0.5 * q_min) / (2.0 * _TWO_PI * sprod * torch.sqrt(a))
           * (torch.erf((a * t1 + b) * inv) - torch.erf((a * t0 + b) * inv)))
    return _scrub(val, active)


def _blocks(fn, r: int, *args):
    """``fn`` over rows [s, s + ROW_BLOCK) of each argument, concatenated."""
    outs = [fn(*(x[s:s + ROW_BLOCK] for x in args)) for s in range(0, r, ROW_BLOCK)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def optical_depth(m: Medium, o, d, hits: list = None):
    """F [R] over [0, BIG_T]: every primitive's depth in one plain sum.
    ``hits``, if given, receives each row's count of primitives whose
    extent the ray meets ahead of its origin (a [R] tensor)."""
    dt = PAIR_DTYPE
    rows = []

    def block(o, d):
        a, b, c = _coeffs(o, d, m, dt)
        valid, _, t_far = _extent_hits(a, b, c, m.extent)
        valid = valid & (t_far > 0.0)
        rows.append(torch.sum(valid, dim=1))
        zero = torch.zeros((o.shape[0], 1), dtype=dt, device=o.device)
        dens = _segment(a, b, c, m.sprod.to(dt)[None, :], zero, zero + BIG_T, valid)
        return torch.sum(dens * m.sigma.to(dt)[None, :], dim=1).to(o.dtype)

    out = _blocks(block, o.shape[0], o, d)
    if hits is not None:
        hits.append(torch.cat(rows))
    return out


def collect(m: Medium, o, d, kp: int):
    """The K' = ``kp`` nearest intervals from t = 0 (entry ascending, ties to
    the lower id; +inf entries with id 0 and exit +inf padding the end),
    their ids and whole depths [R, K']."""
    dt = PAIR_DTYPE

    def block(o, d):
        a, b, c = _coeffs(o, d, m, dt)
        valid, t_near, t_far = _extent_hits(a, b, c, m.extent)
        valid = valid & (t_far > 0.0)
        entry = torch.where(valid, torch.clamp(t_near, min=0.0), torch.inf)
        tau = m.sigma.to(dt)[None, :] * _segment(a, b, c, m.sprod.to(dt)[None, :],
                                                 torch.where(valid, entry, t_far), t_far, valid)
        sel = torch.sort(entry, dim=1, stable=True).indices[:, :kp]
        e = torch.gather(entry, 1, sel)
        fin = torch.isfinite(e)
        x = torch.where(fin, torch.gather(t_far, 1, sel), torch.inf)
        return (e.to(o.dtype), x.to(o.dtype), torch.where(fin, sel, 0),
                torch.where(fin, torch.gather(tau, 1, sel), 0.0).to(o.dtype))

    return _blocks(block, o.shape[0], o, d)


def _window(entry, exit_t, t_min, k: int):
    """The first k open intervals (exit > t_min) in entry order: (entry
    clamped to t_min, exit, positions, valid [R, k])."""
    kp = entry.shape[1]
    open_ = torch.isfinite(entry) & (exit_t > t_min[:, None])
    rank = torch.where(open_, torch.cumsum(open_.to(torch.int32), dim=1), kp + 2)
    key, sel = torch.sort(torch.where(rank <= k, rank, kp + 2), dim=1, stable=True)
    key, sel = key[:, :k], sel[:, :k]
    valid = key <= k
    e = torch.where(valid, torch.maximum(torch.gather(entry, 1, sel), t_min[:, None]), torch.inf)
    return e, torch.where(valid, torch.gather(exit_t, 1, sel), torch.inf), sel, valid


def _f_at(m, o, d, entry, exit_t, ids, tau_fin, t_pt, k: int):
    """F(t) at a point: the entered intervals' whole depths less the open
    intervals' tails beyond t (the first k open ones)."""
    entered = torch.isfinite(entry) & (entry < t_pt[:, None])
    f_entered = torch.sum(torch.where(entered, tau_fin, 0.0), dim=1)
    _, _, sel, valid = _window(entry, exit_t, t_pt, k)
    raw = torch.gather(entry, 1, sel)
    opened = valid & (raw < t_pt[:, None])
    raw = torch.where(opened, raw, t_pt[:, None])
    ids_s = torch.gather(ids, 1, sel)
    a, b, c = _coeffs_of(o, d, m, ids_s)
    sig = torch.where(opened, m.sigma[ids_s], 0.0)
    full = torch.where(opened, torch.gather(tau_fin, 1, sel), 0.0)
    part = sig * _segment(a, b, c, m.sprod[ids_s], raw, t_pt[:, None].expand_as(raw), opened)
    return f_entered - torch.sum(torch.clamp(full - part, min=0.0), dim=1)


def walk(entry, exit_t, cp, al, be, chi, t_budget, active, t_min0, k: int, n_windows: int,
         solver_iters: int, work: dict = None):
    """The window walk of rays ``active`` (no surface cap, so a window that
    reaches the end of the table resolves its ray). Returns (found,
    resolved, t_samp [R]); ``work`` receives, summed over rays, the windows
    walked, the intervals their selections scanned and selected, those
    selected where a ray was found, the longest prefix any window of a ray
    scanned (``scanned_max``) and the intervals any window of a ray
    selected (``selected_union``)."""
    cap = lambda x: torch.where(torch.isfinite(x), x, BIG)  # noqa: E731
    entry, exit_t = cap(entry), cap(exit_t)
    t_budget = cap(t_budget)[:, None]
    act = active[:, None]
    t_min, chi_rem = t_min0[:, None], chi[:, None]
    fin = entry < BIG * 0.5
    has_budget = t_budget < BIG * 0.5
    found = resolved = bdead = torch.zeros_like(act)
    t_samp = torch.full_like(t_min, BIG)
    scanned_max = torch.zeros(t_min.shape, dtype=torch.int64, device=t_min.device)
    ever_sel = torch.zeros_like(fin)

    def lane_sum(x):
        return torch.sum(x, dim=1, keepdim=True)

    for _ in range(n_windows):
        win = act & ~(found | resolved | bdead)
        openm = fin & (exit_t > t_min)
        rank = torch.cumsum(openm.to(torch.int32), dim=1)
        selm = openm & (rank <= k)
        nxt = torch.amin(torch.where(openm & (rank == k + 1), entry, BIG), 1, keepdim=True)
        has_more = nxt < BIG * 0.5
        min_exit = torch.amin(torch.where(selm, exit_t, BIG), 1, keepdim=True)
        t_limit = torch.where(has_more, torch.where(nxt > t_min, nxt, min_exit),
                              torch.full_like(nxt, BIG))
        t_limit = torch.minimum(t_limit, t_budget)
        full = has_more | has_budget
        lo = torch.where(selm, torch.maximum(entry, t_min), 0.0)
        hi = torch.maximum(torch.where(selm, torch.minimum(exit_t, t_limit), 0.0), lo)
        erf_lo = torch.erf(al * lo + be)
        tau_win = lane_sum(torch.where(selm, torch.clamp(cp * (torch.erf(al * hi + be) - erf_lo),
                                                         min=0.0), 0.0))
        found_w = win & (tau_win > chi_rem)
        resolved_w = win & ~found_w & ~full
        bdead_w = win & ~found_w & full & (t_limit >= t_budget)

        def tau_to(t):
            e = torch.erf(al * torch.minimum(torch.maximum(t, lo), hi) + be)
            return lane_sum(torch.where(selm, torch.clamp(cp * (e - erf_lo), min=0.0), 0.0))

        b_lo = t_min
        b_hi = torch.maximum(torch.amax(torch.where(selm, hi, 0.0), 1, keepdim=True), t_min)
        for _ in range(BISECT_ITERS):
            mid = 0.5 * (b_lo + b_hi)
            cross = tau_to(mid) > chi_rem
            b_lo, b_hi = torch.where(cross, b_lo, mid), torch.where(cross, mid, b_hi)
        t_star = 0.5 * (b_lo + b_hi)
        ev_lo = torch.maximum(
            torch.amax(torch.where(selm & (lo <= t_star), lo, -BIG), 1, keepdim=True),
            torch.amax(torch.where(selm & (hi <= t_star), hi, -BIG), 1, keepdim=True))
        t0 = torch.maximum(ev_lo, t_min)
        ev_hi = torch.minimum(
            torch.amin(torch.where(selm & (lo > t_star), lo, BIG), 1, keepdim=True),
            torch.amin(torch.where(selm & (hi > t_star), hi, BIG), 1, keepdim=True))
        t1 = torch.maximum(torch.minimum(ev_hi, t_limit), t0)
        chi_loc = chi_rem - tau_to(t0)
        tt = 0.5 * (t0 + t1)
        erf_t0 = torch.erf(al * torch.minimum(torch.maximum(t0, lo), hi) + be)
        step = 0.25 * (t1 - t0)
        for _ in range(solver_iters):
            e = torch.erf(al * torch.minimum(torch.maximum(tt, lo), hi) + be)
            tau_p = lane_sum(torch.where(selm, cp * (e - erf_t0), 0.0))
            tt = torch.minimum(torch.maximum(torch.where(tau_p > chi_loc, tt - step, tt + step),
                                             t0), t1)
            step = step * 0.5
        if work is not None:
            n_sel = torch.sum(selm, dim=1, keepdim=True)
            kth = torch.argmax((openm & (rank == k + 1)).to(torch.int8), dim=1, keepdim=True)
            n_fin = torch.sum(fin, dim=1, keepdim=True)
            scanned = torch.where(has_more, kth + 1, torch.clamp(n_fin + 1, max=fin.shape[1]))
            scanned = torch.where(win, scanned, 0)
            scanned_max = torch.maximum(scanned_max, scanned)
            ever_sel = ever_sel | (selm & win)
            for name, v in (("windows", win), ("scanned", scanned), ("selected", n_sel * win),
                            ("selected_found", n_sel * found_w)):
                work[name] = work.get(name, 0) + int(torch.sum(v))
        t_samp = torch.where(found_w, tt, t_samp)
        found, bdead = found | found_w, bdead | bdead_w
        resolved = resolved | found_w | resolved_w
        cont = win & ~found_w & ~resolved_w & ~bdead_w
        chi_rem = torch.where(cont, chi_rem - tau_win, chi_rem)
        t_min = torch.where(cont, t_limit, t_min)
    if work is not None:
        work["scanned_max"] = work.get("scanned_max", 0) + int(scanned_max.sum())
        work["selected_union"] = work.get("selected_union", 0) + int(ever_sel.sum())
    return found[:, 0], resolved[:, 0], torch.where(found[:, 0], t_samp[:, 0], torch.inf)


def free_flight(m: Medium, cfg: dict, o, d, xi, active, work: dict = None):
    """The jump path's free flight of every ray (masked by ``active``).
    Returns (found, dead, t_samp, albedo [R, 3], score_found, score_escape)."""
    k, kp = cfg["max_overlaps"], cfg["collect_budget"]
    chi = -torch.log(torch.clamp(xi, min=1e-30))
    hits = []
    f_total = optical_depth(m, o, d, hits)
    needy = active & (f_total > chi)
    trans_jump = torch.exp(-torch.clamp(f_total, min=0.0))
    entry, exit_t, ids, full_tau = collect(m, o, d, kp)
    count = torch.sum(torch.isfinite(entry), dim=1)
    t_budget = torch.where(count >= kp, entry[:, -1], torch.inf)
    tau_fin = torch.where(torch.isfinite(entry), full_tau, 0.0)
    # the jump to the first block whose cumulative depth could reach chi
    cum = torch.cumsum(tau_fin, dim=1)
    f_ub = cum[:, torch.arange(1, max(1, kp // k), device=o.device) * k - 1]
    jb = torch.sum(f_ub <= chi[:, None], dim=1)
    jb = torch.minimum(jb, torch.clamp(torch.div(count - 1, k, rounding_mode="floor"), min=0))
    b_t = torch.gather(entry, 1, torch.clamp(jb * k, max=kp - 1)[:, None])[:, 0]
    b_t = torch.where((jb > 0) & torch.isfinite(b_t), b_t, 0.0)
    b_t = torch.clamp(torch.minimum(b_t, t_budget), min=0.0)
    trans0 = torch.exp(-torch.clamp(_f_at(m, o, d, entry, exit_t, ids, tau_fin, b_t, k), min=0.0))
    # the walk's antiderivative columns
    fin = torch.isfinite(entry)
    a, b, c = _coeffs_of(o, d, m, ids)
    sp = m.sprod[ids]
    q_min = torch.clamp(c - (b * b) / a, min=0.0)
    cp = torch.where(fin, torch.exp(-0.5 * q_min) / (4.0 * math.pi * sp * torch.sqrt(a))
                     * torch.where(fin, m.sigma[ids], 0.0), 0.0)
    al = torch.where(fin, torch.sqrt(0.5 * a), 1.0)
    be = torch.where(fin, b / torch.sqrt(2.0 * a), 0.0)
    chi_w = torch.log(torch.clamp(trans0, min=1e-30)) - torch.log(torch.clamp(xi, min=1e-30))
    found, resolved, t_samp = walk(
        entry, exit_t, cp, al, be, chi_w, t_budget, needy, b_t, k,
        min(cfg["max_windows"], cfg["jump_windows"]), cfg["solver_max_iterations"], work)
    found, resolved = found & needy, resolved & needy
    if work is not None:
        work["walked"] = int(needy.sum())
        work["live_hits"] = int(hits[0][active].sum())
        work["walked_hits"] = int(hits[0][needy].sum())
    # the albedo and sampling density at the sample, the escape transmittance
    e_safe, x_safe = torch.where(fin, entry, 0.0), torch.where(fin, exit_t, 0.0)
    tau_w = torch.where(fin, torch.clamp(
        cp * (torch.erf(al * x_safe + be) - torch.erf(al * e_safe + be)), min=0.0), 0.0)
    ts_safe = torch.where(found, t_samp, 1.0)
    entry_s, exit_s, sel_s, valid_s = _window(entry, exit_t, ts_safe, k)
    ids_s = torch.gather(ids, 1, sel_s)
    a_s, b_s, c_s = _coeffs_of(o, d, m, ids_s)
    ts = ts_safe[:, None]
    q_at = (a_s * ts + 2.0 * b_s) * ts + c_s
    cover = (entry_s <= ts) & (exit_s >= ts)
    pdf_j = torch.where(cover, torch.exp(-0.5 * q_at) / (_TWO_PI ** 1.5 * m.sprod[ids_s])
                        * torch.where(valid_s, m.sigma[ids_s], 0.0), 0.0)
    accum = torch.sum(pdf_j, dim=1)
    alb = torch.stack([torch.sum(pdf_j * m.albedo[:, ch][ids_s], dim=1) for ch in range(3)], -1)
    rcp = torch.where(accum != 0.0, 1.0 / torch.where(accum == 0.0, 1.0, accum), 0.0)
    albedo = torch.where(found[:, None], alb * rcp[:, None], 0.0)
    f_ts = _f_at(m, o, d, entry, exit_t, ids, tau_w, ts_safe, k)
    density = torch.where(found, accum * torch.exp(-torch.clamp(f_ts, min=0.0)), 1.0)
    esc_w = resolved & ~found
    f_res = _f_at(m, o, d, entry, exit_t, ids, tau_w, torch.where(esc_w, 1e15, 1.0), k)
    trans = torch.where(needy, torch.where(esc_w, torch.exp(-torch.clamp(f_res, min=0.0)), 1.0),
                        trans_jump)
    resolved = (active & ~needy) | resolved
    dead = active & ~resolved
    escaped = active & resolved & ~found

    def score(x, on):
        safe = torch.where(on, x, 1.0)
        return torch.where(on, safe / torch.clamp(safe, min=1e-30), 1.0)

    return found, dead, torch.where(found, t_samp, torch.inf), albedo, score(density, found), \
        score(trans, escaped)


def _mis(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0.0, a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-30), 0.0)


def _to_frame(n, local):
    nz = n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return local[..., 0:1] * t + local[..., 1:2] * bt + local[..., 2:3] * n


def _full_f32(fn):
    """``fn`` with TF32 off for float32 matmuls and convolutions (none runs
    in the reference today: its precision stays float32 whatever is added),
    the flags restored after."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    return call


@_full_f32
def trace(m: Medium, sky: Sky, cfg: dict, o, d, index, rows_of, counts: dict = None):
    """Radiance [R, 3] of rays o, d, ray j drawing as ray ``index[j]`` from
    the table rows ``rows_of(bounce)`` [R, 1 + N_SLOTS]. ``counts``
    receives per bounce the live rays, the shadow rays, the rays walked,
    the (ray, primitive) pairs of each whose extents meet, and the walk's
    work (see :func:`walk`)."""
    r, dev = o.shape[0], o.device
    beta = torch.ones((r, 3), device=dev)
    l_acc = torch.zeros((r, 3), device=dev)
    prev_pdf = torch.ones((r,), device=dev)
    active = torch.ones((r,), dtype=torch.bool, device=dev)
    n_bounces = cfg["max_depth"] if cfg["max_depth"] > 0 else cfg["bounce_cap"]
    inv4pi = 1.0 / (4.0 * math.pi)
    for i in range(n_bounces):
        if not bool(active.any()):
            break
        u = uniforms(rows_of(i), index)
        xi = 1e-7 + (1.0 - 1e-7) * u[:, 0]
        work = {} if counts is not None else None
        found, dead, t_samp, albedo, s_found, s_escape = free_flight(m, cfg, o, d, xi, active,
                                                                      work)
        escaped = active & ~found & ~dead
        medium = active & found
        emitter_pdf = sky.pdf(d) if i > 0 else torch.zeros((r,), device=dev)
        lr_dir = beta * s_escape[:, None] * _mis(prev_pdf, emitter_pdf)[:, None] * sky.eval(d)
        l_acc = l_acc + torch.where(escaped[:, None], lr_dir, 0.0)
        beta = torch.where(medium[:, None], beta * albedo * s_found[:, None], beta)
        p_int = o + d * torch.where(found, t_samp, 0.0)[:, None]
        # NEE: an emitter direction and its shadow ray's transmittance
        ds_dir, ds_val, ds_pdf = sky.sample(u[:, 1:3])
        need_tr = medium & (ds_pdf > 0.0)
        shadow_hits = []
        tr = torch.where(need_tr, torch.exp(-optical_depth(m, p_int, ds_dir, shadow_hits)), 0.0)
        phase = torch.full((r,), inv4pi, device=dev)
        nee_val = phase[:, None] * torch.ones((r, 3), device=dev)
        lr_nee = (beta * nee_val * _mis(ds_pdf, phase)[:, None] * tr[:, None]
                  * ds_val / torch.clamp(ds_pdf, min=1e-30)[:, None])
        l_acc = l_acc + torch.where(need_tr[:, None], lr_nee, 0.0)
        # isotropic phase sampling
        z = 1.0 - 2.0 * u[:, 3]
        r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * math.pi * u[:, 4]
        wo = _to_frame(d, torch.stack([r_xy * torch.cos(phi), r_xy * torch.sin(phi), z], -1))
        if counts is not None:
            counts.setdefault("bounces", []).append(dict(
                live=int(active.sum()), shadow=int(need_tr.sum()),
                shadow_hits=int(shadow_hits[0][need_tr].sum()), **work))
        o = torch.where(medium[:, None], p_int, o)
        d = torch.where(medium[:, None], wo, d)
        prev_pdf = torch.where(medium, torch.full((r,), inv4pi, device=dev), prev_pdf)
        active = medium & torch.any(beta > KILL, dim=-1)
    return l_acc


def rays(cam: Camera, px, py):
    """Rays through film positions px, py [R] (the port's pinhole)."""
    dev, f32 = px.device, torch.float32
    f = torch.tensor(cam.focal_length, dtype=f32, device=dev)
    ppx = torch.tensor(cam.width / 2.0, dtype=f32, device=dev)
    ppy = torch.tensor(cam.height / 2.0, dtype=f32, device=dev)
    dl = torch.stack([-(px - ppx) / f, -(py - ppy) / f, torch.ones_like(px)], dim=-1)
    rot = torch.as_tensor(cam.to_world[:3, :3], dtype=f32, device=dev)
    origin = torch.as_tensor(cam.to_world[:3, 3], dtype=f32, device=dev)
    dw = torch.stack([dl[..., 0] * rot[i, 0] + dl[..., 1] * rot[i, 1] + dl[..., 2] * rot[i, 2]
                      for i in range(3)], dim=-1)
    dw = dw / torch.sqrt(torch.sum(dw * dw, -1, keepdim=True))
    return origin.expand(dw.shape), dw
