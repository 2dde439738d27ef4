"""Fused free-flight window walk of the path tracer
(volprim_tpu.pallas_kernels.ffwalk).

Per ray, over a table of K' collected [entry, exit) intervals sorted by
entry (padding +inf), the walk runs up to ``n_windows`` windows from
``t_min0``. Each window selects the first ``k`` open intervals (exit >
t_min) by entry rank, ends at the entry of the (k+1)-th open interval (or,
when that one already overlaps t_min, at the earliest selected exit),
capped by ``t_budget`` and ``t_cap``, and integrates the window's optical
depth with the shared erf antiderivative: interval j contributes
``cp_j (erf(alpha_j hi + beta_j) - erf(alpha_j lo + beta_j))``. Where the
window's depth exceeds the remaining chi = log(T0 / xi) the ray is found:
a bisection of the window's depth F_w(t) > chi_rem locates the crossing,
which is snapped to the tightest enclosing interval-boundary pair and
refined by a ``solver_iters``-step midpoint solve. Otherwise the ray is
resolved (no more intervals, or the surface cap reached), budget-dead (the
collection budget reached) or continues with the next window.

- :func:`walk_reference` is the plain PyTorch version, the TPU kernel's
  arithmetic over [R, K'] tensors;
- :func:`walk` takes CPU tensors to it and CUDA tensors to the hand-written
  kernel ``csrc/ffwalk.cu``, counting launches in ``walk.launches``;
- :func:`synthetic_tables` builds the walk's inputs for rays through a
  medium, as the path tracer collects them, and :func:`walk_variant` cuts
  the test variants (``WALK_VARIANTS``) the kernel is held to from them.

The walk is stop-gradient: every input is detached, and the outputs are
sampling decisions. +inf is carried as ``BIG`` inside (inf * 0 traps), and
padding intervals are neutral (cp 0, alpha 1, beta 0).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

BIG = 3.0e37  # the kernels' finite stand-in for +inf
MAX_KP = 1024  # intervals per ray the CUDA kernel takes


def _cap_big(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, BIG)


def walk_reference(
    entry, exit_t, cp, alpha, beta, chi, t_budget, t_cap, active, t_min0, *,
    k: int, n_windows: int, bisect_iters: int = 22, solver_iters: int = 4,
    solver_disabled: bool = False, work: dict = None,
):
    """The walk in plain PyTorch. Inputs [R, K'] f32 (entry, exit_t, cp,
    alpha, beta) and [R] (chi, t_budget, t_cap, t_min0 f32, active bool).
    Returns (found, resolved, bdead, capres [R] bool, t_samp [R] f32, BIG
    where not found). A ``work`` dict receives what these inputs make the
    walk do, summed over rays: ``windows`` walked, intervals ``scanned`` by
    their selections (each window reads the row up to its (k+1)-th open
    interval, or up to the first padding entry when there is none),
    intervals ``selected`` in them, intervals selected in the windows where
    a ray was found, and per ray the longest prefix any window scanned
    (``scanned_max``) and the intervals any window selected
    (``selected_union``): the table entries the walk must read at all;
    ``group_entries`` counts the entries of the 128-interval groups of each
    row that prefix reaches (at least one group), what the CUDA kernel
    reads of entry and exit."""
    entry, exit_t = _cap_big(entry.detach()), _cap_big(exit_t.detach())
    cp, al, be = cp.detach(), alpha.detach(), beta.detach()
    t_budget = _cap_big(t_budget.detach())[:, None]
    t_cap = _cap_big(t_cap.detach())[:, None]
    act = active[:, None]
    t_min = t_min0.detach()[:, None].to(entry.dtype)
    chi_rem = chi.detach()[:, None].to(entry.dtype)
    fin = entry < BIG * 0.5
    has_budget = t_budget < BIG * 0.5
    false = torch.zeros_like(act)
    found, resolved, bdead, capres = false, false, false, false
    t_samp = torch.full_like(t_min, BIG)
    scanned_max = torch.zeros(t_min.shape, dtype=torch.int64, device=t_min.device)
    ever_sel = torch.zeros_like(fin)

    def lane_sum(x):
        return torch.sum(x, dim=1, keepdim=True)

    for _ in range(n_windows):
        win_act = act & ~(found | resolved | bdead)

        # selection: the first k open intervals by entry rank
        openm = fin & (exit_t > t_min)
        rank = torch.cumsum(openm.to(torch.int32), dim=1)  # inclusive
        selm = openm & (rank <= k)
        nxt = torch.amin(torch.where(openm & (rank == k + 1), entry, BIG), 1, keepdim=True)
        has_more = nxt < BIG * 0.5
        min_exit = torch.amin(torch.where(selm, exit_t, BIG), 1, keepdim=True)
        t_limit = torch.where(
            has_more, torch.where(nxt > t_min, nxt, min_exit), torch.full_like(nxt, BIG)
        )
        t_limit = torch.minimum(t_limit, t_budget)
        hit_cap = t_limit >= t_cap
        t_limit = torch.minimum(t_limit, t_cap)
        full = has_more | has_budget

        # the window's optical depth through the shared antiderivative
        lo = torch.where(selm, torch.maximum(entry, t_min), 0.0)
        hi = torch.where(selm, torch.minimum(exit_t, t_limit), 0.0)
        hi = torch.maximum(hi, lo)
        erf_lo = torch.erf(al * lo + be)
        tau_lane = cp * (torch.erf(al * hi + be) - erf_lo)
        tau_win = lane_sum(torch.where(selm, torch.clamp(tau_lane, min=0.0), 0.0))

        found_w = win_act & (tau_win > chi_rem)
        resolved_w = win_act & ~found_w & (~full | hit_cap)
        bdead_w = win_act & ~found_w & full & ~hit_cap & (t_limit >= t_budget)

        def tau_to(t):  # F_w(t) from the window start [R, 1]
            e = torch.erf(al * torch.minimum(torch.maximum(t, lo), hi) + be)
            return lane_sum(torch.where(selm, torch.clamp(cp * (e - erf_lo), min=0.0), 0.0))

        # locate the crossing: bisection, then the segment snap
        span_hi = torch.amax(torch.where(selm, hi, 0.0), 1, keepdim=True)
        b_lo, b_hi = t_min, torch.maximum(span_hi, t_min)
        for _ in range(bisect_iters):
            mid = 0.5 * (b_lo + b_hi)
            cross = tau_to(mid) > chi_rem
            b_lo, b_hi = torch.where(cross, b_lo, mid), torch.where(cross, mid, b_hi)
        t_star = 0.5 * (b_lo + b_hi)
        ev_lo = torch.maximum(
            torch.amax(torch.where(selm & (lo <= t_star), lo, -BIG), 1, keepdim=True),
            torch.amax(torch.where(selm & (hi <= t_star), hi, -BIG), 1, keepdim=True),
        )
        t0 = torch.maximum(ev_lo, t_min)
        ev_hi = torch.minimum(
            torch.amin(torch.where(selm & (lo > t_star), lo, BIG), 1, keepdim=True),
            torch.amin(torch.where(selm & (hi > t_star), hi, BIG), 1, keepdim=True),
        )
        t1 = torch.maximum(torch.minimum(ev_hi, t_limit), t0)

        # the in-segment midpoint solve
        chi_loc = chi_rem - tau_to(t0)
        tt = 0.5 * (t0 + t1)
        if not solver_disabled:
            erf_t0 = torch.erf(al * torch.minimum(torch.maximum(t0, lo), hi) + be)
            step = 0.25 * (t1 - t0)
            for _ in range(solver_iters):
                e = torch.erf(al * torch.minimum(torch.maximum(tt, lo), hi) + be)
                tau_p = lane_sum(torch.where(selm, cp * (e - erf_t0), 0.0))
                tt = torch.where(tau_p > chi_loc, tt - step, tt + step)
                tt = torch.minimum(torch.maximum(tt, t0), t1)
                step = step * 0.5

        if work is not None:
            n_sel = torch.sum(selm, dim=1, keepdim=True)
            kth = torch.argmax((openm & (rank == k + 1)).to(torch.int8), dim=1, keepdim=True)
            n_fin = torch.sum(fin, dim=1, keepdim=True)
            scanned = torch.where(has_more, kth + 1, torch.clamp(n_fin + 1, max=fin.shape[1]))
            scanned = torch.where(win_act, scanned, 0)
            scanned_max = torch.maximum(scanned_max, scanned)
            ever_sel = ever_sel | (selm & win_act)
            work["windows"] = work.get("windows", 0) + int(win_act.sum())
            work["scanned"] = work.get("scanned", 0) + int(scanned.sum())
            work["selected"] = work.get("selected", 0) + int(n_sel[win_act].sum())
            work["selected_found"] = work.get("selected_found", 0) + int(n_sel[found_w].sum())

        # state updates
        t_samp = torch.where(found_w, tt, t_samp)
        capres = capres | (resolved_w & hit_cap & (t_cap < BIG * 0.5))
        found = found | found_w
        resolved = resolved | found_w | resolved_w
        bdead = bdead | bdead_w
        cont = win_act & ~found_w & ~resolved_w & ~bdead_w
        chi_rem = torch.where(cont, chi_rem - tau_win, chi_rem)
        t_min = torch.where(cont, t_limit, t_min)

    if work is not None:
        work["scanned_max"] = work.get("scanned_max", 0) + int(scanned_max.sum())
        work["selected_union"] = work.get("selected_union", 0) + int(ever_sel.sum())
        groups = torch.clamp(torch.div(scanned_max + 127, 128, rounding_mode="floor"), min=1)
        entries = torch.clamp(groups * 128, max=fin.shape[1])
        work["group_entries"] = work.get("group_entries", 0) + int(entries.sum())
    return found[:, 0], resolved[:, 0], bdead[:, 0], capres[:, 0], t_samp[:, 0]


def _lib():
    """The ctypes library of ``csrc/ffwalk.cu`` (built at first use)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ffwalk", [vp] * 15 + [ci] * 7 + [vp])


def _launch(entry, exit_t, cp, alpha, beta, chi, t_budget, t_cap, active, t_min0, k,
            n_windows, bisect_iters, solver_iters, solver_disabled):
    """Launch csrc/ffwalk.cu on contiguous tensors of one CUDA device."""
    r, kp = entry.shape
    if not 1 <= kp <= MAX_KP:
        raise ValueError(f"the CUDA walk takes K' <= {MAX_KP} intervals per ray, got {kp}")
    if k < 1 or n_windows < 0 or bisect_iters < 0 or solver_iters < 0:
        raise ValueError(f"bad walk sizes k={k} n_windows={n_windows}")
    dev = entry.device
    named = dict(entry=entry, exit_t=exit_t, cp=cp, alpha=alpha, beta=beta, chi=chi,
                 t_budget=t_budget, t_cap=t_cap, active=active, t_min0=t_min0)
    for name, x in named.items():
        want = (r, kp) if x.dim() == 2 else (r,)
        dtype = torch.bool if name == "active" else torch.float32
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != want:
            raise ValueError(
                f"{name} must be {dtype} {want} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r == 0:
        z = torch.zeros(0, dtype=torch.bool, device=dev)
        return z, z, z, z, torch.zeros(0, device=dev)
    lib = _lib()
    # the kernel writes bytes 0 / 1: each row is a torch.bool view as it is
    flags = torch.empty((4, r), dtype=torch.bool, device=dev)
    t_samp = torch.empty((r,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ffwalk(
            *(x.data_ptr() for x in named.values()),
            *(flags[i].data_ptr() for i in range(4)), t_samp.data_ptr(),
            r, kp, int(k), int(n_windows), int(bisect_iters), int(solver_iters),
            int(bool(solver_disabled)), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.raise_on(lib, err, "ffwalk")
    walk.launches += 1
    return flags[0], flags[1], flags[2], flags[3], t_samp


def walk(
    entry, exit_t, cp, alpha, beta, chi, t_budget, t_cap, active, t_min0, *,
    k: int, n_windows: int, bisect_iters: int = 22, solver_iters: int = 4,
    solver_disabled: bool = False,
):
    """The fused window walk. Returns (found, resolved, bdead, capres [R]
    bool, t_samp [R] f32, +inf where not found). Every input is detached.

    CUDA tensors launch the hand-written kernel (csrc/ffwalk.cu) and raise
    if it does not launch; CPU tensors take :func:`walk_reference`."""
    args = [x.detach().contiguous() for x in
            (entry, exit_t, cp, alpha, beta, chi, t_budget, t_cap, active, t_min0)]
    kw = dict(k=k, n_windows=n_windows, bisect_iters=bisect_iters,
              solver_iters=solver_iters, solver_disabled=solver_disabled)
    dev = entry.device
    if dev.type == "cpu":
        out = walk_reference(*args, **kw)
    elif dev.type == "cuda":
        out = _launch(*args, **kw)
    else:
        raise ValueError(f"ffwalk.walk runs on CPU or CUDA, not {dev}")
    found, resolved, bdead, capres, t_samp = out
    return found, resolved, bdead, capres, torch.where(found, t_samp, torch.inf)


walk.launches = 0


def synthetic_tables(prims, o, d, kp: int, seed: int = 0, chunk_size: int = 1024) -> dict:
    """The walk's inputs for rays o, d [R, 3] through the medium ``prims``,
    as the path tracer builds them: the K' = ``kp`` nearest intervals from
    t = 0 (``prb._gather_intervals``), their antiderivative columns, chi =
    -log(xi) with xi ~ U[1e-7, 1) from numpy's generator of ``seed``,
    t_budget from the collection, no cap, every ray active, t_min0 = 0.
    Returns a dict of :func:`walk`'s positional arguments by name."""
    from ..models import prb

    r = o.shape[0]
    dev = o.device
    with torch.no_grad():
        entry, exit_t, ids, count, _ = prb._gather_intervals(
            prims, o, d, torch.zeros(r, device=dev), kp, chunk_size
        )
        cp, alpha, beta = prb._walk_columns(prims, o, d, entry, ids)
    xi = np.random.default_rng(seed).uniform(1e-7, 1.0, r).astype(np.float32)
    return dict(
        entry=entry, exit_t=exit_t, cp=cp, alpha=alpha, beta=beta,
        chi=-torch.log(torch.from_numpy(xi).to(dev)),
        t_budget=torch.where(count >= kp, entry[:, -1], torch.inf),
        t_cap=torch.full((r,), torch.inf, device=dev),
        active=torch.ones(r, dtype=torch.bool, device=dev),
        t_min0=torch.zeros(r, device=dev),
    )


# The variants the kernel is held to against its plain version: the
# path tracer's default K' / k / windows, the JAX bench's (128, 8, 4), the
# exact global mode (k = K', one window), surface caps on half of the rays,
# a finite collection budget, the solver disabled, the walk started at the
# jump boundary, and long intervals that stay open across windows.
WALK_VARIANTS = {
    "kp256_k32_w4": dict(kp=256, k=32, n_windows=4),
    "kp128_k8_w4": dict(kp=128, k=8, n_windows=4),
    "kp64_k64_w1": dict(kp=64, k=64, n_windows=1),
    "t_cap_half": dict(kp=256, k=32, n_windows=4, t_cap_half=True),
    "t_budget": dict(kp=256, k=32, n_windows=4, t_budget=True),
    "solver_disabled": dict(kp=256, k=32, n_windows=4, solver_disabled=True),
    "jump_start": dict(kp=256, k=32, n_windows=4, jump_start=True),
    "long_open": dict(kp=256, k=32, n_windows=4, long_open=True),
}


def _depths(tb: dict, t: torch.Tensor) -> torch.Tensor:
    """Each interval's depth [R, K'] from its entry up to t [R] (clamped to
    [entry, exit], as the walk's F_w; t = inf gives whole intervals, as
    ``models.prb`` collects them), 0 on padding."""
    fin = torch.isfinite(tb["entry"])
    e = torch.where(fin, tb["entry"], 0.0)
    x = torch.where(fin, tb["exit_t"], 0.0)
    al, be = tb["alpha"], tb["beta"]
    tc = torch.minimum(torch.maximum(t[:, None], e), x)
    return torch.where(
        fin, torch.clamp(tb["cp"] * (torch.erf(al * tc + be) - torch.erf(al * e + be)), min=0.0),
        0.0)


def walk_variant(tables: dict, name: str, seed: int = 0):
    """(inputs, keyword arguments) of :func:`walk` for one of
    ``WALK_VARIANTS``, cut from tables collected at K' >= 256: the first K'
    intervals (the K' nearest) with the collection's own budget; for
    ``t_cap_half`` a cap just past the 17th entry on a numpy-seeded half of
    the rays; for ``t_budget`` a budget at the 49th entry; for
    ``jump_start`` t_min0 at the jump boundary, the entry of interval jb * k
    as ``models.prb._jump_walk`` picks it from the tables' chi, and chi less
    the depth up to there; for ``long_open`` the exit of every 37th of the
    first 64 intervals stretched to the row's last finite exit."""
    v = WALK_VARIANTS[name]
    kp, k = v["kp"], v["k"]
    tb = {key: x[:, :kp].contiguous() if x.dim() == 2 else x for key, x in tables.items()}
    entry = tb["entry"]
    r, dev = entry.shape[0], entry.device
    count = torch.isfinite(entry).sum(1)
    tb["t_budget"] = torch.where(count >= kp, entry[:, -1], torch.inf)
    if v.get("t_cap_half"):
        half = torch.from_numpy(np.random.default_rng(seed).uniform(size=r) < 0.5).to(dev)
        tb["t_cap"] = torch.where(half & (count > 16), entry[:, 16] + 0.05, torch.inf)
    if v.get("t_budget"):
        tb["t_budget"] = torch.where(count > 48, entry[:, 48], torch.inf)
    if v.get("jump_start"):
        # models.prb._jump_walk's block jump
        tau_fin = _depths(tb, torch.full((r,), torch.inf, device=dev))
        cum = torch.cumsum(tau_fin, dim=1)
        f_ub = cum[:, torch.arange(1, max(1, kp // k), device=dev) * k - 1]
        jb = torch.sum(f_ub <= tb["chi"][:, None], dim=1)
        jb = torch.minimum(jb, torch.clamp(torch.div(count - 1, k, rounding_mode="floor"), min=0))
        b_t = torch.gather(entry, 1, torch.clamp(jb * k, max=kp - 1)[:, None])[:, 0]
        b_t = torch.where((jb > 0) & torch.isfinite(b_t), b_t, 0.0)
        b_t = torch.clamp(torch.minimum(b_t, torch.minimum(tb["t_cap"], tb["t_budget"])), min=0.0)
        tb["chi"] = torch.clamp(tb["chi"] - _depths(tb, b_t).sum(1), min=0.0)
        tb["t_min0"] = b_t
    if v.get("long_open"):
        exit_t = tb["exit_t"].clone()
        last = torch.amax(torch.where(torch.isfinite(exit_t), exit_t, -torch.inf), 1)
        cols = torch.arange(0, min(64, kp), 37, device=dev)
        stretch = torch.isfinite(entry[:, cols]) & torch.isfinite(last)[:, None]
        exit_t[:, cols] = torch.where(stretch, last[:, None], exit_t[:, cols])
        tb["exit_t"] = exit_t
    kw = dict(k=k, n_windows=v["n_windows"], solver_disabled=v.get("solver_disabled", False))
    return tb, kw
