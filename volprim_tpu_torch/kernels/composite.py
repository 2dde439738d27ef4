"""Tile compositor v1, forward (volprim_tpu.pallas_kernels.composite).

Per tile of R rays, the compositor walks a shortlist of S primitive columns
front to back. The quadric coefficients of a (ray, column) pair are three
10-term dot products of ray features (``ops.quadric.ray_features``) with
the column's primitive features (``ops.quadric.prim_features``)::

    a = fa . pf,  b = fb . pf,  c = fc . pf,  q = max(c - b^2 / a, 0)
    hit   = disc = (extent^2 - q) / a >= 0  and  -b / a - sqrt(disc) > 0
    alpha = min(opac exp(-q / 2), 0.9999), zeroed once the ray's hit count
            passes max_depth
    L    += exp(log_beta) alpha max(basis . sh + 0.5, 0)  while log_beta > log(beta_kill)
    log_beta += log1p(-alpha)

- :func:`composite_tiles_reference` is the plain PyTorch version; the
  compositing backbone it shares with the v2 compositor (kernels/composite2)
  and with both backwards is :func:`walk_reference` / :func:`walk_bwd_reference`;
- :func:`composite_tiles` launches ``csrc/composite_fwd.cu`` for CUDA
  tensors (counted in ``composite_tiles.launches``) and takes the plain
  version for CPU tensors; its differentiable form is
  ``kernels.composite_vjp.composite_tiles_ad``.

``q = c - b^2 / a`` cancels: at small primitive scales c reaches 1e6-1e7
and f32 rounding moves q by O(1). The kernel and the plain version
therefore form a, b and c in the same fixed order, products and sums over
feature index 0..9, each rounded once (the kernel is built with
``-fmad=false``), so both take the same hit decisions. Feature columns
10-15 of the [.., 16] inputs are padding and are not read.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .composite3 import _capped, _log_kill

_FEAT = 16  # feature columns, 10 live
_LIVE = 10
_SH = 16  # SH coefficients per channel block


def pair_terms(a, b, c, opac, extent2: float):
    """The pair math after the coefficients, [T, R, C] each: (q_raw, hit,
    dens, raw, alpha0) with q = max(q_raw, 0), dens = exp(-q / 2),
    raw = opac dens and alpha0 = min(raw, 0.9999) on hits, else 0. q and
    the hit test are formed in the coefficients' dtype, the rest in opac's
    (see ``pair_dtype`` of the backward plain versions)."""
    q_raw = c - b * b / a
    q = torch.clamp(q_raw, min=0.0)
    disc = (extent2 - q) / a
    t_near = -b / a - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc >= 0.0) & (t_near > 0.0)
    q_raw, q = q_raw.to(opac.dtype), q.to(opac.dtype)
    dens = torch.exp(-0.5 * q)
    raw = opac * dens
    alpha0 = torch.where(hit, torch.clamp(raw, max=0.9999), 0.0)
    return q_raw, hit, dens, raw, alpha0


def _segment_state(si, coeffs_of, opac_of, extent2, max_depth, log_beta, count):
    """Recompute segment ``si``: the pair terms, the cap, and the
    log-transmittance of every pair (lw, its inclusive prefix)."""
    a, b, c = coeffs_of(si)
    opac = opac_of(si)
    q_raw, hit, dens, raw, alpha0 = pair_terms(a, b, c, opac, extent2)
    a, b = a.to(opac.dtype), b.to(opac.dtype)
    depth_ok, count_next = _capped(alpha0, count, max_depth)
    alpha = torch.where(depth_ok, alpha0, 0.0)
    logt = torch.log1p(-alpha)
    cs_incl = torch.cumsum(logt, dim=-1)
    lw = log_beta + (cs_incl - logt)
    return dict(a=a, b=b, opac=opac, q_raw=q_raw, hit=hit, dens=dens, raw=raw,
                depth_ok=depth_ok, alpha=alpha, cs_incl=cs_incl, lw=lw), count_next


def walk_reference(coeffs_of, opac_of, emission_of, t, r, n_seg, dtype, device,
                   extent2, max_depth, beta_kill):
    """The compositing backbone of the v1 and v2 plain versions, segment
    by segment with ``torch.cumsum`` for the hit count and the
    log-transmittance prefix. ``coeffs_of(si)`` gives (a, b, c) [T, R, C],
    ``opac_of(si)`` [T, 1, C], ``emission_of(si)`` the three channels'
    ``basis . sh + 0.5`` [T, R, C]. Returns (L [T, R, 3], beta [T, R])."""
    log_kill = _log_kill(beta_kill)
    log_beta = torch.zeros((t, r, 1), dtype=dtype, device=device)
    count = torch.zeros_like(log_beta)
    l_acc = torch.zeros((t, r, 3), dtype=dtype, device=device)
    for si in range(n_seg):
        st, count = _segment_state(si, coeffs_of, opac_of, extent2, max_depth,
                                   log_beta, count)
        w = torch.where(st["lw"] > log_kill, torch.exp(st["lw"]) * st["alpha"], 0.0)
        inc = torch.stack(
            [torch.sum(w * torch.clamp(e, min=0.0), dim=-1) for e in emission_of(si)],
            dim=-1,
        )
        l_acc = l_acc + inc
        log_beta = log_beta + st["cs_incl"][..., -1:]
    return l_acc, torch.exp(log_beta[..., 0])


def walk_bwd_reference(coeffs_of, opac_of, emission_of, g_l, g_beta, t, r, n_seg,
                       dtype, device, extent2, max_depth, beta_kill, accumulate):
    """The two-sweep vector-Jacobian product of :func:`walk_reference`, as
    the TPU kernels compute it (composite_vjp._bwd_kernel,
    composite2._bwd_kernel), not by autograd. A forward sweep keeps each
    segment's (log beta, hit count) carry; the reverse sweep recomputes each
    segment and hands ``accumulate(si, g_a, g_b, g_q, g_opac, g_e)`` the
    per-pair adjoints of a, b, q (= of c), opacity [T, R, C] and the list of
    the three channels' emission adjoints [T, R, C]. The suffix sums of
    g_lw are the total less the inclusive prefix, both in f64."""
    log_kill = _log_kill(beta_kill)
    g_l = g_l.to(dtype)
    carries = []
    log_beta = torch.zeros((t, r, 1), dtype=dtype, device=device)
    count = torch.zeros_like(log_beta)
    for si in range(n_seg):
        carries.append((log_beta, count))
        st, count = _segment_state(si, coeffs_of, opac_of, extent2, max_depth,
                                   log_beta, count)
        log_beta = log_beta + st["cs_incl"][..., -1:]
    g_lb = g_beta.to(dtype)[..., None] * torch.exp(log_beta)  # [T, R, 1]

    for si in reversed(range(n_seg)):
        log_beta, count = carries[si]
        st, _ = _segment_state(si, coeffs_of, opac_of, extent2, max_depth,
                               log_beta, count)
        alpha, lw = st["alpha"], st["lw"]
        alive = lw > log_kill
        exp_lw = torch.exp(lw)
        w = torch.where(alive, exp_lw * alpha, 0.0)
        g_w = torch.zeros_like(w)
        g_e = []
        for ch, e in enumerate(emission_of(si)):
            g_w = g_w + g_l[..., ch:ch + 1] * torch.clamp(e, min=0.0)
            g_e.append(torch.where(e > 0.0, g_l[..., ch:ch + 1] * w, 0.0))
        g_lw = g_w * w
        g_lw64 = g_lw.to(torch.float64)
        tot = torch.sum(g_lw64, dim=-1, keepdim=True)
        g_logt = g_lb + (tot - torch.cumsum(g_lw64, dim=-1)).to(dtype)
        g_alpha = torch.where(alive, g_w * exp_lw, 0.0) + g_logt * (-1.0 / (1.0 - alpha))
        g_alpha = torch.where(st["depth_ok"] & st["hit"], g_alpha, 0.0)
        g_raw = torch.where(st["raw"] < 0.9999, g_alpha, 0.0)
        dens = st["dens"]
        g_q = torch.where(st["q_raw"] > 0.0, g_raw * st["opac"] * dens * (-0.5), 0.0)
        a, b = st["a"], st["b"]
        g_a = g_q * (b * b) / (a * a)
        g_b = g_q * (-2.0 * b / a)
        accumulate(si, g_a, g_b, g_q, g_raw * dens, g_e)
        g_lb = g_lb + tot.to(dtype)


def dot_in_order(x, y, n: int):
    """sum_i x[..., i] y[..., i] over i = 0..n-1, left to right, each
    product and sum rounded once: the order the kernels use."""
    out = x[..., 0] * y[..., 0]
    for i in range(1, n):
        out = out + x[..., i] * y[..., i]
    return out


def v1_coeffs(fa, fb, fc, pf, seg):
    """``coeffs_of`` of the v1 compositor: the three 10-term dot products
    of segment si, [T, R, C] each."""
    def coeffs_of(si):
        cols = pf[:, None, si * seg:(si + 1) * seg, :]  # [T, 1, C, 16]
        return tuple(dot_in_order(f[:, :, None, :], cols, _LIVE) for f in (fa, fb, fc))
    return coeffs_of


def emission_fn(basis, sh3, seg):
    """``emission_of``: basis [T, R, 16] against the channel-major SH
    blocks of sh3 [T, S, 48], plus the 0.5 offset, per channel."""
    def emission_of(si):
        shs = sh3[:, si * seg:(si + 1) * seg, :].to(basis.dtype)
        return [
            torch.matmul(basis, shs[..., ch * _SH:(ch + 1) * _SH].transpose(1, 2)) + 0.5
            for ch in range(3)
        ]
    return emission_of


def _check_seg(s, seg):
    if seg < 1 or s % seg:
        raise ValueError(f"S = {s} is not a multiple of seg = {seg}")
    return s // seg


def composite_tiles_reference(fa, fb, fc, basis, pf, opac, sh3, seg=256,
                              extent2=9.0, max_depth=128, beta_kill=0.01):
    """Plain PyTorch version of the v1 forward compositor. fa, fb, fc,
    basis [T, R, 16]; pf [T, S, 16]; opac [T, 1, S] (0 on invalid slots);
    sh3 [T, S, 48]. Returns (L [T, R, 3], beta [T, R]) in pf's dtype: f32
    as the kernel computes; the tests pass f64 as a yardstick."""
    t, r, _ = fa.shape
    n_seg = _check_seg(pf.shape[1], seg)
    dtype = pf.dtype
    fa, fb, fc, basis = (x.to(dtype) for x in (fa, fb, fc, basis))
    opac = opac.to(dtype)
    return walk_reference(
        v1_coeffs(fa, fb, fc, pf, seg),
        lambda si: opac[:, :, si * seg:(si + 1) * seg],
        emission_fn(basis, sh3, seg),
        t, r, n_seg, dtype, pf.device, extent2, max_depth, beta_kill,
    )


def argtypes(n_pointers: int, n_ints: int = 4) -> list:
    """The ctypes argument types of a v1 / v2 entry point: ``n_pointers``
    tensor pointers, then T, R, S, seg (and the SH count where ``n_ints``
    is 5), extent^2, max_depth, log(beta_kill) and the stream."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return [vp] * n_pointers + [ci] * n_ints + [cf, ci, cf, vp]


def load_lib(name: str, n_pointers: int, n_ints: int = 4):
    """The ctypes library of ``csrc/<name>.cu`` (built at first use), its
    entry point bound with :func:`argtypes`."""
    return _build.bind(name, argtypes(n_pointers, n_ints))


def check_tensors(named, dev):
    """Device, dtype, shape and contiguity of a kernel's inputs:
    ``named`` holds (name, tensor, dtype, shape)."""
    for name, x, dtype, shape in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {list(shape)}, got {list(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_sizes(r, s, seg):
    if not 1 <= r <= 1024:
        raise ValueError(f"R = {r} rays per tile: the kernels take 1 to 1024")
    _check_seg(s, seg)


def stream_of(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def v1_inputs(fa, fb, fc, basis, pf, opac, sh3, seg):
    """Checks of the v1 kernels' inputs; returns (T, R, S)."""
    t, r, _ = fa.shape
    s = pf.shape[1]
    check_sizes(r, s, seg)
    f32 = torch.float32
    check_tensors(
        [(n, x, f32, (t, r, _FEAT)) for n, x in (("fa", fa), ("fb", fb), ("fc", fc),
                                                  ("basis", basis))]
        + [("pf", pf, f32, (t, s, _FEAT)), ("opac", opac, f32, (t, 1, s)),
           ("sh3", sh3, f32, (t, s, 3 * _SH))],
        fa.device,
    )
    return t, r, s


def _launch(fa, fb, fc, basis, pf, opac, sh3, seg, extent2, max_depth, beta_kill):
    """Launch csrc/composite_fwd.cu: (L [T, R, 3], beta [T, R])."""
    t, r, s = v1_inputs(fa, fb, fc, basis, pf, opac, sh3, seg)
    dev = fa.device
    lib = load_lib("composite_fwd", 9)
    l_out = torch.empty((t, r, 3), dtype=torch.float32, device=dev)
    beta = torch.empty((t, r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.composite_fwd(
            fa.data_ptr(), fb.data_ptr(), fc.data_ptr(), basis.data_ptr(),
            pf.data_ptr(), opac.data_ptr(), sh3.data_ptr(), l_out.data_ptr(),
            beta.data_ptr(), t, r, s, seg, float(extent2), int(max_depth),
            _log_kill(beta_kill), stream_of(dev),
        )
    _build.raise_on(lib, err, "composite_fwd")
    composite_tiles.launches += 1
    return l_out, beta


def composite_tiles(fa, fb, fc, basis, pf, opac, sh3, seg=256, extent2=9.0,
                    max_depth=128, beta_kill=0.01):
    """v1 forward compositor: (L [T, R, 3], beta [T, R]). CUDA tensors
    launch the hand-written kernel (csrc/composite_fwd.cu) and raise if it
    does not launch; CPU tensors take :func:`composite_tiles_reference`."""
    args = (seg, extent2, max_depth, beta_kill)
    if fa.device.type == "cpu":
        return composite_tiles_reference(fa, fb, fc, basis, pf, opac, sh3, *args)
    if fa.device.type != "cuda":
        raise ValueError(f"composite_tiles runs on CPU or CUDA, not {fa.device}")
    return _launch(fa, fb, fc, basis, pf, opac, sh3, *args)


composite_tiles.launches = 0
