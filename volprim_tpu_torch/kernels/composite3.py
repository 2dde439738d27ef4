"""Fused tile compositor v3, forward (volprim_tpu.pallas_kernels.composite3).

Per tile of R rays sharing an origin, the compositor walks a shortlist of S
packed primitive columns front to back: closest-approach peak response
``q = p^T (M/2) p`` at ``t* = -b/a`` (cancellation-free: the quadratic form
is evaluated on the small vector ``p = w + t* d``), the extent hit test,
``alpha = min(opac exp(-q), 0.9999)`` capped at ``max_depth`` hits per ray,
the log-transmittance prefix with the ``beta_kill`` cutoff, and SH emission.

- :func:`pack_fused_features` builds the per-frame [16, N] column table;
- :func:`composite_tiles3_reference` is the plain PyTorch version of the
  forward, :func:`composite_tiles3_bwd_reference` that of its backward
  (the TPU kernel's vector-Jacobian product, not autograd);
- :func:`composite_tiles3` is differentiable in ``pf`` and ``sh3``: for CUDA
  tensors its forward launches ``csrc/composite3_fwd.cu`` and its backward
  ``csrc/composite3_bwd.cu``; CPU tensors take the plain versions. The
  launches are counted in ``composite_tiles3.launches`` and
  ``composite_tiles3_bwd.launches``. :func:`forward3` is its forward with
  the profiling counters (segments walked and live per tile), which
  :func:`composite_tiles3` adds to ``utils.spans``' counters
  ``composite3.segments_walked`` / ``segments_live`` while a profiler runs;
- ``compact`` walks each tile's columns that meet its ray cone as one
  packed stream (:func:`_stream`), ``order_band`` corrects each pair's
  transmittance prefix for the entry order of the pairs within that many
  lanes of it in its stream segment (:func:`_band_corr`), and
  ``early_exit`` (without ``compact``) stops a tile before the first
  segment at which none of its rays is both under its hit cap and above
  ``beta_kill``, as the TPU kernel's while-loop walk does
  (composite3.py:728-747): beta is then the product up to that segment.

Packed column rows (the HALVED convention: rows 0-8 and 13 carry M/2, so
the kernel compares against extent^2 / 2)::

    [M11, M22, M33, 2 M12, 2 M13, 2 M23, u(3) = M w, w(3) = o - c,
     opac, c0 = w^T M w, bounding radius, entry-distance key]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import sh
from ..utils import spans
from . import _build

_FEAT = 16
_SH_Y00 = 0.28209479177387814


def pack_fused_features(prims, origin: torch.Tensor) -> torch.Tensor:
    """[16, N] per-frame column table of ``prims`` seen from ``origin`` [3]:
    halved M6 (doubled off-diagonals), u = M w, w = o - c, opacity,
    c0 = w^T M w, extent-scaled bounding radius (row 14, read by the
    compaction mask) and the entry-distance sort key (row 15:
    |w| - extent ||S R^T w_hat||, read by cluster_sort)."""
    q = prims.quats
    qx, qy, qz, qw = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    # rotation-matrix entries (world <- local), columnwise
    r00 = 1.0 - 2.0 * (qy * qy + qz * qz)
    r01 = 2.0 * (qx * qy - qz * qw)
    r02 = 2.0 * (qx * qz + qy * qw)
    r10 = 2.0 * (qx * qy + qz * qw)
    r11 = 1.0 - 2.0 * (qx * qx + qz * qz)
    r12 = 2.0 * (qy * qz - qx * qw)
    r20 = 2.0 * (qx * qz - qy * qw)
    r21 = 2.0 * (qy * qz + qx * qw)
    r22 = 1.0 - 2.0 * (qx * qx + qy * qy)
    # halved inverse-square scales -> every M-derived row is M/2
    s0 = 0.5 / torch.square(prims.scales[:, 0])
    s1 = 0.5 / torch.square(prims.scales[:, 1])
    s2 = 0.5 / torch.square(prims.scales[:, 2])
    m00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    m11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    m22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    m01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    m02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    m12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    wx = origin[0] - prims.centers[:, 0]
    wy = origin[1] - prims.centers[:, 1]
    wz = origin[2] - prims.centers[:, 2]
    ux = m00 * wx + m01 * wy + m02 * wz
    uy = m01 * wx + m11 * wy + m12 * wz
    uz = m02 * wx + m12 * wy + m22 * wz
    c0 = ux * wx + uy * wy + uz * wz
    opac = prims.attrs["opacities"][:, 0]
    extent = float(prims.extent)
    rad = extent * torch.amax(prims.scales, dim=-1)
    wn = torch.sqrt(wx * wx + wy * wy + wz * wz)
    inv_wn = 1.0 / torch.clamp(wn, min=1e-12)
    hx, hy, hz = wx * inv_wn, wy * inv_wn, wz * inv_wn
    # (R^T h)_i = column i of R dotted with h
    p0 = r00 * hx + r10 * hy + r20 * hz
    p1 = r01 * hx + r11 * hy + r21 * hz
    p2 = r02 * hx + r12 * hy + r22 * hz
    sup = extent * torch.sqrt(
        torch.square(prims.scales[:, 0] * p0)
        + torch.square(prims.scales[:, 1] * p1)
        + torch.square(prims.scales[:, 2] * p2)
    )
    return torch.stack(
        [
            m00, m11, m22, 2.0 * m01, 2.0 * m02, 2.0 * m12,
            ux, uy, uz, wx, wy, wz, opac, c0, rad, wn - sup,
        ],
        dim=0,
    )


def neutral_fused_row(device=None) -> torch.Tensor:
    """Inert column: M = I, w = u = 0, opacity 0 (a > 0, never hits) and
    radius -1, so the compaction mask drops it."""
    row = torch.zeros((_FEAT,), dtype=torch.float32, device=device)
    row[:3] = 1.0
    row[14] = -1.0
    return row


def fold_sh_rows(sh_coeffs: torch.Tensor) -> torch.Tensor:
    """[N, k, 3] SH coefficients -> [N, 3k] channel-major rows for the
    compositor, with the DC row storing ``Y00 * dc + 0.5``: the emission
    offset folds into the product (the kernel's basis column 0 is exactly
    1.0) at no bf16 cost, since 1.0 and 0.5 are bf16-exact."""
    n, k, _ = sh_coeffs.shape
    dc = sh_coeffs[:, 0, :] * _SH_Y00 + 0.5
    fold = torch.cat([dc[:, None, :], sh_coeffs[:, 1:, :]], dim=1)
    return fold.permute(0, 2, 1).reshape(n, 3 * k)


def pack_direction_rows(dnx, dny, dnz) -> torch.Tensor:
    """[T, R] unit direction components -> the compositor's [T, 8, R] block:
    rows 0-2 the direction, rows 3-7 the tile's bounding cone (unit axis,
    cos and sin of the half-angle, the same for every ray), which the
    compaction mask reads. The cosine gets 1e-6 of slack for the rounding
    of the in-kernel test."""
    mx, my, mz = dnx.mean(dim=1), dny.mean(dim=1), dnz.mean(dim=1)
    nrm = torch.clamp(torch.sqrt(mx * mx + my * my + mz * mz), min=1e-12)
    ax0, ax1, ax2 = mx / nrm, my / nrm, mz / nrm
    ch = torch.amin(
        dnx * ax0[:, None] + dny * ax1[:, None] + dnz * ax2[:, None], dim=1
    )
    ch = torch.clamp(ch - 1e-6, -1.0, 1.0)
    sh_ = torch.sqrt(torch.clamp(1.0 - ch * ch, min=0.0))
    rows = [v[:, None].expand(dnx.shape) for v in (ax0, ax1, ax2, ch, sh_)]
    return torch.stack([dnx, dny, dnz] + rows, dim=1).contiguous()


def _log_kill(beta_kill: float) -> float:
    """log(beta_kill) rounded to f32, the value both versions compare to."""
    return float(np.log(np.float32(beta_kill)))


def _ray_terms(d8: torch.Tensor, sh_k: int, sh_dtype):
    """Per-ray terms of the plain versions in d8's dtype: (dx, dy, dz)
    [T, R, 1] each, F6(d) and the SH basis [T, R, k], unrounded and rounded
    to the table's dtype (the emission product takes it rounded, as the
    kernels do)."""
    dtype = d8.dtype
    dx, dy, dz = (d8[:, i, :, None] for i in range(3))
    f6 = (dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz)
    basis = torch.cat(
        sh.basis_columns(dx, dy, dz, sh.degree_from_coeffs(sh_k), 1.0), dim=-1
    )
    return (dx, dy, dz), f6, basis, basis.to(sh_dtype).to(dtype)


def _segment_pairs(cols, d3, f6, e2h, live):
    """Pair math of one segment, [T, R, C] each: (row, a, b, p, q_raw,
    dens, raw, alpha0, hit). ``cols`` [T, 16, C] f32, ``live`` [T, 1, 1]."""
    dx, dy, dz = d3
    row = [cols[:, i:i + 1, :] for i in range(13)]  # [T, 1, C] each
    a = f6[0] * row[0]
    for i in range(1, 6):
        a = a + f6[i] * row[i]
    b = dx * row[6] + dy * row[7] + dz * row[8]
    t_peak = -b / a
    px = row[9] + t_peak * dx
    py = row[10] + t_peak * dy
    pz = row[11] + t_peak * dz
    q_raw = (
        px * (row[0] * px + row[3] * py + row[4] * pz)
        + py * (row[1] * py + row[5] * pz)
        + (pz * pz) * row[2]
    )
    q_min = torch.clamp(q_raw, min=0.0)
    hit = (q_min <= e2h) & (t_peak > 0.0) & (q_min - b * t_peak > e2h) & live
    dens = torch.exp(-q_min)
    raw = row[12] * dens
    alpha0 = torch.where(hit, torch.clamp(raw, max=0.9999), 0.0)
    return row, a, b, (px, py, pz), q_raw, dens, raw, alpha0, hit


def _capped(alpha0, count, max_depth):
    """Hit-cap mask and the count after the segment: hits with alpha > 0
    count, and a pair is kept while the running count is <= max_depth."""
    cum = count + torch.cumsum((alpha0 > 0.0).to(alpha0.dtype), dim=-1)
    return cum <= max_depth, cum[..., -1:]


def _entry_keys(cols, d3_32, f6_32, e2h):
    """[T, R, C] entry distance of each pair along its ray,
    t* - sqrt(max(e^2/2 - q, 0) / a), the key the order band compares
    (composite3.py:592-593). Always in f32, as the kernels take it: an f64
    run of a plain version then decides near-tie pairs as they do."""
    _, a, b, _, q_raw, *_ = _segment_pairs(cols.float(), d3_32, f6_32, e2h, True)
    disc = torch.clamp(e2h - torch.clamp(q_raw, min=0.0), min=0.0)
    return -b / a - torch.sqrt(disc / a)


def _pad(x, left, right):
    return torch.nn.functional.pad(x, (left, right))


def _band_corr(tkey, logt, band):
    """The banded order correction of each lane of a segment
    (composite3.py:579-608): for s = 1..band, + logt[i + s] where
    tkey[i + s] < tkey[i], then - logt[i - s] where tkey[i - s] > tkey[i];
    lanes past the segment's ends take no part, NaN keys compare false."""
    corr = torch.zeros_like(logt)
    for s_ in range(1, min(band, tkey.shape[-1] - 1) + 1):
        near, far = tkey[..., :-s_], tkey[..., s_:]  # lanes i and i + s
        corr = corr + _pad(torch.where(far < near, logt[..., s_:], 0.0), 0, s_)
        corr = corr - _pad(torch.where(near > far, logt[..., :-s_], 0.0), s_, 0)
    return corr


def _band_corr_adjoint(g_logt, tkey, g_lw, band):
    """g_logt plus the transpose of :func:`_band_corr` applied to the lane
    weights' adjoints g_lw (composite3.py:1049-1066): for s = 1..band,
    + g_lw[j - s] where tkey[j] < tkey[j - s], then - g_lw[j + s] where
    tkey[j] > tkey[j + s]. The keys get no gradient."""
    for s_ in range(1, min(band, tkey.shape[-1] - 1) + 1):
        near, far = tkey[..., :-s_], tkey[..., s_:]  # lanes j - s and j
        g_logt = g_logt + _pad(torch.where(far < near, g_lw[..., :-s_], 0.0), s_, 0)
        g_logt = g_logt - _pad(torch.where(near > far, g_lw[..., s_:], 0.0), 0, s_)
    return g_logt


@torch.no_grad()
def column_keep(d8, pf):
    """[T, S] columns whose bounding sphere meets the tile's ray cone (d8
    rows 3-7): the compaction mask of the kernels (column_mask in
    csrc/composite3_common.cuh; JAX's _column_mask), in f32."""
    d8, pf = d8.float(), pf.float()
    ax0, ax1, ax2, ch, sh_ = (d8[:, i, 0:1] for i in range(3, 8))
    vx, vy, vz, r = -pf[:, 9], -pf[:, 10], -pf[:, 11], pf[:, 14]
    dist2 = vx * vx + vy * vy + vz * vz
    a = vx * ax0 + vy * ax1 + vz * ax2
    b2 = torch.clamp(dist2 - a * a, min=0.0)
    ch2 = ch * ch
    inside = (a > 0.0) & (b2 * ch2 <= (a * a) * (sh_ * sh_))
    rhs = r + a * sh_
    near = (rhs >= 0.0) & (b2 * ch2 <= rhs * rhs)
    return (((inside | near) & (a + r > 1e-4)) | (dist2 <= r * r)) & (r >= 0.0)


def _stream(d8, pf, sh3, n_seg_t, seg, compact):
    """The column stream the compositor walks, as (pf, sh3, n_seg, order,
    inside): without ``compact`` the tile's columns; with it the live
    columns that pass :func:`column_keep`, packed to the front in stream
    order (the TPU kernel's _compact_phase :403 packs them exactly so),
    then neutral columns with zero SH. ``order`` [T, S] is the permutation
    that gathered them and ``inside`` [T, S] marks the packed survivors
    (None without ``compact``); n_seg [T] counts the stream's segments."""
    s = pf.shape[2]
    nseg = torch.clamp(n_seg_t.to(torch.int64).to(d8.device), 0, s // seg)
    if not compact:
        return pf, sh3, nseg, None, None
    lane = torch.arange(s, device=d8.device)
    keep = (lane[None, :] // seg < nseg[:, None]) & column_keep(d8, pf)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    total = keep.sum(dim=1)
    inside = lane[None, :] < total[:, None]
    neutral = neutral_fused_row(d8.device).to(pf.dtype)
    pf_c = torch.gather(pf, 2, order[:, None, :].expand_as(pf))
    pf_c = torch.where(inside[:, None, :], pf_c, neutral[None, :, None])
    sh_c = torch.gather(sh3, 2, order[:, None, :].expand_as(sh3))
    sh_c = torch.where(inside[:, None, :], sh_c, torch.zeros((), dtype=sh3.dtype))
    return pf_c, sh_c, (total + seg - 1) // seg, order, inside


def _forward3_reference(d8, pf, sh3, n_seg_t, seg, extent2, max_depth, beta_kill,
                        sh_k, compact, order_band, early_exit=False):
    """(L, beta, walked, live) of the plain forward; see
    :func:`composite_tiles3_reference` and :func:`forward3`. Tiles stop
    independently: a stopped tile's segments are masked out (its log beta
    and L frozen), not broken off."""
    t, _, r = d8.shape
    s = pf.shape[2]
    if s % seg:
        raise ValueError(f"S = {s} is not a multiple of seg = {seg}")
    dtype = pf.dtype
    pf, sh3, nseg, _, _ = _stream(d8, pf, sh3, n_seg_t, seg, compact)
    d3, f6, _, basis = _ray_terms(d8.to(dtype), sh_k, sh3.dtype)
    d3_32, f6_32, _, _ = _ray_terms(d8.float(), sh_k, sh3.dtype)
    e2h = extent2 * 0.5
    log_kill = _log_kill(beta_kill)
    log_beta = torch.zeros((t, r, 1), dtype=dtype, device=d8.device)
    count = torch.zeros_like(log_beta)
    l_acc = torch.zeros((t, r, 3), dtype=dtype, device=d8.device)
    walked = torch.zeros((t,), dtype=torch.int64, device=d8.device)
    running = torch.ones((t,), dtype=torch.bool, device=d8.device)
    for si in range(int(nseg.max()) if t else 0):
        active = count[..., 0] <= max_depth  # [T, R]
        if early_exit and not compact:  # JAX's while-loop cond: also above the kill
            active = active & (log_beta[..., 0] > log_kill)
        # a tile walks on while some ray of it is active (the kernels' block
        # vote); past the cap alone that changes no output
        running = running & (si < nseg) & active.any(dim=1)
        live = running[:, None, None]  # [T, 1, 1]
        walked += running
        cols = pf[:, :, si * seg:(si + 1) * seg]
        alpha0 = _segment_pairs(cols, d3, f6, e2h, live)[7]
        depth_ok, count = _capped(alpha0, count, max_depth)
        alpha = torch.where(depth_ok, alpha0, 0.0)
        logt = torch.log1p(-alpha)
        cs_incl = torch.cumsum(logt, dim=-1)
        cs_excl = cs_incl - logt
        if order_band > 0:
            tkey = _entry_keys(cols, d3_32, f6_32, e2h)
            cs_excl = cs_excl + _band_corr(tkey, logt, order_band)
        lw = log_beta + cs_excl
        w = torch.where(lw > log_kill, torch.exp(lw) * alpha, 0.0)
        shs = sh3[:, :, si * seg:(si + 1) * seg].to(dtype)  # [T, 3k, C]
        inc = torch.stack(
            [
                torch.sum(
                    w * torch.clamp(
                        torch.matmul(basis, shs[:, ch * sh_k:(ch + 1) * sh_k]),
                        min=0.0,
                    ),
                    dim=-1,
                )
                for ch in range(3)
            ],
            dim=-1,
        )
        l_acc = l_acc + torch.where(live, inc, 0.0)
        log_beta = log_beta + cs_incl[..., -1:]
    return (l_acc, torch.exp(log_beta[..., 0]), walked.to(torch.int32),
            nseg.to(torch.int32))


def composite_tiles3_reference(
    d8: torch.Tensor,  # [T, 8, R] f32 direction rows (+ cone rows 3-7)
    pf: torch.Tensor,  # [T, 16, S] f32 packed columns
    sh3: torch.Tensor,  # [T, 3k, S] SH rows (bf16 or f32)
    n_seg_t: torch.Tensor,  # [T] int live segments per tile
    seg: int = 256,
    extent2: float = 9.0,
    max_depth: int = 128,
    beta_kill: float = 0.01,
    sh_k: int = 16,
    compact: bool = False,
    order_band: int = 0,
    early_exit: bool = False,
):
    """Plain PyTorch version of the forward compositor: segment by segment,
    with ``torch.cumsum`` for the hit count and the log-transmittance
    prefix. With ``compact`` it walks the compacted stream (:func:`_stream`):
    compaction drops only columns that no ray of the tile can hit, so it
    changes L only through the segment boundaries of the order band and the
    rounding of the carries. ``order_band`` > 0 corrects each lane's
    transmittance prefix for the entry order of its neighbours within that
    many lanes of the same segment (:func:`_band_corr`). ``early_exit``
    without ``compact`` stops each tile as the TPU kernel's while loop does
    (see the module docstring); with ``compact`` it changes nothing, as in
    JAX. Returns (L [T, R, 3], beta [T, R]) in pf's dtype: f32 as the
    kernel computes; the CPU tests pass f64 as a yardstick."""
    return _forward3_reference(d8, pf, sh3, n_seg_t, seg, extent2, max_depth,
                               beta_kill, sh_k, compact, order_band, early_exit)[:2]


def composite_tiles3_bwd_reference(
    d8: torch.Tensor,
    pf: torch.Tensor,
    sh3: torch.Tensor,
    n_seg_t: torch.Tensor,
    g_l: torch.Tensor,  # [T, R, 3] cotangent of L
    g_beta: torch.Tensor,  # [T, R] cotangent of beta
    seg: int = 256,
    extent2: float = 9.0,
    max_depth: int = 128,
    beta_kill: float = 0.01,
    sh_k: int = 16,
    compact: bool = False,
    order_band: int = 0,
):
    """Plain PyTorch version of the backward compositor: the vector-Jacobian
    product of :func:`composite_tiles3_reference`, computed as the TPU
    kernel computes it (_bwd3_subtile, composite3.py:864-1199), not by
    autograd. A forward sweep keeps each segment's (log beta, hit count)
    carry; the reverse sweep recomputes each segment and accumulates the
    adjoints of the packed rows and the SH table. The SH adjoint takes the
    f32 basis, while the emission it differentiates took the bf16-rounded
    one, as in the TPU kernel. With ``compact`` it walks the compacted
    stream and scatters the adjoints back to their slots (a dropped column
    has alpha = 0 for every ray of its tile, so its adjoint is 0). With
    ``order_band`` it recomputes the band and applies its transpose to the
    lane weights' adjoints (:func:`_band_corr_adjoint`).

    Returns (gpf [T, 16, S] in pf's dtype with rows 13-15 zero, gsh
    [T, 3k, S] in sh3's dtype). It computes in pf's dtype: f32 as the
    kernel does; given pf in f64 it is the yardstick that the tests and
    chip_smoke.py hold both f32 versions to (adjoints such as g_u, whose
    exact value is 0 at the closest approach, are rounding noise in every
    f32 version). The band's entry keys are f32 in every dtype, so the
    yardstick orders near-tie pairs as the f32 versions do."""
    t, _, r = d8.shape
    s = pf.shape[2]
    if s % seg:
        raise ValueError(f"S = {s} is not a multiple of seg = {seg}")
    dev = d8.device
    dtype = pf.dtype
    pf, sh3_s, nseg, order, inside = _stream(d8, pf, sh3, n_seg_t, seg, compact)
    d3, f6, basis_f, basis = _ray_terms(d8.to(dtype), sh_k, sh3.dtype)
    d3_32, f6_32, _, _ = _ray_terms(d8.float(), sh_k, sh3.dtype)
    e2h = extent2 * 0.5
    log_kill = _log_kill(beta_kill)
    n_walk = int(nseg.max()) if t else 0
    g_l = g_l.to(dtype)
    gpf = torch.zeros((t, _FEAT, s), dtype=dtype, device=dev)
    gsh = torch.zeros((t, 3 * sh_k, s), dtype=dtype, device=dev)

    def segment(si, log_beta, count):
        live = (si < nseg)[:, None, None]
        cols = pf[:, :, si * seg:(si + 1) * seg]
        pairs = _segment_pairs(cols, d3, f6, e2h, live)
        depth_ok, count_next = _capped(pairs[7], count, max_depth)
        alpha = torch.where(depth_ok, pairs[7], 0.0)
        logt = torch.log1p(-alpha)
        cs_incl = torch.cumsum(logt, dim=-1)
        return pairs, depth_ok, alpha, logt, cs_incl, count_next

    # forward sweep: the carry at each segment start
    carries = []
    log_beta = torch.zeros((t, r, 1), dtype=dtype, device=dev)
    count = torch.zeros_like(log_beta)
    for si in range(n_walk):
        carries.append((log_beta, count))
        _, _, _, _, cs_incl, count = segment(si, log_beta, count)
        log_beta = log_beta + cs_incl[..., -1:]
    g_lb = g_beta.to(dtype)[..., None] * torch.exp(log_beta)  # [T, R, 1]

    for si in reversed(range(n_walk)):
        sl = slice(si * seg, (si + 1) * seg)
        log_beta, count = carries[si]
        pairs, depth_ok, alpha, logt, cs_incl, _ = segment(si, log_beta, count)
        row, a, b, (px, py, pz), q_raw, dens, raw, _, hit = pairs
        cs_excl = cs_incl - logt
        if order_band > 0:
            tkey = _entry_keys(pf[:, :, sl], d3_32, f6_32, e2h)
            cs_excl = cs_excl + _band_corr(tkey, logt, order_band)
        lw = log_beta + cs_excl
        alive = lw > log_kill
        exp_lw = torch.exp(lw)
        w = torch.where(alive, exp_lw * alpha, 0.0)
        shs = sh3_s[:, :, sl].to(dtype)
        g_w = torch.zeros_like(w)
        for ch in range(3):
            e_raw = torch.matmul(basis, shs[:, ch * sh_k:(ch + 1) * sh_k])
            g_w = g_w + g_l[..., ch:ch + 1] * torch.clamp(e_raw, min=0.0)
            g_e = torch.where(e_raw > 0.0, g_l[..., ch:ch + 1] * w, 0.0)
            # [T, k, R] x [T, R, C] -> [T, k, C]
            gsh[:, ch * sh_k:(ch + 1) * sh_k, sl] = torch.matmul(
                basis_f.transpose(1, 2), g_e
            )
        g_lw = g_w * w
        # sum of g_lw over the later columns of the segment, as the total
        # less the inclusive prefix, both in f64 (in f32 the difference of
        # two long sums loses the small suffixes at a segment's end)
        g_lw64 = g_lw.to(torch.float64)
        tot = torch.sum(g_lw64, dim=-1, keepdim=True)
        g_logt = g_lb + (tot - torch.cumsum(g_lw64, dim=-1)).to(dtype)
        if order_band > 0:
            g_logt = _band_corr_adjoint(g_logt, tkey, g_lw, order_band)
        g_alpha = torch.where(alive, g_w * exp_lw, 0.0) + g_logt * (
            -1.0 / (1.0 - alpha)
        )
        g_alpha = torch.where(depth_ok & hit, g_alpha, 0.0)
        g_raw = torch.where(raw < 0.9999, g_alpha, 0.0)
        g_q = torch.where(q_raw > 0.0, -(g_raw * row[12] * dens), 0.0)
        # stable q = m11 px^2 + m22 py^2 + m33 pz^2 + m12_2 px py
        #          + m13_2 px pz + m23_2 py pz, with p = w + t* d
        g_px = g_q * (2.0 * row[0] * px + row[3] * py + row[4] * pz)
        g_py = g_q * (2.0 * row[1] * py + row[3] * px + row[5] * pz)
        g_pz = g_q * (2.0 * row[2] * pz + row[4] * px + row[5] * py)
        dx, dy, dz = d3
        g_t = g_px * dx + g_py * dy + g_pz * dz
        # t* = -b / a
        g_b = -g_t / a
        g_a = g_t * b / (a * a)
        per_pair = [
            g_q * px * px, g_q * py * py, g_q * pz * pz,
            g_q * px * py, g_q * px * pz, g_q * py * pz,
        ]
        rows = [
            torch.sum(per_pair[i], dim=1) + torch.sum(f6[i] * g_a, dim=1)
            for i in range(6)
        ]
        rows += [torch.sum(v * g_b, dim=1) for v in d3]
        rows += [torch.sum(v, dim=1) for v in (g_px, g_py, g_pz)]
        rows.append(torch.sum(g_raw * dens, dim=1))
        gpf[:, :13, sl] = torch.stack(rows, dim=1)
        g_lb = g_lb + tot.to(dtype)
    if compact:
        # back to the original slots; the neutral tail's adjoints are 0
        gpf = torch.zeros_like(gpf).scatter_(
            2, order[:, None, :].expand_as(gpf), torch.where(inside[:, None, :], gpf, 0.0)
        )
        gsh = torch.zeros_like(gsh).scatter_(
            2, order[:, None, :].expand_as(gsh), torch.where(inside[:, None, :], gsh, 0.0)
        )
    return gpf, gsh.to(sh3.dtype)


# each C entry point's arguments after its tensor pointers: T, R, S, seg,
# sh_k, e2h, max_depth, log_kill, compact, band, (the forward's) early_exit,
# stream; the ablations' (built for sh_k 4 and no band) T, R, S, seg, abl,
# e2h, max_depth, log_kill, compact, early_exit, stream
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "composite3_fwd": [_VP] * 9 + [_CI] * 5 + [_CF, _CI, _CF, _CI, _CI, _CI, _VP],
    "composite3_fwd_abl": [_VP] * 9 + [_CI] * 5 + [_CF, _CI, _CF, _CI, _CI, _VP],
    "composite3_bwd": [_VP] * 11 + [_CI] * 5 + [_CF, _CI, _CF, _CI, _CI, _VP],
}
# The forward's timing ablations (csrc/composite3_fwd.cuh, enum Ablation):
# the TPU kernel's _ABL switches that its profiler sweeps, each removing one
# piece of the kernel's work. Their results are wrong by design.
ABLATIONS = {"nodepth": 1, "noemis": 2, "notrans": 3, "nocum": 4, "noop": 5,
             "noop2": 6, "static": 7, "fori": 8}
# widest order band the kernels take (kMaxBand in composite3_common.cuh:
# the rays' windows of hits are sized for it)
MAX_BAND = 32


def _lib(name: str = "composite3_fwd"):
    """The ctypes library of ``csrc/<name>.cu`` (built at first use)."""
    return _build.bind(name, _ARGTYPES[name])


def _check_inputs(d8, pf, sh3, n_seg_t, seg, sh_k, order_band, extra=()):
    """Device, dtype, shape and contiguity checks of the kernels' inputs."""
    dev = d8.device
    t, rows, r = d8.shape
    s = pf.shape[-1]
    named = (
        ("d8", d8, torch.float32), ("pf", pf, torch.float32),
        ("sh3", sh3, torch.bfloat16), ("n_seg_t", n_seg_t, torch.int32),
    ) + tuple(extra)
    for name, x, dtype in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, d8 on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows != 8 or not 1 <= r <= 1024:
        raise ValueError(f"d8 must be [T, 8, R] with R <= 1024, got {tuple(d8.shape)}")
    if sh_k not in (1, 4, 9, 16):
        raise ValueError(f"sh_k must be 1, 4, 9 or 16, got {sh_k}")
    if tuple(pf.shape) != (t, _FEAT, s) or tuple(sh3.shape) != (t, 3 * sh_k, s):
        raise ValueError(
            f"pf {tuple(pf.shape)} / sh3 {tuple(sh3.shape)} do not match "
            f"[{t}, 16, S] / [{t}, {3 * sh_k}, S]"
        )
    if tuple(n_seg_t.shape) != (t,) or seg < 1 or s % seg:
        raise ValueError(f"n_seg_t must be [{t}] and S = {s} a multiple of seg = {seg}")
    if not 0 <= order_band <= MAX_BAND:
        raise ValueError(f"the kernels take order_band 0..{MAX_BAND}, got {order_band}")
    return t, r, s


def _stream_scratch(t, s, compact, dev):
    """The kernels' list of each tile's surviving columns (compaction)."""
    return torch.empty((t, s) if compact else (1,), dtype=torch.int32, device=dev)


def _launch(d8, pf, sh3, n_seg_t, seg, extent2, max_depth, beta_kill, sh_k,
            compact, order_band=0, early_exit=False, abl=0):
    """Launch csrc/composite3_fwd.cu, or with ``abl`` (an ABLATIONS value)
    csrc/composite3_fwd_abl.cu: (L [T, R, 3], beta [T, R], walked [T],
    live [T])."""
    t, r, s = _check_inputs(d8, pf, sh3, n_seg_t, seg, sh_k, order_band)
    dev = d8.device
    name = "composite3_fwd_abl" if abl else "composite3_fwd"
    lib = _lib(name)
    l_out = torch.empty((t, r, 3), dtype=torch.float32, device=dev)
    beta = torch.empty((t, r), dtype=torch.float32, device=dev)
    counts = torch.empty((2, t), dtype=torch.int32, device=dev)
    idx = _stream_scratch(t, s, compact, dev)
    with torch.cuda.device(dev):
        head = (d8.data_ptr(), pf.data_ptr(), sh3.data_ptr(), n_seg_t.data_ptr(),
                l_out.data_ptr(), beta.data_ptr(), counts[0].data_ptr(),
                counts[1].data_ptr(), idx.data_ptr(), t, r, s, seg)
        scalars = (extent2 * 0.5, int(max_depth), _log_kill(beta_kill), int(compact))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if abl:
            err = lib.composite3_fwd_abl(*head, abl, *scalars, int(early_exit), stream)
        else:
            err = lib.composite3_fwd(*head, sh_k, *scalars, int(order_band), int(early_exit),
                                     stream)
    _build.raise_on(lib, err, name)
    if abl:
        forward3_ablated.launches += 1
    else:
        composite_tiles3.launches += 1
    return l_out, beta, counts[0], counts[1]


def _launch_bwd(d8, pf, sh3, n_seg_t, g_l, g_beta, seg, extent2, max_depth,
                beta_kill, sh_k, compact, order_band=0):
    """Launch csrc/composite3_bwd.cu: (gpf [T, 16, S] f32, gsh [T, 3k, S]
    bf16)."""
    f32 = torch.float32
    t, r, s = _check_inputs(
        d8, pf, sh3, n_seg_t, seg, sh_k, order_band,
        (("g_l", g_l, f32), ("g_beta", g_beta, f32)),
    )
    if tuple(g_l.shape) != (t, r, 3) or tuple(g_beta.shape) != (t, r):
        raise ValueError(
            f"g_l {tuple(g_l.shape)} / g_beta {tuple(g_beta.shape)} do not "
            f"match [{t}, {r}, 3] / [{t}, {r}]"
        )
    dev = d8.device
    lib = _lib("composite3_bwd")
    gpf = torch.empty((t, _FEAT, s), dtype=f32, device=dev)
    gsh = torch.empty((t, 3 * sh_k, s), dtype=torch.bfloat16, device=dev)
    # per-segment (log beta, hit count) carries of every ray
    lb_scr = torch.empty((t, s // seg, r), dtype=f32, device=dev)
    cnt_scr = torch.empty((t, s // seg, r), dtype=torch.int32, device=dev)
    idx = _stream_scratch(t, s, compact, dev)
    with torch.cuda.device(dev):
        err = lib.composite3_bwd(
            d8.data_ptr(), pf.data_ptr(), sh3.data_ptr(), n_seg_t.data_ptr(),
            g_l.data_ptr(), g_beta.data_ptr(), lb_scr.data_ptr(),
            cnt_scr.data_ptr(), idx.data_ptr(), gpf.data_ptr(), gsh.data_ptr(),
            t, r, s, seg, sh_k, extent2 * 0.5, int(max_depth),
            _log_kill(beta_kill), int(compact), int(order_band),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.raise_on(lib, err, "composite3_bwd")
    composite_tiles3_bwd.launches += 1
    return gpf, gsh


@spans.spanned("composite3.fwd")
def forward3(d8, pf, sh3, n_seg_t, seg=256, extent2=9.0, max_depth=128,
             beta_kill=0.01, sh_k=16, compact=False, order_band=0, early_exit=False):
    """The forward compositor with its profiling counters, as JAX's
    ``_forward3`` (composite3.py:1202) returns them in columns 4-5:
    (L [T, R, 3], beta [T, R], walked [T], live [T]). ``live`` counts the
    segments of each tile's stream: ceil(survivors / seg) with ``compact``,
    else its live segments. ``walked`` counts the segments the port walked.
    With ``early_exit`` and no compaction it is JAX's: the tile stops before
    the first segment at which every ray is past its hit cap or at or below
    log(beta_kill). Otherwise the port still stops a tile once every ray is
    past its cap, which changes no output (JAX reports the live count there).
    CUDA tensors launch csrc/composite3_fwd.cu; CPU tensors take the plain
    version. Not differentiable: :func:`composite_tiles3` is."""
    args = (seg, extent2, max_depth, beta_kill, sh_k, compact, order_band, early_exit)
    if d8.device.type == "cpu":
        return _forward3_reference(d8, pf, sh3, n_seg_t, *args)
    if d8.device.type != "cuda":
        raise ValueError(f"composite_tiles3 runs on CPU or CUDA, not {d8.device}")
    return _launch(d8, pf, sh3, n_seg_t, *args)


def forward3_ablated(abl, d8, pf, sh3, n_seg_t, seg=256, extent2=9.0, max_depth=128,
                     beta_kill=0.01, sh_k=4, compact=False, early_exit=False):
    """The forward kernel with the timing ablation ``abl`` (a key of
    ABLATIONS) compiled in, for the profiler's abl_* stages: (L, beta,
    walked, live) as :func:`forward3` returns them, wrong by design. CUDA
    tensors only (there is no plain version of a wrong result), sh_k 4 and
    no band; counted in ``forward3_ablated.launches``."""
    if abl not in ABLATIONS:
        raise ValueError(f"unknown ablation {abl!r}; the ablations are {', '.join(ABLATIONS)}")
    if d8.device.type != "cuda":
        raise ValueError("the ablated kernels time the CUDA kernel and run on CUDA tensors only")
    if sh_k != 4:
        raise ValueError(f"the ablated kernels are built for sh_k 4, got {sh_k}")
    return _launch(d8, pf, sh3, n_seg_t, seg, extent2, max_depth, beta_kill, sh_k, compact,
                   0, early_exit, ABLATIONS[abl])


forward3_ablated.launches = 0


@spans.spanned("composite3.bwd")
def composite_tiles3_bwd(d8, pf, sh3, n_seg_t, g_l, g_beta, seg=256,
                         extent2=9.0, max_depth=128, beta_kill=0.01, sh_k=16,
                         compact=False, order_band=0):
    """Backward compositor: (gpf [T, 16, S] f32, gsh [T, 3k, S] in sh3's
    dtype). CUDA tensors launch the hand-written kernel
    (csrc/composite3_bwd.cu) and raise if it does not launch; CPU tensors
    take :func:`composite_tiles3_bwd_reference`."""
    args = (seg, extent2, max_depth, beta_kill, sh_k, compact, order_band)
    if d8.device.type == "cpu":
        return composite_tiles3_bwd_reference(d8, pf, sh3, n_seg_t, g_l, g_beta, *args)
    if d8.device.type != "cuda":
        raise ValueError(f"composite_tiles3_bwd runs on CPU or CUDA, not {d8.device}")
    return _launch_bwd(d8, pf, sh3, n_seg_t, g_l.contiguous(), g_beta.contiguous(), *args)


composite_tiles3_bwd.launches = 0


class _Composite3(torch.autograd.Function):
    """The compositor with the backward of composite3._bwd3_rule: gradients
    reach pf and sh3; d8 and n_seg_t get none (JAX gives zeros and
    float0). An unused beta output is a zero cotangent. The backward takes
    no ``early_exit`` (the last argument): JAX's rule does not pass it to
    its kernel, which walks the whole stream, so under early exit the beta
    cotangent reaches segments the forward did not walk."""

    @staticmethod
    def forward(ctx, d8, pf, sh3, n_seg_t, *args):
        l_out, beta, walked, live = forward3(d8, pf, sh3, n_seg_t, *args)
        spans.count("composite3.segments_walked", walked)
        spans.count("composite3.segments_live", live)
        ctx.save_for_backward(d8, pf, sh3, n_seg_t)
        ctx.args = args[:-1]
        ctx.set_materialize_grads(True)
        return l_out, beta

    @staticmethod
    def backward(ctx, g_l, g_beta):
        d8, pf, sh3, n_seg_t = ctx.saved_tensors
        gpf, gsh = composite_tiles3_bwd(d8, pf, sh3, n_seg_t, g_l, g_beta, *ctx.args)
        need = ctx.needs_input_grad
        return (None, gpf if need[1] else None, gsh if need[2] else None) + (None,) * 9


def composite_tiles3(
    d8: torch.Tensor,
    pf: torch.Tensor,
    sh3: torch.Tensor,
    n_seg_t: torch.Tensor,
    seg: int = 256,
    extent2: float = 9.0,
    max_depth: int = 128,
    beta_kill: float = 0.01,
    sh_k: int = 16,
    compact: bool = False,
    order_band: int = 0,
    early_exit: bool = False,
):
    """Fused compositor: (L [T, R, 3], beta [T, R]), differentiable in
    ``pf`` and ``sh3``.

    CUDA tensors launch the hand-written kernels (csrc/composite3_fwd.cu,
    and csrc/composite3_bwd.cu in the backward; with ``compact`` both first
    drop the columns whose bounding sphere misses the tile's ray cone and
    walk the survivors as one packed stream; ``order_band`` > 0 corrects
    each pair's transmittance prefix for the entry order of its stream
    neighbours, as the TPU kernel's order band) and raise if one does not
    launch. CPU tensors take :func:`composite_tiles3_reference` and
    :func:`composite_tiles3_bwd_reference`.

    ``early_exit`` (default off; JAX's default is on) stops a tile without
    compaction before the first segment at which none of its rays is under
    its hit cap and above ``beta_kill``; beta is then the product up to
    there, which an emitter's light reads. L is the same either way (a ray
    at or below beta_kill adds no more emission). The backward walks the whole stream
    whatever the flag, as JAX's custom VJP does."""
    return _Composite3.apply(
        d8, pf, sh3, n_seg_t, seg, extent2, max_depth, beta_kill, sh_k, compact,
        order_band, early_exit,
    )


composite_tiles3.launches = 0


def synthetic_tiles(
    t: int, r: int, s: int, seg: int, sh_k: int, seed: int = 0,
    sh_dtype=torch.bfloat16, device=None,
):
    """Random packed compositor inputs made with numpy from ``seed``, at
    the kernel's shapes: T tiles of R rays in a narrow cone from the
    origin, each with S columns of primitives scattered around its axis
    (some inside the cone, some outside, which compaction drops), a
    neutral tail after each tile's live columns (zero SH), and some tiles
    with fewer live segments than S / seg. Returns (d8, pf, sh3, n_seg_t)."""
    from ..scene.ellipsoids import EllipsoidScene

    rng = np.random.default_rng(seed)
    n_seg = s // seg
    axis = np.concatenate(
        [rng.uniform(-0.3, 0.3, (t, 2)), np.ones((t, 1))], axis=1
    )
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    d = axis[:, None, :] + rng.normal(0.0, 0.03, (t, r, 3))
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    depth = np.sort(rng.uniform(2.0, 4.0, (t, s)), axis=1)  # near first
    centers = axis[:, None, :] * depth[..., None] + rng.normal(0.0, 0.12, (t, s, 3))
    quats = rng.normal(size=(t * s, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    prims = EllipsoidScene(
        centers=f32(centers.reshape(-1, 3)),
        scales=f32(rng.uniform(0.01, 0.05, (t * s, 3))),
        quats=f32(quats),
        attrs={"opacities": f32(rng.uniform(0.3, 0.99, (t * s, 1)))},
    )
    pf = pack_fused_features(prims, torch.zeros(3)).reshape(_FEAT, t, s)
    pf = pf.permute(1, 0, 2).contiguous()
    sh_rows = fold_sh_rows(f32(rng.normal(0.0, 0.3, (t * s, sh_k, 3))))
    sh3 = sh_rows.reshape(t, s, 3 * sh_k).permute(0, 2, 1).contiguous()
    # live segments per tile, then a neutral tail inside the last live one
    n_live = np.where(rng.uniform(size=t) < 0.5, n_seg, rng.integers(1, n_seg + 1, t))
    for i in range(t):
        cut = n_live[i] * seg - int(rng.integers(0, seg // 2))
        pf[i, :, cut:] = neutral_fused_row()[:, None]
        sh3[i, :, cut:] = 0.0
    dt = torch.from_numpy(d.astype(np.float32))
    d8 = pack_direction_rows(dt[..., 0], dt[..., 1], dt[..., 2])
    dev = device if device is not None else "cpu"
    return (
        d8.to(dev), pf.to(dev), sh3.to(sh_dtype).to(dev),
        torch.from_numpy(n_live.astype(np.int32)).to(dev),
    )
