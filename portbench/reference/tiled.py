"""The plain reference of the tiled renderer's fused route and its
training step.

A frozen copy of the port's plain semantics: the clustered state (Morton
order, cluster and supercluster spheres, bf16 folded-SH cluster rows), the
per-frame cull (strip cones over superclusters, then tile cones over their
member clusters), the need-ordered budget classes, the per-frame column
pack, the cluster-blocked gathers, the compositor's plain forward and its
plain vector-Jacobian product (the SH adjoint on the f32 basis, as the
kernels take it), sRGB, the L1 loss and BoundedAdam. The compositor runs
in blocks of ``TILE_CHUNK`` tiles so that it fits beside the program's
state. It imports nothing of the port and is handed only the inputs that
the benchmark made.

With ``counts`` (a list) every compositor call appends what it had to do:
the live columns (read once), the (ray, column) pairs of each tile's rays
with the columns that meet the tile's ray cone, and the hits under the cap,
of the forward (on the segments its walk reaches under early exit without
compaction) and of the backward (the whole stream); ``portbench/work``
turns them into bytes, operations and the least time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .adam import BoundedAdam
from .scene import (Scene, build_clusters, build_super_spheres, l1, pad_primitives,
                    sh_basis_columns, sh_degree, srgb_to_linear)

TILE_CHUNK = 128  # tiles per block of the plain compositor (memory)
# the compositor's working precision: float32; a control sets a lower one
PAIR_DTYPE = torch.float32
_FEAT = 16


@dataclasses.dataclass(frozen=True)
class TiledConfig:
    """The fused route's knobs that the configurations set."""

    max_depth: int = 128
    tile_pixels: int = 256
    max_candidates: int = 2048
    segment: int = 256
    beta_kill: float = 0.01
    cluster_size: int = 16
    coarse_group: int = 4
    coarse_factor: int = 8
    super_group: int = 4
    budget_classes: tuple = ()
    kernel_compact: bool = False
    cluster_sort: bool = False
    early_exit: bool = False
    srgb_primitives: bool = True


def config_of(fields: dict) -> TiledConfig:
    kw = {f.name: fields[f.name] for f in dataclasses.fields(TiledConfig) if f.name in fields}
    if "budget_classes" in kw:
        kw["budget_classes"] = tuple(tuple(c) for c in kw["budget_classes"])
    return TiledConfig(**kw)


# ---- state ---------------------------------------------------------------

@dataclasses.dataclass
class State:
    prims: Scene  # Morton-ordered, padded
    sup_centers: torch.Tensor
    sup_radii: torch.Tensor
    suprows: torch.Tensor
    shrows: torch.Tensor  # [Ncl, 3k cs] bf16
    ncl: int
    sh_k: int
    extent: float


def fold_sh_rows(sh_coeffs: torch.Tensor) -> torch.Tensor:
    """[N, k, 3] -> [N, 3k] channel-major, the DC row as Y00 dc + 0.5."""
    n, k, _ = sh_coeffs.shape
    dc = sh_coeffs[:, 0, :] * 0.28209479177387814 + 0.5
    fold = torch.cat([dc[:, None, :], sh_coeffs[:, 1:, :]], dim=1)
    return fold.permute(0, 2, 1).reshape(n, 3 * k)


def build_state(prims: Scene, cfg: TiledConfig) -> State:
    cs, sg = cfg.cluster_size, cfg.super_group
    padded = pad_primitives(prims, cs)
    with torch.no_grad():
        perm, cl_c, cl_r = build_clusters(padded, cs, prims.num_prims)
    work = padded.select(perm)
    ncl = work.num_prims // cs
    sh3d = work.sh_coeffs_3d()
    k = sh3d.shape[1]
    shrows = (fold_sh_rows(sh3d).reshape(ncl, cs, 3 * k).permute(0, 2, 1)
              .reshape(ncl, 3 * k * cs).to(torch.bfloat16))
    sup_c, sup_r = build_super_spheres(cl_c, cl_r, sg)
    nsup = sup_c.shape[0]
    pad_cl = nsup * sg - ncl

    def col(x, fill):
        return torch.cat([x, x.new_full((pad_cl,), fill)]).reshape(nsup, sg)

    suprows = torch.cat([col(cl_c[:, 0], 0.0), col(cl_c[:, 1], 0.0), col(cl_c[:, 2], 0.0),
                         col(cl_r, -1.0)], dim=1)
    tail = suprows.new_zeros((1, 4 * sg))
    tail[0, 3 * sg:] = -1.0
    return State(work, sup_c, sup_r, torch.cat([suprows, tail]), shrows, ncl, k,
                 float(prims.extent))


# ---- film layout and jitter -------------------------------------------------

def tile_layout(cam, cfg: TiledConfig, device):
    """Block-major tiles: (px0, py0 [T, RT], unshuffle)."""
    h, w = cam.height, cam.width
    tp = cfg.tile_pixels
    th = int(tp ** 0.5)
    while tp % th or h % th:
        th -= 1
    tw = tp // th
    if h % th or w % tw:
        raise ValueError(f"film {w}x{h} not divisible into {tw}x{th} tiles")
    n_ty, n_tx = h // th, w // tw
    n_tiles, rt = n_ty * n_tx, th * tw
    gc = max(1, cfg.coarse_group)
    gb_y = max(1, int(round(gc ** 0.5)))
    while gb_y > 1 and (gc % gb_y or n_ty % gb_y or n_tx % (gc // gb_y)):
        gb_y -= 1
    gb_x = gc // gb_y if gc % gb_y == 0 and n_tx % (gc // gb_y) == 0 else 1
    if gb_x == 1:
        gb_y = 1
    n_gy, n_gx = n_ty // gb_y, n_tx // gb_x
    ty_of = (torch.arange(n_ty).reshape(n_gy, 1, gb_y, 1).expand(n_gy, n_gx, gb_y, gb_x)
             .reshape(-1))
    tx_of = (torch.arange(n_tx).reshape(1, n_gx, 1, gb_x).expand(n_gy, n_gx, gb_y, gb_x)
             .reshape(-1))
    ys = torch.arange(h).reshape(n_ty, th)[ty_of]
    xs = torch.arange(w).reshape(n_tx, tw)[tx_of]
    py0 = ys[:, :, None].expand(n_tiles, th, tw).reshape(n_tiles, rt)
    px0 = xs[:, None, :].expand(n_tiles, th, tw).reshape(n_tiles, rt)

    def unshuffle(acc):
        return (acc.reshape(n_gy, n_gx, gb_y, gb_x, th, tw, 3).permute(0, 2, 4, 1, 3, 5, 6)
                .reshape(h, w, 3))

    f32 = torch.float32
    return px0.to(device=device, dtype=f32), py0.to(device=device, dtype=f32), unshuffle


def tile_offsets(seed, i, n_tiles, rt, jitter, device):
    """In-pixel offsets [T, RT, 2] of sample ``i``: a Philox generator keyed
    by (seed, i) over the whole film; pixel centers without jitter."""
    if not jitter:
        return torch.full((n_tiles, rt, 2), 0.5, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + i) % (2 ** 63))
    return torch.rand((n_tiles, rt, 2), generator=gen, device=device)


def class_counts(n_tiles: int, budget_classes) -> list:
    counts = [int(round(n_tiles * f)) for f, _ in budget_classes]
    counts[-1] = n_tiles - sum(counts[:-1])
    return counts


# ---- cull ------------------------------------------------------------------

def _keys(depth, dist, radii, cos_half):
    safe = torch.clamp(dist, min=1e-8)
    cos_theta = depth / safe
    sin_rho = torch.clamp(radii / safe, 0.0, 1.0)
    cos_rho = torch.sqrt(torch.clamp(1.0 - sin_rho * sin_rho, min=0.0))
    ch = torch.clamp(cos_half, -1.0, 1.0)
    sh = torch.sqrt(torch.clamp(1.0 - ch * ch, min=0.0))
    wraps = cos_rho <= -ch
    inside = wraps | (cos_theta >= ch * cos_rho - sh * sin_rho)
    hit = ((inside & (depth + radii > 1e-4)) | (dist <= radii)) & (radii >= 0.0)
    return torch.where(hit, depth, torch.full_like(depth, float("inf")))


def cone_keys_batch(origin, axes, cos_half, centers, radii):
    """[T, N] keys; the per-pair depth is one [T, 3] x [3, N] product."""
    v = centers - origin
    dist = torch.sqrt(torch.sum(v * v, dim=-1))
    depth = torch.matmul(axes, v.T)
    return _keys(depth, dist[None, :], radii[None, :], cos_half[:, None])


def cone_keys_cols(origin, axis, cos_half, cx, cy, cz, radii):
    vx, vy, vz = cx - origin[0], cy - origin[1], cz - origin[2]
    dist = torch.sqrt(vx * vx + vy * vy + vz * vz)
    depth = vx * axis[..., 0:1] + vy * axis[..., 1:2] + vz * axis[..., 2:3]
    return _keys(depth, dist, radii, cos_half[..., None])


def shortlist(keys, k):
    order = torch.argsort(keys, dim=-1, stable=True)[:, :k]
    return order, torch.isfinite(torch.gather(keys, 1, order))


# ---- pack --------------------------------------------------------------------

def pack_features(prims: Scene, origin: torch.Tensor) -> torch.Tensor:
    """[16, N] columns seen from ``origin``: halved M6 (doubled
    off-diagonals), u = M w, w = o - c, opacity, c0, bounding radius, the
    entry-distance key."""
    q = prims.quats
    qx, qy, qz, qw = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1.0 - 2.0 * (qy * qy + qz * qz)
    r01 = 2.0 * (qx * qy - qz * qw)
    r02 = 2.0 * (qx * qz + qy * qw)
    r10 = 2.0 * (qx * qy + qz * qw)
    r11 = 1.0 - 2.0 * (qx * qx + qz * qz)
    r12 = 2.0 * (qy * qz - qx * qw)
    r20 = 2.0 * (qx * qz - qy * qw)
    r21 = 2.0 * (qy * qz + qx * qw)
    r22 = 1.0 - 2.0 * (qx * qx + qy * qy)
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
    p0 = r00 * hx + r10 * hy + r20 * hz
    p1 = r01 * hx + r11 * hy + r21 * hz
    p2 = r02 * hx + r12 * hy + r22 * hz
    sup = extent * torch.sqrt(torch.square(prims.scales[:, 0] * p0)
                              + torch.square(prims.scales[:, 1] * p1)
                              + torch.square(prims.scales[:, 2] * p2))
    return torch.stack([m00, m11, m22, 2.0 * m01, 2.0 * m02, 2.0 * m12,
                        ux, uy, uz, wx, wy, wz, opac, c0, rad, wn - sup], dim=0)


def neutral_row(device) -> torch.Tensor:
    row = torch.zeros((_FEAT,), dtype=torch.float32, device=device)
    row[:3] = 1.0
    row[14] = -1.0
    return row


def direction_rows(dnx, dny, dnz) -> torch.Tensor:
    """[T, 8, R]: the directions and the tile's bounding cone (axis, cos
    and sin of the half-angle, the cosine with 1e-6 of slack)."""
    mx, my, mz = dnx.mean(dim=1), dny.mean(dim=1), dnz.mean(dim=1)
    nrm = torch.clamp(torch.sqrt(mx * mx + my * my + mz * mz), min=1e-12)
    ax0, ax1, ax2 = mx / nrm, my / nrm, mz / nrm
    ch = torch.amin(dnx * ax0[:, None] + dny * ax1[:, None] + dnz * ax2[:, None], dim=1)
    ch = torch.clamp(ch - 1e-6, -1.0, 1.0)
    sh_ = torch.sqrt(torch.clamp(1.0 - ch * ch, min=0.0))
    rows = [v[:, None].expand(dnx.shape) for v in (ax0, ax1, ax2, ch, sh_)]
    return torch.stack([dnx, dny, dnz] + rows, dim=1).contiguous()


# ---- the compositor's plain versions ------------------------------------------

def _log_kill(beta_kill: float) -> float:
    return float(np.log(np.float32(beta_kill)))


def _ray_terms(d8, sh_k, sh_dtype):
    dtype = d8.dtype
    dx, dy, dz = (d8[:, i, :, None] for i in range(3))
    f6 = (dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz)
    basis = torch.cat(sh_basis_columns(dx, dy, dz, sh_degree(sh_k), 1.0), dim=-1)
    return (dx, dy, dz), f6, basis, basis.to(sh_dtype).to(dtype)


def _segment_pairs(cols, d3, f6, e2h, live):
    dx, dy, dz = d3
    row = [cols[:, i:i + 1, :] for i in range(13)]
    a = f6[0] * row[0]
    for i in range(1, 6):
        a = a + f6[i] * row[i]
    b = dx * row[6] + dy * row[7] + dz * row[8]
    t_peak = -b / a
    px = row[9] + t_peak * dx
    py = row[10] + t_peak * dy
    pz = row[11] + t_peak * dz
    q_raw = (px * (row[0] * px + row[3] * py + row[4] * pz)
             + py * (row[1] * py + row[5] * pz) + (pz * pz) * row[2])
    q_min = torch.clamp(q_raw, min=0.0)
    hit = (q_min <= e2h) & (t_peak > 0.0) & (q_min - b * t_peak > e2h) & live
    dens = torch.exp(-q_min)
    raw = row[12] * dens
    alpha0 = torch.where(hit, torch.clamp(raw, max=0.9999), 0.0)
    return row, a, b, (px, py, pz), q_raw, dens, raw, alpha0, hit


def _capped(alpha0, count, max_depth):
    cum = count + torch.cumsum((alpha0 > 0.0).to(alpha0.dtype), dim=-1)
    return cum <= max_depth, cum[..., -1:]


@torch.no_grad()
def column_keep(d8, pf):
    """Columns whose bounding sphere meets the tile's ray cone."""
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
    """The walked column stream: (pf, sh3, n_seg, order, inside); with
    ``compact`` the columns that meet the cone packed to the front."""
    s = pf.shape[2]
    nseg = torch.clamp(n_seg_t.to(torch.int64).to(d8.device), 0, s // seg)
    if not compact:
        return pf, sh3, nseg, None, None
    lane = torch.arange(s, device=d8.device)
    keep = (lane[None, :] // seg < nseg[:, None]) & column_keep(d8, pf)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    total = keep.sum(dim=1)
    inside = lane[None, :] < total[:, None]
    neutral = neutral_row(d8.device).to(pf.dtype)
    pf_c = torch.gather(pf, 2, order[:, None, :].expand_as(pf))
    pf_c = torch.where(inside[:, None, :], pf_c, neutral[None, :, None])
    sh_c = torch.gather(sh3, 2, order[:, None, :].expand_as(sh3))
    sh_c = torch.where(inside[:, None, :], sh_c, torch.zeros((), dtype=sh3.dtype))
    return pf_c, sh_c, (total + seg - 1) // seg, order, inside


def forward_plain(d8, pf, sh3, n_seg_t, kw, counts=None):
    """(L [T, R, 3], beta [T, R]) in pf's dtype. ``counts`` (a dict) gets
    the work of this call added to it."""
    seg, sh_k, max_depth = kw["seg"], kw["sh_k"], kw["max_depth"]
    compact, early_exit = kw["compact"], kw["early_exit"]
    stops = early_exit and not compact
    t, _, r = d8.shape
    dtype = pf.dtype
    s = pf.shape[2]
    live_lanes = torch.clamp(n_seg_t.to(torch.int64), 0, s // seg) * seg
    # the pairs a tile needs: its rays against the columns that meet its
    # ray cone (a column outside it is hit by none of them)
    meets = column_keep(d8, pf) if counts is not None and not compact else None
    pf, sh3, nseg, _, inside = _stream(d8, pf, sh3, n_seg_t, seg, compact)
    d3, f6, _, basis = _ray_terms(d8.to(dtype), sh_k, sh3.dtype)
    e2h = kw["extent2"] * 0.5
    log_kill = _log_kill(kw["beta_kill"])
    log_beta = torch.zeros((t, r, 1), dtype=dtype, device=d8.device)
    count = torch.zeros_like(log_beta)
    count_all = torch.zeros_like(log_beta)
    l_acc = torch.zeros((t, r, 3), dtype=dtype, device=d8.device)
    running = torch.ones((t,), dtype=torch.bool, device=d8.device)
    walked = torch.zeros((t,), dtype=torch.int64, device=d8.device)
    for si in range(int(nseg.max()) if t else 0):
        active = count[..., 0] <= max_depth
        if stops:
            active = active & (log_beta[..., 0] > log_kill)
        running = running & (si < nseg) & active.any(dim=1)
        walked += running
        live = running[:, None, None]
        cols = pf[:, :, si * seg:(si + 1) * seg]
        pairs = _segment_pairs(cols, d3, f6, e2h, live)
        alpha0 = pairs[7]
        depth_ok, count = _capped(alpha0, count, max_depth)
        if counts is not None:
            lanes = (inside if compact else meets)[:, si * seg:(si + 1) * seg].sum(dim=1)
            live_t = si < nseg
            counts["fwd_stream"] += int(lanes[running if stops else live_t].sum())
            counts["bwd_stream"] += int(lanes[live_t].sum())
            hit_fwd = pairs[8] & depth_ok
            counts["fwd_hits"] += int(hit_fwd.sum())
            if stops:  # the backward's walk takes the whole stream
                every = _segment_pairs(cols, d3, f6, e2h, live_t[:, None, None])
                ok, count_all = _capped(every[7], count_all, max_depth)
                counts["bwd_hits"] += int((every[8] & ok).sum())
            else:
                counts["bwd_hits"] += int(hit_fwd.sum())
        alpha = torch.where(depth_ok, alpha0, 0.0)
        logt = torch.log1p(-alpha)
        cs_incl = torch.cumsum(logt, dim=-1)
        lw = log_beta + cs_incl - logt
        w = torch.where(lw > log_kill, torch.exp(lw) * alpha, 0.0)
        shs = sh3[:, :, si * seg:(si + 1) * seg].to(dtype)
        inc = torch.stack([
            torch.sum(w * torch.clamp(torch.matmul(basis, shs[:, ch * sh_k:(ch + 1) * sh_k]),
                                      min=0.0), dim=-1)
            for ch in range(3)], dim=-1)
        l_acc = l_acc + torch.where(live, inc, 0.0)
        log_beta = log_beta + cs_incl[..., -1:]
    if counts is not None:
        counts["bwd_live"] += int(live_lanes.sum())
        counts["fwd_live"] += int(torch.minimum(live_lanes, walked * seg).sum()) if stops \
            else int(live_lanes.sum())
    return l_acc, torch.exp(log_beta[..., 0])


def backward_plain(d8, pf, sh3, n_seg_t, g_l, g_beta, kw):
    """The compositor's vector-Jacobian product, as the kernel computes it:
    (gpf [T, 16, S] with rows 13-15 zero, gsh [T, 3k, S] in sh3's dtype).
    The backward walks the whole stream (no early exit)."""
    seg, sh_k, max_depth, compact = kw["seg"], kw["sh_k"], kw["max_depth"], kw["compact"]
    t, _, r = d8.shape
    s = pf.shape[2]
    dev, dtype = d8.device, pf.dtype
    pf, sh3_s, nseg, order, inside = _stream(d8, pf, sh3, n_seg_t, seg, compact)
    d3, f6, basis_f, basis = _ray_terms(d8.to(dtype), sh_k, sh3.dtype)
    e2h = kw["extent2"] * 0.5
    log_kill = _log_kill(kw["beta_kill"])
    n_walk = int(nseg.max()) if t else 0
    g_l = g_l.to(dtype)
    gpf = torch.zeros((t, _FEAT, s), dtype=dtype, device=dev)
    gsh = torch.zeros((t, 3 * sh_k, s), dtype=dtype, device=dev)

    def segment(si, count):
        live = (si < nseg)[:, None, None]
        pairs = _segment_pairs(pf[:, :, si * seg:(si + 1) * seg], d3, f6, e2h, live)
        depth_ok, count_next = _capped(pairs[7], count, max_depth)
        alpha = torch.where(depth_ok, pairs[7], 0.0)
        logt = torch.log1p(-alpha)
        return pairs, depth_ok, alpha, logt, torch.cumsum(logt, dim=-1), count_next

    carries = []
    log_beta = torch.zeros((t, r, 1), dtype=dtype, device=dev)
    count = torch.zeros_like(log_beta)
    for si in range(n_walk):
        carries.append((log_beta, count))
        *_, cs_incl, count = segment(si, count)
        log_beta = log_beta + cs_incl[..., -1:]
    g_lb = g_beta.to(dtype)[..., None] * torch.exp(log_beta)
    for si in reversed(range(n_walk)):
        sl = slice(si * seg, (si + 1) * seg)
        log_beta, count = carries[si]
        pairs, depth_ok, alpha, logt, cs_incl, _ = segment(si, count)
        row, a, b, (px, py, pz), q_raw, dens, raw, _, hit = pairs
        lw = log_beta + cs_incl - logt
        alive = lw > log_kill
        exp_lw = torch.exp(lw)
        w = torch.where(alive, exp_lw * alpha, 0.0)
        shs = sh3_s[:, :, sl].to(dtype)
        g_w = torch.zeros_like(w)
        for ch in range(3):
            e_raw = torch.matmul(basis, shs[:, ch * sh_k:(ch + 1) * sh_k])
            g_w = g_w + g_l[..., ch:ch + 1] * torch.clamp(e_raw, min=0.0)
            g_e = torch.where(e_raw > 0.0, g_l[..., ch:ch + 1] * w, 0.0)
            gsh[:, ch * sh_k:(ch + 1) * sh_k, sl] = torch.matmul(basis_f.transpose(1, 2), g_e)
        g_lw = g_w * w
        # the suffix sums of g_lw in f64: in f32 the difference of two long
        # sums loses the small suffixes at a segment's end
        g_lw64 = g_lw.to(torch.float64)
        tot = torch.sum(g_lw64, dim=-1, keepdim=True)
        g_logt = g_lb + (tot - torch.cumsum(g_lw64, dim=-1)).to(dtype)
        g_alpha = torch.where(alive, g_w * exp_lw, 0.0) + g_logt * (-1.0 / (1.0 - alpha))
        g_alpha = torch.where(depth_ok & hit, g_alpha, 0.0)
        g_raw = torch.where(raw < 0.9999, g_alpha, 0.0)
        g_q = torch.where(q_raw > 0.0, -(g_raw * row[12] * dens), 0.0)
        g_px = g_q * (2.0 * row[0] * px + row[3] * py + row[4] * pz)
        g_py = g_q * (2.0 * row[1] * py + row[3] * px + row[5] * pz)
        g_pz = g_q * (2.0 * row[2] * pz + row[4] * px + row[5] * py)
        dx, dy, dz = d3
        g_t = g_px * dx + g_py * dy + g_pz * dz
        g_b = -g_t / a
        g_a = g_t * b / (a * a)
        per_pair = [g_q * px * px, g_q * py * py, g_q * pz * pz,
                    g_q * px * py, g_q * px * pz, g_q * py * pz]
        rows = [torch.sum(per_pair[i], dim=1) + torch.sum(f6[i] * g_a, dim=1) for i in range(6)]
        rows += [torch.sum(v * g_b, dim=1) for v in d3]
        rows += [torch.sum(v, dim=1) for v in (g_px, g_py, g_pz)]
        rows.append(torch.sum(g_raw * dens, dim=1))
        gpf[:, :13, sl] = torch.stack(rows, dim=1)
        g_lb = g_lb + tot.to(dtype)
    if compact:
        idx_pf = order[:, None, :].expand_as(gpf)
        gpf = torch.zeros_like(gpf).scatter_(2, idx_pf, torch.where(inside[:, None, :], gpf, 0.0))
        idx_sh = order[:, None, :].expand_as(gsh)
        gsh = torch.zeros_like(gsh).scatter_(2, idx_sh, torch.where(inside[:, None, :], gsh, 0.0))
    return gpf, gsh.to(sh3.dtype)


def _blocks(t):
    return [slice(t0, t0 + TILE_CHUNK) for t0 in range(0, t, TILE_CHUNK)]


class _Composite(torch.autograd.Function):
    """The plain compositor, differentiable in pf and sh3, in tile blocks."""

    @staticmethod
    def forward(ctx, d8, pf, sh3, n_seg, kw, counts):
        dt = PAIR_DTYPE
        outs = [forward_plain(d8[c].to(dt), pf[c].to(dt), sh3[c], n_seg[c], kw, counts)
                for c in _blocks(d8.shape[0])]
        ctx.save_for_backward(d8, pf, sh3, n_seg)
        ctx.kw = kw
        return (torch.cat([o[0] for o in outs]).float(),
                torch.cat([o[1] for o in outs]).float())

    @staticmethod
    def backward(ctx, g_l, g_beta):
        d8, pf, sh3, n_seg = ctx.saved_tensors
        dt = PAIR_DTYPE
        outs = [backward_plain(d8[c].to(dt), pf[c].to(dt), sh3[c], n_seg[c], g_l[c], g_beta[c],
                               ctx.kw)
                for c in _blocks(d8.shape[0])]
        return (None, torch.cat([o[0] for o in outs]).float(), torch.cat([o[1] for o in outs]),
                None, None, None)


def composite(d8, pf, sh3, n_seg, kw, counts=None):
    return _Composite.apply(d8, pf, sh3, n_seg, kw, counts)


# ---- one frame ---------------------------------------------------------------------

def render(state: State, cam, cfg: TiledConfig, spp: int, seed: int, jitter: bool,
           counts=None) -> torch.Tensor:
    """[H, W, 3]: the fused route's frame of ``cam`` (a scene.Camera).
    ``counts`` (a list) gets one dict per compositor call."""
    dev = state.sup_centers.device
    f32 = torch.float32
    px0, py0, unshuffle = tile_layout(cam, cfg, dev)
    n_tiles, rt = px0.shape
    work = state.prims
    cs = cfg.cluster_size
    s = min(cfg.max_candidates, work.num_prims)
    s = max(cfg.segment, (s // cfg.segment) * cfg.segment) if s >= cfg.segment else s
    k_cl = max(1, s // cs)
    origin = torch.as_tensor(cam.to_world[:3, 3], dtype=f32, device=dev)
    rot = torch.as_tensor(cam.to_world[:3, :3], dtype=f32, device=dev)
    focal = torch.tensor(cam.focal_length, dtype=f32, device=dev)
    ppx = torch.tensor(cam.width / 2.0, dtype=f32, device=dev)
    ppy = torch.tensor(cam.height / 2.0, dtype=f32, device=dev)

    def dirs_cols(px, py):
        dlx = -(px - ppx) / focal
        dly = -(py - ppy) / focal
        ddx = rot[0, 0] * dlx + rot[0, 1] * dly + rot[0, 2]
        ddy = rot[1, 0] * dlx + rot[1, 1] * dly + rot[1, 2]
        ddz = rot[2, 0] * dlx + rot[2, 1] * dly + rot[2, 2]
        inv = 1.0 / torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        return ddx * inv, ddy * inv, ddz * inv

    dnx, dny, dnz = dirs_cols(px0 + 0.5, py0 + 0.5)
    ax = torch.stack([dnx.mean(dim=1), dny.mean(dim=1), dnz.mean(dim=1)], dim=-1)
    axis = ax / torch.sqrt(torch.sum(ax * ax, dim=-1, keepdim=True))
    cos_half = torch.amin(dnx * axis[:, 0:1] + dny * axis[:, 1:2] + dnz * axis[:, 2:3], dim=1)
    cos_half = torch.cos(torch.arccos(torch.clamp(cos_half, -1.0, 1.0)) + 1.5 / focal)

    gc = cfg.coarse_group
    use_classes = bool(cfg.budget_classes)
    id_map = None
    ncl_total = state.ncl
    if gc > 1 and n_tiles % gc == 0:
        n_coarse = n_tiles // gc
        ax_g = axis.reshape(n_coarse, gc, 3)
        c_axis = ax_g.mean(dim=1)
        c_axis = c_axis / torch.sqrt(torch.sum(c_axis * c_axis, dim=-1, keepdim=True))
        cos_between = torch.sum(ax_g * c_axis[:, None, :], dim=-1)
        ang = torch.arccos(torch.clamp(cos_between, -1.0, 1.0)) + torch.arccos(
            torch.clamp(cos_half.reshape(n_coarse, gc), -1.0, 1.0))
        c_cos = torch.cos(torch.amax(ang, dim=1))
        sg = cfg.super_group
        keys_s = cone_keys_batch(origin, c_axis, c_cos, state.sup_centers, state.sup_radii)
        k_sup = min(max(1, -(-cfg.coarse_factor * k_cl // sg)), state.sup_centers.shape[0])
        sup_ids, sup_valid = shortlist(keys_s, k_sup)
        offs_s = torch.arange(sg, device=dev)
        cl_c = torch.clamp((sup_ids[..., None] * sg + offs_s).reshape(n_coarse, k_sup * sg),
                           max=ncl_total - 1)
        k_c = k_sup * sg
        nsup_t = state.suprows.shape[0] - 1
        sup_safe = torch.where(sup_valid, sup_ids, torch.full_like(sup_ids, nsup_t))
        cc = (state.suprows[sup_safe.reshape(-1)].reshape(n_coarse, k_sup, 4, sg)
              .permute(0, 2, 1, 3).reshape(n_coarse, 4, k_c))

        def rep(a):
            return torch.repeat_interleave(a, gc, dim=0)

        keys = cone_keys_cols(origin, axis, cos_half, rep(cc[:, 0]), rep(cc[:, 1]),
                              rep(cc[:, 2]), rep(cc[:, 3]))
        id_map = rep(cl_c)
        if not use_classes:
            loc_ids, cl_valid = shortlist(keys, min(k_cl, k_c))
            cl_ids = torch.gather(id_map, 1, loc_ids)
            if k_cl > k_c:
                cl_ids = torch.nn.functional.pad(cl_ids, (0, k_cl - k_c))
                cl_valid = torch.nn.functional.pad(cl_valid, (0, k_cl - k_c))
    else:
        raise ValueError("the reference carries the two-level cull only")

    ncl, kl = state.ncl, state.sh_k
    planes = pack_features(work, origin).reshape(16, ncl, cs)
    sh_table = state.shrows
    if cfg.cluster_sort:
        order = torch.argsort(planes[15], dim=-1, stable=True)
        planes = torch.gather(planes, 2, order[None].expand(16, ncl, cs))
        sh_table = torch.gather(sh_table.reshape(ncl, 3 * kl, cs), 2,
                                order[:, None, :].expand(ncl, 3 * kl, cs)).reshape(ncl, 3 * kl * cs)
    ptab_rows = planes.permute(1, 0, 2).reshape(ncl, 16 * cs)
    neutral = neutral_row(dev)
    fold = max(1, min(spp, 512 // rt))
    while spp % fold:
        fold -= 1
    kw = dict(seg=None, extent2=state.extent ** 2, max_depth=cfg.max_depth,
              beta_kill=cfg.beta_kill, sh_k=kl, compact=cfg.kernel_compact,
              early_exit=cfg.early_exit)

    def block(cl_i, cl_v, k_here, sel):
        px_b, py_b = px0[sel], py0[sel]
        tb = px_b.shape[0]
        seg = min(cfg.segment, k_here * cs)
        per_seg = max(1, seg // cs)
        if k_here % per_seg:
            pad_k = per_seg - k_here % per_seg
            cl_i = torch.nn.functional.pad(cl_i, (0, pad_k))
            cl_v = torch.nn.functional.pad(cl_v, (0, pad_k))
            k_here += pad_k
        s_here = k_here * cs
        n_seg_t = (-(-(cl_v.sum(dim=-1) * cs) // seg)).to(torch.int32)
        valid_row = torch.repeat_interleave(cl_v, cs, dim=-1)
        pf_t = (ptab_rows[cl_i.reshape(-1)].reshape(tb, k_here, 16, cs).permute(0, 2, 1, 3)
                .reshape(tb, 16, s_here))
        pf_t = torch.where(valid_row[:, None, :], pf_t, neutral[None, :, None])
        sh_t = (sh_table[cl_i.reshape(-1)].reshape(tb, k_here, 3 * kl, cs).permute(0, 2, 1, 3)
                .reshape(tb, 3 * kl, s_here))
        acc_b = torch.zeros((tb, rt, 3), dtype=f32, device=dev)
        for g in range(spp // fold):
            cols = []
            for j in range(fold):
                off = tile_offsets(seed, g * fold + j, n_tiles, rt, jitter, dev)[sel]
                cols.append(dirs_cols(px_b + off[..., 0], py_b + off[..., 1]))
            dirs = [torch.cat([c[i] for c in cols], dim=1) for i in range(3)]
            d8 = direction_rows(*dirs)
            call = None
            if counts is not None:
                call = dict(t=tb, r=d8.shape[2], s=s_here, sh_k=kl, fwd_live=0, fwd_stream=0,
                            fwd_hits=0, bwd_live=0, bwd_stream=0, bwd_hits=0)
                counts.append(call)
            l, _ = composite(d8, pf_t, sh_t, n_seg_t, dict(kw, seg=seg), call)
            if cfg.srgb_primitives:
                l = srgb_to_linear(l)
            acc_b = acc_b + l.reshape(tb, fold, rt, 3).sum(dim=1)
        return acc_b

    every = torch.arange(n_tiles, device=dev)
    if not use_classes:
        return unshuffle(block(cl_ids, cl_valid, k_cl, every) / spp)
    kcap = keys.shape[1]
    n_fin = torch.isfinite(keys).sum(dim=-1)
    order = torch.argsort(n_fin, stable=True)
    acc = torch.zeros((n_tiles, rt, 3), dtype=f32, device=dev)
    start = 0
    for cnt, (_, kb) in zip(class_counts(n_tiles, cfg.budget_classes), cfg.budget_classes):
        sel = order[start:start + cnt]
        start += cnt
        loc, val = shortlist(keys[sel], min(kb, kcap))
        ids_c = torch.gather(id_map[sel], 1, loc)
        acc[sel] = block(ids_c, val, min(kb, kcap), sel)
    return unshuffle(acc / spp)


# ---- the training step ---------------------------------------------------------------

def to_scene(params: dict, base: Scene) -> Scene:
    attrs = dict(base.attrs)
    attrs["opacities"] = params.get("opacities", base.attrs["opacities"])
    attrs["sh_coeffs"] = params.get("sh_coeffs", base.attrs["sh_coeffs"])
    return Scene(params.get("centers", base.centers), params.get("scales", base.scales),
                 params.get("quats", base.quats), attrs, base.extent)


def train_step(params: dict, opt: BoundedAdam, target, cams, cfg: TiledConfig, spp: int,
               seed: int, base: Scene, jitter: bool = True, counts=None) -> float:
    """One step in place: every camera's frame side by side (camera i seeded
    ``seed * 131 + i``), L1 against ``target``, backward, BoundedAdam.
    Returns the loss."""
    for p in params.values():
        p.grad = None
    state = build_state(to_scene(params, base), cfg)
    img = torch.cat([render(state, cam, cfg, spp, seed * 131 + i, jitter, counts)
                     for i, cam in enumerate(cams)], dim=1)
    loss = l1(target, img)
    loss.backward()
    opt.step(params)
    return float(loss.detach())
