"""Fused tile compositor v3, forward (volprim_tpu.pallas_kernels.composite3).

Per tile of R rays sharing an origin, the compositor walks a shortlist of S
packed primitive columns front to back: closest-approach peak response
``q = p^T (M/2) p`` at ``t* = -b/a`` (cancellation-free: the quadratic form
is evaluated on the small vector ``p = w + t* d``), the extent hit test,
``alpha = min(opac exp(-q), 0.9999)`` capped at ``max_depth`` hits per ray,
the log-transmittance prefix with the ``beta_kill`` cutoff, and SH emission.

- :func:`pack_fused_features` builds the per-frame [16, N] column table;
- :func:`composite_tiles3_reference` is the plain PyTorch version;
- :func:`composite_tiles3` launches the CUDA kernel
  (``csrc/composite3_fwd.cu``) for CUDA tensors and takes the plain version
  for CPU tensors. It counts its launches in ``composite_tiles3.launches``.

Packed column rows (the HALVED convention: rows 0-8 and 13 carry M/2, so
the kernel compares against extent^2 / 2)::

    [M11, M22, M33, 2 M12, 2 M13, 2 M23, u(3) = M w, w(3) = o - c,
     opac, c0 = w^T M w, bounding radius, entry-distance key]

Only the forward pass is ported; gradients come with the backward kernel
(ROADMAP.md §B2).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import sh

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
):
    """Plain PyTorch version of the forward compositor: segment by segment,
    with ``torch.cumsum`` for the hit count and the log-transmittance
    prefix. It does not compact: compaction only drops columns that no ray
    of the tile can hit. Returns (L [T, R, 3], beta [T, R]) in f32."""
    t, _, r = d8.shape
    s = pf.shape[2]
    if s % seg:
        raise ValueError(f"S = {s} is not a multiple of seg = {seg}")
    f32 = torch.float32
    dx, dy, dz = (d8[:, i, :, None].to(f32) for i in range(3))  # [T, R, 1]
    f6 = (dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz)
    basis = torch.cat(
        sh.basis_columns(dx, dy, dz, sh.degree_from_coeffs(sh_k), 1.0), dim=-1
    )
    # the emission product runs in the table's dtype with f32 accumulation:
    # round the basis as the kernels do
    basis = basis.to(sh3.dtype).to(f32)  # [T, R, k]
    e2h = extent2 * 0.5
    log_kill = _log_kill(beta_kill)
    nseg = torch.clamp(n_seg_t.to(torch.int64), max=s // seg).to(d8.device)
    log_beta = torch.zeros((t, r, 1), dtype=f32, device=d8.device)
    count = torch.zeros_like(log_beta)
    l_acc = torch.zeros((t, r, 3), dtype=f32, device=d8.device)
    for si in range(int(nseg.max()) if t else 0):
        live = (si < nseg)[:, None, None]  # [T, 1, 1]
        cols = pf[:, :, si * seg:(si + 1) * seg].to(f32)
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
        hit = (
            (q_min <= e2h) & (t_peak > 0.0) & (q_min - b * t_peak > e2h) & live
        )
        zero = torch.zeros((), dtype=f32, device=d8.device)
        alpha = torch.where(
            hit, torch.clamp(row[12] * torch.exp(-q_min), max=0.9999), zero
        )
        cum = count + torch.cumsum((alpha > 0.0).to(f32), dim=-1)
        alpha = torch.where(cum <= max_depth, alpha, zero)
        logt = torch.log1p(-alpha)
        cs_incl = torch.cumsum(logt, dim=-1)
        lw = log_beta + (cs_incl - logt)
        w = torch.where(lw > log_kill, torch.exp(lw) * alpha, zero)
        shs = sh3[:, :, si * seg:(si + 1) * seg].to(f32)  # [T, 3k, C]
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
        l_acc = l_acc + torch.where(live, inc, zero)
        log_beta = log_beta + cs_incl[..., -1:]
        count = cum[..., -1:]
    return l_acc, torch.exp(log_beta[..., 0])


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("composite3_fwd")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.composite3_fwd.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, ci, cf, ci, vp,
        ]
        lib.composite3_fwd.restype = ci
        lib.composite3_error_string.argtypes = [ci]
        lib.composite3_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(d8, pf, sh3, n_seg_t, seg, extent2, max_depth, beta_kill, sh_k,
            compact):
    dev = d8.device
    t, rows, r = d8.shape
    s = pf.shape[-1]
    for name, x, dtype in (
        ("d8", d8, torch.float32), ("pf", pf, torch.float32),
        ("sh3", sh3, torch.bfloat16), ("n_seg_t", n_seg_t, torch.int32),
    ):
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
    lib = _lib()
    l_out = torch.empty((t, r, 3), dtype=torch.float32, device=dev)
    beta = torch.empty((t, r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.composite3_fwd(
            d8.data_ptr(), pf.data_ptr(), sh3.data_ptr(), n_seg_t.data_ptr(),
            l_out.data_ptr(), beta.data_ptr(), t, r, s, seg, sh_k,
            extent2 * 0.5, int(max_depth), _log_kill(beta_kill), int(compact),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.composite3_error_string(err).decode()
        raise RuntimeError(f"composite3_fwd launch failed: {msg} ({err})")
    composite_tiles3.launches += 1
    return l_out, beta


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
):
    """Fused forward compositor: (L [T, R, 3], beta [T, R]).

    CUDA tensors launch the hand-written kernel (csrc/composite3_fwd.cu;
    with ``compact`` it first drops the columns whose bounding sphere
    misses the tile's ray cone) and raise if it does not launch. CPU
    tensors take :func:`composite_tiles3_reference`. Inputs that require
    grad are refused: the backward kernel is ROADMAP.md §B2."""
    if any(x.requires_grad for x in (d8, pf, sh3)):
        raise RuntimeError(
            "composite_tiles3 is forward-only: its backward kernel (the "
            "_bwd3_kernel port) is ROADMAP.md §B2"
        )
    if d8.device.type == "cpu":
        return composite_tiles3_reference(
            d8, pf, sh3, n_seg_t, seg, extent2, max_depth, beta_kill, sh_k
        )
    if d8.device.type != "cuda":
        raise ValueError(f"composite_tiles3 runs on CPU or CUDA, not {d8.device}")
    return _launch(
        d8, pf, sh3, n_seg_t, seg, extent2, max_depth, beta_kill, sh_k, compact
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
