"""Tiled radiance-field renderer, fused path (volprim_tpu.models.rf_tiled).

Same light transport as :mod:`.rf`, organised like a rasterizer:

1. :func:`build_state` (per scene): pad and Morton-cluster the primitives,
   bound clusters and superclusters, and pack the bf16 SH cluster rows.
2. :func:`render_state` (per frame): split the film into tiles whose rays
   share an origin and span a small cone; cull superclusters per strip of
   ``coarse_group`` tiles, then clusters per tile; sort tiles into
   need-ordered budget classes; gather each tile's clusters into packed
   column blocks; composite them with the fused compositor
   (kernels/composite3.py, CUDA kernels on the card), ``fold`` samples per
   launch; sRGB per sample.

Both are differentiable: with primitive parameters that require grad,
``build_state`` -> ``render_state`` under autograd gives gradients of
centers, scales, quats, opacities and sh_coeffs through the padding, the
Morton permutation, the SH fold and its bf16 cast, the per-frame pack, the
cluster gathers and the neutral-row masking, the compositor's backward
kernel, sRGB and the sample sum. The cull (Morton codes, cluster and
supercluster spheres, cone keys, shortlists) selects integer ids and is
computed on detached tensors.

Ported: ``backend='fused'`` with the two-level cull, ``budget_classes``,
``kernel_compact``, ``cluster_sort``, the banded order correction
(``order_band``, per class ``band_classes``) and the refinement of
truncated tiles (``refine_fraction``, ``refine_factor``); ``backend='pallas'`` (v1:
kernels/composite.py + composite_vjp.py) and ``backend='pallas2'`` (v2,
camera-relative: kernels/composite2.py), which expand the cluster shortlist
to primitives, refine it with ``prim_resort`` (True, 'entry', 'cluster',
'cluster-entry'; on by default, as in JAX), gather [T, S, F] feature, SH and
opacity tables built by ``build_state`` and composite one sample per
launch (CUDA kernels on the card, forward and backward). The fused-only
knobs (``budget_classes``, ``kernel_compact``, ``cluster_sort``) are
ignored by v1 and v2, as in JAX. The TPU layout knobs (``feat_major``,
``kernel_batch``, ``tile_group``) have no counterpart. The fused
compositor always walks a tile's full stream (its beta is the full capped
product), so ``early_exit`` changes nothing here. What is not ported yet
(the ``xla`` backend, ``use_clusters=False``, ``prim_resort`` with the
fused backend) raises NotImplementedError naming its ROADMAP.md item.

``_DEBUG_STOP`` (set by tools/profile_rf.py) makes a frame return early, as
JAX's does: after the cull ("cull") or the pack ("pack"), or inside each
tile block after the column gather ("gather_pf") or the SH gather
("gather"), with a cheap probe of what was computed (sums times 1e-12,
broadcast to the tiles) so that the stages before it can be timed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..accel import clusters
from ..accel import tiles as tiling
from ..kernels import composite2, composite3, composite_vjp
from ..ops import quadric, quaternion, sh, srgb_to_linear
from ..ops.kernels import Kernel
from ..scene.cameras import CameraSpecs
from ..scene.ellipsoids import EllipsoidScene
from .base import pad_primitives

_SH = 16  # SH coefficients per channel block of the v1/v2 table

# Profiling hook (tools/profile_rf.py): None, "cull", "pack", "gather_pf" or
# "gather"; see the module docstring.
_DEBUG_STOP = None


@dataclasses.dataclass(frozen=True)
class RFTiledConfig:
    max_depth: int = 64  # max composited primitives per ray
    kernel_type: str = "gaussian"
    srgb_primitives: bool = True
    tile_pixels: int = 1024  # rays per tile
    tile_shape: Optional[tuple] = None  # explicit (tile_h, tile_w)
    max_candidates: int = 4096  # shortlist size per tile (primitives)
    segment: int = 256  # shortlist columns per compositor segment
    beta_kill: float = 0.01
    use_clusters: bool = True
    cluster_size: int = 64
    early_exit: bool = False  # accepted for parity; see the module docstring
    # 'fused' (v3), 'pallas' (v1) or 'pallas2' (v2); the JAX default,
    # 'xla', is not ported
    backend: str = "fused"
    # per-primitive depth refinement of the v1/v2 shortlist: None (on for
    # v1/v2), False, True, 'entry', 'cluster' or 'cluster-entry'
    prim_resort: Optional[bool] = None
    # two-level cull: strips of coarse_group tiles select superclusters
    # (coarse_factor x the per-tile budget), then each tile culls its
    # strip's member clusters; 0 culls every cluster per tile
    coarse_group: int = 0
    coarse_factor: int = 4
    super_group: int = 16
    # after the base pass, re-render the refine_fraction of tiles most
    # likely truncated (a full cluster list and rays still above beta_kill
    # at its end) with a refine_factor-times-larger shortlist; 0 disables
    refine_fraction: float = 0.0
    refine_factor: int = 4
    # ((fraction, clusters), ...): tiles sorted by need (finite cull keys)
    # split into static-fraction classes, each with its own cluster budget
    budget_classes: tuple = ()
    kernel_compact: bool = False  # drop columns outside the tile cone in-kernel
    cluster_sort: bool = False  # per-frame intra-cluster entry-distance sort
    # per-ray banded order correction: each pair's transmittance prefix is
    # corrected for the entry order of the pairs within order_band lanes of
    # it in its compositor segment (the compacted stream with
    # kernel_compact); 0 disables
    order_band: int = 0
    # one band per budget class (None inherits order_band)
    band_classes: tuple = ()

    @property
    def kernel(self) -> Kernel:
        return Kernel(self.kernel_type)


def _check_config(cfg: RFTiledConfig) -> None:
    """Refuse what is not ported yet, naming the ROADMAP.md item."""
    todo = {
        f"backend={cfg.backend!r}": cfg.backend not in ("fused", "pallas", "pallas2"),
        "use_clusters=False": not cfg.use_clusters,
        "prim_resort with backend='fused'": cfg.backend == "fused" and bool(cfg.prim_resort),
    }
    missing = [k for k, v in todo.items() if v]
    if missing:
        raise NotImplementedError(
            f"rf_tiled: {', '.join(missing)} not ported yet "
            "(ROADMAP.md §A2, the rest of rf_tiled)"
        )
    if cfg.prim_resort not in (None, False, True, "entry", "cluster", "cluster-entry"):
        raise ValueError(f"unknown prim_resort {cfg.prim_resort!r}")
    if cfg.backend == "fused":
        # the fused backend's knobs, as JAX asserts them (rf_tiled.py:649,
        # :1078); band_classes without budget_classes would be dropped
        if cfg.budget_classes and cfg.refine_fraction > 0.0:
            raise ValueError("budget_classes replaces refine_fraction")
        if cfg.band_classes and len(cfg.band_classes) != len(cfg.budget_classes):
            raise ValueError(
                "band_classes needs one band per budget_classes entry, got "
                f"{len(cfg.band_classes)} for {len(cfg.budget_classes)} classes"
            )
    cfg.kernel  # refuses non-Gaussian kernels


@dataclasses.dataclass
class RFTiledState:
    """Per-scene render state (rebuild when primitive parameters change)."""

    prims: EllipsoidScene  # Morton-sorted and padded to a cluster multiple
    cull_centers: torch.Tensor  # [Ncl, 3] cluster bounding spheres
    cull_radii: torch.Tensor  # [Ncl]
    # [Ncl, 3k*cs] bf16 cluster rows, each a channel-major [3k, cs] block
    # of folded SH (kernels.composite3.fold_sh_rows)
    shrows: torch.Tensor
    sup_centers: torch.Tensor  # [Nsup, 3] supercluster spheres
    sup_radii: torch.Tensor  # [Nsup]
    # [Nsup + 1, 4*sg] member-cluster spheres, each a [4, sg] block
    # (cx, cy, cz, r); the trailing row has r = -1 (never hits)
    suprows: torch.Tensor
    extent: float = 3.0
    cluster_size: int = 64
    super_group: int = 16
    sh_k: int = 1  # live SH coefficients per channel
    # v1/v2 tables, built only for backend 'pallas' / 'pallas2' (None else):
    # [N, 16] quadric features (10 used; v1 only), [N] opacities and [N, 48]
    # channel-major SH blocks of 16
    feats16: Optional[torch.Tensor] = None
    opac: Optional[torch.Tensor] = None
    sh48: Optional[torch.Tensor] = None


def build_state(primitives: EllipsoidScene, cfg: RFTiledConfig) -> RFTiledState:
    """Morton-sort, cluster and pack the scene for tiled rendering."""
    _check_config(cfg)
    cs, sg = cfg.cluster_size, cfg.super_group
    padded = pad_primitives(primitives, cs)
    # the cull geometry (Morton order, cluster and supercluster spheres)
    # only selects integer ids: it carries no gradient, in JAX either, and
    # is built detached so that autograd holds none of it
    with torch.no_grad():
        index = clusters.build_clusters(padded, cs, num_real=primitives.num_prims)
    work = padded.select(index.perm)  # the Morton order, under autograd
    n = work.num_prims
    ncl = n // cs
    sh_coeffs = work.sh_coeffs_3d()  # [N, k, 3]
    k = sh_coeffs.shape[1]
    # the fused path's bf16 SH cluster rows (built for every backend, as in
    # JAX: they are cheap and keep one state layout)
    shrows = (
        composite3.fold_sh_rows(sh_coeffs)
        .reshape(ncl, cs, 3 * k)
        .permute(0, 2, 1)
        .reshape(ncl, 3 * k * cs)
        .to(torch.bfloat16)
    )
    sup_centers, sup_radii = clusters.build_super_spheres(
        index.centers, index.radii, sg
    )
    nsup = sup_centers.shape[0]
    pad_cl = nsup * sg - ncl

    def col(x, fill):
        return torch.cat([x, x.new_full((pad_cl,), fill)]).reshape(nsup, sg)

    suprows = torch.cat(
        [
            col(index.centers[:, 0], 0.0), col(index.centers[:, 1], 0.0),
            col(index.centers[:, 2], 0.0), col(index.radii, -1.0),
        ],
        dim=1,
    )
    tail = suprows.new_zeros((1, 4 * sg))
    tail[0, 3 * sg:] = -1.0
    tables = {}
    if cfg.backend in ("pallas", "pallas2"):
        zeros = sh_coeffs.new_zeros((n, _SH - k))
        tables["sh48"] = torch.cat(
            [t for ch in range(3) for t in (sh_coeffs[:, :, ch], zeros)], dim=1
        )
        tables["opac"] = work.attrs["opacities"][:, 0]
    if cfg.backend == "pallas":
        feats = quadric.prim_features(work.centers, work.scales, work.quats)
        tables["feats16"] = torch.cat([feats.T, feats.new_zeros((n, 6))], dim=1)
    return RFTiledState(
        prims=work,
        cull_centers=index.centers,
        cull_radii=index.radii,
        shrows=shrows,
        sup_centers=sup_centers,
        sup_radii=sup_radii,
        suprows=torch.cat([suprows, tail]),
        extent=float(primitives.extent),
        cluster_size=cs,
        super_group=sg,
        sh_k=k,
        **tables,
    )


def _tile_layout(camera: CameraSpecs, cfg: RFTiledConfig, device):
    """Block-major tile grid: ``(px0, py0, tile_ids, unshuffle)``, px0/py0
    [T, RT] pixel coordinates ordered so that each run of ``coarse_group``
    tiles is a near-square block (the strip the coarse cull bounds), and
    ``unshuffle(acc)`` folding [T, RT, 3] back into the [H, W, 3] film."""
    h, w = camera.height, camera.width
    if cfg.tile_shape is not None:
        th, tw = cfg.tile_shape
    else:
        tp = cfg.tile_pixels
        th = int(tp**0.5)
        while tp % th or h % th:
            th -= 1
        tw = tp // th
    if h % th or w % tw:
        raise ValueError(f"film {w}x{h} not divisible into {tw}x{th} tiles")
    n_ty, n_tx = h // th, w // tw
    n_tiles = n_ty * n_tx
    rt = th * tw
    gc = max(1, cfg.coarse_group)
    gb_y = max(1, int(round(gc ** 0.5)))
    while gb_y > 1 and (gc % gb_y or n_ty % gb_y or n_tx % (gc // gb_y)):
        gb_y -= 1
    gb_x = gc // gb_y if gc % gb_y == 0 and n_tx % (gc // gb_y) == 0 else 1
    if gb_x == 1:
        gb_y = 1  # fall back to row-consecutive strips
    n_gy, n_gx = n_ty // gb_y, n_tx // gb_x
    ty_of = (
        torch.arange(n_ty).reshape(n_gy, 1, gb_y, 1).expand(n_gy, n_gx, gb_y, gb_x)
        .reshape(-1)
    )
    tx_of = (
        torch.arange(n_tx).reshape(1, n_gx, 1, gb_x).expand(n_gy, n_gx, gb_y, gb_x)
        .reshape(-1)
    )
    ys = torch.arange(h).reshape(n_ty, th)[ty_of]  # [T, th]
    xs = torch.arange(w).reshape(n_tx, tw)[tx_of]  # [T, tw]
    py0 = ys[:, :, None].expand(n_tiles, th, tw).reshape(n_tiles, rt)
    px0 = xs[:, None, :].expand(n_tiles, th, tw).reshape(n_tiles, rt)
    f32 = torch.float32

    def unshuffle(acc):
        return (
            acc.reshape(n_gy, n_gx, gb_y, gb_x, th, tw, 3)
            .permute(0, 2, 4, 1, 3, 5, 6)
            .reshape(h, w, 3)
        )

    return (
        px0.to(device=device, dtype=f32), py0.to(device=device, dtype=f32),
        torch.arange(n_tiles, device=device), unshuffle,
    )


def render_state(
    state: RFTiledState,
    camera: CameraSpecs,
    cfg: RFTiledConfig,
    emitter=None,
    spp: int = 1,
    seed: int = 0,
    jitter: bool = True,
    mesh=None,
) -> torch.Tensor:
    """Render one camera from prepared state: [H, W, 3] on the state's
    device. Jitter offsets come from a Philox ``torch.Generator`` seeded by
    (``seed``, sample) and drawn for the whole film, so a tile's offsets
    depend only on its global tile id; they are not ``jax.random``'s bits,
    so parity checks use ``jitter=False`` (pixel centers)."""
    _check_config(cfg)
    if emitter is not None:
        raise NotImplementedError(
            "rf_tiled: emitters are not ported yet (ROADMAP.md §A, path-tracer slice)"
        )
    if mesh is not None:
        raise NotImplementedError(
            "rf_tiled: mesh sharding is not ported yet (ROADMAP.md §A, parallel/)"
        )
    dev = state.cull_centers.device
    px0, py0, tile_ids, unshuffle = _tile_layout(camera, cfg, dev)
    acc = _render_tiles(
        state, px0, py0, tile_ids, camera, cfg=cfg, spp=spp, seed=int(seed),
        jitter=jitter,
    )
    return unshuffle(acc)


def _render_tiles(state, px0, py0, tile_ids, camera, *, cfg, spp, seed, jitter):
    """Cull, gather and composite the tiles. Returns [T, RT, 3]."""
    dev = px0.device
    f32 = torch.float32
    n_tiles, rt = px0.shape
    work = state.prims
    cs = state.cluster_size
    s = min(cfg.max_candidates, work.num_prims)
    s = max(cfg.segment, (s // cfg.segment) * cfg.segment) if s >= cfg.segment else s
    k_cl = max(1, s // cs)

    def scalar(v):
        return torch.tensor(v, dtype=f32, device=dev)

    origin = torch.as_tensor(camera.to_world[:3, 3], dtype=f32, device=dev)
    rot = torch.as_tensor(camera.to_world[:3, :3], dtype=f32, device=dev)
    focal = scalar(camera.focal_length)
    ppx = scalar(camera.width / 2.0 - camera.cx)
    ppy = scalar(camera.height / 2.0 - camera.cy)

    def dirs_cols(px, py):
        """Unit ray directions as three [T, RT] component arrays."""
        dlx = -(px - ppx) / focal
        dly = -(py - ppy) / focal
        ddx = rot[0, 0] * dlx + rot[0, 1] * dly + rot[0, 2]
        ddy = rot[1, 0] * dlx + rot[1, 1] * dly + rot[1, 2]
        ddz = rot[2, 0] * dlx + rot[2, 1] * dly + rot[2, 2]
        inv = 1.0 / torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        return ddx * inv, ddy * inv, ddz * inv

    # ---- per-frame culling: one bounding cone per tile -------------------
    dnx, dny, dnz = dirs_cols(px0 + 0.5, py0 + 0.5)
    ax = torch.stack([dnx.mean(dim=1), dny.mean(dim=1), dnz.mean(dim=1)], dim=-1)
    axis = ax / torch.sqrt(torch.sum(ax * ax, dim=-1, keepdim=True))
    cos_half = torch.amin(
        dnx * axis[:, 0:1] + dny * axis[:, 1:2] + dnz * axis[:, 2:3], dim=1
    )
    half = torch.arccos(torch.clamp(cos_half, -1.0, 1.0)) + 1.5 / focal
    cos_half = torch.cos(half)

    gc = cfg.coarse_group
    use_fused = cfg.backend == "fused"
    use_classes = bool(cfg.budget_classes) and use_fused  # fused only, as in JAX
    id_map = strips = None
    if gc > 1 and n_tiles % gc == 0:
        # ---- two-level cull: strip cones -> per-tile refinement ----------
        n_coarse = n_tiles // gc
        ax_g = axis.reshape(n_coarse, gc, 3)
        c_axis = ax_g.mean(dim=1)
        c_axis = c_axis / torch.sqrt(torch.sum(c_axis * c_axis, dim=-1, keepdim=True))
        # the strip's half-angle covers every member tile's cone
        cos_between = torch.sum(ax_g * c_axis[:, None, :], dim=-1)
        ang = torch.arccos(torch.clamp(cos_between, -1.0, 1.0)) + torch.arccos(
            torch.clamp(cos_half.reshape(n_coarse, gc), -1.0, 1.0)
        )
        c_cos = torch.cos(torch.amax(ang, dim=1))
        # third level: exact selection over superclusters, expanded back to
        # their Morton-contiguous member clusters
        sg = state.super_group
        ncl_total = state.cull_centers.shape[0]
        keys_s = tiling.cone_cull_keys_batch(
            origin, c_axis, c_cos, state.sup_centers, state.sup_radii
        )
        k_sup = min(
            max(1, -(-cfg.coarse_factor * k_cl // sg)), state.sup_centers.shape[0]
        )
        sup_ids, sup_valid = tiling.shortlist(keys_s, k_sup)
        offs_s = torch.arange(sg, device=dev)
        cl_c = (sup_ids[..., None] * sg + offs_s).reshape(n_coarse, k_sup * sg)
        cl_c = torch.clamp(cl_c, max=ncl_total - 1)
        k_c = k_sup * sg
        # member spheres come as wide [4, sg] rows (one gather per strip)
        nsup_t = state.suprows.shape[0] - 1
        sup_safe = torch.where(sup_valid, sup_ids, torch.full_like(sup_ids, nsup_t))
        cc = (
            state.suprows[sup_safe.reshape(-1)]
            .reshape(n_coarse, k_sup, 4, sg)
            .permute(0, 2, 1, 3)
            .reshape(n_coarse, 4, k_c)
        )

        def rep(a):
            return torch.repeat_interleave(a, gc, dim=0)

        keys = tiling.cone_cull_keys_cols(
            origin, axis, cos_half,
            rep(cc[:, 0]), rep(cc[:, 1]), rep(cc[:, 2]), rep(cc[:, 3]),
        )
        id_map = rep(cl_c)
        strips = (cl_c, cc)  # the strips' candidate clusters and spheres
        if not use_classes:
            loc_ids, cl_valid = tiling.shortlist(keys, min(k_cl, k_c))
            cl_ids = torch.gather(id_map, 1, loc_ids)
            if k_cl > k_c:
                pad = k_cl - k_c
                cl_ids = torch.nn.functional.pad(cl_ids, (0, pad))
                cl_valid = torch.nn.functional.pad(cl_valid, (0, pad))
    else:
        keys = tiling.cone_cull_keys_batch(
            origin, axis, cos_half, state.cull_centers, state.cull_radii
        )
        if not use_classes:
            cl_ids, cl_valid = tiling.shortlist(keys, k_cl)

    if not use_fused:
        return _render_v12(state, cl_ids, cl_valid, origin, axis, dirs_cols, px0, py0,
                           tile_ids, n_tiles, cfg=cfg, spp=spp, seed=seed, jitter=jitter)

    # ---- per-frame pack: [Ncl, 16*cs] cluster rows -------------------------
    ncl = work.num_prims // cs
    kl = state.sh_k
    planes = composite3.pack_fused_features(work, origin).reshape(16, ncl, cs)
    sh_table = state.shrows
    if cfg.cluster_sort:
        # order each cluster's columns by the entry-distance key (row 15);
        # one permute of the tables serves every tile's gathers
        order = torch.argsort(planes[15], dim=-1, stable=True)  # [Ncl, cs]
        planes = torch.gather(planes, 2, order[None].expand(16, ncl, cs))
        sh_table = torch.gather(
            sh_table.reshape(ncl, 3 * kl, cs), 2,
            order[:, None, :].expand(ncl, 3 * kl, cs),
        ).reshape(ncl, 3 * kl * cs)
    ptab_rows = planes.permute(1, 0, 2).reshape(ncl, 16 * cs)
    if _DEBUG_STOP in ("cull", "pack"):
        probe = torch.where(torch.isfinite(keys), keys, 0.0).sum() * 1e-12
        if _DEBUG_STOP == "pack":
            probe = probe + ptab_rows.sum() * 1e-12
        return probe.expand(n_tiles, rt, 3)
    neutral = composite3.neutral_fused_row(dev)
    fold = max(1, min(spp, 512 // rt))
    while spp % fold:
        fold -= 1

    def fused_block(cl_i, cl_v, k_here, px_b, py_b, tid_b, band=None):
        """Gather and composite a block of tiles: (sum over samples
        [Tb, RT, 3], the first sample's beta [Tb, RT]). ``band`` overrides
        cfg.order_band for this block."""
        tb = px_b.shape[0]
        band_here = int(cfg.order_band if band is None else band)
        seg = min(cfg.segment, k_here * cs)
        per_seg = max(1, seg // cs)
        if k_here % per_seg:
            pad_k = per_seg - k_here % per_seg
            cl_i = torch.nn.functional.pad(cl_i, (0, pad_k))
            cl_v = torch.nn.functional.pad(cl_v, (0, pad_k))
            k_here += pad_k
        s_here = k_here * cs
        # live segments per tile (valid clusters sort first)
        n_seg_t = (-(-(cl_v.sum(dim=-1) * cs) // seg)).to(torch.int32)
        # cluster-blocked gather: one wide row per cluster, relaid out to the
        # compositor's [Tb, 16, S] block; invalid clusters become neutral
        valid_row = torch.repeat_interleave(cl_v, cs, dim=-1)  # [Tb, S]
        pf_t = (
            ptab_rows[cl_i.reshape(-1)]
            .reshape(tb, k_here, 16, cs)
            .permute(0, 2, 1, 3)
            .reshape(tb, 16, s_here)
        )
        pf_t = torch.where(valid_row[:, None, :], pf_t, neutral[None, :, None])
        if _DEBUG_STOP == "gather_pf":
            probe = (pf_t.sum() + n_seg_t.sum().to(f32)) * 1e-12
            return probe.expand(tb, rt, 3), torch.ones((tb, rt), device=dev)
        # invalid slots' SH needs no mask: their opacity is 0, so their
        # emission weight is exactly 0 (the rows are real, finite clusters)
        sh_t = (
            sh_table[cl_i.reshape(-1)]
            .reshape(tb, k_here, 3 * kl, cs)
            .permute(0, 2, 1, 3)
            .reshape(tb, 3 * kl, s_here)
        )
        if _DEBUG_STOP == "gather":
            probe = (pf_t.sum() + sh_t.to(f32).sum() + n_seg_t.sum().to(f32)) * 1e-12
            return probe.expand(tb, rt, 3), torch.ones((tb, rt), device=dev)
        acc_b = torch.zeros((tb, rt, 3), dtype=f32, device=dev)
        beta0 = None
        for g in range(spp // fold):
            # spp folding: `fold` samples' rays share one shortlist walk
            cols = []
            for j in range(fold):
                off = _tile_offsets(seed, g * fold + j, tid_b, n_tiles, rt, jitter, dev)
                cols.append(dirs_cols(px_b + off[..., 0], py_b + off[..., 1]))
            d8 = composite3.pack_direction_rows(
                *(torch.cat([c[i] for c in cols], dim=1) for i in range(3))
            )
            l, beta = composite3.composite_tiles3(
                d8, pf_t, sh_t, n_seg_t,
                seg=seg,
                extent2=state.extent ** 2,
                max_depth=cfg.max_depth if cfg.max_depth > 0 else 10**6,
                beta_kill=cfg.beta_kill,
                sh_k=kl,
                compact=cfg.kernel_compact,
                order_band=band_here,
            )
            if beta0 is None:
                beta0 = beta[:, :rt]
            if cfg.srgb_primitives:
                l = srgb_to_linear(l)  # per sample
            acc_b = acc_b + l.reshape(tb, fold, rt, 3).sum(dim=1)
        return acc_b, beta0

    if not use_classes:
        acc, beta0 = fused_block(cl_ids, cl_valid, k_cl, px0, py0, tile_ids)
        if cfg.refine_fraction > 0.0:
            acc = _refine(state, cfg, acc, beta0, cl_valid, k_cl, strips, origin,
                          axis, cos_half, px0, py0, tile_ids, fused_block)
        return acc / spp

    # ---- need-ordered budget classes ---------------------------------------
    kcap = keys.shape[1]
    n_fin = torch.isfinite(keys).sum(dim=-1)
    # stable: n_fin is a count with many ties, and the tie order decides
    # which budget a tile gets
    order = torch.argsort(n_fin, stable=True)
    counts = _class_counts(n_tiles, cfg.budget_classes)
    bands = cfg.band_classes or (None,) * len(cfg.budget_classes)
    acc = torch.zeros((n_tiles, rt, 3), dtype=f32, device=dev)
    start = 0
    for cnt, (_, kb), band in zip(counts, cfg.budget_classes, bands):
        sel = order[start:start + cnt]
        start += cnt
        k_eff = min(kb, kcap)
        loc, val = tiling.shortlist(keys[sel], k_eff)
        ids_c = loc if id_map is None else torch.gather(id_map[sel], 1, loc)
        acc[sel] = fused_block(ids_c, val, k_eff, px0[sel], py0[sel], tile_ids[sel],
                               band)[0]
    return acc / spp


def refine_select(score: torch.Tensor, m: int):
    """The m tiles of largest ``score`` [T], ties to the lower tile index
    (as ``jax.lax.top_k``; the counts tie often and the order decides which
    tiles are refined): (score_sel [m], tile ids [m])."""
    sel = torch.argsort(-score, stable=True)[:m]
    return score[sel], sel


def _refine(state, cfg, acc, beta0, cl_valid, k_cl, strips, origin, axis, cos_half,
            px0, py0, tile_ids, fused_block):
    """Residual-driven refinement (rf_tiled.py:1111-1149): the tiles whose
    cluster list was full, scored by their first-sample rays still above
    beta_kill, are re-culled with a refine_factor-times-larger budget (against
    their strip's candidates after the two-level cull, else against every
    cluster) and re-composited; the worst max(1, round(T f)) tiles keep the
    new result where their score is positive. Returns the new [T, RT, 3]."""
    n_tiles = acc.shape[0]
    m = max(1, int(round(n_tiles * cfg.refine_fraction)))
    trunc = torch.sum(beta0 > cfg.beta_kill, dim=1)
    score = torch.where(cl_valid.sum(dim=-1) >= k_cl, trunc, torch.zeros_like(trunc))
    score_sel, sel_t = refine_select(score, m)
    k2 = min(cfg.refine_factor * k_cl, state.cull_centers.shape[0])
    if strips is not None:
        cl_c, cc = strips
        strip_of = sel_t // cfg.coarse_group
        keys_r = tiling.cone_cull_keys_cols(
            origin, axis[sel_t], cos_half[sel_t],
            cc[strip_of, 0], cc[strip_of, 1], cc[strip_of, 2], cc[strip_of, 3],
        )
        k2 = min(k2, keys_r.shape[1])
        loc_r, cl_valid_r = tiling.shortlist(keys_r, k2)
        cl_ids_r = torch.gather(cl_c[strip_of], 1, loc_r)
    else:
        keys_r = tiling.cone_cull_keys_batch(
            origin, axis[sel_t], cos_half[sel_t], state.cull_centers, state.cull_radii
        )
        cl_ids_r, cl_valid_r = tiling.shortlist(keys_r, k2)
    acc_r, _ = fused_block(cl_ids_r, cl_valid_r, k2, px0[sel_t], py0[sel_t],
                           tile_ids[sel_t])
    use_r = (score_sel > 0)[:, None, None]
    return acc.index_copy(0, sel_t, torch.where(use_r, acc_r, acc[sel_t]))


def _neutral_feature(device=None) -> torch.Tensor:
    """v1 feature row with M = I, c = 0: keeps a > 0 on masked slots."""
    row = torch.zeros((_SH,), dtype=torch.float32, device=device)
    row[:3] = 1.0
    return row


def _resort(state, ids, valid, origin, axis, mode):
    """Order each tile's primitive shortlist by view depth along the tile
    axis (``mode`` True or 'cluster'), or by the entry-biased key depth
    minus the ellipsoid's support extent ||diag(s) R^T axis|| ('entry',
    'cluster-entry'); the 'cluster' modes sort within each cluster only.
    Invalid slots sort last (key inf; the sorts are stable, as jnp.argsort)."""
    work = state.prims
    cs = state.cluster_size
    c = work.centers.detach()[ids] - origin  # [T, S, 3]
    depth = c[..., 0] * axis[:, 0:1] + c[..., 1] * axis[:, 1:2] + c[..., 2] * axis[:, 2:3]
    if mode in ("entry", "cluster-entry"):
        rot = quaternion.to_rotation_matrix(work.quats.detach()[ids])  # [T, S, 3, 3]
        ra = (
            rot[..., 0, :] * axis[:, None, 0:1] + rot[..., 1, :] * axis[:, None, 1:2]
            + rot[..., 2, :] * axis[:, None, 2:3]
        )  # (R^T axis)_i
        v = work.scales.detach()[ids] * ra
        depth = depth - float(work.extent) * torch.sqrt(
            v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
        )
    depth = torch.where(valid, depth, torch.inf)
    t, s = ids.shape
    if mode in ("cluster", "cluster-entry"):
        order = torch.argsort(depth.reshape(t, s // cs, cs), dim=-1, stable=True)
        order = order.reshape(t, s) + (torch.arange(s, device=ids.device) // cs * cs)
    else:
        order = torch.argsort(depth, dim=-1, stable=True)
    return torch.gather(ids, 1, order), torch.gather(valid, 1, order)


def _render_v12(state, cl_ids, cl_valid, origin, axis, dirs_cols, px0, py0, tile_ids,
                n_tiles, *, cfg, spp, seed, jitter):
    """The v1 / v2 backends after the cull (rf_tiled.py:724-767,
    :1152-1267): expand the cluster shortlist to primitives, refine its
    order (prim_resort), pad it to a segment multiple, gather the [T, S, F]
    tables with neutral rows and zero opacity on invalid slots, and
    composite one sample per launch. Returns [T, RT, 3]."""
    dev = px0.device
    rt = px0.shape[1]
    ids, valid = clusters.expand_cluster_ids(cl_ids, cl_valid, state.cluster_size)
    resort = True if cfg.prim_resort is None else cfg.prim_resort
    if resort:
        ids, valid = _resort(state, ids, valid, origin, axis, resort)
    s = ids.shape[1]
    # the compositors take whole segments: pad small shortlists
    seg = min(cfg.segment, s)
    if s % seg:
        pad = seg - s % seg
        ids = torch.nn.functional.pad(ids, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    opac_t = torch.where(valid, state.opac[ids], 0.0)  # [T, S]
    sh_t = state.sh48[ids]  # [T, S, 48]; invalid slots have opacity 0
    max_depth = cfg.max_depth if cfg.max_depth > 0 else 10**6
    kw = dict(seg=seg, extent2=state.extent ** 2, max_depth=max_depth,
              beta_kill=cfg.beta_kill)
    k = state.sh_k
    if cfg.backend == "pallas":
        pf_t = torch.where(valid[..., None], state.feats16[ids], _neutral_feature(dev))
        opac_t = opac_t[:, None, :].contiguous()
    else:
        cam = composite2.camera_relative_features_from_prims(state.prims, origin)
        pf_t = torch.where(valid[..., None], cam[ids], composite2.neutral_row(origin))
        o2 = origin[0] * origin[0] + origin[1] * origin[1] + origin[2] * origin[2]
        c0_t = torch.where(valid, cam[:, 9][ids], o2)
        aux_t = torch.stack([opac_t, c0_t], dim=1)  # [T, 2, S]

    acc = torch.zeros((n_tiles, rt, 3), dtype=torch.float32, device=dev)
    for i in range(spp):
        off = _tile_offsets(seed, i, tile_ids, n_tiles, rt, jitter, dev)
        d = torch.stack(dirs_cols(px0 + off[..., 0], py0 + off[..., 1]), dim=-1)  # [T, RT, 3]
        if cfg.backend == "pallas":
            d_flat = d.reshape(-1, 3)
            fa, fb, fc = quadric.ray_features(origin.expand_as(d_flat), d_flat)
            pad = d_flat.new_zeros((d_flat.shape[0], 6))
            fa, fb, fc = (torch.cat([f, pad], -1).reshape(n_tiles, rt, 16) for f in (fa, fb, fc))
            basis = sh.eval_basis(d_flat, sh.degree_from_coeffs(k))
            basis = torch.cat([basis, d_flat.new_zeros((d_flat.shape[0], _SH - k))], -1)
            l, _ = composite_vjp.composite_tiles_ad(
                fa, fb, fc, basis.reshape(n_tiles, rt, _SH), pf_t, opac_t, sh_t, **kw
            )
        else:
            d8 = torch.cat([d, d.new_zeros(d.shape[:-1] + (5,))], dim=-1)
            l, _ = composite2.composite_tiles2(d8, pf_t, aux_t, sh_t, sh_k=k, **kw)
        if cfg.srgb_primitives:
            l = srgb_to_linear(l)  # per sample
        acc = acc + l
    return acc / spp


def _class_counts(n_tiles: int, budget_classes) -> list:
    """Tiles per budget class: rounded fractions, the last class takes the rest."""
    fracs = [f for f, _ in budget_classes]
    if abs(sum(fracs) - 1.0) > 1e-6:
        raise ValueError(f"budget_classes fractions sum to {sum(fracs)}")
    counts = [int(round(n_tiles * f)) for f in fracs]
    counts[-1] = n_tiles - sum(counts[:-1])
    if min(counts) < 1:
        raise ValueError(f"budget class with no tiles: {counts} (n_tiles {n_tiles})")
    return counts


def _tile_offsets(seed, i, tile_ids, n_tiles, rt, jitter, device):
    """In-pixel offsets [T, RT, 2] of sample ``i`` for the tiles ``tile_ids``:
    drawn for the whole film from a Philox generator keyed by (seed, i) and
    indexed by global tile id; 0.5 (pixel centers) without jitter."""
    if not jitter:
        return torch.full((tile_ids.shape[0], rt, 2), 0.5, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + i) % (2**63))
    off = torch.rand((n_tiles, rt, 2), generator=gen, device=device)
    return off[tile_ids]


def render(primitives, camera, cfg, emitter=None, spp=1, seed=0, jitter=True):
    """Convenience: build the state and render (rebuilds the cluster index
    every call; use build_state + render_state for repeated frames)."""
    state = build_state(primitives, cfg)
    return render_state(state, camera, cfg, emitter, spp, seed, jitter)
