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

Backends: ``'fused'`` (v3: kernels/composite3.py) with the two-level cull,
``budget_classes``, ``kernel_compact``, ``cluster_sort``, the banded order
correction (``order_band``, per class ``band_classes``), the refinement of
truncated tiles (``refine_fraction``, ``refine_factor``) and, with
``prim_resort``, the in-block resort of each tile's packed columns by their
entry distance (pack row 15), as JAX's fused block does; and the shortlist
backends, which expand the cluster shortlist to primitives, refine it with
``prim_resort`` (True, 'entry', 'cluster', 'cluster-entry'; on by default,
as in JAX), gather [T, S, F] feature, SH and opacity tables built by
``build_state`` and composite one sample at a time: ``'pallas'`` (v1:
kernels/composite.py + composite_vjp.py), ``'pallas2'`` (v2, camera
relative: kernels/composite2.py) and ``'xla'`` (:func:`_composite_group_xla`,
plain PyTorch under autograd: JAX's backend is plain XLA too). With
``use_clusters=False`` the shortlist backends cull every primitive per tile
(flat culling; the fused backend needs clusters). The fused-only knobs
(``budget_classes``, ``kernel_compact``, ``cluster_sort``) are ignored by the
others, as in JAX. Only the xla backend reads ``kernel_type``: the
compositor kernels are Gaussian, as JAX's are. An emitter adds
``beta * emitter.eval(d)`` per sample before the sRGB conversion.
``early_exit`` stops a tile once none of its rays is under its hit cap and
above ``beta_kill``: in the xla backend, and in the fused compositor without
``kernel_compact`` (JAX takes its early-exit walk only there), so that beta,
and with it an emitter's light, is the product up to where the tile
stopped, as in JAX. The TPU layout knobs (``feat_major``, ``kernel_batch``)
have no counterpart.

``_DEBUG_STOP`` (set by tools/profile_rf.py) makes a frame return early, as
JAX's does: after the cull ("cull") or the pack ("pack"), or inside each
tile block after the column gather ("gather_pf") or the SH gather
("gather"), with a cheap probe of what was computed (sums times 1e-12,
broadcast to the tiles) so that the stages before it can be timed.

Under ``torch.profiler`` the fused route's stages are ranges of
``utils.spans``: ``rf_tiled.build_state`` and ``rf_tiled.render_state``,
and inside a frame ``rf_tiled.layout`` (the film's tile layout and the
camera's upload), ``rf_tiled.cull``, ``rf_tiled.pack``, ``rf_tiled.gather``
and ``rf_tiled.composite`` (the sample loop around the compositor). The
counters ``rf_tiled.layout_builds`` and ``rf_tiled.layout_hits`` count the
tile layouts built and those served from the cache of film layouts
(:func:`_tile_layout`).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from ..accel import clusters
from ..accel import tiles as tiling
from ..kernels import composite2, composite3, composite_vjp
from ..ops import quadric, quaternion, sh, srgb_to_linear
from ..ops.kernels import Kernel
from ..parallel.mesh import gather_blocks
from ..scene.cameras import CameraSpecs
from ..scene.ellipsoids import EllipsoidScene
from ..utils.spans import count, span, spanned
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
    # tiles per vectorised step of the xla backend: a memory knob, the image
    # does not depend on it; on the card the step grows to _GROUP_PAIRS
    tile_group: int = 8
    # the xla backend stops a tile once none of its rays is above beta_kill
    # (one host read per segment); see the module docstring for the fused
    early_exit: bool = False
    # 'xla', 'fused' (v3), 'pallas' (v1) or 'pallas2' (v2)
    backend: str = "xla"
    # per-primitive depth refinement of the shortlist: None (on for
    # xla/v1/v2, off for fused), False, True, 'entry', 'cluster' or
    # 'cluster-entry'; the fused backend sorts its packed columns by entry
    # distance whatever the truthy mode
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
        return Kernel(self.kernel_type, normalized=True, full_range=True)


def _check_config(cfg: RFTiledConfig) -> None:
    """Refuse configurations that JAX asserts against or cannot name."""
    if cfg.backend not in ("xla", "fused", "pallas", "pallas2"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.backend == "fused" and not cfg.use_clusters:
        raise ValueError("backend='fused' requires use_clusters=True")
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
    cfg.kernel  # refuses unknown kernel types


@dataclasses.dataclass
class RFTiledState:
    """Per-scene render state (rebuild when primitive parameters change)."""

    # Morton-sorted and padded to a cluster multiple (the scene as given
    # without clusters)
    prims: EllipsoidScene
    cull_centers: torch.Tensor  # [Ncl, 3] cluster bounding spheres (or [N, 3])
    cull_radii: torch.Tensor  # [Ncl] (or [N]: extent x the largest scale)
    # the cluster tables (None without clusters):
    # [Ncl, 3k*cs] bf16 cluster rows, each a channel-major [3k, cs] block
    # of folded SH (kernels.composite3.fold_sh_rows)
    shrows: Optional[torch.Tensor] = None
    sup_centers: Optional[torch.Tensor] = None  # [Nsup, 3] supercluster spheres
    sup_radii: Optional[torch.Tensor] = None  # [Nsup]
    # [Nsup + 1, 4*sg] member-cluster spheres, each a [4, sg] block
    # (cx, cy, cz, r); the trailing row has r = -1 (never hits)
    suprows: Optional[torch.Tensor] = None
    extent: float = 3.0
    clustered: bool = True
    cluster_size: int = 64
    super_group: int = 16
    sh_k: int = 1  # live SH coefficients per channel
    # the shortlist backends' tables, built only for 'xla', 'pallas' and
    # 'pallas2' (None else): [N, 16] quadric features (10 used; xla and v1),
    # [N] opacities and [N, 48] channel-major SH blocks of 16
    feats16: Optional[torch.Tensor] = None
    opac: Optional[torch.Tensor] = None
    sh48: Optional[torch.Tensor] = None


@spanned("rf_tiled.build_state")
def build_state(primitives: EllipsoidScene, cfg: RFTiledConfig) -> RFTiledState:
    """Morton-sort, cluster and pack the scene for tiled rendering (or,
    with ``use_clusters=False``, keep it as it is with one cull sphere per
    primitive)."""
    _check_config(cfg)
    if cfg.use_clusters:
        state = _cluster_state(primitives, cfg)
    else:
        # the cull spheres select integer ids and carry no gradient
        state = RFTiledState(
            prims=primitives,
            cull_centers=primitives.centers.detach(),
            cull_radii=primitives.extent * torch.amax(primitives.scales.detach(), dim=-1),
            extent=float(primitives.extent),
            clustered=False,
            cluster_size=cfg.cluster_size,
            super_group=cfg.super_group,
            sh_k=primitives.sh_coeffs_3d().shape[1],
        )
    if cfg.backend == "fused":
        return state
    work = state.prims
    sh_coeffs = work.sh_coeffs_3d()  # [N, k, 3]
    n, k = sh_coeffs.shape[:2]
    zeros = sh_coeffs.new_zeros((n, _SH - k))
    state.sh48 = torch.cat([t for ch in range(3) for t in (sh_coeffs[:, :, ch], zeros)], dim=1)
    state.opac = work.attrs["opacities"][:, 0]
    if cfg.backend in ("pallas", "xla"):
        feats = quadric.prim_features(work.centers, work.scales, work.quats)
        state.feats16 = torch.cat([feats.T, feats.new_zeros((n, 6))], dim=1)
    return state


def _cluster_state(primitives: EllipsoidScene, cfg: RFTiledConfig) -> RFTiledState:
    """The clustered state: Morton order, cluster and supercluster spheres
    and the fused path's bf16 SH cluster rows."""
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
    )


# Tile layouts by film: (height, width, tile_h, tile_w, coarse_group,
# device) -> (px0, py0, tile_ids, unshuffle), built on the device at a film's
# first camera and shared by every later one, in any thread (least recently
# used first out). A layout depends on its key alone; callers only read its
# tensors (px0 + 0.5, px0[sel], px0[blk]).
_LAYOUTS: collections.OrderedDict = collections.OrderedDict()
_LAYOUT_CACHE = 8  # films; one is ~4 MB at 960 x 544
_LAYOUT_LOCK = threading.Lock()


def _tile_shape(h: int, cfg: RFTiledConfig) -> tuple:
    """(tile_h, tile_w): cfg.tile_shape, else the tallest divisor of
    tile_pixels up to its square root that divides the film's height."""
    if cfg.tile_shape is not None:
        return tuple(cfg.tile_shape)
    tp = cfg.tile_pixels
    th = int(tp**0.5)
    while tp % th or h % th:
        th -= 1
    return th, tp // th


def _tile_layout(camera: CameraSpecs, cfg: RFTiledConfig, device):
    """The camera's film's tile layout (:func:`_build_layout`), from the
    cache after the film's first camera. The principal point does not enter
    it: ``cx`` / ``cy`` come in with the camera's numbers."""
    h, w = camera.height, camera.width
    key = (h, w, *_tile_shape(h, cfg), max(1, cfg.coarse_group), device)
    with _LAYOUT_LOCK:
        layout = _LAYOUTS.get(key)
        if layout is not None:
            _LAYOUTS.move_to_end(key)
    if layout is not None:
        count("rf_tiled.layout_hits", 1)
        return layout
    count("rf_tiled.layout_builds", 1)
    layout = _build_layout(*key)
    with _LAYOUT_LOCK:
        _LAYOUTS[key] = layout
        if len(_LAYOUTS) > _LAYOUT_CACHE:
            _LAYOUTS.popitem(last=False)
    return layout


def _build_layout(h, w, th, tw, gc, device):
    """Block-major tile grid: ``(px0, py0, tile_ids, unshuffle)``, px0/py0
    [T, RT] f32 pixel coordinates ordered so that each run of ``gc`` tiles
    is a near-square block (the strip the coarse cull bounds), and
    ``unshuffle(acc)`` folding [T, RT, 3] back into the [H, W, 3] film. Made
    on ``device``."""
    if h % th or w % tw:
        raise ValueError(f"film {w}x{h} not divisible into {tw}x{th} tiles")
    n_ty, n_tx = h // th, w // tw
    n_tiles = n_ty * n_tx
    rt = th * tw
    gb_y = max(1, int(round(gc ** 0.5)))
    while gb_y > 1 and (gc % gb_y or n_ty % gb_y or n_tx % (gc // gb_y)):
        gb_y -= 1
    gb_x = gc // gb_y if gc % gb_y == 0 and n_tx % (gc // gb_y) == 0 else 1
    if gb_x == 1:
        gb_y = 1  # fall back to row-consecutive strips
    n_gy, n_gx = n_ty // gb_y, n_tx // gb_x
    ty_of = (
        torch.arange(n_ty, device=device).reshape(n_gy, 1, gb_y, 1)
        .expand(n_gy, n_gx, gb_y, gb_x).reshape(-1)
    )
    tx_of = (
        torch.arange(n_tx, device=device).reshape(1, n_gx, 1, gb_x)
        .expand(n_gy, n_gx, gb_y, gb_x).reshape(-1)
    )
    ys = torch.arange(h, device=device).reshape(n_ty, th)[ty_of]  # [T, th]
    xs = torch.arange(w, device=device).reshape(n_tx, tw)[tx_of]  # [T, tw]
    f32 = torch.float32
    py0 = ys[:, :, None].expand(n_tiles, th, tw).reshape(n_tiles, rt).to(f32)
    px0 = xs[:, None, :].expand(n_tiles, th, tw).reshape(n_tiles, rt).to(f32)

    def unshuffle(acc):
        return (
            acc.reshape(n_gy, n_gx, gb_y, gb_x, th, tw, 3)
            .permute(0, 2, 4, 1, 3, 5, 6)
            .reshape(h, w, 3)
        )

    return px0, py0, torch.arange(n_tiles, device=device), unshuffle


def _camera_numbers(camera: CameraSpecs, dev):
    """The camera's origin [3], rotation [3, 3], focal length, ppx and ppy
    as f32 views of one tensor on ``dev``, sent in one copy: from pinned
    memory on a card, so the host does not wait for the stream."""
    host = np.empty(15, np.float32)
    host[:3] = camera.to_world[:3, 3]
    host[3:12] = camera.to_world[:3, :3].reshape(9)
    host[12:] = (camera.focal_length, camera.width / 2.0 - camera.cx,
                 camera.height / 2.0 - camera.cy)
    buf = torch.from_numpy(host)
    if dev.type == "cuda":
        buf = buf.pin_memory()
    nums = buf.to(dev, non_blocking=True)
    return nums[:3], nums[3:12].view(3, 3), nums[12], nums[13], nums[14]


@spanned("rf_tiled.render_state")
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
    so parity checks use ``jitter=False`` (pixel centers).

    With ``mesh`` (a :class:`volprim_tpu_torch.parallel.Mesh` of W ranks,
    each holding the same state), each rank renders its contiguous block of
    T / W tiles of the block-major layout and an all-gather assembles the
    frame on every rank (its backward hands a rank its own block's
    cotangent: parallel/mesh.py). The tile count must divide by W, as JAX
    asserts. A tile's jitter depends only on its global id, so the frame
    equals the single process's bit for bit; budget classes, refinement and
    the coarse cull's strips act per block, as under JAX's ``shard_map``,
    so frames with budget classes or refinement are statistically equal."""
    _check_config(cfg)
    dev = state.cull_centers.device
    with span("rf_tiled.layout"):
        px0, py0, tile_ids, unshuffle = _tile_layout(camera, cfg, dev)
        cam = _camera_numbers(camera, dev)
    film_tiles = px0.shape[0]
    if mesh is not None:
        if film_tiles % mesh.size:
            raise ValueError(f"{film_tiles} tiles are not divisible over {mesh.size} ranks")
        blk = mesh.block(film_tiles)
        px0, py0, tile_ids = px0[blk], py0[blk], tile_ids[blk]
    acc = _render_tiles(
        state, emitter, px0, py0, tile_ids, cam, cfg=cfg, spp=spp, seed=int(seed),
        jitter=jitter, film_tiles=film_tiles,
    )
    return unshuffle(gather_blocks(mesh, acc))


def _render_tiles(state, emitter, px0, py0, tile_ids, cam, *, cfg, spp, seed, jitter,
                  film_tiles):
    """Cull, gather and composite the tiles ``tile_ids`` of a film of
    ``film_tiles`` tiles seen by the camera whose numbers ``cam`` are
    (:func:`_camera_numbers`). Returns [T, RT, 3]."""
    dev = px0.device
    f32 = torch.float32
    n_tiles, rt = px0.shape
    work = state.prims
    cs = state.cluster_size
    s = min(cfg.max_candidates, work.num_prims)
    s = max(cfg.segment, (s // cfg.segment) * cfg.segment) if s >= cfg.segment else s
    k_cl = max(1, s // cs)

    origin, rot, focal, ppx, ppy = cam

    def dirs_cols(px, py):
        """Unit ray directions as three [T, RT] component arrays."""
        dlx = -(px - ppx) / focal
        dly = -(py - ppy) / focal
        ddx = rot[0, 0] * dlx + rot[0, 1] * dly + rot[0, 2]
        ddy = rot[1, 0] * dlx + rot[1, 1] * dly + rot[1, 2]
        ddz = rot[2, 0] * dlx + rot[2, 1] * dly + rot[2, 2]
        inv = 1.0 / torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        return ddx * inv, ddy * inv, ddz * inv

    use_fused = cfg.backend == "fused"
    resort = cfg.prim_resort if cfg.prim_resort is not None else not use_fused
    with span("rf_tiled.cull"):
        # ---- per-frame culling: one bounding cone per tile ---------------
        dnx, dny, dnz = dirs_cols(px0 + 0.5, py0 + 0.5)
        ax = torch.stack([dnx.mean(dim=1), dny.mean(dim=1), dnz.mean(dim=1)], dim=-1)
        axis = ax / torch.sqrt(torch.sum(ax * ax, dim=-1, keepdim=True))
        cos_half = torch.amin(
            dnx * axis[:, 0:1] + dny * axis[:, 1:2] + dnz * axis[:, 2:3], dim=1
        )
        half = torch.arccos(torch.clamp(cos_half, -1.0, 1.0)) + 1.5 / focal
        cos_half = torch.cos(half)

        if not state.clustered:
            # flat culling: every primitive's sphere against every tile cone
            keys = tiling.cone_cull_keys_batch(
                origin, axis, cos_half, state.cull_centers, state.cull_radii
            )
            ids, valid = tiling.shortlist(keys, s)
        else:
            gc = cfg.coarse_group
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
                ids, valid = clusters.expand_cluster_ids(cl_ids, cl_valid, cs)
                if resort:
                    ids, valid = _resort(state, ids, valid, origin, axis, resort)
    if not state.clustered or not use_fused:
        return _render_shortlist(state, emitter, ids, valid, origin, dirs_cols, px0, py0,
                                 tile_ids, cfg=cfg, spp=spp, seed=seed, jitter=jitter,
                                 film_tiles=film_tiles)

    with span("rf_tiled.pack"):
        # ---- per-frame pack: [Ncl, 16*cs] cluster rows ---------------------
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
        with span("rf_tiled.gather"):
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
            if resort:
                # every column of the tile in entry-distance order (pack row
                # 15; invalid columns last), as JAX's fused block sorts them
                order = torch.argsort(torch.where(valid_row, pf_t[:, 15], torch.inf), dim=-1,
                                      stable=True)
                pf_t = torch.gather(pf_t, 2, order[:, None, :].expand(pf_t.shape))
                sh_t = torch.gather(sh_t, 2, order[:, None, :].expand(sh_t.shape))
            if _DEBUG_STOP == "gather":
                probe = (pf_t.sum() + sh_t.to(f32).sum() + n_seg_t.sum().to(f32)) * 1e-12
                return probe.expand(tb, rt, 3), torch.ones((tb, rt), device=dev)
        with span("rf_tiled.composite"):
            acc_b = torch.zeros((tb, rt, 3), dtype=f32, device=dev)
            beta0 = None
            for g in range(spp // fold):
                # spp folding: `fold` samples' rays share one shortlist walk
                cols = []
                for j in range(fold):
                    off = _tile_offsets(seed, g * fold + j, tid_b, film_tiles, rt, jitter, dev)
                    cols.append(dirs_cols(px_b + off[..., 0], py_b + off[..., 1]))
                dirs = [torch.cat([c[i] for c in cols], dim=1) for i in range(3)]
                d8 = composite3.pack_direction_rows(*dirs)
                l, beta = composite3.composite_tiles3(
                    d8, pf_t, sh_t, n_seg_t,
                    seg=seg,
                    extent2=state.extent ** 2,
                    max_depth=cfg.max_depth if cfg.max_depth > 0 else 10**6,
                    beta_kill=cfg.beta_kill,
                    sh_k=kl,
                    compact=cfg.kernel_compact,
                    order_band=band_here,
                    early_exit=cfg.early_exit,
                )
                if beta0 is None:
                    beta0 = beta[:, :rt]
                if emitter is not None:
                    l = l + beta[..., None] * emitter.eval(torch.stack(dirs, dim=-1))
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
        with span("rf_tiled.cull"):
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
    with span("rf_tiled.cull"):
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


def _render_shortlist(state, emitter, ids, valid, origin, dirs_cols, px0, py0, tile_ids, *,
                      cfg, spp, seed, jitter, film_tiles):
    """The shortlist backends after the cull (rf_tiled.py:1152-1267): pad the
    primitive shortlist [T, S] to a segment multiple, gather the [T, S, F]
    tables with neutral rows and zero opacity on invalid slots, and
    composite one sample at a time (v1, v2 or xla); an emitter lights what
    each ray's beta leaves. Returns [T, RT, 3]."""
    dev = px0.device
    n_tiles, rt = px0.shape
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
    if cfg.backend in ("pallas", "xla"):
        pf_t = torch.where(valid[..., None], state.feats16[ids], _neutral_feature(dev))
        if cfg.backend == "pallas":
            opac_t = opac_t[:, None, :].contiguous()
    else:
        cam = composite2.camera_relative_features_from_prims(state.prims, origin)
        pf_t = torch.where(valid[..., None], cam[ids], composite2.neutral_row(origin))
        o2 = origin[0] * origin[0] + origin[1] * origin[1] + origin[2] * origin[2]
        c0_t = torch.where(valid, cam[:, 9][ids], o2)
        aux_t = torch.stack([opac_t, c0_t], dim=1)  # [T, 2, S]

    acc = torch.zeros((n_tiles, rt, 3), dtype=torch.float32, device=dev)
    for i in range(spp):
        off = _tile_offsets(seed, i, tile_ids, film_tiles, rt, jitter, dev)
        d = torch.stack(dirs_cols(px0 + off[..., 0], py0 + off[..., 1]), dim=-1)  # [T, RT, 3]
        if cfg.backend == "pallas":
            d_flat = d.reshape(-1, 3)
            fa, fb, fc = quadric.ray_features(origin.expand_as(d_flat), d_flat)
            pad = d_flat.new_zeros((d_flat.shape[0], 6))
            fa, fb, fc = (torch.cat([f, pad], -1).reshape(n_tiles, rt, 16) for f in (fa, fb, fc))
            basis = sh.eval_basis(d_flat, sh.degree_from_coeffs(k))
            basis = torch.cat([basis, d_flat.new_zeros((d_flat.shape[0], _SH - k))], -1)
            l, beta = composite_vjp.composite_tiles_ad(
                fa, fb, fc, basis.reshape(n_tiles, rt, _SH), pf_t, opac_t, sh_t, **kw
            )
        elif cfg.backend == "pallas2":
            d8 = torch.cat([d, d.new_zeros(d.shape[:-1] + (5,))], dim=-1)
            l, beta = composite2.composite_tiles2(d8, pf_t, aux_t, sh_t, sh_k=k, **kw)
        else:
            l, beta = _composite_tiles_xla(origin, d, pf_t, opac_t, sh_t, valid, k,
                                           state.extent, cfg)
        if emitter is not None:
            l = l + beta[..., None] * emitter.eval(d)
        if cfg.srgb_primitives:
            l = srgb_to_linear(l)  # per sample
        acc = acc + l
    return acc / spp


# pairs (rays x shortlist columns) per vectorised step of the xla backend:
# a step's tiles grow past cfg.tile_group up to this many
# (scripts/xla_memory.py: of 2^24, 2^26 and 2^28, the largest gave the
# fastest headline-sized frame on the card)
_GROUP_PAIRS = 1 << 28


def xla_step_tiles(n_tiles: int, rt: int, s: int, cfg) -> int:
    """Tiles in one vectorised step of the xla backend on a film of
    ``n_tiles`` tiles of ``rt`` rays and ``s`` shortlist columns:
    max(cfg.tile_group, _GROUP_PAIRS // (RT S)), at most the film's."""
    return min(n_tiles, max(cfg.tile_group, _GROUP_PAIRS // (rt * s)))


def _composite_tiles_xla(origin, d, pf, opac, sh48, valid, basis_k, extent, cfg):
    """The xla backend over every tile, in steps of :func:`xla_step_tiles`
    tiles (the last step may be short). Under autograd every step's
    intermediates stay saved (40.0 GiB at the headline train step, on the
    card; scripts/xla_memory.py).
    d [T, RT, 3], pf [T, S, 16], opac [T, S], sh48 [T, S, 48], valid [T, S]
    -> (L [T, RT, 3], beta [T, RT])."""
    n_tiles, rt = d.shape[:2]
    g = xla_step_tiles(n_tiles, rt, pf.shape[1], cfg)
    parts = [
        _composite_group_xla(origin, d[t0:t0 + g], pf[t0:t0 + g], opac[t0:t0 + g],
                             sh48[t0:t0 + g], valid[t0:t0 + g], basis_k, extent, cfg)
        for t0 in range(0, n_tiles, g)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _composite_group_xla(origin, d, pf, opac, sh48, valid, basis_k, extent, cfg):
    """JAX's ``_composite_tile_xla`` (rf_tiled.py:334-457) over a group of
    G tiles: per segment of the shortlist, a, b, c as full-f32 products of
    the ray and primitive features, q = c - b^2/a, the hit test on the
    extent ellipsoid, alpha = min(opacity K(q), 0.9999), the max_depth cap
    by cumulative hit count, the transmittance prefix (banded order
    correction within the segment with order_band), the beta_kill cut on
    beta * prefix and the clamped SH emission. With ``early_exit`` a tile
    stops at the first segment where none of its rays is above beta_kill
    (one host read per segment, JAX's while_loop condition).
    d [G, RT, 3], pf [G, S, 16], opac [G, S], sh48 [G, S, 48], valid [G, S]
    -> (L [G, RT, 3], beta [G, RT])."""
    kern = cfg.kernel
    g, rt = d.shape[:2]
    s = pf.shape[1]
    c = min(cfg.segment, s)
    d_flat = d.reshape(-1, 3).to(pf.dtype)  # (an f64 yardstick's tables are f64)
    origin = origin.to(pf.dtype)
    fa, fb, fc = (f.reshape(g, rt, 10)
                  for f in quadric.ray_features(origin.expand_as(d_flat), d_flat))
    basis = sh.eval_basis(d_flat, sh.degree_from_coeffs(basis_k)).reshape(g, rt, basis_k)
    e2 = extent * extent
    band = min(int(cfg.order_band), c - 1)  # offsets beyond the segment are empty

    l_acc = pf.new_zeros((g, rt, 3))
    beta = pf.new_ones((g, rt))
    count = torch.zeros((g, rt), dtype=torch.int32, device=d.device)
    for si in range(s // c):
        live = None
        if cfg.early_exit:
            live = torch.any(beta > cfg.beta_kill, dim=1)  # [G]
            if not bool(live.any()):
                break
        sl = slice(si * c, (si + 1) * c)
        pf_s = pf[:, sl, :10].transpose(1, 2)  # [G, 10, C]
        a = torch.matmul(fa, pf_s)  # [G, RT, C]
        b = torch.matmul(fb, pf_s)
        cc = torch.matmul(fc, pf_s)
        q_min = torch.clamp(cc - b * b / a, min=0.0)
        disc = (e2 - q_min) / a
        t_near = -b / a - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc >= 0.0) & (t_near > 0.0) & valid[:, None, sl]
        alpha = torch.clamp(opac[:, None, sl] * kern.eval_q(q_min), max=0.9999)
        alpha = torch.where(hit, alpha, 0.0)
        new_count = count[..., None] + torch.cumsum((alpha > 0.0).to(torch.int32), dim=-1,
                                                    dtype=torch.int32)
        if cfg.max_depth > 0:
            alpha = torch.where(new_count <= cfg.max_depth, alpha, 0.0)
        trans = 1.0 - alpha
        cp = torch.cumprod(trans, dim=-1)
        excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
        if band > 0:
            # JAX's intra-segment banded correction (see its order_band
            # docstring): j = i + s nearer joins i's prefix, j = i - s
            # farther leaves it; dead columns carry trans = 1
            tkey = torch.where(alpha > 0.0, t_near, torch.inf)
            inf_b = torch.full_like(tkey[..., :1], torch.inf)
            one_b = torch.ones_like(trans[..., :1])
            for s_ in range(1, band + 1):
                t_f = torch.cat([tkey[..., s_:], inf_b.expand(g, rt, s_)], dim=-1)
                tr_f = torch.cat([trans[..., s_:], one_b.expand(g, rt, s_)], dim=-1)
                excl = excl * torch.where(t_f < tkey, tr_f, 1.0)
                t_b = torch.cat([-inf_b.expand(g, rt, s_), tkey[..., :c - s_]], dim=-1)
                tr_b = torch.cat([one_b.expand(g, rt, s_), trans[..., :c - s_]], dim=-1)
                excl = excl / torch.where(t_b > tkey, tr_b, 1.0)
        pre = beta[..., None] * excl
        weight = torch.where(pre > cfg.beta_kill, pre * alpha, 0.0)
        sh_s = sh48[:, sl]  # [G, C, 48]
        emission = []
        for ch in range(3):
            sh_ch = sh_s[..., ch * _SH:ch * _SH + basis_k].transpose(1, 2)  # [G, k, C]
            e_ch = torch.clamp(torch.matmul(basis, sh_ch) + 0.5, min=0.0)
            emission.append(torch.sum(weight * e_ch, dim=-1))
        l_new = l_acc + torch.stack(emission, dim=-1)
        beta_new = beta * cp[..., -1]
        count_new = new_count[..., -1]
        if live is None:
            l_acc, beta, count = l_new, beta_new, count_new
        else:  # tiles that stopped keep their carry
            l_acc = torch.where(live[:, None, None], l_new, l_acc)
            beta = torch.where(live[:, None], beta_new, beta)
            count = torch.where(live[:, None], count_new, count)
    return l_acc, beta


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


def _tile_offsets(seed, i, tile_ids, film_tiles, rt, jitter, device):
    """In-pixel offsets [T, RT, 2] of sample ``i`` for the tiles ``tile_ids``:
    drawn for the whole film of ``film_tiles`` tiles from a Philox generator
    keyed by (seed, i) and indexed by global tile id; 0.5 (pixel centers)
    without jitter."""
    if not jitter:
        return torch.full((tile_ids.shape[0], rt, 2), 0.5, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + i) % (2**63))
    off = torch.rand((film_tiles, rt, 2), generator=gen, device=device)
    return off[tile_ids]


def render(primitives, camera, cfg, emitter=None, spp=1, seed=0, jitter=True):
    """Convenience: build the state and render (rebuilds the cluster index
    every call; use build_state + render_state for repeated frames)."""
    state = build_state(primitives, cfg)
    return render_state(state, camera, cfg, emitter, spp, seed, jitter)
