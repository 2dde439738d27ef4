"""The port's rf_tiled with the xla backend (plain PyTorch, JAX's
``_composite_tile_xla``) against the JAX package's, jitter off.

- Frames of surface_scene(1600, seed=3) at 32x32 with the Gaussian and the
  Epanechnikov kernel, order_band 8, early_exit, a binding max_depth cap
  (4), every prim_resort mode and
  a ConstantEmitter (with early_exit too: the emitter reads the beta a tile
  stopped at), and flat culling (use_clusters=False) in the setup of JAX's
  test_tiled_matches_exact (surface_scene(400), 64x64).
- The fused backend with a ConstantEmitter and with prim_resort=True (JAX's
  fused block then sorts each tile's packed columns by entry distance).
- tile_group 2, 3 and 8 (a short last step): the image does not depend on
  the group.

(The gradients: test_torch_rf_tiled_xla_grads.py.)

Frames agree within 1e-5 absolute. Where the cancelling q = c - b^2/a
decides (the surface scene's primitives are small: both packages' f32
images lie up to ~6e-4 from an f64 run, and the two packages round the
features differently), the yardstick is JAX's xla route in f64 on the same
shortlists (:func:`jax_render64`): the port's f32 image has an RMS
deviation from it at most twice JAX's f32 image's and a largest at most
four times JAX's largest (one silhouette pixel decides the largest;
ROADMAP.md, "Recorded mismatches"). The port in f64 is held to JAX in f64
within 1e-5 in every case, so a fault that does not depend on precision
fails there whatever the f32 rounding.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu.ops import envmap as jenv
from volprim_tpu.ops import quadric as jquadric
from volprim_tpu_torch import train
from volprim_tpu_torch.models import rf_tiled as trt
from volprim_tpu_torch.ops import envmap as tenv
from volprim_tpu_torch.scene.ellipsoids import EllipsoidScene

from test_rf_tiled import surface_scene as _make_scene
from test_torch_rf_tiled import _cameras, _port_scene

surface_scene = functools.lru_cache(maxsize=None)(_make_scene)

FRAME = dict(max_depth=64, srgb_primitives=False, tile_pixels=256, max_candidates=512,
             segment=128, use_clusters=True, cluster_size=32, tile_group=2)
# JAX's test_tiled_matches_exact
FLAT = dict(max_depth=64, srgb_primitives=False, tile_pixels=256, max_candidates=256,
            segment=64, tile_group=4, use_clusters=False)
FRAME_TOL = 1e-5
EMIT = (0.3, 0.6, 0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene64(s, params=None):
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)  # noqa: E731
    base = EllipsoidScene(t(s.centers), t(s.scales), t(s.quats),
                          {k: t(v) for k, v in s.attrs.items()}, float(s.extent))
    return train.to_scene(params or {}, base)


def _render64(scene64, cam, cfg, emitter=None):
    """The port in f64: build_state in f64, the cull geometry cast to f32
    (the f32 frame's shortlists), the f32 rays cast to f64."""
    st = trt.build_state(scene64, cfg)
    st = dataclasses.replace(st, **{
        k: getattr(st, k).float()
        for k in ("cull_centers", "cull_radii", "sup_centers", "sup_radii", "suprows")
        if getattr(st, k) is not None})
    return trt.render_state(st, cam, cfg, emitter, spp=1, jitter=False)


def jax_scene64(s, params=None):
    """``s`` in f64 for JAX (call under ``jax.enable_x64(True)``), with
    ``params`` (the five trained arrays) in place of its own."""
    p = params or {}
    f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    attrs = {k: f64(p.get(k, v)) for k, v in s.attrs.items()}
    return jscene.EllipsoidScene(*(f64(p.get(k, getattr(s, k)))
                                   for k in ("centers", "scales", "quats")), attrs, s.extent)


def jax_state64(s64, cfg):
    """JAX's build_state of an f64 scene with its f32 pins lifted: the
    feature and SH tables in f64 (as build_state forms them), the cull
    geometry in f32, so the f64 frame takes the f32 frame's shortlists."""
    st = jrt.build_state(s64, cfg)
    w = st.prims
    feats = jnp.zeros((w.num_prims, 16), jnp.float64).at[:, :10].set(
        jquadric.prim_features(w.centers, w.scales, w.quats).T)
    sh = w.sh_coeffs_3d()
    sh48 = jnp.zeros((w.num_prims, 48), jnp.float64)
    for ch in range(3):
        sh48 = sh48.at[:, ch * 16:ch * 16 + sh.shape[1]].set(sh[:, :, ch])
    cull = {k: getattr(st, k).astype(jnp.float32)
            for k in ("cull_centers", "cull_radii", "sup_centers", "sup_radii", "suprows")
            if getattr(st, k) is not None}
    return dataclasses.replace(st, feats16=feats, sh48=sh48, **cull)


@contextlib.contextmanager
def jax_xla64():
    """JAX's _composite_tile_xla on f64 rays (render_state forms the rays
    in f32, as the port does): with jax_state64's f64 tables every pair
    is composited in f64; each sample's L and beta are rounded to f32,
    the dtype of render_state's sample sum."""
    orig = jrt._composite_tile_xla

    def f64(o, d, *args):
        l, beta = orig(o.astype(jnp.float64), d.astype(jnp.float64), *args)
        return l.astype(jnp.float32), beta.astype(jnp.float32)

    jrt._composite_tile_xla = f64
    try:
        yield
    finally:
        jrt._composite_tile_xla = orig


def jax_render64(s, cam, kw, emitter=None):
    """JAX's xla route in f64 on the f32 frame's shortlists: the yardstick."""
    cfg = jrt.RFTiledConfig(**kw)
    with jax.enable_x64(True), jax_xla64():
        st = jax_state64(jax_scene64(s), cfg)
        return np.asarray(jrt.render_state(st, cam, cfg, emitter, spp=1, seed=0,
                                           jitter=False))


def hold_to_jax(got, want, got64, want64, tol, what, max_factor=4.0):
    """The port in f64 (``got64``) within ``tol`` of JAX in f64
    (``want64``), always; the port in f32 (``got``) within ``tol`` of JAX
    in f32 (``want``), or else its RMS deviation from JAX in f64 at most
    twice JAX's f32 deviation and its largest at most ``max_factor`` times
    JAX's largest."""
    err64 = np.abs(got64 - want64).max()
    assert err64 <= tol, f"{what}: port f64 - JAX f64 {err64:.3g} > {tol:.3g}"
    err = np.abs(got - want).max()
    if err <= tol:
        return
    dp, dj = np.abs(got - want64), np.abs(want - want64)
    rms_p, rms_j = np.sqrt(np.mean(dp ** 2)), np.sqrt(np.mean(dj ** 2))
    print(f"{what}: port-JAX {err:.3g} > {tol:.3g}; from JAX f64: port max {dp.max():.3g} "
          f"rms {rms_p:.3g}, JAX max {dj.max():.3g} rms {rms_j:.3g}; f64 port-JAX {err64:.3g}")
    assert rms_p <= 2.0 * rms_j, what
    assert dp.max() <= max_factor * dj.max(), what


def _frames(s, kw, emit=False, f64=True):
    """(port, JAX) frames of ``s`` under config ``kw``, and with ``f64``
    the same in f64 (:func:`_render64`, :func:`jax_render64`)."""
    cam_j, cam_t = _cameras(64, 64) if not kw.get("use_clusters", True) else _cameras(32, 32)
    em_j = jenv.ConstantEmitter(radiance=jnp.asarray(EMIT, jnp.float32)) if emit else None
    em_t = tenv.ConstantEmitter(radiance=torch.tensor(EMIT)) if emit else None
    img_j = np.asarray(jrt.render(s, cam_j, jrt.RFTiledConfig(**kw), em_j, spp=1, seed=0,
                                  jitter=False))
    img_t = trt.render(_port_scene(s), cam_t, trt.RFTiledConfig(**kw), em_t, spp=1, seed=0,
                       jitter=False).numpy()
    if not f64:
        return img_t, img_j
    img_64 = _render64(_scene64(s), cam_t, trt.RFTiledConfig(**kw), em_t).numpy()
    return img_t, img_j, img_64, jax_render64(s, cam_j, kw, em_j)


CASES = {
    "gaussian": {},
    "epanechnikov": dict(kernel_type="epanechnikov"),
    "band8": dict(order_band=8),
    "early_exit": dict(early_exit=True),
    "max_depth_4": dict(max_depth=4),
    "no_resort": dict(prim_resort=False),
    "resort_entry": dict(prim_resort="entry"),
    "resort_cluster": dict(prim_resort="cluster"),
    "resort_cluster_entry": dict(prim_resort="cluster-entry"),
    "emitter": dict(emit=True),
    "emitter_early_exit": dict(emit=True, early_exit=True),
    "flat": dict(flat=True),
    "flat_epanechnikov": dict(flat=True, kernel_type="epanechnikov"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_xla_frame_matches_jax(case):
    extra = dict(CASES[case])
    emit = extra.pop("emit", False)
    if extra.pop("flat", False):
        s, kw = surface_scene(400), dict(FLAT, **extra)
    else:
        s, kw = surface_scene(1600, seed=3), dict(FRAME, **extra)
    img_t, img_j, img_64, img_j64 = _frames(s, dict(kw, backend="xla"), emit)
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01
    hold_to_jax(img_t, img_j, img_64, img_j64, FRAME_TOL, case)


@pytest.mark.parametrize("extra", [dict(emit=True), dict(prim_resort=True)],
                         ids=["emitter", "prim_resort"])
def test_fused_frame_matches_jax(extra):
    """The fused route: a ConstantEmitter lights what the kernel's beta
    leaves (early_exit and compaction off, where JAX's beta is the full
    product too), and prim_resort=True sorts each tile's packed columns by
    their entry distance, as JAX's fused block does. Both within 1e-5 of
    JAX's frame (bf16 SH rows and the v3 walk round alike in both
    packages)."""
    extra = dict(extra)
    emit = extra.pop("emit", False)
    kw = dict(FRAME, backend="fused", cluster_size=16, **extra)
    img_t, img_j = _frames(surface_scene(1600, seed=3), kw, emit, f64=False)
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01
    assert np.abs(img_t - img_j).max() <= FRAME_TOL


def test_tile_group_leaves_the_image_alone(monkeypatch):
    """tile_group sets the step (_GROUP_PAIRS at 0): 2, 3 (a short last
    step of the film's 4 tiles) and 8 (one step) give the same image."""
    monkeypatch.setattr(trt, "_GROUP_PAIRS", 0)
    s = _port_scene(surface_scene(1600, seed=3))
    cam = _cameras(32, 32)[1]
    imgs = [trt.render(s, cam, trt.RFTiledConfig(**dict(FRAME, backend="xla", tile_group=g,
                                                         early_exit=True)),
                       spp=1, jitter=False) for g in (2, 3, 8)]
    assert torch.equal(imgs[0], imgs[1]) and torch.equal(imgs[0], imgs[2])


@pytest.mark.parametrize("route", ["xla", "fused"])
def test_beta_image_places_each_ray_on_its_pixel(monkeypatch, route):
    """chip_smoke's phase-24 comparator: the compositor's betas, placed on
    the film by their rays' directions (chip_smoke.beta_image), equal the
    frame lit by ConstantEmitter(ones) less the frame unlit, pixel by
    pixel, one ray a pixel; a beta moved to another ray of its tile does
    not."""
    import chip_smoke
    from volprim_tpu_torch.kernels import composite3

    s = _port_scene(surface_scene(1600, seed=3))
    cam = _cameras(32, 32)[1]
    cfg = trt.RFTiledConfig(**dict(FRAME, backend=route))
    module, name = ((composite3, "composite_tiles3") if route == "fused"
                    else (trt, "_composite_tiles_xla"))
    orig, rays = getattr(module, name), []

    def recording(*a, **kw):
        out = orig(*a, **kw)
        rays.append(chip_smoke.launch_rays(route, a, out))
        return out

    monkeypatch.setattr(module, name, recording)
    lit = trt.render(s, cam, cfg, tenv.ConstantEmitter(radiance=torch.ones(3)), spp=1,
                     jitter=False)
    monkeypatch.setattr(module, name, orig)
    diff = (lit - trt.render(s, cam, cfg, None, spp=1, jitter=False)).double()
    beta, count = chip_smoke.beta_image(cam, rays)
    assert bool((count == 1).all()) and float(beta.max()) > 0.1
    assert float((diff - beta[..., None]).abs().max()) <= 1e-6
    moved = [(d, torch.roll(b, 1, dims=1)) for d, b in rays]
    assert float((diff - chip_smoke.beta_image(cam, moved)[0][..., None]).abs().max()) > 1e-3
