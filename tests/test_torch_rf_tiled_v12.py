"""The port's rf_tiled with the v1 and v2 compositors (backend='pallas' /
'pallas2') against the JAX package: the configurations of the JAX
package's own tests (tests/test_rf_tiled.py:86-204, without the TPU knob
tile_group), jitter off.

- Frames of surface_scene(1600, seed=3) at 32x32 in every prim_resort mode
  (v1) and the default (v2). Both compositor calls are recorded: their
  opacity and SH inputs, gathered per shortlist slot straight from the
  scene's values, are equal, so both packages composite the same
  primitives in the same order; the images agree within rtol 1e-3 /
  atol 2e-3 (the JAX test's tolerance between its backends).
- Gradients of the mean squared frame in centers, opacities and sh_coeffs
  on surface_scene(800, seed=5), each normalised by the largest JAX
  gradient, within 2e-3 (v1) and 8e-3 (v2), the JAX test's tolerances.
- A scene smaller than one segment (the shortlist is padded).

Where f32 rounding at a hit edge or in the cancelling q = c - b^2 / a
moves the two packages apart by more than that (a silhouette pixel
whose edge primitive one package hits and the other misses; the centers'
gradient), the port is instead held to twice the JAX package's own
deviation from an f64 run of the port (the same scene in f64 through
build_state, its cull geometry cast to f32, which the cull takes; the
test checks that the f64 run composites the same slots), as ROADMAP.md §C
records.
"""

import dataclasses
import functools


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu.pallas_kernels import composite2 as jcomp2
from volprim_tpu.pallas_kernels import composite_vjp as jvjp
from volprim_tpu_torch import interop, train
from volprim_tpu_torch.kernels import composite2 as tcomp2
from volprim_tpu_torch.kernels import composite_vjp as tvjp
from volprim_tpu_torch.models import rf_tiled as trt
from volprim_tpu_torch.scene.ellipsoids import EllipsoidScene

from test_rf_tiled import surface_scene as _make_scene
from test_torch_rf_tiled import _cameras, _port_scene

FRAME = dict(max_depth=64, srgb_primitives=False, tile_pixels=256, max_candidates=512,
             segment=128, use_clusters=True, cluster_size=32)
# the scene factory takes ~2 ms a primitive: build each scene once (the
# frames' scene is a quarter of the JAX test's 6400 for the same reason)
surface_scene = functools.lru_cache(maxsize=None)(_make_scene)

GRAD = dict(max_depth=48, srgb_primitives=False, tile_pixels=256, max_candidates=256,
            segment=64, use_clusters=True, cluster_size=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_LOG = []


def _sink(*arrays):
    _JAX_LOG.append([np.array(x) for x in arrays])


@pytest.fixture(scope="module")
def jax_log():
    """Record the JAX compositors' (opacity, SH) inputs in _JAX_LOG: one
    wrapper per module for the whole file, through jax.debug.callback
    (rf_tiled calls them inside a scan), so that JAX's trace caches keep
    hitting from one test to the next."""
    picks = {(jvjp, "composite_tiles_ad"): (5, 6), (jcomp2, "composite_tiles2"): (2, 3)}
    with pytest.MonkeyPatch.context() as mp:
        for (module, name), idx in picks.items():
            orig = getattr(module, name)

            def wrapped(*args, _orig=orig, _idx=idx):
                jax.debug.callback(_sink, *(args[i] for i in _idx))
                return _orig(*args)

            mp.setattr(module, name, wrapped)
        yield _JAX_LOG


def _record_torch(monkeypatch, module, name, log, picks):
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        log.append([args[i].detach().numpy().copy() for i in picks])
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


def _scene64(s, params=None):
    """surface_scene ``s`` as a port scene in f64, with ``params`` (f64
    leaf tensors) in place of its arrays where given."""
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)  # noqa: E731
    base = EllipsoidScene(t(s.centers), t(s.scales), t(s.quats),
                          {k: t(v) for k, v in s.attrs.items()}, float(s.extent))
    return train.to_scene(params or {}, base)


def _render64(scene64, cam, cfg):
    """The f64 yardstick: build_state in f64, the cull geometry cast to f32."""
    st = trt.build_state(scene64, cfg)
    st = dataclasses.replace(st, **{k: getattr(st, k).float() for k in (
        "cull_centers", "cull_radii", "sup_centers", "sup_radii", "suprows")})
    return trt.render_state(st, cam, cfg, spp=1, jitter=False)


def _close_or_within_jax(got, want, yard, tol, what):
    """|got - want| <= tol, or else got deviates from the f64 ``yard`` by
    at most twice what JAX's ``want`` does (all three normalised alike)."""
    err = np.abs(got - want).max()
    if err <= tol:
        return
    port, jax_ = np.abs(got - yard).max(), np.abs(want - yard).max()
    print(f"{what}: port-JAX {err:.3g} > {tol:.3g}; from f64: port {port:.3g}, JAX {jax_:.3g}")
    assert port <= 2.0 * jax_, what


@pytest.mark.parametrize(
    "backend,resort",
    [("pallas", None), ("pallas", "entry"), ("pallas", "cluster"),
     ("pallas", "cluster-entry"), ("pallas2", None)],
)
def test_frame_matches_jax(backend, resort, monkeypatch, jax_log):
    s = surface_scene(1600, seed=3)
    cam_j, cam_t = _cameras(32, 32)
    cfg = dict(FRAME, backend=backend, prim_resort=resort)
    jax_log.clear()
    log_j, log_t = jax_log, []
    if backend == "pallas":  # (opac [T, 1, S], sh [T, S, 48])
        _record_torch(monkeypatch, tvjp, "composite_tiles_ad", log_t, (5, 6))
    else:  # (aux [T, 2, S], sh)
        _record_torch(monkeypatch, tcomp2, "composite_tiles2", log_t, (2, 3))
    img_j = np.asarray(jrt.render(s, cam_j, jrt.RFTiledConfig(**cfg), None, spp=1, seed=0,
                                  jitter=False))
    img_t = trt.render(_port_scene(s), cam_t, trt.RFTiledConfig(**cfg), spp=1, seed=0,
                       jitter=False).numpy()
    assert len(log_j) == len(log_t) == 1
    (col_j, sh_j), (col_t, sh_t) = log_j[0], log_t[0]
    assert col_t.shape == col_j.shape and col_t.shape[-1] == 512
    np.testing.assert_array_equal(col_t[:, 0], col_j[:, 0])  # opacity per slot
    np.testing.assert_array_equal(sh_t, sh_j)
    assert img_t.shape == (32, 32, 3) and np.isfinite(img_t).all() and img_t.mean() > 0.01
    np.testing.assert_allclose(img_t, img_j, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("backend,tol", [("pallas", 2e-3), ("pallas2", 8e-3)])
def test_gradients_match_jax(backend, tol):
    s = surface_scene(800, seed=5)
    cam_j, cam_t = _cameras(32, 32)
    keys = ("centers", "opacities", "sh_coeffs")

    def loss_j(p):
        s2 = jscene.EllipsoidScene(
            p["centers"], s.scales, s.quats,
            {**s.attrs, "opacities": p["opacities"], "sh_coeffs": p["sh_coeffs"]}, s.extent,
        )
        img = jrt.render(s2, cam_j, jrt.RFTiledConfig(backend=backend, **GRAD), None,
                         spp=1, seed=0, jitter=False)
        return jnp.mean(img ** 2)

    arrays = {"centers": s.centers, "opacities": s.attrs["opacities"],
              "sh_coeffs": s.attrs["sh_coeffs"]}
    g_j = jax.grad(loss_j)(arrays)
    params = interop.params_from_jax({k: np.asarray(v) for k, v in arrays.items()},
                                     device="cpu")
    cfg = trt.RFTiledConfig(backend=backend, **GRAD)
    img = train.render_cameras(train.to_scene(params, _port_scene(s)), [cam_t], cfg,
                               jitter=False)
    torch.mean(img ** 2).backward()
    p64 = {k: torch.tensor(np.asarray(v), dtype=torch.float64, requires_grad=True)
           for k, v in arrays.items()}
    torch.mean(_render64(_scene64(s, p64), cam_t, cfg) ** 2).backward()
    for k in keys:
        a, b = np.asarray(g_j[k]), params[k].grad.numpy()
        assert np.isfinite(b).all() and np.abs(a).max() > 0, k
        scale = np.abs(a).max()
        print(f"{backend} {k}: max diff / max |g| {np.abs(b - a).max() / scale:.3g}")
        _close_or_within_jax(b / scale, a / scale, p64[k].grad.numpy() / scale, tol,
                             f"{backend} {k}")


@pytest.mark.parametrize("backend", ["pallas", "pallas2"])
def test_small_scene_segment_padding(backend):
    """100 primitives (128 padded) under a 256-column segment: the
    shortlist is padded to a segment multiple, as in JAX."""
    s = surface_scene(100, seed=7)
    cam_j, cam_t = _cameras(32, 32)
    cfg = dict(max_depth=32, srgb_primitives=False, tile_pixels=256, max_candidates=4096,
               segment=256, use_clusters=True, cluster_size=32, backend=backend)
    img_j = np.asarray(jrt.render(s, cam_j, jrt.RFTiledConfig(**cfg), None, spp=1,
                                  jitter=False))
    img_t = trt.render(_port_scene(s), cam_t, trt.RFTiledConfig(**cfg), spp=1,
                       jitter=False).numpy()
    assert np.isfinite(img_t).all() and img_t.max() > 0
    img_64 = _render64(_scene64(s), cam_t, trt.RFTiledConfig(**cfg)).numpy()
    # the images' tolerance, rtol 1e-3 / atol 2e-3, as one bound on |diff|
    tol = 2e-3 + 1e-3 * np.abs(img_j).max()
    _close_or_within_jax(img_t, img_j, img_64, tol, f"{backend} image")
