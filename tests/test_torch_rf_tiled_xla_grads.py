"""The gradients of the port's xla backend against the JAX package's:
all five parameters of the mean squared frame of surface_scene(800,
seed=5) at 32x32 against jax.grad, each normalised by the largest JAX
gradient. The port in f64 lies within 1e-4 of JAX's xla route in f64
(jax.grad of :func:`jax_render64`'s frame); the port in f32 within 1e-4 of
JAX in f32, or else, where q = c - b^2/a cancels, its RMS deviation and
its largest from JAX in f64 at most twice JAX's f32 gradient's. The
card's yardstick of the same route, the v1 plain version in f64
(chip_smoke.v1_plain64_frame), is held to JAX in f64 too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch import interop, train
from volprim_tpu_torch.models import rf_tiled as trt

import chip_smoke
from test_torch_rf_tiled import _cameras, _port_scene
from test_torch_rf_tiled_xla import (  # noqa: F401 (the thread fixture)
    _one_thread, _render64, _scene64, hold_to_jax, jax_render64, jax_scene64, jax_state64,
    jax_xla64, surface_scene,
)

GRAD = dict(max_depth=48, srgb_primitives=False, tile_pixels=256, max_candidates=256,
            segment=64, use_clusters=True, cluster_size=32, tile_group=2)
GRAD_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """The scene's five arrays and jax.grad of the mean squared frame
    through JAX's xla route, in f32 and in f64 (:func:`jax_render64`)."""
    s = surface_scene(800, seed=5)
    cam_j = _cameras(32, 32)[0]
    arrays = {"centers": s.centers, "scales": s.scales, "quats": s.quats,
              "opacities": s.attrs["opacities"], "sh_coeffs": s.attrs["sh_coeffs"]}
    cfg_j = jrt.RFTiledConfig(backend="xla", **GRAD)

    def loss_j(p, f64=False):
        if f64:
            with jax_xla64():
                img = jrt.render_state(jax_state64(jax_scene64(s, p), cfg_j), cam_j, cfg_j,
                                       None, spp=1, seed=0, jitter=False)
        else:
            s2 = type(s)(p["centers"], p["scales"], p["quats"],
                         {**s.attrs, "opacities": p["opacities"],
                          "sh_coeffs": p["sh_coeffs"]}, s.extent)
            img = jrt.render(s2, cam_j, cfg_j, None, spp=1, seed=0, jitter=False)
        return jnp.mean(img ** 2)

    g_j = {k: np.asarray(v) for k, v in jax.grad(loss_j)(arrays).items()}
    with jax.enable_x64(True):
        g_j64 = jax.grad(lambda p: loss_j(p, True))(
            {k: jnp.asarray(v, jnp.float64) for k, v in arrays.items()})
        g_j64 = {k: np.asarray(v) for k, v in g_j64.items()}
    return {k: np.asarray(v) for k, v in arrays.items()}, g_j, g_j64


def test_xla_gradients_match_jax():
    """All five parameters, the mean squared frame, against jax.grad."""
    s = surface_scene(800, seed=5)
    cam_t = _cameras(32, 32)[1]
    arrays, g_j, g_j64 = _jax_grads()
    params = interop.params_from_jax(arrays, device="cpu")
    cfg = trt.RFTiledConfig(backend="xla", **GRAD)
    img = train.render_cameras(train.to_scene(params, _port_scene(s)), [cam_t], cfg,
                               jitter=False)
    torch.mean(img ** 2).backward()
    p64 = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
           for k, v in arrays.items()}
    torch.mean(_render64(_scene64(s, p64), cam_t, cfg) ** 2).backward()
    for k in interop.TRAIN_KEYS:
        a, b = g_j[k], params[k].grad.numpy()
        assert np.isfinite(b).all() and np.abs(b).max() > 0, k
        scale = np.abs(a).max()
        print(f"xla {k}: max diff / max |g| {np.abs(b - a).max() / scale:.3g}")
        hold_to_jax(b / scale, a / scale, p64[k].grad.numpy() / scale, g_j64[k] / scale,
                    GRAD_TOL, f"xla gradient {k}", max_factor=2.0)


def test_v1_plain64_yardstick_matches_jax_f64():
    """chip_smoke's yardstick of the xla route on the card, the v1 plain
    version in f64 on the f32 shortlists (chip_smoke.v1_plain64_frame),
    is JAX's xla route in f64: its gradients within 1e-4 of each maximum
    of jax.grad's in f64, and its frame within 1e-5 of JAX's f64 frame."""
    s = surface_scene(800, seed=5)
    cam_j, cam_t = _cameras(32, 32)
    arrays, _, g_j64 = _jax_grads()
    p64 = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
           for k, v in arrays.items()}
    cfg = trt.RFTiledConfig(backend="xla", **GRAD)
    img = chip_smoke.v1_plain64_frame(trt, _port_scene(s), cam_t, cfg, 0, spp=1, params=p64,
                                      jitter=False)
    torch.mean(img ** 2).backward()
    want = jax_render64(s, cam_j, dict(GRAD, backend="xla"))
    assert np.abs(img.detach().numpy() - want).max() <= 1e-5
    for k in interop.TRAIN_KEYS:
        y = g_j64[k]
        err = np.abs(p64[k].grad.numpy() - y).max() / np.abs(y).max()
        print(f"v1 plain f64 {k}: from JAX f64 {err:.3g}")
        assert err <= GRAD_TOL, k
