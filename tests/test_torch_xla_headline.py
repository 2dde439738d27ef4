"""The xla backend's gradients at the headline scene's scales, against the
JAX package's xla backend.

bench.py's 262,144-primitive surface scene (``synthetic.make_scene``,
bit-equal to ``bench.make_scene``) through chip_smoke's V12 configuration
on a 64x64 film of the headline camera: the gradients of all five
parameters of the L1 frame. The yardstick is JAX's xla route in f64 on the
f32 frame's shortlists (test_torch_rf_tiled_xla.jax_render64). The port in
f64 lies within 1e-4 of each maximum of it, and so does the card's
yardstick, the v1 plain version in f64 (chip_smoke.v1_plain64_frame). At these scales (splats ~0.004
wide seen from 3.2 away) q = c - b^2/a cancels, and the plain-autograd
gradients of centers, scales and quats, which pass through the quadric
feature rows, lie far from f64 in both packages' f32 runs; the port's f32
gradients are held to JAX's own: RMS deviation from f64 at most twice
JAX's, largest at most four times JAX's largest, and their projection on
the f64 gradient, <g, g64> / <g64, g64>, within chip_smoke.XLA_PROJ_TOL of
1 (JAX's lies 0.05-0.18 from 1), which a zero, shrunk, scaled or
sign-flipped gradient fails. On the card chip_smoke's phase 23 holds the
same projection."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch import interop, train
from volprim_tpu_torch.models import rf_tiled as trt
from volprim_tpu_torch.scene import CameraSpecs, look_at, synthetic

import chip_smoke
from test_torch_rf_tiled_xla import jax_state64, jax_xla64

WIDTH = 64
TIGHT = 1e-4  # the port in f64 against JAX in f64, of each maximum


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_headline_scale_gradients_match_jax():
    a = synthetic.make_scene_arrays(chip_smoke.N_PRIMS)
    keys = interop.TRAIN_KEYS
    kw = dict(chip_smoke.V12, backend="xla")
    cfg_j = jrt.RFTiledConfig(**kw)
    pose = dict(name="bench", width=WIDTH, height=WIDTH, fov=50.0)
    at = ([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0])
    cam_j = jscene.CameraSpecs(to_world=jscene.look_at(*at), **pose)
    cam_t = CameraSpecs(to_world=look_at(*at), **pose)

    def loss_j(p, f64=False):
        s = jscene.EllipsoidScene(p["centers"], p["scales"], p["quats"],
                                  {"opacities": p["opacities"], "sh_coeffs": p["sh_coeffs"]})
        if f64:
            with jax_xla64():
                img = jrt.render_state(jax_state64(s, cfg_j), cam_j, cfg_j, None, spp=1,
                                       seed=0, jitter=False)
        else:
            img = jrt.render(s, cam_j, cfg_j, None, spp=1, seed=0, jitter=False)
        return jnp.mean(jnp.abs(img))

    g_j = jax.grad(loss_j)({k: jnp.asarray(a[k]) for k in keys})
    with jax.enable_x64(True):
        g_j64 = jax.grad(lambda p: loss_j(p, True))(
            {k: jnp.asarray(a[k], jnp.float64) for k in keys})
        g_j64 = {k: np.asarray(v) for k, v in g_j64.items()}

    def port(dtype):
        params = {k: torch.tensor(a[k], dtype=dtype, requires_grad=True) for k in keys}
        cfg = trt.RFTiledConfig(**kw)
        state = trt.build_state(train.to_scene(params, None), cfg)
        if dtype == torch.float64:
            state = chip_smoke.f32_cull(state)
        img = trt.render_state(state, cam_t, cfg, None, spp=1, jitter=False)
        torch.mean(torch.abs(img)).backward()
        return {k: params[k].grad.double().numpy() for k in keys}

    g_t, g_64 = port(torch.float32), port(torch.float64)
    # chip_smoke's yardstick of phase 23, the v1 plain version in f64
    p64 = {k: torch.tensor(a[k], dtype=torch.float64, requires_grad=True) for k in keys}
    base = train.to_scene({k: torch.tensor(a[k]) for k in keys}, None)
    img = chip_smoke.v1_plain64_frame(trt, base, cam_t, trt.RFTiledConfig(**kw), 0, spp=1,
                                      params=p64, jitter=False)
    torch.mean(torch.abs(img)).backward()
    for k in keys:
        y = g_j64[k]
        scale = np.abs(y).max()
        err64 = np.abs(g_64[k] - y).max() / scale
        err_v1 = np.abs(p64[k].grad.numpy() - y).max() / scale
        assert err_v1 <= TIGHT, (k, err_v1)
        dp, dj = np.abs(g_t[k] - y) / scale, np.abs(np.asarray(g_j[k]) - y) / scale
        rms_p, rms_j = np.sqrt(np.mean(dp ** 2)), np.sqrt(np.mean(dj ** 2))
        proj_p, proj_j = (float(np.sum(g * y) / np.sum(y * y)) for g in (g_t[k], g_j[k]))
        print(f"{k}: f64 port-JAX {err64:.3g}, v1 plain-JAX {err_v1:.3g}; from JAX f64, "
              f"port max {dp.max():.3g} rms {rms_p:.3g} proj {proj_p:.4f}, "
              f"JAX max {dj.max():.3g} rms {rms_j:.3g} proj {proj_j:.4f}")
        assert err64 <= TIGHT, k
        assert np.isfinite(g_t[k]).all() and np.abs(g_t[k]).max() > 0, k
        assert rms_p <= 2.0 * rms_j, k
        assert dp.max() <= 4.0 * dj.max(), k
        assert abs(proj_p - 1.0) <= chip_smoke.XLA_PROJ_TOL, k
