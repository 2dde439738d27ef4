"""The port's exact-order integrator with the Epanechnikov kernel and with
emitters, and ``models.render_batch``, against the JAX package.

- ``rf.radiance`` on surface_scene(400) with its primitives scaled 4x (as
  test_torch_rf_tiled's exact-path test: at their own scales q = c - b^2/a
  cancels so that each package lies ~5e-4 from f64), 32x32 unjittered
  rays: the Epanechnikov kernel, a ConstantEmitter and the procedural sky
  (an EnvironmentMap), each within atol 1e-4 of JAX.
- ``render_batch``: its rays (``batch_rays``) against JAX's
  ``rays_from_pixels`` per camera on the same film coordinates (atol 1e-6),
  and the wide-film layout against JAX's render_batch with a radiance
  function that lights each camera's rays by its origin alone (no jitter
  dependence): camera i fills columns [i W, (i + 1) W) in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import models as jmodels
from volprim_tpu import scene as jscene
from volprim_tpu.models import rf as jrf
from volprim_tpu.ops import envmap as jenv
from volprim_tpu.scene import cameras as jcameras
from volprim_tpu_torch import models as tmodels
from volprim_tpu_torch import scene as tscene
from volprim_tpu_torch.models import base as tbase
from volprim_tpu_torch.models import rf as trf
from volprim_tpu_torch.ops import envmap as tenv

from test_rf_tiled import surface_scene
from test_torch_rf_tiled import _cameras, _port_scene


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emitters(kind):
    if kind is None:
        return None, None
    if kind == "constant":
        rgb = (0.3, 0.6, 0.9)
        return jenv.ConstantEmitter(radiance=jnp.asarray(rgb)), tenv.ConstantEmitter(
            radiance=torch.tensor(rgb))
    return jenv.procedural_sky(32, 64), tenv.procedural_sky(32, 64, device="cpu")


@pytest.mark.parametrize("kernel,emitter", [("epanechnikov", None), ("gaussian", "constant"),
                                            ("epanechnikov", "sky")])
def test_exact_radiance_matches_jax(kernel, emitter):
    s = surface_scene(400)
    s = dataclasses.replace(s, scales=s.scales * 4.0)
    cam_j, cam_t = _cameras(32, 32)
    em_j, em_t = _emitters(emitter)
    cfg = dict(max_depth=64, srgb_primitives=True, chunk_size=128, kernel_type=kernel)
    o, d = jscene.generate_rays(cam_j, jitter=False)
    ref = np.asarray(jrf.radiance(s, em_j, o, d, jrf.RFConfig(**cfg), jax.random.PRNGKey(0)))
    ot, dt = tscene.generate_rays(cam_t, jitter=False, device="cpu")
    got = trf.radiance(_port_scene(s), em_t, ot, dt, trf.RFConfig(**cfg)).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.01
    np.testing.assert_allclose(got, ref, atol=1e-4)
    if emitter is not None:  # the emitter lit something the primitives left
        bare = trf.radiance(_port_scene(s), None, ot, dt, trf.RFConfig(**cfg)).numpy()
        assert (got - bare).max() > 0.05


def _cams(n, width=16, height=12):
    pose = dict(width=width, height=height, fov=50.0)
    out_j, out_t = [], []
    for i in range(n):
        at = ([0.5 * i - 1.0, 0.3, -3.0], [0, 0, 0], [0, 1, 0])
        out_j.append(jscene.CameraSpecs(name=f"c{i}", to_world=jscene.look_at(*at), **pose,
                                        cx=0.5 * i))
        out_t.append(tscene.CameraSpecs(name=f"c{i}", to_world=tscene.look_at(*at), **pose,
                                        cx=0.5 * i))
    return out_j, out_t


def test_batch_rays_match_jax_per_camera():
    cams_j, cams_t = _cams(3)
    rng = np.random.default_rng(0)
    r = 16 * 12
    px = np.float32(rng.uniform(0, 16, (3, r)))
    py = np.float32(rng.uniform(0, 12, (3, r)))
    o, d = tbase.batch_rays(cams_t, torch.from_numpy(px), torch.from_numpy(py))
    for i, cam in enumerate(cams_j):
        oj, dj = jcameras.rays_from_pixels(cam, px[i], py[i])
        np.testing.assert_allclose(o[i * r:(i + 1) * r].numpy(), np.asarray(oj), atol=1e-6)
        np.testing.assert_allclose(d[i * r:(i + 1) * r].numpy(), np.asarray(dj), atol=1e-6)


def test_render_batch_wide_film_matches_jax():
    cams_j, cams_t = _cams(3)

    def by_origin_j(prims, emitter, o, d, cfg, key):
        return jnp.stack([o[:, 0] + 2.0, o[:, 1], jnp.ones_like(o[:, 0])], axis=-1)

    def by_origin_t(prims, emitter, o, d, cfg, gen):
        return torch.stack([o[:, 0] + 2.0, o[:, 1], torch.ones_like(o[:, 0])], dim=-1)

    s = surface_scene(64)
    img_j = np.asarray(jmodels.render_batch(s, cams_j, by_origin_j, None, spp=2, seed=0))
    gen = torch.Generator()
    gen.manual_seed(0)
    img_t = tmodels.render_batch(_port_scene(s), cams_t, by_origin_t, None, spp=2,
                                 generator=gen).numpy()
    assert img_t.shape == img_j.shape == (12, 48, 3)
    np.testing.assert_allclose(img_t, img_j, atol=1e-6)
    for i in range(3):  # camera i's block holds its own origin
        np.testing.assert_allclose(img_t[:, 16 * i:16 * (i + 1), 0], 0.5 * i + 1.0, atol=1e-6)


def test_render_batch_radiance_and_arguments():
    s = _port_scene(surface_scene(400))
    _, cams_t = _cams(2)
    gen = torch.Generator()
    gen.manual_seed(1)
    img = tmodels.render_batch(s, cams_t, trf.radiance, trf.RFConfig(max_depth=32), None,
                               spp=1, generator=gen)
    assert img.shape == (12, 32, 3) and bool(torch.isfinite(img).all()) and img.mean() > 0
    with pytest.raises(ValueError, match="Generator"):
        tmodels.render_batch(s, cams_t, trf.radiance, trf.RFConfig(), None, 1)
    odd = [cams_t[0], dataclasses.replace(cams_t[1], width=8)]
    with pytest.raises(ValueError, match="one film size"):
        tmodels.render_batch(s, odd, trf.radiance, trf.RFConfig(), None, 1, generator=gen)
