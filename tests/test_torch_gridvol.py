"""The port's grid volumes (volprim_tpu_torch.scene.vol) and their
renderers (models/gridvol.py) against the JAX package's.

- ``GridVolume.sample`` at random points, inside, outside and on the
  bbox faces: within 1e-6 of JAX's.
- ``procedural_smoke`` bit-equal; ``.vol`` files byte-identical both ways,
  and each package loads the other's file to the same arrays.
- ``gridvol.radiance`` (the absorption marcher) and ``_transmittance`` on
  the same rays: rtol 1e-5. ``transform_grid`` equal.
- The scattering path tracer draws from a torch.Generator, so it is held
  in distribution: the furnace (a uniform grid at albedo 1 returns the
  emitter, mean within 0.03 of 1) and the absorbing limit (albedo 0: the
  mean equals the marcher's within 0.015), tests/test_tomography.py's two
  checks, and its image mean against JAX's within 4 standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.models import gridvol as jgv
from volprim_tpu.ops import envmap as jenv
from volprim_tpu.scene import vol as jvol
from volprim_tpu_torch import interop
from volprim_tpu_torch.models import gridvol as tgv
from volprim_tpu_torch.ops import envmap as tenv
from volprim_tpu_torch.scene import vol as tvol


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_grids(data, lo=(-1.0, -1.0, -1.0), hi=(1.0, 1.0, 1.0)):
    data = np.asarray(data, np.float32)
    return (jvol.GridVolume(jnp.asarray(data), jnp.asarray(lo, jnp.float32),
                            jnp.asarray(hi, jnp.float32)),
            interop.grid_from_arrays(data, lo, hi, device="cpu"))


def random_grid(seed=0, shape=(6, 7, 5, 2)):
    return np.random.default_rng(seed).uniform(0.1, 0.9, size=shape).astype(np.float32)


def test_sample_matches_jax():
    jg, tg = both_grids(random_grid(), lo=(-1.0, -0.5, 0.0), hi=(1.0, 1.5, 0.5))
    rng = np.random.default_rng(1)
    lo, hi = np.asarray([-1.0, -0.5, 0.0]), np.asarray([1.0, 1.5, 0.5])
    inside = lo + (hi - lo) * rng.uniform(0.0, 1.0, size=(400, 3))
    outside = lo + (hi - lo) * rng.uniform(-0.5, 1.5, size=(400, 3))
    faces = inside.copy()
    for k in range(3):  # points on each face and on the corners
        faces[k * 100:(k + 1) * 100, k] = np.where(np.arange(100) % 2, lo[k], hi[k])
    corners = np.stack(np.meshgrid(*zip(lo, hi), indexing="ij"), -1).reshape(-1, 3)
    p = np.concatenate([inside, outside, faces, corners]).astype(np.float32)
    want = np.asarray(jg.sample(jnp.asarray(p)))
    got = tg.sample(torch.from_numpy(p)).numpy()
    assert got.shape == (p.shape[0], 2)
    assert (got[400:800] == 0.0).any() and (got[800:] != 0.0).all()  # faces are inside
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    # a [..., 3] batch keeps its leading dims
    assert tg.sample(torch.from_numpy(p[:12].reshape(3, 4, 3))).shape == (3, 4, 2)


def test_procedural_smoke_bit_equal():
    for res, seed in ((48, 0), (16, 3)):
        j, t = jvol.procedural_smoke(res, seed), tvol.procedural_smoke(res, seed, device="cpu")
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.bbox_min.numpy(), np.asarray(j.bbox_min))
        np.testing.assert_array_equal(t.bbox_max.numpy(), np.asarray(j.bbox_max))
    assert t.resolution == (16, 16, 16) and t.device == torch.device("cpu")


def test_vol_files_across_packages(tmp_path):
    jg, tg = both_grids(random_grid(2), lo=(-0.5, -1.0, -0.5), hi=(0.5, 1.0, 0.5))
    jf, tf = tmp_path / "jax.vol", tmp_path / "port.vol"
    jvol.save_vol(jg, str(jf))
    tvol.save_vol(tg, str(tf))
    assert tf.read_bytes() == jf.read_bytes()
    for f in (jf, tf):
        back = tvol.load_vol(str(f), device="cpu")
        want = jvol.load_vol(str(f))
        np.testing.assert_array_equal(back.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(back.bbox_max.numpy(), np.asarray(want.bbox_max))
        np.testing.assert_array_equal(back.bbox_min.numpy(), np.asarray(want.bbox_min))
    (tmp_path / "bad.vol").write_bytes(b"VOX" + jf.read_bytes()[3:])
    with pytest.raises(ValueError, match="not a .vol"):
        tvol.load_vol(str(tmp_path / "bad.vol"), device="cpu")


def _rays(n, seed, spread=0.3):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray([[0.0, 0.0, -3.0]], np.float32), (n, 1))
    o[: n // 4] = [0.2, 3.0, -3.0]  # a quarter of the rays miss the bbox
    d = rng.normal(size=(n, 3)) * spread + [0.0, 0.0, 1.0]
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_transform_grid_and_marchers_match_jax():
    smoke_j, smoke_t = jvol.procedural_smoke(16), tvol.procedural_smoke(16, device="cpu")
    cfg_j, cfg_t = jgv.GridVolumeConfig(num_steps=64, shadow_steps=48), tgv.GridVolumeConfig(
        num_steps=64, shadow_steps=48)
    gj, gt = jgv.transform_grid(smoke_j, cfg_j), tgv.transform_grid(smoke_t, cfg_t)
    np.testing.assert_array_equal(gt.bbox_min.numpy(), np.asarray(gj.bbox_min))
    np.testing.assert_array_equal(gt.bbox_max.numpy(), np.asarray(gj.bbox_max))
    o, d = _rays(512, 3)
    emit = np.asarray([0.9, 0.7, 0.5], np.float32)
    for em_j, em_t in ((jenv.ConstantEmitter(radiance=jnp.asarray(emit)),
                        tenv.ConstantEmitter(radiance=torch.from_numpy(emit))), (None, None)):
        want = np.asarray(jgv.radiance(gj, em_j, jnp.asarray(o), jnp.asarray(d), cfg_j))
        got = tgv.radiance(gt, em_t, torch.from_numpy(o), torch.from_numpy(d), cfg_t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got.min() < 0.5 * got.max()  # the plume absorbs
    want = np.asarray(jgv._transmittance(gj, jnp.asarray(o), jnp.asarray(d), cfg_j))
    got = tgv._transmittance(gt, torch.from_numpy(o), torch.from_numpy(d), cfg_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got[:128] == 1.0).sum() >= 64 and got.min() < 0.5  # misses and hits


def _cfg(mod, **kw):
    return mod.GridVolumeConfig(**kw)


def test_scattering_furnace():
    """A uniform grid at albedo 1 under a unit emitter returns the emitter."""
    data = np.full((8, 8, 8, 1), 0.8, np.float32)
    _, g = both_grids(data)
    cfg = _cfg(tgv, sigma_scale=3.0, albedo=1.0, bounce_cap=64, tracking_steps=64,
               shadow_steps=64)
    n = 4096
    o = torch.tensor([[0.0, 0.0, -3.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    gen = torch.Generator().manual_seed(0)
    out = tgv.radiance_scattering(g, tenv.ConstantEmitter(radiance=torch.ones(3)), o, d, cfg,
                                  gen).numpy()
    assert np.isfinite(out).all()
    assert abs(out[:, 0].mean() - 1.0) < 0.03, out[:, 0].mean()


def test_scattering_absorbing_limit():
    """Albedo 0: the path tracer's mean is the absorption marcher's."""
    data = np.random.default_rng(0).uniform(0.1, 0.9, size=(6, 6, 6, 1)).astype(np.float32)
    _, g = both_grids(data)
    cfg = _cfg(tgv, sigma_scale=2.0, albedo=0.0, bounce_cap=8, tracking_steps=96,
               num_steps=256)
    n = 8192
    o = torch.tensor([[0.0, 0.0, -3.0]]).repeat(n, 1)
    dd = np.random.default_rng(1).normal(size=(n, 3)) * 0.1 + [0, 0, 1.0]
    d = torch.from_numpy((dd / np.linalg.norm(dd, axis=-1, keepdims=True)).astype(np.float32))
    em = tenv.ConstantEmitter(radiance=torch.ones(3))
    mc = tgv.radiance_scattering(g, em, o, d, cfg, torch.Generator().manual_seed(1)).numpy()
    ref = tgv.radiance(g, em, o, d, cfg).numpy()
    assert abs(mc[:, 0].mean() - ref[:, 0].mean()) < 0.015


def test_scattering_mean_matches_jax():
    """The scattering radiance of the smoke plume on the same 4096 rays:
    per-channel means within 4 standard errors of their difference."""
    smoke_j, smoke_t = jvol.procedural_smoke(16), tvol.procedural_smoke(16, device="cpu")
    kw = dict(bounce_cap=8, tracking_steps=48, shadow_steps=32)
    cfg_j, cfg_t = _cfg(jgv, **kw), _cfg(tgv, **kw)
    gj, gt = jgv.transform_grid(smoke_j, cfg_j), tgv.transform_grid(smoke_t, cfg_t)
    o, d = _rays(4096, 5, spread=0.15)
    want = np.asarray(jgv.radiance_scattering(
        gj, jenv.ConstantEmitter(radiance=jnp.ones(3)), jnp.asarray(o), jnp.asarray(d), cfg_j,
        jax.random.PRNGKey(2)))
    got = tgv.radiance_scattering(gt, tenv.ConstantEmitter(radiance=torch.ones(3)),
                                  torch.from_numpy(o), torch.from_numpy(d), cfg_t,
                                  torch.Generator().manual_seed(2)).numpy()
    assert np.isfinite(got).all() and got.shape == (4096, 3)
    se = np.sqrt(got.var(0) / len(got) + want.var(0) / len(want))
    assert np.all(np.abs(got.mean(0) - want.mean(0)) <= 4.0 * se), (got.mean(0), want.mean(0))
    # the misses (a quarter of the rays) see the emitter alone
    np.testing.assert_allclose(got[:1024], 1.0)


def test_scattering_needs_a_generator():
    _, g = both_grids(np.ones((2, 2, 2, 1)))
    with pytest.raises(ValueError, match="Generator"):
        tgv.radiance_scattering(g, tenv.ConstantEmitter(radiance=torch.ones(3)),
                                torch.zeros(1, 3), torch.ones(1, 3), tgv.GridVolumeConfig())
