"""The fused compositor's banded order correction (``order_band``) and its
per-class form (``band_classes``) in the port, against the JAX package.

- The plain forward (``composite3.forward3`` on CPU tensors) against JAX's
  ``_forward3`` (Pallas interpret mode) on numpy-made tiles, with the band
  at 0, 8 and 16 lanes, compaction off and on: L and beta within atol 2e-5
  / rtol 2e-4 (the tolerance of test_torch_composite3.py: JAX builds its
  prefix sums from bf16 hi/lo parts with triangular matmuls and moves
  compacted columns through a bf16x3 one-hot product), and the stream's
  segment count ``live`` equal to JAX's column 5.
- The plain backward against ``jax.vjp`` of ``composite_tiles3_ad`` with the
  band: per row of gpf the port's deviation from an f64 run of the plain
  backward is at most twice JAX's own, plus 1e-5 of the row's largest
  value (the rule of test_torch_composite3_bwd.py), except in the u rows
  6-8: their exact value is 0 at the closest approach, so both f32
  versions give rounding noise there (~1e-7 against ~30 in the w rows),
  and with the band the port's sequential f32 prefix sums put its noise at
  up to 2.3x JAX's hi/lo-split sums (ROADMAP.md §C); those rows are held to
  four times JAX's deviation, the factor chip_smoke.py's GRAD_BAND gives
  two f32 versions of the same noise. gsh within one bf16 ulp of its
  largest value.
- ``rf_tiled`` frames of ``surface_scene(6400, seed=3)`` at 64x64 with
  ``order_band=16`` (compaction off and on) and with ``band_classes``
  against JAX's fused frames within 1e-5, and the three properties of
  tests/test_rf_tiled.py::test_band_classes_per_class on the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu.pallas_kernels import composite3 as jcomp
from volprim_tpu_torch.kernels import composite3 as tcomp
from volprim_tpu_torch.models import rf_tiled as trt

from test_rf_tiled import surface_scene as _make_scene
from test_torch_composite3_bwd import _assert_gsh_close
from test_torch_rf_tiled import _cameras, _port_scene

T, R, S, SEG, SH_K = 4, 64, 512, 128, 4
KW = dict(seg=SEG, extent2=9.0, max_depth=24, beta_kill=0.01)
# the scene factory takes ~2 ms a primitive: build the scene once
surface_scene = functools.lru_cache(maxsize=None)(_make_scene)
FRAME = dict(max_depth=64, srgb_primitives=False, tile_pixels=256, max_candidates=512,
             segment=128, use_clusters=True, cluster_size=16, backend="fused")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_gpf_close(got, want, yardstick):
    """Per row of gpf, ``got`` deviates from the f64 ``yardstick`` by at
    most twice what ``want`` (the JAX kernel) does (four times in the u
    rows 6-8, see the module docstring), plus 1e-5 of the row's largest
    yardstick value."""
    err_got = np.max(np.abs(got - yardstick), axis=(0, 2))
    err_want = np.max(np.abs(want - yardstick), axis=(0, 2))
    scale = np.max(np.abs(yardstick), axis=(0, 2))
    factor = np.full(err_got.shape, 2.0)
    factor[6:9] = 4.0
    print("gpf rows: port err", err_got, "JAX err", err_want, "scale", scale)
    assert np.all(err_got <= factor * err_want + 1e-5 * scale)


def _tiles():
    d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(T, R, S, SEG, SH_K, seed=5)
    jx = (jnp.asarray(d8.numpy()), jnp.asarray(pf.numpy()),
          jnp.asarray(sh3.float().numpy()).astype(jnp.bfloat16), jnp.asarray(n_seg_t.numpy()))
    return (d8, pf, sh3, n_seg_t), jx


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("band", [0, 8, 16])
def test_band_forward_matches_jax(band, compact):
    (d8, pf, sh3, n_seg_t), jx = _tiles()
    out = np.asarray(jcomp._forward3(
        *jx, SEG, KW["extent2"], KW["max_depth"], KW["beta_kill"], 1, SH_K,
        False, True, True, 1, compact, False, band,
    ))
    l_t, b_t, walked, live = tcomp.forward3(
        d8, pf, sh3, n_seg_t, sh_k=SH_K, compact=compact, order_band=band, **KW
    )
    np.testing.assert_array_equal(live.numpy(), out[:, 0, 5].astype(np.int32))
    if compact:  # the mask drops columns, and shifts the later ones' lanes
        assert not tcomp.column_keep(d8, pf).all()
    assert walked.dtype == torch.int32 and (walked <= live).all()
    np.testing.assert_allclose(l_t.numpy(), out[..., :3], atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(b_t.numpy(), out[..., 3], atol=2e-5, rtol=2e-4)
    if band:  # the correction moves the image
        l_0 = tcomp.composite_tiles3_reference(d8, pf, sh3, n_seg_t, sh_k=SH_K,
                                               compact=compact, **KW)[0]
        assert float((l_0 - l_t).abs().max()) > 1e-2


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("band", [8, 16])
def test_band_backward_matches_jax_vjp(band, compact):
    (d8, pf, sh3, n_seg_t), jx = _tiles()
    rng = np.random.default_rng(band)
    g_l = torch.from_numpy(rng.normal(0.0, 1.0, (T, R, 3)).astype(np.float32))
    g_beta = torch.from_numpy(rng.normal(0.0, 1.0, (T, R)).astype(np.float32))

    def fwd(pf_, sh_):
        return jcomp.composite_tiles3_ad(
            jx[0], pf_, sh_, jx[3], SEG, KW["extent2"], KW["max_depth"], KW["beta_kill"],
            1, SH_K, False, True, True, 1, compact, False, band,
        )

    _, vjp = jax.vjp(fwd, jx[1], jx[2])
    gpf_j, gsh_j = vjp((jnp.asarray(g_l.numpy()), jnp.asarray(g_beta.numpy())))
    gpf_j, gsh_j = np.asarray(gpf_j), np.asarray(gsh_j.astype(jnp.float32))
    args = dict(sh_k=SH_K, compact=compact, order_band=band, **KW)
    gpf_b, gsh_b = tcomp.composite_tiles3_bwd_reference(d8, pf, sh3, n_seg_t, g_l, g_beta,
                                                        **args)
    gpf_64, _ = tcomp.composite_tiles3_bwd_reference(
        d8.double(), pf.double(), sh3, n_seg_t, g_l, g_beta, **args
    )
    assert np.isfinite(gpf_b.numpy()).all() and not gpf_b[:, 13:].any()
    _assert_gpf_close(gpf_b.numpy(), gpf_j, gpf_64.numpy())
    _assert_gsh_close(gsh_b.float().numpy(), gsh_j)
    # the band moves the gradients
    gpf_0, _ = tcomp.composite_tiles3_bwd_reference(
        d8, pf, sh3, n_seg_t, g_l, g_beta, **{**args, "order_band": 0}
    )
    assert float((gpf_0 - gpf_b).abs().max()) > 1e-3 * float(gpf_b.abs().max())
    # autograd through the wrapper takes the plain backward
    pf_leaf = pf.clone().requires_grad_(True)
    sh_leaf = sh3.clone().requires_grad_(True)
    l, b = tcomp.composite_tiles3(d8, pf_leaf, sh_leaf, n_seg_t, **args)
    (torch.sum(l * g_l) + torch.sum(b * g_beta)).backward()
    assert torch.equal(pf_leaf.grad, gpf_b) and torch.equal(sh_leaf.grad, gsh_b)


def _frames(jax_too=True, **extra):
    """The port's frame of ``surface_scene(6400, seed=3)`` at 64x64 with
    FRAME and ``extra``, held to JAX's within 1e-5 when ``jax_too``."""
    s = surface_scene(6400, seed=3)
    cam_j, cam_t = _cameras(64, 64)
    img_t = trt.render(_port_scene(s), cam_t, trt.RFTiledConfig(**FRAME, **extra),
                       spp=1, seed=0, jitter=False).numpy()
    assert np.isfinite(img_t).all()
    if jax_too:
        img_j = np.asarray(jrt.render(s, cam_j, jrt.RFTiledConfig(**FRAME, **extra), None,
                                      spp=1, seed=0, jitter=False))
        np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    return img_t


@pytest.mark.parametrize("compact", [False, True])
def test_band_frame_matches_jax(compact):
    img = _frames(order_band=16, kernel_compact=compact)
    img_0 = _frames(jax_too=False, kernel_compact=compact)
    assert np.abs(img - img_0).max() > 1e-3


def test_band_classes_per_class():
    """The port's band_classes against JAX's frames, with the properties of
    the JAX test: uniform per-class bands reproduce the global band, a band
    on the deepest-need class alone changes a subset of the pixels the
    global band changes, and None inherits order_band (the last two
    properties on the port's frames alone)."""
    classes = dict(budget_classes=((0.5, 16), (0.5, 32)))
    img_b0 = _frames(order_band=0, **classes)
    img_b8 = _frames(order_band=8, **classes)
    img_uniform = _frames(jax_too=False, order_band=0, band_classes=(8, 8), **classes)
    np.testing.assert_allclose(img_uniform, img_b8, atol=1e-6)
    img_top = _frames(order_band=0, band_classes=(0, 8), **classes)
    d_top = np.abs(img_top - img_b0) > 1e-7
    d_all = np.abs(img_b8 - img_b0) > 1e-7
    assert 0 < d_top.sum() <= d_all.sum()
    img_inherit = _frames(jax_too=False, order_band=8, band_classes=(None, 8), **classes)
    np.testing.assert_allclose(img_inherit, img_b8, atol=1e-6)


def test_band_classes_need_budget_classes():
    with pytest.raises(ValueError, match="band_classes"):
        trt.build_state(_port_scene(surface_scene(400, seed=0)),
                        trt.RFTiledConfig(**FRAME, band_classes=(8,)))
    with pytest.raises(ValueError, match="band_classes"):
        trt._check_config(trt.RFTiledConfig(
            **FRAME, budget_classes=((0.5, 16), (0.5, 32)), band_classes=(8, 8, 8)))
    with pytest.raises(ValueError, match="order_band"):
        d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(1, 32, 256, 128, 1, seed=3)
        tcomp._launch(d8, pf, sh3, n_seg_t, 128, 9.0, 128, 0.01, 1, False,
                      tcomp.MAX_BAND + 1)
