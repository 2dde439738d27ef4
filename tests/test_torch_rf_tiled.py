"""The port's render path as a whole against the JAX package.

The headline-shaped configuration at test size (two-level cull, five
need-ordered budget classes, kernel compaction, cluster sort, 2 spp folded
into one walk) renders the same scene in both packages. Both sides are
instrumented at their shortlist and compositor calls, so the test shows
that every cull selects the same ids, that every budget class holds the
same tiles in the same order with the same packed inputs, and that the
images agree within atol 1e-4 / rtol 1e-3."""

import jax
import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu.accel import tiles as jtiles
from volprim_tpu.models import rf as jrf
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu.pallas_kernels import composite3 as jcomp
from volprim_tpu_torch import interop, parallel
from volprim_tpu_torch import scene as tscene
from volprim_tpu_torch.accel import tiles as ttiles
from volprim_tpu_torch.kernels import composite3 as tcomp
from volprim_tpu_torch.models import rf as trf
from volprim_tpu_torch.models import rf_tiled as trt

from test_rf_tiled import surface_scene

# bench.py's headline (max_depth 128, cluster_size 16, coarse_group 4,
# coarse_factor 8, super_group 4, compact, cluster_sort, spp 2) with the
# film, tiles and budgets scaled to a 6400-primitive scene
HEADLINE_AT_TEST_SIZE = dict(
    max_depth=128, tile_pixels=64, max_candidates=256, segment=128,
    cluster_size=16, backend="fused", early_exit=True,
    coarse_group=4, coarse_factor=8, super_group=4,
    budget_classes=((0.35, 16), (0.3, 24), (0.2, 36), (0.1, 48), (0.05, 64)),
    kernel_compact=True, cluster_sort=True,
)


def _port_scene(s):
    return interop.scene_from_arrays(
        np.asarray(s.centers), np.asarray(s.scales), np.asarray(s.quats),
        {k: np.asarray(v) for k, v in s.attrs.items()}, s.extent, device="cpu",
    )


def _cameras(width, height):
    pose = dict(name="c", width=width, height=height, fov=45.0)
    at = ([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0])
    return (
        jscene.CameraSpecs(to_world=jscene.look_at(*at), **pose),
        tscene.CameraSpecs(to_world=tscene.look_at(*at), **pose),
    )


def _recorder(monkeypatch, module, name, log, to_numpy):
    """Wrap module.name so each call appends (array args, outputs) to log."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        arrays = [to_numpy(a) for a in args if hasattr(a, "dtype")]
        log.append((arrays, [to_numpy(o) for o in out]))
        return out

    monkeypatch.setattr(module, name, wrapped)


def test_headline_path_matches_jax(monkeypatch):
    s = surface_scene(6400, seed=3)
    cam_j, cam_t = _cameras(64, 64)
    jnp_ = lambda x: np.asarray(x, np.float32) if x.dtype != bool else np.asarray(x)  # noqa: E731
    tnp = lambda x: x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()  # noqa: E731
    sl_j, sl_t, cp_j, cp_t = [], [], [], []
    _recorder(monkeypatch, jtiles, "shortlist", sl_j, jnp_)
    _recorder(monkeypatch, ttiles, "shortlist", sl_t, tnp)
    _recorder(monkeypatch, jcomp, "composite_tiles3_ad", cp_j, jnp_)
    _recorder(monkeypatch, tcomp, "composite_tiles3", cp_t, tnp)

    img_j = np.asarray(
        jrt.render(s, cam_j, jrt.RFTiledConfig(**HEADLINE_AT_TEST_SIZE), None,
                   spp=2, seed=0, jitter=False)
    )
    img_t = trt.render(
        _port_scene(s), cam_t, trt.RFTiledConfig(**HEADLINE_AT_TEST_SIZE),
        spp=2, seed=0, jitter=False,
    ).numpy()

    # shortlists: the strip supercluster cull, then one per budget class
    assert len(sl_t) == len(sl_j) == 1 + 5
    for ([keys_t], (ids_t, val_t)), ([keys_j], (ids_j, val_j)) in zip(sl_t, sl_j):
        np.testing.assert_array_equal(np.isfinite(keys_t), np.isfinite(keys_j))
        np.testing.assert_array_equal(val_t, val_j)
        np.testing.assert_array_equal(ids_t[val_j], ids_j[val_j])
    # budget classes: one launch each (spp 2 folds into one walk), the same
    # tiles in the same order (their ray blocks), the same live segments
    # and packed columns
    assert len(cp_t) == len(cp_j) == 5
    for ((d8_t, pf_t, sh_t, nseg_t), _), ((d8_j, pf_j, sh_j, nseg_j), _) in zip(
        cp_t, cp_j
    ):
        assert d8_t.shape == d8_j.shape and d8_t.shape[2] == 2 * 64
        np.testing.assert_allclose(d8_t[:, :7], d8_j[:, :7], atol=1e-6)
        # row 7, sin(half-angle) = sqrt(1 - cos^2), magnifies the last-bit
        # difference of the cosine ~10x at these narrow cones
        np.testing.assert_allclose(d8_t[:, 7], d8_j[:, 7], atol=1e-5)
        np.testing.assert_array_equal(nseg_t, nseg_j)
        np.testing.assert_array_equal(sh_t, sh_j)
        np.testing.assert_allclose(pf_t, pf_j, rtol=1e-5, atol=1e-5)
    assert [c[0][0].shape[0] for c in cp_t] == [22, 19, 13, 6, 4]

    assert img_t.shape == (64, 64, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0.01
    np.testing.assert_allclose(img_t, img_j, atol=1e-4, rtol=1e-3)


def test_exact_radiance_matches_jax():
    """The exact-order oracle, atol 1e-4. The shell's primitives are scaled
    4x: at their own scales (0.02-0.08 seen from 3.5 away) the exact path's
    q_min = c - b^2/a cancels so hard that each package is ~5e-4 from a
    float64 run of the same algorithm, and XLA's FMA contraction versus
    torch's separate roundings decides which way."""
    import dataclasses

    s = surface_scene(400)
    s = dataclasses.replace(s, scales=s.scales * 4.0)
    cam_j, cam_t = _cameras(32, 32)
    cfg = dict(max_depth=64, srgb_primitives=True, chunk_size=128)
    o, d = jscene.generate_rays(cam_j, jitter=False)
    ref = np.asarray(jrf.radiance(s, None, o, d, jrf.RFConfig(**cfg), jax.random.PRNGKey(0)))
    ot, dt = tscene.generate_rays(cam_t, jitter=False, device="cpu")
    np.testing.assert_allclose(dt.numpy(), np.asarray(d), atol=1e-6)
    got = trf.radiance(_port_scene(s), None, ot, dt, trf.RFConfig(**cfg)).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.01
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize(
    "override",
    [dict(backend="xla"), dict(use_clusters=False), dict(prim_resort="entry"),
     dict(prim_resort="cluster"), dict(prim_resort=True),
     dict(backend="pallas", use_clusters=False), dict(backend="pallas2", use_clusters=False)],
)
def test_unported_options_raise(override):
    """The options the port refused until the 3DGS-asset slice: each now
    builds and renders a finite frame, except the fused backend without
    clusters, which JAX asserts against (ValueError)."""
    cfg = trt.RFTiledConfig(**{**HEADLINE_AT_TEST_SIZE, **override})
    scene = _port_scene(surface_scene(64))
    if cfg.backend == "fused" and not cfg.use_clusters:
        with pytest.raises(ValueError, match="use_clusters"):
            trt.build_state(scene, cfg)
        return
    img = trt.render_state(trt.build_state(scene, cfg), _cameras(64, 64)[1], cfg, spp=1,
                           jitter=False)
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("extra", [dict(backend="fused"), dict(backend="xla")])
def test_unported_render_arguments_raise(extra):
    """The device mesh is ported (ROADMAP.md §A7), on either route: a mesh
    whose ranks do not divide the tile count raises, as JAX asserts, and a
    one-rank mesh renders the frame of ``mesh=None`` bit for bit
    (tests/test_torch_parallel.py shards frames over four ranks)."""
    cfg = trt.RFTiledConfig(**{**HEADLINE_AT_TEST_SIZE, **extra})
    state = trt.build_state(_port_scene(surface_scene(64)), cfg)
    cam = _cameras(64, 64)[1]
    with pytest.raises(ValueError, match="not divisible over 3 ranks"):
        trt.render_state(state, cam, cfg, mesh=parallel.Mesh(0, 3, torch.device("cpu")))
    img = trt.render_state(state, cam, cfg, spp=2, seed=4)
    assert torch.equal(trt.render_state(state, cam, cfg, spp=2, seed=4,
                                        mesh=parallel.data_mesh("cpu")), img)
