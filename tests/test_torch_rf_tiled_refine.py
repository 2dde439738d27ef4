"""The port's refinement of truncated tiles (``refine_fraction``,
``refine_factor``) against the JAX package's fused frames.

``surface_scene(6400, seed=3)`` at 64x64 (the scene and film of
tests/test_rf_tiled.py::test_refinement_recovers_truncated_tiles) renders
in both packages with refine_fraction 1.0 and 0.25, through the flat cull
and the two-level cull (whose refine pass re-culls against the strip's
candidates). The port's frame is held to JAX's within 1e-5 (f32 sums in
another order), and the refined tiles to JAX's exactly: both packages'
selection functions are recorded (JAX's ``jax.lax.top_k`` on the [T] score,
the port's ``rf_tiled.refine_select``), and their scores and selected tile
ids must be equal. At 256 candidates the scores tie at the cut (many tiles
have every ray above beta_kill), so the tie order is tested too.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch.models import rf_tiled as trt

from test_rf_tiled import surface_scene as _make_scene
from test_torch_rf_tiled import _cameras, _port_scene

# the scene factory takes ~2 ms a primitive: build the scene once
surface_scene = functools.lru_cache(maxsize=None)(_make_scene)
FRAME = dict(max_depth=64, srgb_primitives=False, tile_pixels=256, segment=128,
             use_clusters=True, cluster_size=16, backend="fused", refine_factor=4)
STRIPS = dict(coarse_group=4, coarse_factor=4, super_group=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorders(monkeypatch):
    """Record (score, selected tiles) of each package's refine selection."""
    log_j, log_t = [], []
    top_k, select = jax.lax.top_k, trt.refine_select

    def top_k_rec(x, k):
        out = top_k(x, k)
        if x.ndim == 1:  # the refine score; the shortlists are [T, K] keys
            log_j.append((np.asarray(x), np.asarray(out[1])))
        return out

    def select_rec(score, m):
        out = select(score, m)
        log_t.append((score.numpy().copy(), out[1].numpy().copy()))
        return out

    monkeypatch.setattr(jax.lax, "top_k", top_k_rec)
    monkeypatch.setattr(trt, "refine_select", select_rec)
    return log_j, log_t


@pytest.mark.parametrize("path", ["flat", "strips"])
@pytest.mark.parametrize("fraction, candidates", [(1.0, 512), (0.25, 256)])
def test_refine_matches_jax(fraction, candidates, path, monkeypatch):
    s = surface_scene(6400, seed=3)
    cam_j, cam_t = _cameras(64, 64)
    cfg = dict(FRAME, max_candidates=candidates, refine_fraction=fraction,
               **(STRIPS if path == "strips" else {}))
    log_j, log_t = _recorders(monkeypatch)
    img_j = np.asarray(jrt.render(s, cam_j, jrt.RFTiledConfig(**cfg), None, spp=1, seed=0,
                                  jitter=False))
    img_t = trt.render(_port_scene(s), cam_t, trt.RFTiledConfig(**cfg), spp=1, seed=0,
                       jitter=False).numpy()
    assert len(log_j) == len(log_t) == 1
    (score_j, sel_j), (score_t, sel_t) = log_j[0], log_t[0]
    np.testing.assert_array_equal(score_t, score_j)
    np.testing.assert_array_equal(sel_t, sel_j)
    assert sel_t.shape == (max(1, round(16 * fraction)),)
    assert score_t[sel_t].max() > 0  # some tiles are refined
    if fraction < 1.0:  # the cut falls inside a run of equal scores
        cut = score_t[sel_t[-1]]
        assert (score_t == cut).sum() > (score_t[sel_t] == cut).sum()
    assert np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    # the refined tiles changed the frame
    base = trt.render(_port_scene(s), cam_t,
                      trt.RFTiledConfig(**{**cfg, "refine_fraction": 0.0}),
                      spp=1, seed=0, jitter=False).numpy()
    assert np.abs(base - img_t).max() > 1e-3


def test_refinement_recovers_truncated_tiles():
    """The port's form of the JAX test: refining every tile with factor 4
    equals a base pass with a 4-times-larger shortlist (the same culls,
    gathers and compositor calls), within the JAX test's rtol 1e-5 /
    atol 1e-6."""
    s = _port_scene(surface_scene(6400, seed=3))
    cam = _cameras(64, 64)[1]
    full = trt.render(s, cam, trt.RFTiledConfig(**FRAME, max_candidates=512,
                                                refine_fraction=1.0),
                      spp=1, seed=0, jitter=False).numpy()
    big = trt.render(s, cam, trt.RFTiledConfig(**FRAME, max_candidates=2048),
                     spp=1, seed=0, jitter=False).numpy()
    np.testing.assert_allclose(full, big, rtol=1e-5, atol=1e-6)


def test_refine_and_budget_classes_are_exclusive():
    cfg = trt.RFTiledConfig(**FRAME, max_candidates=512, refine_fraction=0.25,
                            budget_classes=((0.5, 16), (0.5, 32)))
    with pytest.raises(ValueError, match="budget_classes replaces refine_fraction"):
        trt.build_state(_port_scene(surface_scene(400, seed=0)), cfg)
