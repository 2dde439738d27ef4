"""The port's other fused-path branches against the JAX package: one fixed
budget instead of classes, with the single-level cull (every cluster per
tile) and with the two-level cull, uncompacted, 1 spp, without sRGB; and
the jittered render's determinism. Images agree within atol 1e-4 /
rtol 1e-3 (see test_torch_rf_tiled.py)."""

import numpy as np
import pytest

from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch.models import rf_tiled as trt

from test_rf_tiled import surface_scene
from test_torch_rf_tiled import _cameras, _port_scene

BASE = dict(
    max_depth=64, srgb_primitives=False, tile_pixels=256, max_candidates=512,
    segment=128, cluster_size=16, backend="fused",
)


@pytest.mark.parametrize(
    "cull", [dict(coarse_group=0), dict(coarse_group=4, coarse_factor=2, super_group=4)]
)
def test_fixed_budget_paths_match_jax(cull):
    s = surface_scene(3000, seed=4)
    cam_j, cam_t = _cameras(32, 64)
    kw = {**BASE, **cull}
    img_j = np.asarray(
        jrt.render(s, cam_j, jrt.RFTiledConfig(**kw), None, spp=1, seed=0, jitter=False)
    )
    img_t = trt.render(
        _port_scene(s), cam_t, trt.RFTiledConfig(**kw), spp=1, seed=0, jitter=False
    ).numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01
    np.testing.assert_allclose(img_t, img_j, atol=1e-4, rtol=1e-3)


def test_jittered_render_is_seeded():
    cfg = trt.RFTiledConfig(**BASE)
    state = trt.build_state(_port_scene(surface_scene(1000, seed=6)), cfg)
    cam = _cameras(32, 32)[1]
    a = trt.render_state(state, cam, cfg, spp=2, seed=3)
    b = trt.render_state(state, cam, cfg, spp=2, seed=3)
    c = trt.render_state(state, cam, cfg, spp=2, seed=4)
    centers = trt.render_state(state, cam, cfg, spp=1, jitter=False)
    assert bool((a == b).all()) and not bool((a == c).all())
    # jitter moves rays inside their pixels: close to the pixel-center render
    assert float((a - centers).abs().mean()) < 0.1 * float(centers.mean())
