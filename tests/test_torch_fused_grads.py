"""Gradients through the fused renderer's options, the port against JAX.

The L1 loss of a 64x64 frame of ``surface_scene(6400, seed=3)`` (against a
zero image) and its gradients in all five parameters, through
``rf_tiled.render_state`` with the fused backend, in each package:
``jax.value_and_grad`` (jitted) against ``loss.backward()``. The options:

- ``order_band`` 16, compaction off and on (the train step's configuration
  at test size, tests/test_torch_train.py);
- ``refine_fraction`` 0.25 on strips at 256 candidates (the refine test's
  frame, tests/test_torch_rf_tiled_refine.py);
- ``budget_classes`` ((0.5, 16), (0.5, 32)) with ``cluster_sort``;
- the same classes with ``band_classes`` (0, 8), held to un-jitted JAX:
  JAX's jitted frame differs from its own eager one there (ROADMAP §C4).

Tolerances: the loss within 5e-7 relative; each gradient within 2.5e-6 of
its largest JAX value, the SH's within 2.5e-3 (the SH gradient is bf16: the
compositor writes it in bf16 and the cluster gather sums it per primitive,
in another order in each package). Each is about twice the largest
difference measured over the five cases on the CPU (f32 sums taken in
another order): loss 2.28e-7 (classes), gradients 1.22e-6 (classes,
centers), SH 1.19e-3 (band16_compact). A limit at the measured maximum
itself would fail on the next reordering of a sum.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch import interop, optim, train
from volprim_tpu_torch.models import rf_tiled as trt

from test_rf_tiled import surface_scene as _make_scene
from test_torch_rf_tiled import _cameras, _port_scene
from test_torch_train import KEYS, TRAIN_AT_TEST_SIZE, _jax_scene

surface_scene = functools.lru_cache(maxsize=None)(_make_scene)
CLASSES = dict(budget_classes=((0.5, 16), (0.5, 32)), cluster_sort=True)
REFINE = dict(max_depth=64, srgb_primitives=False, tile_pixels=256, segment=128,
              use_clusters=True, cluster_size=16, backend="fused", refine_factor=4,
              coarse_group=4, coarse_factor=4, super_group=4, max_candidates=256,
              refine_fraction=0.25)
CASES = {
    "band16": (dict(TRAIN_AT_TEST_SIZE, order_band=16, kernel_compact=False), True),
    "band16_compact": (dict(TRAIN_AT_TEST_SIZE, order_band=16), True),
    "refine": (REFINE, True),
    "classes": (dict(TRAIN_AT_TEST_SIZE, **CLASSES), True),
    "band_classes": (dict(TRAIN_AT_TEST_SIZE, **CLASSES, band_classes=(0, 8)), False),
}
LOSS_RTOL, GRAD_TOL, SH_TOL = 5e-7, 2.5e-6, 2.5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_option_gradients_match_jax(case):
    cfg, jit = CASES[case]
    s = surface_scene(6400, seed=3)
    cam_j, cam_t = _cameras(64, 64)
    jcfg, tcfg = jrt.RFTiledConfig(**cfg), trt.RFTiledConfig(**cfg)

    def loss_j(p):
        st = jrt.build_state(_jax_scene(s, p), jcfg)
        img = jrt.render_state(st, cam_j, jcfg, None, spp=1, seed=0, jitter=False)
        return jnp.mean(jnp.abs(img - 0.0))

    arrays = {
        "centers": s.centers, "scales": s.scales, "quats": s.quats,
        "opacities": s.attrs["opacities"], "sh_coeffs": s.attrs["sh_coeffs"],
    }
    vg = jax.value_and_grad(loss_j)
    l_j, g_j = (jax.jit(vg) if jit else vg)(arrays)

    params = interop.params_from_jax({k: np.asarray(v) for k, v in arrays.items()},
                                     device="cpu")
    img = train.render_cameras(train.to_scene(params, _port_scene(s)), [cam_t], tcfg,
                               jitter=False)
    loss = optim.l1(torch.zeros_like(img), img)
    loss.backward()
    assert abs(float(loss.detach()) - float(l_j)) <= LOSS_RTOL * abs(float(l_j)), case
    for k in KEYS:
        a, b = np.asarray(g_j[k]), params[k].grad.numpy()
        assert np.isfinite(b).all() and np.abs(a).max() > 0, k
        err = np.abs(b - a).max() / np.abs(a).max()
        print(f"{case} {k}: max diff / max |g| {err:.3g}")
        assert err <= (SH_TOL if k == "sh_coeffs" else GRAD_TOL), (case, k, err)
