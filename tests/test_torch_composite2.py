"""The port's camera-relative v2 tile compositor (kernels/composite2.py)
against the JAX package.

The camera-relative column table (from the primitives, and from the scene
features with its vector-Jacobian product) against JAX's; then the same
numpy-made inputs (those of
test_torch_composite.tile_inputs, seen from the same origin) go through the
JAX kernels in interpret mode (``composite2.composite_tiles2`` and its
``jax.vjp``) and the port's plain versions, at SH degrees 0 and 1, under a
cap that decides many pairs and one that decides none.

Tolerances: the forward within atol 1e-4 / rtol 1e-3 (chip_smoke.py's bar
for a kernel); each adjoint row within 8e-3 of its largest JAX value, the
tolerance of the JAX package's own v2 gradient test
(tests/test_rf_tiled.py::test_pallas_gradients_match_xla); the plain
backward against autograd through the plain forward in f64 to 1e-9; and
chip_smoke.compare_grads12 passes the plain version summed in another
order and fails wrong ones, also at the headline scene's scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu.ops import quadric as jquadric
from volprim_tpu.pallas_kernels import composite2 as jcomp2
from volprim_tpu_torch.kernels import composite2 as tcomp2
from volprim_tpu_torch.scene.ellipsoids import EllipsoidScene

from test_torch_composite import (
    COMPARATOR_CASES, ORIGIN, assert_grads_close, comparator_result, kw, t_, tile_inputs,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def v2_args(x):
    """(d8 [T, R, 8], pf_cam [T, S, 16], aux [T, 2, S], sh3), numpy: the
    columns of tile_inputs seen from ORIGIN, the neutral tail as rf_tiled
    builds it (M = I, U = o, c0 = |o|^2, opacity 0)."""
    t, r, _ = x["d"].shape
    s = x["pf"].shape[1]
    o = torch.tensor(ORIGIN, dtype=torch.float32)
    prims = EllipsoidScene(
        centers=t_(x["centers"]), scales=t_(x["scales"]), quats=t_(x["quats"]),
        attrs={"opacities": t_(x["opac"].reshape(-1, 1))},
    )
    pf = tcomp2.camera_relative_features_from_prims(prims, o).numpy().reshape(t, s, 16)
    tail = x["opac"] == 0.0
    pf[tail] = tcomp2.neutral_row(o).numpy()
    c0 = np.where(tail, np.float32((o * o).sum()), pf[..., 9])
    aux = np.stack([x["opac"], c0], axis=1).astype(np.float32)
    d8 = np.concatenate([x["d"], np.zeros((t, r, 5), np.float32)], -1)
    return [d8, pf, aux, x["sh3"]]


def _jax_scene(x):
    return jscene.EllipsoidScene(
        jnp.asarray(x["centers"]), jnp.asarray(x["scales"]), jnp.asarray(x["quats"]),
        {"opacities": jnp.asarray(x["opac"].reshape(-1, 1))}, 3.0,
    )


def test_camera_relative_features_match_jax():
    x = tile_inputs(1)
    o = torch.tensor(ORIGIN, dtype=torch.float32)
    prims = EllipsoidScene(centers=t_(x["centers"]), scales=t_(x["scales"]),
                           quats=t_(x["quats"]), attrs={})
    want = np.asarray(jcomp2.camera_relative_features_from_prims(_jax_scene(x), jnp.asarray(o)))
    got = tcomp2.camera_relative_features_from_prims(prims, o).numpy()
    _assert_columns_close(got, want, 1e-5)


def test_camera_relative_features_from_scene_features_match_jax():
    """composite2.camera_relative_features (from the [N, 16] scene features
    and the origin) and its vector-Jacobian product in both arguments
    against JAX's and jax.vjp, each column within 1e-5 of its largest."""
    x = tile_inputs(2)
    feats = np.zeros((x["centers"].shape[0], 16), np.float32)
    feats[:, :10] = np.asarray(jquadric.prim_features(
        jnp.asarray(x["centers"]), jnp.asarray(x["scales"]), jnp.asarray(x["quats"]))).T
    cot = np.random.default_rng(2).normal(size=feats.shape).astype(np.float32)
    want, vjp = jax.vjp(jcomp2.camera_relative_features, jnp.asarray(feats),
                        jnp.asarray(ORIGIN, jnp.float32))
    g_feats_j, g_o_j = vjp(jnp.asarray(cot))
    f_t = torch.tensor(feats, requires_grad=True)
    o_t = torch.tensor(ORIGIN, dtype=torch.float32, requires_grad=True)
    got = tcomp2.camera_relative_features(f_t, o_t)
    got.backward(torch.from_numpy(cot))
    _assert_columns_close(got.detach().numpy(), np.asarray(want), 1e-5)
    _assert_columns_close(f_t.grad.numpy()[:, :10], np.asarray(g_feats_j)[:, :10], 1e-5)
    assert not f_t.grad[:, 10:].any() and not np.asarray(g_feats_j)[:, 10:].any()
    _assert_columns_close(o_t.grad.numpy()[None], np.asarray(g_o_j)[None], 1e-5)


def _assert_columns_close(got, want, tol):
    """Each column within tol of its largest |value| (c0 and U cancel:
    relative error of an element is no measure)."""
    err = np.abs(got - want).max(axis=0)
    assert np.all(err <= tol * np.abs(want).max(axis=0)), err


def _jax(sh_k, max_depth):
    """composite_tiles2's static arguments, interpret mode."""
    k = kw(max_depth)
    return (k["seg"], k["extent2"], k["max_depth"], k["beta_kill"],
            int(sh_k**0.5) - 1, sh_k, True)


@pytest.mark.parametrize("sh_k,max_depth", [(1, 128), (4, 128), (4, 6)])
def test_forward_matches_jax(sh_k, max_depth):
    x = tile_inputs(60 + sh_k + max_depth, sh_k=sh_k)
    args = v2_args(x)
    l_j, b_j = jcomp2.composite_tiles2(*map(jnp.asarray, args), *_jax(sh_k, max_depth))
    l_t, b_t = tcomp2.composite_tiles2(*map(t_, args), sh_k=sh_k, **kw(max_depth))
    if max_depth == 128:
        assert float(b_t.min()) < 0.01
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-4, rtol=1e-3)


def jax_vjp(args, g_l, g_beta, sh_k, max_depth):
    _, vjp = jax.vjp(
        lambda pf, aux, sh_: jcomp2.composite_tiles2(
            jnp.asarray(args[0]), pf, aux, sh_, *_jax(sh_k, max_depth)
        ),
        *map(jnp.asarray, args[1:]),
    )
    return [np.asarray(g) for g in vjp((jnp.asarray(g_l), jnp.asarray(g_beta)))]


def rows(gpf, gaux, gsh):
    """[T, 9 + 2 + 48, S]: gpf's live rows (M6, U), gaux, gsh."""
    return np.concatenate(
        [np.asarray(gpf)[..., :9].transpose(0, 2, 1), np.asarray(gaux),
         np.asarray(gsh).transpose(0, 2, 1)], axis=1,
    )


@pytest.mark.parametrize("sh_k,max_depth", [(1, 128), (4, 128), (4, 6)])
def test_backward_matches_jax_vjp(sh_k, max_depth):
    x = tile_inputs(70 + sh_k + max_depth, sh_k=sh_k)
    args = v2_args(x)
    cot = (t_(x["g_l"]), t_(x["g_beta"]))
    want = jax_vjp(args, x["g_l"], x["g_beta"], sh_k, max_depth)
    got = tcomp2.composite_tiles2_bwd_reference(*map(t_, args), *cot, sh_k=sh_k,
                                                **kw(max_depth))
    assert not got[0][..., 9:].any() and not got[2][..., sh_k:16].any()
    live = np.abs(rows(*want)).max(axis=(0, 2)) > 0
    assert live[:11].all() and live[11:11 + sh_k].all()
    assert_grads_close(rows(*(g.numpy() for g in got)), rows(*want), 8e-3)

    leaves = [t_(a).requires_grad_(True) for a in args[1:]]
    l, b = tcomp2.composite_tiles2(t_(args[0]), *leaves, sh_k=sh_k, **kw(max_depth))
    (torch.sum(l * cot[0]) + torch.sum(b * cot[1])).backward()
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def test_backward_matches_autograd_of_forward():
    x = tile_inputs(80)
    args = [t_(a).double() for a in v2_args(x)]
    cot = (t_(x["g_l"]), t_(x["g_beta"]))
    leaves = [a.clone().requires_grad_(True) for a in args[1:]]
    l, b = tcomp2.composite_tiles2_reference(args[0], *leaves, sh_k=4, **kw(12))
    (torch.sum(l * cot[0]) + torch.sum(b * cot[1])).backward()
    got = tcomp2.composite_tiles2_bwd_reference(*args, *cot, sh_k=4, **kw(12))
    for leaf, g in zip(leaves, got):
        want = leaf.grad
        if g.shape[-1] == 16:  # autograd also reaches pf_cam rows 9-15, unread
            want = torch.cat([want[..., :9], torch.zeros_like(want[..., 9:])], -1)
        assert float((g - want).abs().max()) <= 1e-9 * float(want.abs().max())


@pytest.mark.parametrize("headline,kernel", COMPARATOR_CASES)
def test_chip_comparator_passes_another_order_and_fails_a_wrong_kernel(headline, kernel):
    """chip_smoke.compare_grads12 on the v2 layouts (gaux has the c0 row)."""
    x = tile_inputs(90, headline=headline)
    result = comparator_result(kernel, x, v2_args(x),
                               tcomp2.composite_tiles2_bwd_reference, dict(sh_k=4, **kw(24)),
                               1, 1)
    assert result["ok"] == (kernel == "rays_permuted")
