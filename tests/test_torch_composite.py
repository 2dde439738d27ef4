"""The port's v1 tile compositor (kernels/composite.py, composite_vjp.py)
and the quadric feature packing it reads, against the JAX package.

The same numpy-made inputs go through (a) the JAX Pallas kernels in
interpret mode (``composite.composite_tiles``, ``jax.vjp`` of
``composite_vjp.composite_tiles_ad``) and (b) the port's plain versions,
over a cap that decides many pairs and one that decides none, the
beta_kill cutoff, opacity-0 neutral slots and a nonzero beta cotangent.

Tolerances. The forward: atol 1e-4 / rtol 1e-3, the bar of
chip_smoke.py's kernel checks (the packages sum the 10-term dots in
different orders; a and b only feed q through the cancelling
c - b^2 / a). The backward: per adjoint row (the 10 feature rows, the
opacity row, the 48 SH rows), within 2e-3 of the row's largest JAX value,
the tolerance of the JAX package's own v1 gradient test
(tests/test_rf_tiled.py::test_pallas_gradients_match_xla); the two f32
versions sum log(1 - alpha) differently (the TPU kernel in a bf16 hi/lo
split, the port left to right) and g_alpha divides by 1 - alpha, so each
lies up to ~1e-4 of a row's largest value from an f64 run of the plain
version. The plain backward equals autograd through the plain forward in
f64 to 1e-9.
Last, chip_smoke.compare_grads12, which holds the CUDA kernels to their
plain versions on the card, is shown to pass the plain version summed in
another order and to fail wrong ones, also at the headline scene's scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.accel import clusters as jclusters
from volprim_tpu.ops import quadric as jquadric
from volprim_tpu.ops import sh as jsh
from volprim_tpu.pallas_kernels import composite as jcomp
from volprim_tpu.pallas_kernels import composite_vjp as jvjp
from volprim_tpu_torch.accel import clusters as tclusters
from volprim_tpu_torch.kernels import composite as tcomp
from volprim_tpu_torch.kernels import composite_vjp as tvjp
from volprim_tpu_torch.ops import quadric as tquadric

T, R, S, SEG = 3, 32, 256, 128
ORIGIN = np.array([0.1, 0.2, -3.0])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: torch's thread pool only slows them under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_arrays(n, seed, scale=(0.05, 0.2)):
    """Primitives in front of ORIGIN along +z: centers, scales, unit quats."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 0.3, (n, 3)).astype(np.float32)
    scales = rng.uniform(*scale, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4))
    quats = (quats / np.linalg.norm(quats, axis=1, keepdims=True)).astype(np.float32)
    return centers, scales, quats


def headline_arrays(d, s, seed):
    """Primitives at the headline scene's scales (tangent sigma
    0.007-0.013, normal 0.0006-0.003), each centred near a random ray of
    its tile 3.0-3.4 from ORIGIN, where c = |o - mu|^2_M reaches 1e6-1e7."""
    rng = np.random.default_rng(seed)
    t, r, _ = d.shape
    ray = d[np.arange(t)[:, None], rng.integers(0, r, (t, s))]  # [T, S, 3]
    centers = ORIGIN + rng.uniform(3.0, 3.4, (t, s, 1)) * ray + rng.normal(0.0, 0.006, (t, s, 3))
    scales = np.concatenate(
        [rng.uniform(0.007, 0.013, (t * s, 2)), rng.uniform(0.0006, 0.003, (t * s, 1))], -1
    )
    quats = rng.normal(size=(t * s, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return tuple(x.reshape(t * s, -1).astype(np.float32) for x in (centers, scales, quats))


def tile_inputs(seed, t=T, r=R, s=S, sh_k=4, headline=False):
    """Shared inputs of both compositors, numpy, made from ``seed``: unit
    directions d [T, R, 3] in a narrow cone, the primitives of each tile in
    depth order (their stream order), their v1 features pf [T, S, 16],
    opacities [T, S] with a tail of 17 opacity-0 neutral slots per tile, SH
    [T, S, 48] (sh_k live coefficients per channel) and cotangents. With
    ``headline`` the cone is ten times narrower and the primitives are those
    of :func:`headline_arrays`."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 0.005 if headline else 0.05, (t, r, 3)) + np.array([0.0, 0.0, 1.0])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    if headline:
        centers, scales, quats = headline_arrays(d, s, seed + 1)
    else:
        centers, scales, quats = scene_arrays(t * s, seed + 1)
    order = np.argsort(centers[:, 2].reshape(t, s), axis=1) + np.arange(t)[:, None] * s
    centers, scales, quats = (x[order.reshape(-1)] for x in (centers, scales, quats))
    pf = np.zeros((t * s, 16), np.float32)
    pf[:, :10] = tquadric.prim_features(
        *(torch.from_numpy(x) for x in (centers, scales, quats))
    ).T.numpy()
    pf = pf.reshape(t, s, 16)
    opac = rng.uniform(0.3, 0.99, (t, s)).astype(np.float32)
    neutral = slice(s - 17, s)
    pf[:, neutral] = 0.0
    pf[:, neutral, :3] = 1.0
    opac[:, neutral] = 0.0
    sh3 = np.zeros((t, s, 48), np.float32)
    for ch in range(3):
        sh3[..., ch * 16:ch * 16 + sh_k] = rng.normal(0.0, 0.4, (t, s, sh_k))
    g_l = rng.normal(size=(t, r, 3)).astype(np.float32)
    g_beta = rng.normal(size=(t, r)).astype(np.float32)
    return dict(d=d, centers=centers, scales=scales, quats=quats, pf=pf, opac=opac,
                sh3=sh3, g_l=g_l, g_beta=g_beta)


def v1_args(x, sh_k=4):
    """The v1 compositor's (fa, fb, fc, basis, pf, opac [T, 1, S], sh3), numpy."""
    t, r, _ = x["d"].shape
    d = x["d"].reshape(-1, 3)
    o = np.broadcast_to(ORIGIN, d.shape).astype(np.float32)
    pad = np.zeros((t * r, 6), np.float32)
    fa, fb, fc = (
        np.concatenate([f.numpy(), pad], -1).reshape(t, r, 16)
        for f in tquadric.ray_features(torch.from_numpy(o), torch.from_numpy(d))
    )
    basis = np.concatenate(
        [np.asarray(jsh.eval_basis(jnp.asarray(d), int(sh_k**0.5) - 1)),
         np.zeros((t * r, 16 - sh_k), np.float32)], -1,
    ).reshape(t, r, 16)
    return [fa, fb, fc, basis, x["pf"], x["opac"][:, None, :], x["sh3"]]


def kw(max_depth):
    return dict(seg=SEG, extent2=9.0, max_depth=max_depth, beta_kill=0.01)


def t_(a):
    return torch.from_numpy(np.array(a))


def assert_grads_close(got, want, tol):
    """Per row of the [T, rows, S] adjoints, ``got`` within ``tol`` of the
    row's largest |want|."""
    diff = np.max(np.abs(got - want), axis=(0, 2))
    scale = np.max(np.abs(want), axis=(0, 2))
    print("max diff / row max:", diff / np.maximum(scale, 1e-30))
    assert np.all(diff <= tol * scale), (diff, scale)


def test_features_match_jax():
    centers, scales, quats = scene_arrays(500, 0)
    want = np.asarray(jquadric.prim_features(*(jnp.asarray(x) for x in (centers, scales, quats))))
    got = tquadric.prim_features(*(t_(x) for x in (centers, scales, quats))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    d = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    o = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32)
    for a, b in zip(tquadric.ray_features(t_(o), t_(d)), jquadric.ray_features(o, d)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_expand_cluster_ids_matches_jax():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 50, (4, 6)).astype(np.int32)
    valid = rng.uniform(size=(4, 6)) < 0.7
    want = jclusters.expand_cluster_ids(jnp.asarray(ids), jnp.asarray(valid), 8)
    got = tclusters.expand_cluster_ids(t_(ids), t_(valid), 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("max_depth", [128, 6])
def test_forward_matches_jax(max_depth):
    x = tile_inputs(10 + max_depth)
    args = v1_args(x)
    l_j, b_j = jcomp.composite_tiles(*map(jnp.asarray, args), interpret=True, **kw(max_depth))
    l_t, b_t = tcomp.composite_tiles(*map(t_, args), **kw(max_depth))
    assert l_t.dtype == torch.float32 and l_t.shape == (T, R, 3)
    if max_depth == 128:  # the beta_kill cutoff is reached
        assert float(b_t.min()) < 0.01
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-4, rtol=1e-3)


def jax_vjp(args, g_l, g_beta, max_depth):
    k = kw(max_depth)
    _, vjp = jax.vjp(
        lambda pf, op, sh_: jvjp.composite_tiles_ad(
            *map(jnp.asarray, args[:4]), pf, op, sh_, k["seg"], k["extent2"],
            k["max_depth"], k["beta_kill"], True,
        ),
        *map(jnp.asarray, args[4:]),
    )
    return [np.asarray(g) for g in vjp((jnp.asarray(g_l), jnp.asarray(g_beta)))]


def rows(gpf, gopac, gsh):
    """The three adjoints as one [T, rows, S] array: gpf's 10 live rows,
    the opacity row, the 48 SH rows."""
    return np.concatenate(
        [np.asarray(gpf)[..., :10].transpose(0, 2, 1), np.asarray(gopac),
         np.asarray(gsh).transpose(0, 2, 1)], axis=1,
    )


@pytest.mark.parametrize("max_depth", [128, 6])
def test_backward_matches_jax_vjp(max_depth):
    x = tile_inputs(20 + max_depth)
    args = v1_args(x)
    want = jax_vjp(args, x["g_l"], x["g_beta"], max_depth)
    got = tvjp.composite_tiles_bwd_reference(*map(t_, args), t_(x["g_l"]), t_(x["g_beta"]),
                                             **kw(max_depth))
    assert all(g.dtype == torch.float32 for g in got)
    assert not got[0][..., 10:].any()  # padding features carry no gradient
    # every live row carries gradient; under the cap, the neutral slots'
    # opacity too (hit with alpha 0: the TPU kernel's depth_ok & hit mask)
    assert (np.abs(rows(*want)).max(axis=(0, 2)) > 0)[:15].all()
    if max_depth == 128:
        assert np.abs(want[1][:, 0, -17:]).max() > 0
    assert_grads_close(rows(*(g.numpy() for g in got)), rows(*want), 2e-3)

    # autograd through the wrapper on CPU tensors: the same function
    leaves = [t_(a).requires_grad_(True) for a in args[4:]]
    l, b = tvjp.composite_tiles_ad(*map(t_, args[:4]), *leaves, **kw(max_depth))
    (torch.sum(l * t_(x["g_l"])) + torch.sum(b * t_(x["g_beta"]))).backward()
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def test_backward_matches_autograd_of_forward():
    """The plain backward against torch.autograd through the plain
    forward, both in f64."""
    x = tile_inputs(40)
    args = [t_(a).double() for a in v1_args(x)]
    leaves = [a.clone().requires_grad_(True) for a in args[4:]]
    l, b = tcomp.composite_tiles_reference(*args[:4], *leaves, **kw(12))
    (torch.sum(l * t_(x["g_l"])) + torch.sum(b * t_(x["g_beta"]))).backward()
    got = tvjp.composite_tiles_bwd_reference(*args, t_(x["g_l"]), t_(x["g_beta"]), **kw(12))
    for leaf, g in zip(leaves, got):
        want = leaf.grad
        if g.shape[-1] == 16:  # autograd also reaches the 6 padding features
            want = torch.cat([want[..., :10], torch.zeros_like(want[..., 10:])], -1)
        assert float((g - want).abs().max()) <= 1e-9 * float(want.abs().max())


# (headline scales, planted kernel): at the headline scene's scales q
# cancels and only a yardstick that takes the f32 q can tell 1e-3 from f32
# noise
COMPARATOR_CASES = [
    (False, "rays_permuted"), (False, "one_ray_dropped"), (False, "relative_1e-4"),
    (False, "column_row_off"), (True, "rays_permuted"), (True, "relative_1e-3"),
    (True, "tile_zeroed"),
]


def comparator_result(kernel, x, args, bwd, k, n_ray, col_row):
    """chip_smoke.compare_grads12 of a planted ``kernel`` against the plain
    backward ``bwd`` on ``args`` (the first ``n_ray`` per ray), with
    chip_smoke.yard12 as the yardstick. The kernels: the plain version on
    each tile's rays in another order (the same function summed in another
    order, as the CUDA kernels' warp and atomic sums do), one ray of one
    tile dropped, every adjoint off by a relative 1e-4 / 1e-3, one tile's
    adjoints zero, and row ``col_row`` of the column adjoints (opacity;
    v2's c0) off by a relative 1e-3."""
    import chip_smoke

    ta = list(map(t_, args))
    cot = (t_(x["g_l"]), t_(x["g_beta"]))
    plain = bwd(*ta, *cot, **k)
    yard = chip_smoke.yard12(bwd, ta, cot, k)
    if kernel == "rays_permuted":
        p = torch.randperm(ta[0].shape[1], generator=torch.Generator().manual_seed(0))
        got = bwd(*(a[:, p] if i < n_ray else a for i, a in enumerate(ta)),
                  *(c[:, p] for c in cot), **k)
    elif kernel == "one_ray_dropped":
        g_l, g_beta = (c.clone() for c in cot)
        g_l[1, 7], g_beta[1, 7] = 0.0, 0.0
        got = bwd(*ta, g_l, g_beta, **k)
    elif kernel.startswith("relative_"):
        got = tuple(g * (1.0 + float(kernel.split("_")[1])) for g in plain)
    elif kernel == "tile_zeroed":
        got = tuple(torch.cat([torch.zeros_like(g[:1]), g[1:]]) for g in plain)
    else:
        gcol = plain[1].clone()
        gcol[:, col_row] *= 1.0 + 1e-3
        got = (plain[0], gcol, plain[2])
    result = chip_smoke.compare_grads12(got, plain, yard)
    print(kernel, result["elements_outside_band"], result["rows_median_failed"],
          result["max_rel_tile_row"])
    return result


@pytest.mark.parametrize("headline,kernel", COMPARATOR_CASES)
def test_chip_comparator_passes_another_order_and_fails_a_wrong_kernel(headline, kernel):
    """chip_smoke.compare_grads12, which holds the CUDA backward kernels to
    their plain versions on the card, accepts the same function summed in
    another order and rejects the wrong kernels of comparator_result, at
    this file's scales and at the headline scene's."""
    x = tile_inputs(50, headline=headline)
    result = comparator_result(kernel, x, v1_args(x),
                               tvjp.composite_tiles_bwd_reference, kw(24), 4, 0)
    assert result["ok"] == (kernel == "rays_permuted")
