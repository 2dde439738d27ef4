"""volprim_tpu_torch.ops against volprim_tpu.ops on the same numpy inputs.

Tolerance atol 1e-6 / rtol 1e-5 in f32: both run the same operations in
the same order on the CPU, but XLA contracts a*b+c into FMAs and torch does
not, so results differ in the last bits. The exact-path quadric
``q_min = c - b^2/a`` amplifies that by its cancellation (~c * 2^-24), so
the inputs keep c moderate (scales 0.2-0.6 at distance ~2); the
intersection distances are compared where the intersection exists."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import ops as jops
from volprim_tpu.ops import kernels as jkernels
from volprim_tpu.ops import quadric as jquadric
from volprim_tpu.ops import quaternion as jquat
from volprim_tpu.ops import sh as jsh
from volprim_tpu_torch import ops as tops
from volprim_tpu_torch.ops import kernels as tkernels
from volprim_tpu_torch.ops import quadric as tquadric
from volprim_tpu_torch.ops import quaternion as tquat
from volprim_tpu_torch.ops import sh as tsh

TOL = dict(atol=1e-6, rtol=1e-5)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def _rays_and_prims(seed, r=64, c=48):
    rng = np.random.default_rng(seed)
    o = np.tile(rng.normal(0.0, 0.2, (1, 3)) + [0.0, 0.0, -2.0], (r, 1))
    d = rng.normal(0.0, 0.3, (r, 3)) + [0.0, 0.0, 1.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    centers = rng.normal(0.0, 0.3, (c, 3))
    scales = rng.uniform(0.2, 0.6, (c, 3))
    quats = rng.normal(size=(c, 4))
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f(o), f(d), f(centers), f(scales), f(quats)


def test_quaternion_to_rotation_matrix():
    q = np.random.default_rng(0).normal(size=(100, 4)).astype(np.float32)
    _close(tquat.to_rotation_matrix(torch.from_numpy(q)), jquat.to_rotation_matrix(q))


def test_srgb_to_linear():
    x = np.linspace(-0.2, 1.5, 1001, dtype=np.float32)
    _close(tops.srgb_to_linear(torch.from_numpy(x)), jops.srgb_to_linear(jnp.asarray(x)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_basis(degree):
    d = np.random.default_rng(degree).normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(tsh.eval_basis(torch.from_numpy(d), degree), jsh.eval_basis(d, degree))
    assert tsh.degree_from_coeffs(tsh.num_coeffs(degree)) == degree


def test_quadric_features():
    o, d, c, s, q = _rays_and_prims(1)
    t = [torch.from_numpy(x) for x in (o, d, c, s, q)]
    ct = tquadric.ray_prim_coeffs(*t)
    cj = jquadric.ray_prim_coeffs(o, d, c, s, q)
    for a, b in zip(ct, cj):
        _close(a, b)
    vt, nt, ft = tquadric.intersect_extent(ct, 3.0)
    vj, nj, fj = jquadric.intersect_extent(cj, 3.0)
    vj = np.array(vj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    assert vj.any() and (~vj).any()
    _close(nt[vt], np.asarray(nj)[vj])
    _close(ft[vt], np.asarray(fj)[vj])
    # matched pairs: ray i against primitive i
    n = min(o.shape[0], c.shape[0])
    pt = tquadric.pair_coeffs(t[0][:n], t[1][:n], t[2][:n], t[3][:n], t[4][:n])
    pj = jquadric.pair_coeffs(o[:n], d[:n], c[:n], s[:n], q[:n])
    for a, b in zip(pt, pj):
        _close(a, b)


def test_gaussian_eval_q_and_peak_response():
    q = np.linspace(0.0, 30.0, 301, dtype=np.float32)
    kt, kj = tkernels.Kernel("gaussian"), jkernels.Kernel("gaussian")
    _close(kt.eval_q(torch.from_numpy(q)), kj.eval_q(jnp.asarray(q)))
    o, d, c, s, qt = _rays_and_prims(2)
    ct = tquadric.ray_prim_coeffs(*(torch.from_numpy(x) for x in (o, d, c, s, qt)))
    cj = jquadric.ray_prim_coeffs(o, d, c, s, qt)
    _close(kt.peak_response(ct), kj.peak_response(cj))
    with pytest.raises(ValueError):  # as JAX's Kernel refuses an unknown type
        tkernels.Kernel("box")
