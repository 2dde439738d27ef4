"""The port's tomography integrator (volprim_tpu_torch.models.tomography)
against the JAX package's, on the same numpy-made scenes and rays.

- The cases of tests/test_tomography.py and test_analytic_golden.py:133:
  one Gaussian's transmittance (rtol 1e-5 against JAX and the closed form),
  the max_depth blackout, a ray starting inside a primitive,
  hide_emitters, no emitter, sigma_t shaped [N] and [N, 1], N not a
  multiple of chunk_size, and the full-range Epanechnikov kernel at extent
  3, whose integral vanishes in both packages (ROADMAP.md §D).
- Radiance of 64 primitives on 256 random rays within rtol 1e-5 / atol
  1e-6 of JAX; gradients of centers, scales, quats and sigma_t within
  1e-4 of each maximum of jax.grad's. Where the f32 coefficients cancel
  (q = c - b^2 / a) beyond that, the yardstick is JAX in f64: the port in
  f64 lies within 1e-5 (radiance) / 1e-4 of each maximum (gradients) of
  it always, and the port's f32 deviation from it is at most twice JAX's.
- The pair budget ``_TOMO_PAIRS``: the radiance is bit-identical under two
  budgets (the last ray block short), the gradients within 1e-6 of each
  maximum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu.models import tomography as jtomo
from volprim_tpu.ops import envmap as jenv
from volprim_tpu_torch.models import tomography as ttomo
from volprim_tpu_torch.ops import envmap as tenv
from volprim_tpu_torch.ops import quadric
from volprim_tpu_torch.scene.ellipsoids import EllipsoidScene

from test_analytic_golden import _analytic_tau

KEYS = ("centers", "scales", "quats", "sigma_t")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def medium(n, seed=0, sigma_shape=(1,)):
    """A random medium of ``n`` anisotropic Gaussians around the origin."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(
        centers=(rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        scales=rng.uniform(0.05, 0.3, size=(n, 3)).astype(np.float32),
        quats=q,
        sigma_t=rng.uniform(0.1, 2.0, size=(n,) + sigma_shape).astype(np.float32),
    )


def rays(r, seed=1):
    """``r`` rays from around (0, 0, -4) towards +z."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(r, 3)) * 0.3 + [0.0, 0.0, -4.0]).astype(np.float32)
    d = rng.normal(size=(r, 3)) * 0.2 + [0.0, 0.0, 1.0]
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def jax_scene(a, dtype=jnp.float32, extent=3.0):
    f = lambda k: jnp.asarray(a[k], dtype)  # noqa: E731
    return jscene.EllipsoidScene(f("centers"), f("scales"), f("quats"),
                                 {"sigma_t": f("sigma_t")}, extent)


def port_scene(a, dtype=torch.float32, extent=3.0, requires_grad=False):
    t = {k: torch.tensor(a[k], dtype=dtype, requires_grad=requires_grad) for k in KEYS}
    return EllipsoidScene(t["centers"], t["scales"], t["quats"], {"sigma_t": t["sigma_t"]},
                          extent), t


def run_jax(a, o, d, emit=(1.0, 1.0, 1.0), f64=False, **kw):
    dt = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        em = None if emit is None else jenv.ConstantEmitter(radiance=jnp.asarray(emit, dt))
        return np.asarray(jtomo.radiance(jax_scene(a, dt), em, jnp.asarray(o, dt),
                                         jnp.asarray(d, dt), jtomo.TomographyConfig(**kw)))


def run_port(a, o, d, emit=(1.0, 1.0, 1.0), f64=False, **kw):
    dt = torch.float64 if f64 else torch.float32
    em = None if emit is None else tenv.ConstantEmitter(radiance=torch.tensor(emit, dtype=dt))
    s, _ = port_scene(a, dt)
    return ttomo.radiance(s, em, torch.tensor(o, dtype=dt), torch.tensor(d, dtype=dt),
                          ttomo.TomographyConfig(**kw)).numpy()


def hold_to_jax(got, want, got64, want64, rtol, atol, tol64, what, edge=None):
    """The port in f64 within ``tol64`` of JAX in f64, always; the port in
    f32 within rtol / atol of JAX in f32, or else its largest deviation
    from JAX in f64 at most twice JAX's f32 deviation. Rows marked in
    ``edge`` (rays that graze an extent ellipsoid, :func:`edge_rays`) are
    left out of the f32 comparisons."""
    err64 = np.abs(got64 - want64).max()
    assert err64 <= tol64, f"{what}: port f64 - JAX f64 {err64:.3g} > {tol64:.3g}"
    if edge is not None:
        got, want, want64 = got[~edge], want[~edge], want64[~edge]
    if np.all(np.abs(got - want) <= atol + rtol * np.abs(want)):
        return
    dp, dj = np.abs(got - want64).max(), np.abs(want - want64).max()
    print(f"{what}: port-JAX {np.abs(got - want).max():.3g}; from JAX f64: port {dp:.3g}, "
          f"JAX {dj:.3g}")
    assert dp <= 2.0 * dj, what


def edge_rays(a, o, d, extent=3.0, rel=1e-4):
    """Rays that graze a primitive's extent ellipsoid: the f64 minimum of
    q lies within ``rel`` of extent^2, or the entry within ``rel`` of the
    origin, so f32 rounding decides whether the primitive counts (the
    packages round q apart: XLA contracts the coefficient sums into FMAs
    inside its scan, eager PyTorch and eager JAX do not)."""
    s, _ = port_scene(a, torch.float64)
    co = quadric.ray_prim_coeffs(torch.tensor(o, dtype=torch.float64),
                                 torch.tensor(d, dtype=torch.float64),
                                 s.centers, s.scales, s.quats)
    e2 = extent * extent
    q_min = co.c - co.b * co.b / co.a
    _, t_near, _ = quadric.intersect_extent(co, extent)
    graze = (torch.abs(q_min - e2) <= rel * e2) | ((q_min < e2) & (torch.abs(t_near) <= rel))
    return graze.any(dim=-1).numpy()


def single_gaussian(sigma_t=2.0, scale=0.5):
    a = dict(centers=np.zeros((1, 3), np.float32), scales=np.full((1, 3), scale, np.float32),
             quats=np.asarray([[0.0, 0.0, 0.0, 1.0]], np.float32),
             sigma_t=np.full((1, 1), sigma_t, np.float32))
    return a


def test_single_gaussian_transmittance():
    a = single_gaussian()
    o = np.asarray([[0.0, 0.0, -5.0], [0.0, 3.0, -5.0]], np.float32)
    d = np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    kw = dict(max_depth=-1, chunk_size=8)
    got, want = run_port(a, o, d, **kw), run_jax(a, o, d, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got[0], np.exp(-_analytic_tau(2.0, 0.5, 0.0)), rtol=1e-5)
    np.testing.assert_allclose(got[1], 1.0, rtol=1e-6)  # misses the 3-sigma extent


def test_analytic_golden_and_sigma_t_gradient():
    """test_analytic_golden.py:133: absorption and the emitter against the
    closed form, with the sigma_t gradient."""
    s, sigma_t, d_perp = 0.25, 3.0, 0.1
    a = single_gaussian(sigma_t, s)
    emit = np.asarray([0.8, 0.6, 0.4], np.float32)
    o = torch.tensor([[d_perp, 0.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    scene, t = port_scene(a, requires_grad=True)
    out = ttomo.radiance(scene, tenv.ConstantEmitter(radiance=torch.from_numpy(emit)), o, d,
                         ttomo.TomographyConfig(max_depth=8))
    tau = _analytic_tau(sigma_t, s, d_perp)
    np.testing.assert_allclose(out[0].detach().numpy(), np.exp(-tau) * emit, rtol=1e-3)
    out[0, 0].backward()
    np.testing.assert_allclose(float(t["sigma_t"].grad[0, 0]),
                               -tau / sigma_t * np.exp(-tau) * 0.8, rtol=1e-3)


def test_max_depth_blackout():
    a = dict(centers=np.asarray([[0, 0, z] for z in (-1.0, 0.0, 1.0)], np.float32),
             scales=np.full((3, 3), 0.1, np.float32),
             quats=np.tile(np.asarray([[0, 0, 0, 1.0]], np.float32), (3, 1)),
             sigma_t=np.ones((3, 1), np.float32))
    o = np.asarray([[0.0, 0.0, -5.0]], np.float32)
    d = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    for depth, lit in ((2, False), (3, True), (-1, True)):
        got = run_port(a, o, d, max_depth=depth, chunk_size=8)
        kw = dict(max_depth=depth, chunk_size=8)
        # tau = 47.7: JAX's c - b^2 / a cancels to 1e-3 relative here
        hold_to_jax(got, run_jax(a, o, d, **kw), run_port(a, o, d, f64=True, **kw),
                    run_jax(a, o, d, f64=True, **kw), 1e-5, 0.0, 1e-26, f"max_depth {depth}")
        assert bool(np.all(got > 0.0)) == lit, depth


def test_ray_inside_primitive_skips_it():
    a = single_gaussian()
    o = np.zeros((1, 3), np.float32)
    d = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    got = run_port(a, o, d, chunk_size=8)
    np.testing.assert_allclose(got, 1.0, rtol=1e-6)
    np.testing.assert_array_equal(got, run_jax(a, o, d, chunk_size=8))


@pytest.mark.parametrize("case", ["hide_emitters", "no_emitter"])
def test_emitter_cases(case):
    a = single_gaussian()
    o = np.asarray([[0.0, 0.0, -5.0], [0.0, 3.0, -5.0]], np.float32)
    d = np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    kw = dict(max_depth=-1, chunk_size=8)
    if case == "hide_emitters":
        kw["hide_emitters"] = True
        got, want = run_port(a, o, d, **kw), run_jax(a, o, d, **kw)
        assert got[0, 0] > 0.0 and np.all(got[1] == 0.0)  # the miss is blanked
    else:
        got, want = run_port(a, o, d, emit=None, **kw), run_jax(a, o, d, emit=None, **kw)
        assert np.all(got == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n,chunk,shape", [(64, 16, (1,)), (64, 16, ()), (37, 16, (1,)),
                                            (37, 1024, ())])
def test_radiance_matches_jax(n, chunk, shape):
    """sigma_t [N, 1] and [N]; N a multiple of chunk_size, and not (the
    padding); the JAX package's default chunk."""
    a = medium(n, seed=n, sigma_shape=shape)
    o, d = rays(256)
    kw = dict(max_depth=-1, chunk_size=chunk)
    got, want = run_port(a, o, d, **kw), run_jax(a, o, d, **kw)
    assert got.shape == (256, 3) and np.isfinite(got).all()
    assert 0.05 < got.mean() < 0.95  # the medium absorbs part of the light
    edge = edge_rays(a, o, d)
    assert edge.sum() <= 2, edge.sum()
    hold_to_jax(got, want, run_port(a, o, d, f64=True, **kw), run_jax(a, o, d, f64=True, **kw),
                1e-5, 1e-6, 1e-5, f"radiance n={n} chunk={chunk} sigma_t{shape}", edge)


def test_max_depth_binding_matches_jax():
    a = medium(64, seed=3)
    o, d = rays(256)
    kw = dict(max_depth=3, chunk_size=16)
    got, want = run_port(a, o, d, **kw), run_jax(a, o, d, **kw)
    dark = np.all(want == 0.0, axis=-1)
    assert 0 < dark.sum() < 256  # the cap blacks out some rays, not all
    np.testing.assert_array_equal(np.all(got == 0.0, axis=-1), dark)
    hold_to_jax(got, want, run_port(a, o, d, f64=True, **kw), run_jax(a, o, d, f64=True, **kw),
                1e-5, 1e-6, 1e-5, "radiance max_depth 3")


def test_epanechnikov_extent3_vanishes():
    """The full-range Epanechnikov integral over the extent-3 chord goes
    negative and is scrubbed to 0 in both packages: the medium is
    transparent (ROADMAP.md §D)."""
    a = medium(64, seed=4)
    o, d = rays(256)
    kw = dict(max_depth=-1, chunk_size=16, kernel_type="epanechnikov")
    got = run_port(a, o, d, **kw)
    np.testing.assert_array_equal(got, run_jax(a, o, d, **kw))
    np.testing.assert_array_equal(got, 1.0)


def _port_grads(a, o, d, f64=False, **kw):
    dt = torch.float64 if f64 else torch.float32
    scene, t = port_scene(a, dt, requires_grad=True)
    em = tenv.ConstantEmitter(radiance=torch.tensor([0.9, 0.6, 0.3], dtype=dt))
    out = ttomo.radiance(scene, em, torch.tensor(o, dtype=dt), torch.tensor(d, dtype=dt),
                         ttomo.TomographyConfig(**kw))
    torch.mean(out ** 2).backward()
    return out.detach().numpy(), {k: t[k].grad.numpy() for k in KEYS}


def _jax_grads(a, o, d, f64=False, **kw):
    dt = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        em = jenv.ConstantEmitter(radiance=jnp.asarray([0.9, 0.6, 0.3], dt))

        def loss(p):
            s = jscene.EllipsoidScene(p["centers"], p["scales"], p["quats"],
                                      {"sigma_t": p["sigma_t"]}, 3.0)
            out = jtomo.radiance(s, em, jnp.asarray(o, dt), jnp.asarray(d, dt),
                                 jtomo.TomographyConfig(**kw))
            return jnp.mean(out ** 2)

        g = jax.grad(loss)({k: jnp.asarray(a[k], dt) for k in KEYS})
        return {k: np.asarray(v) for k, v in g.items()}


def test_gradients_match_jax():
    a = medium(64, seed=5)
    o, d = rays(256, seed=6)
    kw = dict(max_depth=-1, chunk_size=16)
    _, g_t = _port_grads(a, o, d, **kw)
    _, g_t64 = _port_grads(a, o, d, f64=True, **kw)
    g_j, g_j64 = _jax_grads(a, o, d, **kw), _jax_grads(a, o, d, f64=True, **kw)
    for k in KEYS:
        scale = np.abs(g_j[k]).max()
        assert np.isfinite(g_t[k]).all() and scale > 0, k
        print(f"{k}: max diff / max |g| {np.abs(g_t[k] - g_j[k]).max() / scale:.3g}")
        hold_to_jax(g_t[k] / scale, g_j[k] / scale, g_t64[k] / scale, g_j64[k] / scale,
                    0.0, 1e-4, 1e-4, f"gradient {k}")


def test_pair_budget(monkeypatch):
    """The radiance is the same bits under two pair budgets; the gradients
    agree within 1e-6 of each maximum."""
    a = medium(64, seed=7)
    o, d = rays(256, seed=8)
    kw = dict(max_depth=-1, chunk_size=16)
    monkeypatch.setattr(ttomo, "_TOMO_PAIRS", 16 * 256)  # one ray block
    out_a, g_a = _port_grads(a, o, d, **kw)
    monkeypatch.setattr(ttomo, "_TOMO_PAIRS", 16 * 7)  # blocks of 7 rays, the last of 4
    out_b, g_b = _port_grads(a, o, d, **kw)
    np.testing.assert_array_equal(out_a, out_b)
    for k in KEYS:
        assert np.abs(g_a[k] - g_b[k]).max() <= 1e-6 * np.abs(g_a[k]).max(), k


def test_row_sum_order_is_fixed():
    """_row_sum folds in halves (odd columns carried): a row's sum is the
    same bits in any block of rows, and equals the float64 sum to f32
    rounding."""
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(50, 37)).astype(np.float32))
    full = ttomo._row_sum(x)
    for lo, hi in ((0, 1), (3, 10), (10, 50)):
        assert torch.equal(ttomo._row_sum(x[lo:hi]), full[lo:hi])
    np.testing.assert_allclose(full.numpy(), x.double().sum(-1).numpy(), rtol=1e-5, atol=1e-5)


def test_sigma_t_gradient_matches_finite_differences():
    """tests/test_tomography.py's finite-difference check, in f64."""
    a = single_gaussian(sigma_t=1.5)
    o = torch.tensor([[0.2, -0.1, -5.0]], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    em = tenv.ConstantEmitter(radiance=torch.ones(3, dtype=torch.float64))
    cfg = ttomo.TomographyConfig(max_depth=-1, chunk_size=8)
    scene, t = port_scene(a, torch.float64, requires_grad=True)

    def loss(sig):
        return torch.sum(ttomo.radiance(dataclasses.replace(scene, attrs={"sigma_t": sig}), em,
                                        o, d, cfg))

    loss(t["sigma_t"]).backward()
    eps = 1e-3
    with torch.no_grad():
        fd = (loss(t["sigma_t"] + eps) - loss(t["sigma_t"] - eps)) / (2 * eps)
    np.testing.assert_allclose(float(t["sigma_t"].grad[0, 0]), float(fd), rtol=1e-6)


def test_registered_with_jax_defaults():
    from volprim_tpu_torch import models

    assert models.REGISTRY["volprim_tomography"] is ttomo.radiance
    assert models.CONFIGS["volprim_tomography"] is ttomo.TomographyConfig
    assert dataclasses.asdict(ttomo.TomographyConfig()) == dataclasses.asdict(
        jtomo.TomographyConfig())
    k = ttomo.TomographyConfig(kernel_type="epanechnikov").kernel
    assert (k.type, k.normalized, k.full_range) == ("epanechnikov", False, True)
