"""volprim_tpu_torch.ops.kernels against volprim_tpu.ops.kernels: the
Epanechnikov kernel's functions, the Gaussian inverse CDF and
normalisation, and ``Kernel`` with every ``normalized`` / ``full_range``
combination, on the same numpy inputs.

Both packages take the same quadric coefficients (JAX's, as numpy), so
only the kernels' own arithmetic is compared: atol 1e-6 / rtol 1e-5 in
f32 (XLA contracts a*b+c into FMAs, torch does not). The inverse CDFs
(erfinv, arcsin of a cubic's root) amplify that near the ends of their
range: atol 1e-5 / rtol 1e-4 there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.ops import kernels as jk
from volprim_tpu.ops import quadric as jq
from volprim_tpu_torch.ops import kernels as tk
from volprim_tpu_torch.ops.quadric import QuadricCoeffs

TOL = dict(atol=1e-6, rtol=1e-5)
INV_TOL = dict(atol=1e-5, rtol=1e-4)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def _inputs(seed=0, r=64, c=48):
    """Coefficients of rays against primitives (moderate scales: q does not
    cancel), s_prod, scales, per-pair segment bounds, sigma_t, chi."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    o = f32(np.tile(rng.normal(0.0, 0.2, (1, 3)) + [0.0, 0.0, -2.0], (r, 1)))
    d = rng.normal(0.0, 0.3, (r, 3)) + [0.0, 0.0, 1.0]
    d = f32(d / np.linalg.norm(d, axis=1, keepdims=True))
    centers = f32(rng.normal(0.0, 0.3, (c, 3)))
    scales = f32(rng.uniform(0.2, 0.6, (c, 3)))
    quats = f32(rng.normal(size=(c, 4)))
    coeffs = [np.asarray(x) for x in jq.ray_prim_coeffs(o, d, centers, scales, quats)]
    # segments around each pair's peak, most inside the unit-q chord (the
    # Epanechnikov support), some reaching past it or empty
    a, b, c_ = (v.astype(np.float64) for v in coeffs)
    half = np.sqrt(np.maximum(1.0 - (c_ - b * b / a), 0.04) / a)
    t0 = f32(-b / a + half * rng.uniform(-1.2, 0.5, (r, c)))
    t1 = f32(t0 + half * rng.uniform(-0.2, 1.5, (r, c)))
    return dict(
        coeffs=coeffs, s_prod=f32(np.prod(scales, axis=-1))[None, :].repeat(r, 0),
        scales=np.broadcast_to(scales[None], (r, c, 3)).copy(), t0=t0, t1=t1,
        sigma_t=f32(rng.uniform(0.5, 3.0, (r, c))), chi=f32(rng.uniform(0.05, 0.999, (r, c))),
        active=rng.uniform(size=(r, c)) < 0.9,
    )


def _both(x):
    """(torch, jax) views of a numpy input; coefficient triples stay triples."""
    if isinstance(x, list):
        return (QuadricCoeffs(*(torch.from_numpy(v.copy()) for v in x)),
                jq.QuadricCoeffs(*(jnp.asarray(v) for v in x)))
    return torch.from_numpy(np.asarray(x)), jnp.asarray(x)


def test_epanechnikov_functions():
    x = _inputs(1)
    c_t, c_j = _both(x["coeffs"])
    sp_t, sp_j = _both(x["s_prod"])
    q = np.linspace(0.0, 12.0, 241, dtype=np.float32)
    _close(tk.epanechnikov_eval_q(torch.from_numpy(q)), jk.epanechnikov_eval_q(q))
    qq = np.linspace(0.0, 1.5, 61, dtype=np.float32)[:, None]
    sp = np.float32([[0.01, 0.3]])
    _close(tk.epanechnikov_pdf_q(torch.from_numpy(qq), torch.from_numpy(sp)),
           jk.epanechnikov_pdf_q(qq, sp))
    args = [_both(x[k]) for k in ("t0", "t1", "active")]
    _close(tk.epanechnikov_integral_segment(c_t, sp_t, *(a[0] for a in args)),
           jk.epanechnikov_integral_segment(c_j, sp_j, *(a[1] for a in args)))
    sig, chi, act = (_both(x[k]) for k in ("sigma_t", "chi", "active"))
    got = tk.epanechnikov_inv_cdf(c_t, sp_t, sig[0], chi[0], act[0])
    want = jk.epanechnikov_inv_cdf(c_j, sp_j, sig[1], chi[1], act[1])
    assert (np.asarray(want) != 0).sum() > 100  # rays inside some supports
    _close(got, want, **INV_TOL)
    sc_t, sc_j = _both(x["scales"])
    _close(tk.epanechnikov_normalization_factor(sc_t), jk.epanechnikov_normalization_factor(sc_j))


def test_gaussian_inverse_cdf_and_normalization():
    x = _inputs(2)
    c_t, c_j = _both(x["coeffs"])
    sp_t, sp_j = _both(x["s_prod"])
    # chi above the Gaussian's escape probability: erfinv's argument in (-1, 1)
    peak = np.exp(-0.5 * np.maximum(x["coeffs"][2] - x["coeffs"][1] ** 2 / x["coeffs"][0], 0))
    full = x["sigma_t"] * peak / (2 * np.pi * x["s_prod"] * np.sqrt(x["coeffs"][0]))
    chi = np.float32(np.exp(-full * np.random.default_rng(2).uniform(0.05, 0.95, full.shape)))
    sig, chi_, act = _both(x["sigma_t"]), _both(chi), _both(x["active"])
    _close(tk.gaussian_inv_cdf(c_t, sp_t, sig[0], chi_[0], act[0]),
           jk.gaussian_inv_cdf(c_j, sp_j, sig[1], chi_[1], act[1]), **INV_TOL)
    sc_t, sc_j = _both(x["scales"])
    _close(tk.gaussian_normalization_factor(sc_t), jk.gaussian_normalization_factor(sc_j))


@pytest.mark.parametrize("kind", ["gaussian", "epanechnikov"])
@pytest.mark.parametrize("normalized,full_range",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_kernel_dispatch(kind, normalized, full_range):
    x = _inputs(3)
    kt = tk.Kernel(kind, normalized=normalized, full_range=full_range)
    kj = jk.Kernel(kind, normalized=normalized, full_range=full_range)
    c_t, c_j = _both(x["coeffs"])
    sp_t, sp_j = _both(x["s_prod"])
    sc_t, sc_j = _both(x["scales"])
    (t0_t, t0_j), (t1_t, t1_j), (a_t, a_j) = (_both(x[k]) for k in ("t0", "t1", "active"))
    # extent 1: the full-range Epanechnikov integral runs over the unit-q
    # chord (over a wider one its pdf's (1 - q) goes negative and the
    # scrubbed result is 0, in both packages)
    for extent in (1.0, 3.0):
        got = kt.density_integral(c_t, sp_t, sc_t, extent, t0_t, t1_t, a_t)
        want = kj.density_integral(c_j, sp_j, sc_j, extent, t0_j, t1_j, a_j)
        if extent == 1.0:
            assert (np.asarray(want) > 0).sum() > 100
        _close(got, want, atol=1e-6, rtol=1e-4 if normalized else 1e-5)
        # no bounds: the whole line
        _close(kt.density_integral(c_t, sp_t, sc_t, extent, None, None, a_t),
               kj.density_integral(c_j, sp_j, sc_j, extent, None, None, a_j),
               atol=1e-6, rtol=1e-4 if normalized else 1e-5)
    q = np.linspace(0.0, 12.0, 97, dtype=np.float32)
    _close(kt.eval_q(torch.from_numpy(q)), kj.eval_q(q))
    _close(kt.peak_response(c_t), kj.peak_response(c_j))
    _close(kt.pdf_q(torch.from_numpy(q[:, None]), sp_t[:1]), kj.pdf_q(q[:, None], sp_j[:1]))
    _close(kt.normalization_factor(sc_t), kj.normalization_factor(sc_j))
    sig, chi, act = (_both(x[k]) for k in ("sigma_t", "chi", "active"))
    if kind == "epanechnikov":  # (the Gaussian's erfinv: the test above)
        _close(kt.inv_cdf(c_t, sp_t, sig[0], chi[0], act[0]),
               kj.inv_cdf(c_j, sp_j, sig[1], chi[1], act[1]), **INV_TOL)


def test_unknown_kernel_type_raises():
    with pytest.raises(ValueError, match="gaussian"):
        tk.Kernel("box")
    with pytest.raises(ValueError):
        jk.Kernel("box")


def test_refusals_name_their_roadmap_items():
    """What stays unported names the ROADMAP.md item that records it: the
    TPU layout knobs have no counterpart (§D). The device mesh (§A7), the
    path tracer's general walk and the tent filter are ported: a mesh
    whose ranks do not divide the tiles raises as JAX asserts, and an
    Epanechnikov medium renders through the tent filter, on a one-rank
    mesh as without one."""
    from volprim_tpu_torch import parallel
    from volprim_tpu_torch.models import base, prb, rf_tiled
    from volprim_tpu_torch.ops import envmap
    from volprim_tpu_torch.scene import CameraSpecs, look_at, synthetic
    from volprim_tpu_torch.tools import profile_rf

    s = synthetic.make_scene(256, device="cpu")
    cam = CameraSpecs(name="c", width=16, height=16, fov=50.0,
                      to_world=look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]))
    cfg = rf_tiled.RFTiledConfig(tile_pixels=64, max_candidates=256, segment=64)
    with pytest.raises(ValueError, match="not divisible"):
        rf_tiled.render_state(rf_tiled.build_state(s, cfg), cam, cfg,
                              mesh=parallel.Mesh(0, 3, torch.device("cpu")))
    medium = synthetic.make_medium(256, device="cpu")
    imgs = []
    for mesh in (None, parallel.data_mesh("cpu")):
        gen = torch.Generator()
        gen.manual_seed(0)
        imgs.append(base.render(
            medium, synthetic.medium_camera(8, 8), prb.radiance,
            prb.PRBConfig(kernel_type="epanechnikov", walk_backend="pallas", bounce_cap=4),
            envmap.ConstantEmitter(radiance=torch.ones(3)), 1, gen, rfilter="tent",
            mesh=mesh))
    img = imgs[0]
    assert bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
    assert torch.equal(imgs[1], img)
    for argv in (["--feat_major"], ["--kernel_batch", "2"]):
        with pytest.raises(SystemExit, match="ROADMAP.md §D"):
            profile_rf.main(["--cpu", *argv])
