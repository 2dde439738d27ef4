"""The port's path tracer (volprim_tpu_torch.models.prb), its emitters and
its render loop against the JAX package and against analytic answers.

JAX's threefry stream cannot be reproduced, so whole-image parity is
statistical: per-channel means within 4 standard errors of their
difference. Everything downstream of the uniforms is compared on the same
numbers: optical depth within 1e-4 relative (sums over thousands of
primitives in another order), emitter and phase sampling within 1e-5
(f32 transcendental rounding)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ffwalk import both_scenes, cloud_arrays, one_torch_thread, rays  # noqa: F401
from volprim_tpu.models import prb as jprb
from volprim_tpu.ops import envmap as jenvmap
from volprim_tpu_torch import as_device, default_device, parallel
from volprim_tpu_torch.models import base, prb, render
from volprim_tpu_torch.ops import bsdf, envmap, kernels, quadric
from volprim_tpu_torch.scene import generate_rays, mesh, synthetic

CFG = prb.PRBConfig(walk_backend="pallas")


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        as_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.make_medium(16)
    assert as_device("cpu") == torch.device("cpu")


def test_plume_is_seeded_and_in_range():
    a = synthetic.make_medium_arrays(4096, seed=0)
    b = synthetic.make_medium_arrays(4096, seed=0)
    for key in a:
        assert a[key].dtype == np.float32
        np.testing.assert_array_equal(a[key], b[key])
    assert a["centers"].shape == (4096, 3) and a["sigma_t"].shape == (4096, 1)
    assert np.abs(a["centers"]).max() <= 1.0
    assert 0.0 < a["sigma_t"].min() and a["sigma_t"].max() <= synthetic.MEDIUM_SIGMA
    assert 0.02 <= a["scales"].min() and a["scales"].max() <= 0.06
    np.testing.assert_allclose(np.linalg.norm(a["quats"], axis=1), 1.0, rtol=1e-6)
    assert not np.array_equal(a["centers"], synthetic.make_medium_arrays(4096, 1)["centers"])
    # the plume rises along +y: its centers spread wider at the top
    top = a["centers"][:, 1] > 0.3
    bottom = a["centers"][:, 1] < -0.3
    assert np.abs(a["centers"][top][:, [0, 2]]).mean() > np.abs(
        a["centers"][bottom][:, [0, 2]]).mean()
    # MEDIUM_SIGMA: median optical depth of the central 64 x 64 rays in [1, 4]
    scene = synthetic.make_medium(4096, 0, device="cpu")
    o, d = generate_rays(synthetic.medium_camera(512, 512), jitter=False, device="cpu")
    center = (slice(224, 288), slice(224, 288))
    o = o.reshape(512, 512, 3)[center].reshape(-1, 3)
    d = d.reshape(512, 512, 3)[center].reshape(-1, 3)
    f = prb.optical_depth(scene, o, d, CFG)
    assert 1.0 <= float(f.median()) <= 4.0


def test_optical_depth_and_transmittance_match_jax():
    """Against JAX and, as the yardstick, a float64 run of the port: the
    small plume primitives seen from ~4 away have c ~ 1e4 in q_min = c -
    b^2/a, whose cancellation puts both f32 runs ~5e-4 from f64 (XLA's FMA
    contraction and torch's separate roundings decide the last bits). The
    port must stay within 2x JAX's own largest deviation from f64."""
    a = synthetic.make_medium_arrays(4096, seed=0)
    ts, js = both_scenes(a)
    o, d = generate_rays(synthetic.medium_camera(16, 16), jitter=False, device="cpu")
    oj, dj = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    jcfg = jprb.PRBConfig()
    t64 = dataclasses.replace(
        ts, centers=ts.centers.double(), scales=ts.scales.double(), quats=ts.quats.double(),
        attrs={k: v.double() for k, v in ts.attrs.items()},
    )
    for t_max in (prb._BIG_T, 4.0):
        want = np.asarray(jprb.optical_depth(js, oj, dj, jcfg, t_max))
        got = prb.optical_depth(ts, o, d, CFG, t_max).numpy()
        yard = prb.optical_depth(t64, o.double(), d.double(), CFG, t_max).numpy()
        assert want.max() > 1.0
        dev_jax = np.abs(want - yard).max()
        assert np.abs(got - yard).max() <= 2.0 * dev_jax + 1e-7
        np.testing.assert_allclose(got, want, atol=3.0 * dev_jax, rtol=0)
        np.testing.assert_allclose(
            prb.transmittance(ts, o, d, CFG, t_max).numpy(),
            np.asarray(jprb.transmittance(js, oj, dj, jcfg, t_max)), atol=3.0 * dev_jax, rtol=0,
        )


def test_envmap_matches_jax():
    jsky = jenvmap.procedural_sky(32, 64)
    tsky = envmap.procedural_sky(32, 64, device="cpu")
    for name in ("data", "row_cdf", "cond_cdf", "lum", "lum_integral"):
        np.testing.assert_allclose(getattr(tsky, name).numpy(), np.asarray(getattr(jsky, name)),
                                   rtol=1e-5, atol=1e-7)
    # sampling on JAX's own tables (identical CDFs), JAX's uniforms
    tsky = envmap.EnvironmentMap(**{
        name: torch.from_numpy(np.array(getattr(jsky, name)))
        for name in ("data", "row_cdf", "cond_cdf", "lum", "lum_integral")
    })
    u = np.array(jax.random.uniform(jax.random.PRNGKey(3), (4096, 2)))
    jd, jv, jp = (np.asarray(x) for x in jsky.sample_direction(jnp.asarray(u)))
    td, tv, tp = (x.numpy() for x in tsky.sample_direction(torch.from_numpy(u)))
    np.testing.assert_allclose(td, jd, atol=1e-5)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tp, jp, rtol=1e-4)
    dirs = np.array(jax.random.normal(jax.random.PRNGKey(4), (4096, 3)))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    np.testing.assert_allclose(tsky.eval(torch.from_numpy(dirs)).numpy(),
                               np.asarray(jsky.eval(jnp.asarray(dirs))), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tsky.pdf_direction(torch.from_numpy(dirs)).numpy(),
                               np.asarray(jsky.pdf_direction(jnp.asarray(dirs))), rtol=1e-4)
    jc = jenvmap.ConstantEmitter(radiance=jnp.asarray([0.5, 1.0, 2.0]))
    tc = envmap.ConstantEmitter(radiance=torch.tensor([0.5, 1.0, 2.0]))
    for x, y in zip(tc.sample_direction(torch.from_numpy(u)), jc.sample_direction(jnp.asarray(u))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    np.testing.assert_allclose(tc.pdf_direction(torch.from_numpy(dirs)).numpy(), 1 / (4 * np.pi))


@pytest.mark.parametrize("phase", ["isotropic", "hg"])
def test_sample_phase_matches_jax(phase):
    key = jax.random.PRNGKey(8)
    d_in = np.array(jax.random.normal(jax.random.PRNGKey(9), (2048, 3)))
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    jcfg = jprb.PRBConfig(phase=phase, phase_g=0.6)
    wo_j, pdf_j = jprb._sample_phase(key, jnp.asarray(d_in), jcfg)
    k1, k2 = jax.random.split(key)  # the uniforms _sample_phase draws
    u = np.stack([np.array(jax.random.uniform(k, (2048,))) for k in (k1, k2)], axis=1)
    tcfg = prb.PRBConfig(phase=phase, phase_g=0.6)
    wo_t, pdf_t = prb._sample_phase(torch.from_numpy(u), torch.from_numpy(d_in), tcfg)
    np.testing.assert_allclose(wo_t.numpy(), np.asarray(wo_j), atol=1e-5)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-5)
    np.testing.assert_allclose(
        prb.eval_phase_pdf(torch.from_numpy(d_in), wo_t, tcfg).numpy(),
        np.asarray(jprb.eval_phase_pdf(jnp.asarray(d_in), wo_j, jcfg)), rtol=1e-4,
    )


def line_depth(scene, o, d):
    """D: the Gaussians' whole-line integral along one ray, summed."""
    c = quadric.ray_prim_coeffs(o[:1], d[:1], scene.centers, scene.scales, scene.quats)
    full = kernels.gaussian_integral_full(c, scene.scale_prod()[None, :],
                                          torch.ones_like(c.a, dtype=torch.bool))
    return full[0]


def same_rays(n):
    o = torch.tensor([[0.0, 0.0, -5.0]]).expand(n, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    return o, d


def test_found_probability_is_one_minus_transmittance():
    ts, _ = both_scenes(cloud_arrays(6, 9, 0.15, 0.3, 0.5))
    n = 4096
    o, d = same_rays(n)
    g = torch.Generator().manual_seed(2)
    xi = 1e-7 + (1 - 1e-7) * torch.rand(n, generator=g)
    cfg = prb.PRBConfig(max_overlaps=8, max_windows=6, chunk_size=64, walk_backend="pallas")
    found, dead, _, _, _, _ = prb.free_flight(ts, o, d, xi, cfg, torch.ones(n, dtype=torch.bool))
    assert not dead.any()
    t = float(torch.exp(-torch.sum(line_depth(ts, o, d) * ts.attrs["sigma_t"][:, 0])))
    tol = 4.0 * math.sqrt(t * (1 - t) / n)
    assert abs(float(found.float().mean()) - (1.0 - t)) < tol


def absorbing():
    """One Gaussian with albedo 0 under a unit constant sky: each ray's L
    is 1 with probability T and 0 otherwise."""
    a = dict(centers=np.zeros((1, 3), np.float32), scales=np.full((1, 3), 0.5, np.float32),
             quats=np.asarray([[0, 0, 0, 1.0]], np.float32),
             sigma_t=np.asarray([[3.0]], np.float32), albedo=np.zeros((1, 3), np.float32))
    ts, _ = both_scenes(a)
    cfg = prb.PRBConfig(max_overlaps=4, max_windows=2, chunk_size=8, bounce_cap=32,
                        walk_backend="pallas")
    return ts, envmap.ConstantEmitter(radiance=torch.ones(3)), cfg


def test_absorbing_medium_radiance_is_transmittance():
    ts, sky, cfg = absorbing()
    n = 8192
    o, d = same_rays(n)
    L = prb.radiance(ts, sky, o, d, cfg, torch.Generator().manual_seed(1))
    t = math.exp(-3.0 * float(line_depth(ts, o, d).sum()))
    assert set(np.unique(L.numpy())) <= {0.0, 1.0}
    assert abs(float(L[:, 0].mean()) - t) < 4.0 * math.sqrt(t * (1 - t) / n)


def test_score_gradient_of_absorbing_medium():
    """dE[L]/dsigma_t = -D T through autograd (tests/test_ffwalk.py:262)."""
    ts, sky, cfg = absorbing()
    n = 8192
    o, d = same_rays(n)
    sig = ts.attrs["sigma_t"].clone().requires_grad_(True)
    ts.attrs["sigma_t"] = sig
    L = prb.radiance(ts, sky, o, d, cfg, torch.Generator().manual_seed(4))
    L[:, 0].mean().backward()
    d_full = float(line_depth(ts, o, d).sum())
    t = math.exp(-3.0 * d_full)
    expected = -d_full * t
    tol = 4.0 * d_full * math.sqrt(t * (1 - t) / n) + 0.02 * abs(expected)
    assert abs(float(sig.grad[0, 0]) - expected) < tol


def test_radiance_matches_jax_in_distribution():
    a = cloud_arrays(10, 13, 0.4, 0.15, 0.5)
    ts, js = both_scenes(a)
    n = 1024
    o, d, _ = rays(n, 21)
    radiance = np.asarray([0.6, 0.8, 1.0], np.float32)
    jcfg = jprb.PRBConfig(max_overlaps=8, max_windows=6, chunk_size=64, bounce_cap=8,
                          walk_backend="pallas")
    lj = np.asarray(jprb.radiance(js, jenvmap.ConstantEmitter(radiance=jnp.asarray(radiance)),
                                  jnp.asarray(o), jnp.asarray(d), jcfg, jax.random.PRNGKey(5)))
    tcfg = prb.PRBConfig(max_overlaps=8, max_windows=6, chunk_size=64, bounce_cap=8,
                         walk_backend="pallas")
    lt = prb.radiance(ts, envmap.ConstantEmitter(radiance=torch.from_numpy(radiance)),
                      torch.from_numpy(o), torch.from_numpy(d), tcfg,
                      torch.Generator().manual_seed(5)).numpy()
    assert np.all(np.isfinite(lt)) and lt.shape == (n, 3)
    se = np.sqrt(lt.var(0) / n + lj.var(0) / n)
    print("means port", lt.mean(0), "jax", lj.mean(0), "4 se", 4 * se)
    assert np.all(np.abs(lt.mean(0) - lj.mean(0)) <= 4 * se)


def test_render_is_finite_seeded_and_reproducible():
    scene = synthetic.make_medium(4096, 0, device="cpu")
    cam = synthetic.medium_camera(32, 32)
    sky = envmap.procedural_sky(device="cpu")
    imgs = [render(scene, cam, prb.radiance, CFG, sky, 2, torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert imgs[0].shape == (32, 32, 3)
    assert bool(torch.isfinite(imgs[0]).all()) and float(imgs[0].mean()) > 0.0
    assert torch.equal(imgs[0], imgs[1])
    assert not torch.equal(imgs[0], imgs[2])


def test_unported_options_raise():
    """What still raises: a missing generator. The path tracer's options
    raise no more (test_options_render renders them), nor does a device
    mesh (ROADMAP.md §A7, ported): on one rank the render loop draws what
    it draws without one."""
    ts, sky, cfg = absorbing()
    o, d = same_rays(4)
    with pytest.raises(ValueError, match="Generator"):
        prb.radiance(ts, sky, o, d, cfg)
    cam = synthetic.medium_camera(4, 4)
    imgs = []
    for mesh in (None, parallel.data_mesh("cpu")):
        g = torch.Generator()
        g.manual_seed(1)
        imgs.append(base.render(ts, cam, prb.radiance, cfg, sky, 2, g, mesh=mesh))
    assert torch.equal(imgs[0], imgs[1])
    with pytest.raises(ValueError, match="Generator"):
        base.render(ts, cam, prb.radiance, cfg, sky, 1)


@pytest.mark.parametrize("option", [
    dict(walk_backend="xla"), dict(jump=False), dict(use_clusters=True, cluster_size=8),
    dict(coeff_gemm=True), dict(kernel_type="epanechnikov"), dict(rfilter="tent"),
    dict(spp_group=2), dict(mesh=True), dict(defaults=True),
], ids=lambda kw: next(iter(kw)))
def test_options_render(option):
    """The options that raised before the rest of the path tracer was
    ported: each renders a finite 8x8 frame of the absorbing medium, and the
    default PRBConfig() renders too."""
    ts, sky, cfg = absorbing()
    cam = synthetic.medium_camera(8, 8)
    kw, cfg_kw = {}, {}
    for key, value in option.items():
        if key in ("rfilter", "spp_group"):
            kw[key] = value
        elif key == "mesh":
            m = mesh.make_rect([0, -0.8, 0], [3, 0, 0], [0, 0, -3], {"base_color": [0.5] * 3},
                               device="cpu")
            kw["radiance_fn"] = lambda *a: prb.radiance(*a, mesh=m, bsdf=bsdf.Diffuse())
        elif key == "defaults":
            cfg = prb.PRBConfig()
        else:
            cfg_kw[key] = value
    cfg = dataclasses.replace(cfg, **cfg_kw)
    fn = kw.pop("radiance_fn", prb.radiance)
    img = base.render(ts, cam, fn, cfg, sky, 2, torch.Generator().manual_seed(3), **kw)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert float(img.max()) > 0.0
