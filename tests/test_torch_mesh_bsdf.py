"""The port's triangle meshes (volprim_tpu_torch.scene.mesh) and surface
BSDFs (volprim_tpu_torch.ops.bsdf) against the JAX package on the same
numpy-made inputs.

Tolerances: per ray within 1e-5 (f32 Möller–Trumbore in another summation
order): intersect's valid, t, face id and barycentrics, and occluded, on
rays aimed at a Cornell box and an icosphere; normals and interpolation
within 1e-5; the builders' vertices equal and faces equal; the BSDFs'
eval and pdf within rtol 1e-4 / atol 1e-6 on numpy-made directions and
attributes (GGX's D at low roughness amplifies f32 rounding); ``sample``
fed the uniforms JAX's key draws (rebuilt with the same ``jax.random``
calls): the same directions within 1e-5, pdf and weight within rtol 1e-4;
``sample`` from a generator held in distribution (the hemisphere
quadrature of eval against the sampled weights, within 3%, as
tests/test_surfaces.py does); ``sample_surface`` held to area weighting.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ffwalk import one_torch_thread  # noqa: F401
from volprim_tpu.ops import bsdf as jbsdf
from volprim_tpu.scene import mesh as jmesh
from volprim_tpu_torch import interop
from volprim_tpu_torch.ops import bsdf
from volprim_tpu_torch.scene import mesh


def both_meshes(jm):
    tm = interop.mesh_from_arrays(np.asarray(jm.vertices), np.asarray(jm.faces),
                                  {k: np.asarray(v) for k, v in jm.attrs.items()}, device="cpu")
    return tm, jm


def box_and_sphere():
    """A Cornell box with an icosphere inside it, in both packages."""
    jm = jmesh.merge([jmesh.cornell_box(), jmesh.make_icosphere(
        [0.2, -0.3, 0.1], 0.4, subdiv=1, attrs={"base_color": [0.5, 0.6, 0.7]})])
    return both_meshes(jm)


def aimed_rays(n, seed):
    """Rays from inside and outside the box toward random points on it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3))
    o[: n // 4, 2] = -3.0  # from in front of the open side
    target = rng.uniform(-1.1, 1.1, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_builders_match_jax():
    pairs = [
        (mesh.make_rect([0, 0, 2.0], [1, 0, 0], [0, 1, 0], {"base_color": [1, 0.5, 0]},
                        device="cpu"),
         jmesh.make_rect([0, 0, 2.0], [1, 0, 0], [0, 1, 0], {"base_color": [1, 0.5, 0]})),
        (mesh.make_icosphere([0.1, 0.2, 0.3], 0.7, subdiv=2, attrs={"roughness": [0.3]},
                             device="cpu"),
         jmesh.make_icosphere([0.1, 0.2, 0.3], 0.7, subdiv=2, attrs={"roughness": [0.3]})),
        (mesh.cornell_box(1.5, device="cpu"), jmesh.cornell_box(1.5)),
    ]
    for tm, jm in pairs:
        np.testing.assert_array_equal(tm.vertices.numpy(), np.asarray(jm.vertices))
        np.testing.assert_array_equal(tm.faces.numpy(), np.asarray(jm.faces))
        assert set(tm.attrs) == set(jm.attrs)
        for k in tm.attrs:
            np.testing.assert_array_equal(tm.attrs[k].numpy(), np.asarray(jm.attrs[k]))
        for name in ("face_normals", "face_areas", "vertex_normals"):
            np.testing.assert_allclose(getattr(tm, name)().numpy(),
                                       np.asarray(getattr(jm, name)()), atol=1e-5)
    assert mesh.cornell_box(device="cpu").num_faces == 10


@pytest.mark.parametrize("chunk", [512, 7])
def test_intersect_and_occluded_match_jax(chunk):
    tm, jm = box_and_sphere()
    o, d = aimed_rays(1024, 1)
    got = [x.numpy() for x in mesh.intersect(tm, torch.from_numpy(o), torch.from_numpy(d),
                                             chunk=chunk)]
    want = [np.asarray(x) for x in jmesh.intersect(jm, jnp.asarray(o), jnp.asarray(d),
                                                   chunk=chunk)]
    assert 0.5 < got[0].mean() < 1.0
    np.testing.assert_array_equal(got[0], want[0])
    v = got[0]
    np.testing.assert_allclose(got[1][v], want[1][v], rtol=1e-5, atol=1e-5)
    assert np.all(np.isinf(got[1][~v]))
    np.testing.assert_array_equal(got[2][v], want[2][v])
    np.testing.assert_allclose(got[3][v], want[3][v], atol=1e-5)
    for t_max in (np.inf, 1.0):
        occ_t = mesh.occluded(tm, torch.from_numpy(o), torch.from_numpy(d), t_max=t_max,
                              chunk=chunk).numpy()
        occ_j = np.asarray(jmesh.occluded(jm, jnp.asarray(o), jnp.asarray(d), t_max=t_max,
                                          chunk=chunk))
        np.testing.assert_array_equal(occ_t, occ_j)
    # interpolation at the hits: colours and shading normals
    tm2 = mesh.TriangleMesh(tm.vertices, tm.faces, {**tm.attrs, "_vn": tm.vertex_normals()})
    jm2 = jmesh.TriangleMesh(jm.vertices, jm.faces, {**jm.attrs, "_vn": jm.vertex_normals()})
    for name in ("base_color", "_vn"):
        np.testing.assert_allclose(
            tm2.interpolate(name, torch.from_numpy(want[2]), torch.from_numpy(want[3])).numpy(),
            np.asarray(jm2.interpolate(name, jnp.asarray(want[2]), jnp.asarray(want[3]))),
            atol=1e-5)
    # no mesh: nothing hit
    none = mesh.intersect(None, torch.from_numpy(o), torch.from_numpy(d))
    assert not none[0].any() and torch.isinf(none[1]).all()
    assert not mesh.occluded(None, torch.from_numpy(o), torch.from_numpy(d)).any()


def test_rect_and_box_analytic():
    """tests/test_surfaces.py's analytic hits on the port."""
    m = mesh.make_rect([0, 0, 2.0], [1, 0, 0], [0, 1, 0], {"base_color": [1.0, 1.0, 1.0]},
                       device="cpu")
    o = torch.tensor([[0.2, -0.3, 0.0], [3.0, 0.0, 0.0], [0.0, 0.0, 3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    valid, t, _, _ = mesh.intersect(m, o, d)
    assert valid.tolist() == [True, False, False]
    assert abs(float(t[0]) - 2.0) < 1e-5
    box = mesh.cornell_box(device="cpu")
    np.testing.assert_allclose(box.face_areas().numpy(), 2.0)
    for direction, color in (([0.0, -1.0, 0.0], [0.73] * 3), ([-1.0, 0.0, 0.0],
                                                              [0.65, 0.05, 0.05])):
        valid, t, fid, uv = mesh.intersect(box, torch.zeros(1, 3), torch.tensor([direction]))
        assert bool(valid[0]) and abs(float(t[0]) - 1.0) < 1e-5
        np.testing.assert_allclose(box.interpolate("base_color", fid, uv)[0].numpy(), color,
                                   rtol=1e-5)
    ico = mesh.make_icosphere([0, 0, 0], 1.0, subdiv=2, device="cpu")
    v = ico.vertices
    cos = torch.sum(ico.vertex_normals() * v / torch.linalg.norm(v, dim=-1, keepdim=True), -1)
    assert float(cos.min()) > 0.99


def test_sample_surface_is_area_weighted():
    m = mesh.merge([
        mesh.make_rect([0, 0, 0], [1, 0, 0], [0, 1, 0], {"base_color": [1, 1, 1]}, device="cpu"),
        mesh.make_rect([5, 0, 0], [3, 0, 0], [0, 3, 0], {"base_color": [1, 1, 1]}, device="cpu"),
    ])
    n = 20000
    pts, normals, fid, bary, pdf = mesh.sample_surface(m, torch.Generator().manual_seed(0), n)
    frac_big = float((fid >= 2).float().mean())  # areas 4 and 36
    assert abs(frac_big - 0.9) < 4.0 * np.sqrt(0.09 / n) + 1e-3
    np.testing.assert_allclose(pdf.numpy(), 1.0 / 40.0, rtol=1e-5)
    np.testing.assert_allclose(torch.abs(normals[:, 2]).numpy(), 1.0, atol=1e-5)
    assert bool(((bary >= 0).all(1) & (bary.sum(1) <= 1 + 1e-6)).all())
    # points lie on their faces, uniformly: the mean of the big rectangle's is its centre
    big = pts[fid >= 2]
    np.testing.assert_allclose(big.mean(0).numpy(), [5.0, 0.0, 0.0], atol=0.1)
    assert float(torch.abs(big[:, 2]).max()) < 1e-6


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def bsdf_inputs(n, seed):
    rng = np.random.default_rng(seed)
    wi = unit(rng.normal(size=(n, 3)))
    wi[: n // 2, 2] = np.abs(wi[: n // 2, 2])  # half from the front side
    wo = unit(rng.normal(size=(n, 3)))
    wo[: 3 * n // 4, 2] = np.abs(wo[: 3 * n // 4, 2])
    attrs = {
        "base_color": rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32),
        "roughness": rng.uniform(0.05, 1.0, n).astype(np.float32),
        "metallic": rng.uniform(0.0, 1.0, n).astype(np.float32),
        "anisotropic": rng.uniform(0.0, 0.9, n).astype(np.float32),
        "spec_tint": rng.uniform(0.0, 1.0, n).astype(np.float32),
    }
    active = rng.uniform(size=n) < 0.9
    return wi, wo, attrs, active


MODELS = {
    "diffuse": (bsdf.Diffuse(), jbsdf.Diffuse()),
    "principled": (bsdf.Principled(), jbsdf.Principled()),
    "principled_all": (bsdf.Principled(has_anisotropic=True, has_spec_tint=True, specular=0.3),
                       jbsdf.Principled(has_anisotropic=True, has_spec_tint=True,
                                        specular=0.3)),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_bsdf_eval_pdf_sample_match_jax(model):
    tb, jb = MODELS[model]
    n = 4096
    wi, wo, attrs, active = bsdf_inputs(n, 2)
    ta = {k: torch.from_numpy(v) for k, v in attrs.items()}
    ja = {k: jnp.asarray(v) for k, v in attrs.items()}
    for fn in ("eval", "pdf"):
        got = getattr(tb, fn)(ta, torch.from_numpy(wi), torch.from_numpy(wo),
                              torch.from_numpy(active)).numpy()
        want = np.asarray(getattr(jb, fn)(ja, jnp.asarray(wi), jnp.asarray(wo),
                                          jnp.asarray(active)))
        assert np.isfinite(got).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=fn)
    # sample on the uniforms JAX's key draws (Principled: s1 then s2 from a
    # split key; Diffuse: s2 from the key itself)
    key = jax.random.PRNGKey(3)
    if model == "diffuse":
        s1, s2 = None, np.asarray(jax.random.uniform(key, (n, 2)))
    else:
        k1, k2 = jax.random.split(key)
        s1 = np.asarray(jax.random.uniform(k1, (n,)))
        s2 = np.asarray(jax.random.uniform(k2, (n, 2)))
    got = tb.sample(ta, torch.from_numpy(wi), None if s1 is None else torch.from_numpy(s1),
                    torch.from_numpy(s2), torch.from_numpy(active))
    want = jb.sample(ja, jnp.asarray(wi), key, jnp.asarray(active))
    g = [x.numpy() for x in got]
    w = [np.asarray(x) for x in want]
    ok = w[1] > 0
    assert ok.mean() > 0.3
    np.testing.assert_array_equal(g[1] > 0, ok)
    np.testing.assert_allclose(g[0][ok], w[0][ok], atol=1e-5)
    np.testing.assert_allclose(g[1], w[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g[2], w[2], rtol=1e-4, atol=1e-6)


def test_frames_and_fresnel_match_jax():
    rng = np.random.default_rng(5)
    n = unit(rng.normal(size=(512, 3)))
    v = unit(rng.normal(size=(512, 3)))
    loc = bsdf.to_local(torch.from_numpy(n), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(loc, np.asarray(jbsdf.to_local(jnp.asarray(n), jnp.asarray(v))),
                               atol=1e-6)
    np.testing.assert_allclose(bsdf.to_world(torch.from_numpy(n), torch.from_numpy(loc)).numpy(),
                               v, atol=1e-5)
    cos = np.linspace(-1.0, 1.0, 257).astype(np.float32)
    for eta in (1.5, 1.0 / 1.33):
        np.testing.assert_allclose(bsdf.fresnel_dielectric(torch.from_numpy(cos), eta).numpy(),
                                   np.asarray(jbsdf.fresnel_dielectric(jnp.asarray(cos), eta)),
                                   atol=1e-6)
    s2 = np.random.default_rng(6).uniform(size=(512, 2)).astype(np.float32)
    wi = unit(np.abs(rng.normal(size=(512, 3))))
    m_t = bsdf.ggx_sample_vndf(torch.from_numpy(wi), 0.3, 0.5, torch.from_numpy(s2)).numpy()
    m_j = np.asarray(jbsdf.ggx_sample_vndf(jnp.asarray(wi), 0.3, 0.5, jnp.asarray(s2)))
    np.testing.assert_allclose(m_t, m_j, atol=1e-5)


def test_sampling_in_distribution():
    """Sampling on a generator's uniforms: Diffuse's mean weight is its albedo
    (the white furnace); Principled's sampled weights against a uniform
    hemisphere quadrature of eval, within 3% (tests/test_surfaces.py)."""
    n = 100_000
    g = torch.Generator().manual_seed(0)
    wi = torch.nn.functional.normalize(torch.tensor([[0.3, 0.1, 0.95]]), dim=-1).expand(n, 3)
    attrs = {"base_color": torch.full((n, 3), 0.7)}
    wo, pdf, w = bsdf.Diffuse().sample(attrs, wi, None, torch.rand((n, 2), generator=g))
    np.testing.assert_allclose(w.double().mean(0).numpy(), 0.7, rtol=1e-5)
    np.testing.assert_allclose((bsdf.Diffuse().eval(attrs, wi, wo) / pdf[:, None]).numpy(),
                               w.numpy(), rtol=1e-5)
    b = bsdf.Principled()
    wi = torch.nn.functional.normalize(torch.tensor([[0.4, -0.2, 0.8]]), dim=-1).expand(n, 3)
    for rough, metal in ((0.3, 0.0), (0.7, 1.0), (0.15, 0.5)):
        attrs = {"base_color": torch.full((n, 3), 0.6), "roughness": torch.full((n,), rough),
                 "metallic": torch.full((n,), metal)}
        s1 = torch.rand((n,), generator=g)
        wo, pdf, w = b.sample(attrs, wi, s1, torch.rand((n, 2), generator=g))
        u = torch.rand((n, 2), generator=g)
        r = torch.sqrt(torch.clamp(1.0 - u[:, 0] ** 2, min=0.0))
        phi = 2 * np.pi * u[:, 1]
        wo_u = torch.stack([r * torch.cos(phi), r * torch.sin(phi), u[:, 0]], -1)
        quad = b.eval(attrs, wi, wo_u).double().mean(0) * 2 * np.pi
        np.testing.assert_allclose(w.double().mean(0).numpy(), quad.numpy(), rtol=0.03)
        integral = float(b.pdf(attrs, wi, wo_u).double().mean()) * 2 * np.pi
        assert 0.5 < integral < 1.02
