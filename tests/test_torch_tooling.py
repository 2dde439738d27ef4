"""The port's research tooling (volprim_tpu_torch.tooling: energy_pmf,
regularizer, sh_fit, remesh, visualizer), ``utils.benchmark.measure`` and
the smaller public names it shares with the JAX package (``sh.eval_emission``,
``ops.linear_to_srgb``, ``kernels.gaussian_peak_response``,
``tiles.tile_cones`` / ``cone_cull_keys`` / ``shortlist_approx``,
``native.morton_argsort``, the aliases) against the JAX package on
numpy-made inputs.

Tolerances:
- held exactly (both packages compute in f64 numpy): ``knn_edges``,
  ``edges_from_faces``, ``remesh``'s vertices, faces and attributes, the
  quadrature nodes and weights (made in f64, cast once), the overlays
  ``draw_points`` / ``draw_rays``, ``morton_argsort``;
- atol 1e-6 / rtol 1e-5 in f32 (tests/test_torch_ops.py:26): the TV value
  and its gradient, ``fit_sh`` of a fixed function, ``fit_sh_batched``
  under a small ``ray_budget`` against its own unchunked run and JAX's,
  the EnergyPMF ``pmf`` / ``cdf``, ``render_mesh_attribute`` at 64x48 on
  the pixels whose hit (valid and face id) is the same in both packages
  (those that differ are counted, at most 1%), the closed name gaps;
- the rays ``fit_sh_on_mesh`` queries, batch by batch, within 1e-6 of
  JAX's;
- in distribution, within 4 standard errors: ``EnergyPMF.sample``'s bin
  frequencies against the pmf and against JAX's draws, ``fit_sh_on_mesh``'s
  coefficients per basis function (over 8 seeds against 8 JAX keys);
- the JAX tests' own criteria on the port: the quadrature's integrals,
  the SH round trip, the diffuse plane's SH fit within 0.15 of direct
  queries, the headless visualizer, remeshing, and the ``measure`` checks
  of tests/test_utils_filters.py:147-163.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import native as jnative
from volprim_tpu import ops as jops
from volprim_tpu.accel import tiles as jtiles
from volprim_tpu.ops import bsdf as jbsdf
from volprim_tpu.ops import envmap as jenvmap
from volprim_tpu.ops import kernels as jkernels
from volprim_tpu.ops import quadric as jquadric
from volprim_tpu.ops import sh as jsh
from volprim_tpu.scene import CameraSpecs as JCameraSpecs
from volprim_tpu.scene import generate_rays as jgenerate_rays
from volprim_tpu.scene import mesh as jmesh
from volprim_tpu.tooling import energy_pmf as jpmf
from volprim_tpu.tooling import radiance_cache as jrc
from volprim_tpu.tooling import regularizer as jreg
from volprim_tpu.tooling import remesh as jremesh
from volprim_tpu.tooling import sh_fit as jsh_fit
from volprim_tpu.tooling import visualizer as jvis
from volprim_tpu_torch import interop, native, ops
from volprim_tpu_torch.accel import clusters, tiles
from volprim_tpu_torch.ops import bsdf, envmap, kernels, quadric, quaternion, sh
from volprim_tpu_torch.scene import CameraSpecs, generate_rays, look_at
from volprim_tpu_torch.scene import mesh
from volprim_tpu_torch.tooling import energy_pmf, radiance_cache, regularizer, remesh, sh_fit
from volprim_tpu_torch.tooling import visualizer
from volprim_tpu_torch.utils import benchmark

TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_meshes(jm):
    tm = interop.mesh_from_arrays(np.asarray(jm.vertices), np.asarray(jm.faces),
                                  {k: np.asarray(v) for k, v in jm.attrs.items()}, device="cpu")
    return tm, jm


def unit_dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# ---- EnergyPMF --------------------------------------------------------------


def test_energy_pmf_tables_and_jax_test():
    e = np.random.default_rng(0).uniform(-0.2, 3.0, 64).astype(np.float32)
    e[[3, 17]] = 0.0
    got = energy_pmf.EnergyPMF.from_energies(torch.from_numpy(e))
    want = jpmf.EnergyPMF.from_energies(jnp.asarray(e))
    np.testing.assert_allclose(got.pmf.numpy(), np.asarray(want.pmf), **TOL)
    np.testing.assert_allclose(got.cdf.numpy(), np.asarray(want.cdf), **TOL)
    # tests/test_tooling.py::test_energy_pmf on the port
    pmf = energy_pmf.EnergyPMF.from_energies(torch.tensor([1.0, 3.0, 0.0, 4.0]))
    np.testing.assert_allclose(pmf.pmf.numpy(), [0.125, 0.375, 0.0, 0.5])
    assert pmf.test(torch.Generator().manual_seed(0), n=100000)
    idx = pmf.sample(torch.Generator().manual_seed(1), (1000,))
    assert idx.shape == (1000,) and not bool(torch.any(idx == 2))
    assert float(pmf.eval_pdf(torch.tensor([1, 3])).sum()) == 0.875


def test_energy_pmf_sample_in_distribution():
    e = np.random.default_rng(1).uniform(0.0, 2.0, 12).astype(np.float32)
    n = 200000
    got = energy_pmf.EnergyPMF.from_energies(torch.from_numpy(e))
    want = jpmf.EnergyPMF.from_energies(jnp.asarray(e))
    ft = np.bincount(got.sample(torch.Generator().manual_seed(2), (n,)).numpy(), minlength=12) / n
    fj = np.bincount(np.asarray(want.sample(jax.random.PRNGKey(2), (n,))), minlength=12) / n
    p = got.pmf.numpy().astype(np.float64)
    se = np.sqrt(p * (1 - p) / n)
    assert (np.abs(ft - p) <= 4 * se + 1e-12).all(), (ft, p)
    assert (np.abs(ft - fj) <= 4 * math.sqrt(2) * se + 1e-12).all(), (ft, fj)


# ---- regularizer ------------------------------------------------------------


def test_edge_lists_equal_jax():
    jm = jmesh.make_icosphere([0.0, 0.0, 0.0], 1.0, subdiv=1)
    faces = np.asarray(jm.faces)
    assert np.array_equal(regularizer.edges_from_faces(faces), jreg.edges_from_faces(faces))
    pts = np.random.default_rng(3).normal(size=(200, 3))
    for k in (1, 4, 7):
        assert np.array_equal(regularizer.knn_edges(pts, k), jreg.knn_edges(pts, k))
    e = regularizer.knn_edges(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5.0]]), k=1)
    assert e.shape[1] == 2 and ({(0, 1)} <= {tuple(r) for r in e}
                                or {(0, 2)} <= {tuple(r) for r in e})


def test_tv_value_and_gradient():
    rng = np.random.default_rng(4)
    edges = regularizer.knn_edges(rng.normal(size=(60, 3)), 4)
    attr = rng.normal(size=(60, 3)).astype(np.float32)
    reg = regularizer.TVRegularizer(edges, device="cpu")
    a = torch.from_numpy(attr).requires_grad_(True)
    val = reg.compute_loss(a)
    val.backward()
    jreg_ = jreg.TVRegularizer(edges)
    jval, jgrad = jax.value_and_grad(jreg_.compute_loss)(jnp.asarray(attr))
    np.testing.assert_allclose(float(val.detach()), float(jval), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jgrad), **TOL)
    # tests/test_tooling.py::test_tv_regularizer on the port
    reg = regularizer.TVRegularizer(np.array([[0, 1], [1, 2]]), device="cpu")
    x = torch.tensor([[0.0], [1.0], [3.0]], requires_grad=True)
    loss = reg.compute_loss(x)
    loss.backward()
    assert float(loss.detach()) == 1.5 and float(x.grad[2, 0]) > 0.0 and float(x.grad[0, 0]) < 0.0


# ---- sh_fit -----------------------------------------------------------------


@pytest.mark.parametrize("res", [9, 15, 31])
def test_quadrature_equals_jax(res):
    d, w = sh_fit.spherical_quadrature(res, "cpu")
    jd, jw = jsh_fit.spherical_quadrature(res)
    assert np.array_equal(d.numpy(), np.asarray(jd)) and np.array_equal(w.numpy(), np.asarray(jw))
    assert np.array_equal(np.stack(sh_fit.composite_simpson(res)),
                          np.stack(jsh_fit.composite_simpson(res)))
    if res == 31:  # tests/test_tooling.py's integrals of 1 and y^2
        np.testing.assert_allclose(float(w.sum()), 4 * np.pi, rtol=1e-4)
        np.testing.assert_allclose(float((w * d[:, 1] ** 2).sum()), 4 * np.pi / 3, rtol=1e-4)


def test_fit_sh_and_eval_sh():
    rng = np.random.default_rng(5)
    c1 = rng.normal(size=16).astype(np.float32)
    c3 = rng.normal(size=(16, 3)).astype(np.float32)
    for c in (c1, c3):
        tc, jc = torch.from_numpy(c), jnp.asarray(c)
        got = sh_fit.fit_sh(lambda d: sh.eval_basis(d, 3) @ tc, degree=3, res=31, device="cpu")
        want = jsh_fit.fit_sh(lambda d: jsh.eval_basis(d, 3) @ jc, degree=3, res=31)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), c, atol=2e-3)  # the JAX test's round trip
        d = unit_dirs(64, 6)
        rec = sh_fit.eval_sh(got, torch.from_numpy(d))
        np.testing.assert_allclose(rec.numpy(), np.asarray(jsh_fit.eval_sh(want, jnp.asarray(d))),
                                   **TOL)
        np.testing.assert_allclose(rec.numpy(), (sh.eval_basis(torch.from_numpy(d), 3) @ tc)
                                   .numpy(), atol=5e-3)


def test_fit_sh_batched_chunks():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(23, 3)).astype(np.float32)

    def field(p, d):  # [P, M, 2], smooth in d
        return torch.stack([torch.exp(d @ p.T).T, torch.sin(3.0 * (d @ p.T).T)], dim=-1)

    def jfield(p, d):
        return jnp.stack([jnp.exp(d @ p.T).T, jnp.sin(3.0 * (d @ p.T).T)], axis=-1)

    m = 15 * 29
    whole = sh_fit.fit_sh_batched(field, torch.from_numpy(pts), degree=2, res=15)
    chunked = sh_fit.fit_sh_batched(field, torch.from_numpy(pts), degree=2, res=15,
                                    ray_budget=4 * m + 7)  # batches of 4 points
    want = jsh_fit.fit_sh_batched(jfield, jnp.asarray(pts), degree=2, res=15,
                                  ray_budget=4 * m + 7)
    assert whole.shape == (23, 9, 2)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **TOL)


def diffuse_plane():
    jm = jmesh.make_rect([0, 0, 0], [3, 0, 0], [0, 0, -3], attrs={"base_color": [0.8, 0.8, 0.8]})
    tm, _ = both_meshes(jm)
    tcache = radiance_cache.RadianceCache(emitter=envmap.ConstantEmitter(radiance=torch.ones(3)),
                                          mesh=tm, bsdf=bsdf.Diffuse(), integrator="prb")
    jcache = jrc.RadianceCache(emitter=jenvmap.ConstantEmitter(radiance=jnp.ones(3)), mesh=jm,
                               bsdf=jbsdf.Diffuse(), integrator="prb")
    return tm, jm, tcache, jcache


def test_fit_sh_on_mesh_diffuse_plane():
    """tests/test_tooling.py's diffuse-plane test on the port: the SH
    reconstruction at 8 interior directions of vertex 0 within 0.15 of
    directly queried outgoing radiance; a ray budget that splits the
    vertices leaves the coefficients' statistics alone."""
    tm, _, cache, _ = diffuse_plane()
    g = torch.Generator().manual_seed(0)
    coeffs = sh_fit.fit_sh_on_mesh(cache, tm, degree=2, res=9, generator=g)
    assert coeffs.shape == (4, 9, 3) and bool(torch.isfinite(coeffs).all())
    rng = np.random.default_rng(0)
    dl = rng.normal(size=(8, 3))
    dl[:, 2] = np.abs(dl[:, 2]) + 1.0
    dl = torch.from_numpy((dl / np.linalg.norm(dl, axis=-1, keepdims=True)).astype(np.float32))
    recon = sh.eval_basis(dl, 2) @ coeffs[0]
    v0, n0 = tm.vertices[0], tm.vertex_normals()[0]
    dw = bsdf.to_world(n0.expand(8, 3), dl)
    o = (v0 + n0 * 1e-3)[None, :] + dw * 1e-3
    direct = cache.query(o, -dw, torch.Generator().manual_seed(0))
    assert float((recon - direct).abs().mean()) < 0.15, (recon, direct)
    split = sh_fit.fit_sh_on_mesh(cache, tm, degree=2, res=9, ray_budget=2 * 9 * 17,
                                  generator=torch.Generator().manual_seed(1))
    assert split.shape == coeffs.shape and bool(torch.isfinite(split).all())


def test_fit_sh_on_mesh_query_rays(monkeypatch):
    """The rays fit_sh_on_mesh queries, batch by batch, within 1e-6 of
    JAX's (the cache's query recorded in both packages)."""
    tm, jm, tcache, jcache = diffuse_plane()
    calls = {"port": [], "jax": []}
    for key, cache, zeros in (("port", tcache, torch.zeros), ("jax", jcache, jnp.zeros)):
        monkeypatch.setattr(cache, "query", lambda o, d, *a, key=key, zeros=zeros: (
            calls[key].append((np.asarray(o), np.asarray(d))), zeros(o.shape))[1])
    budget = 3 * 9 * 17
    sh_fit.fit_sh_on_mesh(tcache, tm, degree=2, res=9, ray_budget=budget)
    jsh_fit.fit_sh_on_mesh(jcache, jm, degree=2, res=9, ray_budget=budget)
    assert len(calls["port"]) == len(calls["jax"]) == 2  # 3 vertices, then 1
    for (o, d), (jo, jd) in zip(calls["port"], calls["jax"]):
        np.testing.assert_allclose(o, jo, atol=1e-6)
        np.testing.assert_allclose(d, jd, atol=1e-6)


def test_fit_sh_on_mesh_in_distribution():
    """Per basis function, the coefficients' mean over vertices and
    channels, over 8 seeds against 8 JAX keys."""
    tm, jm, tcache, jcache = diffuse_plane()
    runs = {"port": [], "jax": []}
    for s in range(8):
        c = sh_fit.fit_sh_on_mesh(tcache, tm, degree=2, res=9,
                                  generator=torch.Generator().manual_seed(10 + s))
        runs["port"].append(c.numpy().mean(axis=(0, 2)))
        jc = jsh_fit.fit_sh_on_mesh(jcache, jm, degree=2, res=9, key=jax.random.PRNGKey(10 + s))
        runs["jax"].append(np.asarray(jc).mean(axis=(0, 2)))
    m = {k: np.mean(v, 0) for k, v in runs.items()}
    se = np.sqrt(sum(np.var(v, 0, ddof=1) / len(v) for v in runs.values()))
    z = np.abs(m["port"] - m["jax"]) / np.maximum(se, 1e-30)
    assert (z <= 4.0).all(), (m, se, z)
    assert m["port"][0] > 1.0  # the DC term of Lo ~ 0.8 over the upper hemisphere


# ---- remesh -----------------------------------------------------------------


def remesh_input():
    jm = jmesh.make_icosphere([0.0, 0.0, 0.0], 1.0, subdiv=1)
    jm = jmesh.TriangleMesh(jm.vertices, jm.faces, {"c": jm.vertices[:, :1] * 0.5 + 0.5})
    return both_meshes(jm)


def same_mesh(t, j):
    assert np.array_equal(t.vertices.numpy(), np.asarray(j.vertices))
    assert np.array_equal(t.faces.numpy(), np.asarray(j.faces).astype(np.int64))
    assert sorted(t.attrs) == sorted(j.attrs)
    for k in t.attrs:
        assert np.array_equal(t.attrs[k].numpy(), np.asarray(j.attrs[k]))


@pytest.mark.parametrize("op", ["subdivide", "collapse", "smooth"])
def test_remesh_steps_equal_jax(op):
    tm, jm = remesh_input()
    if op == "subdivide":
        same_mesh(remesh.subdivide(tm), jremesh.subdivide(jm))
    elif op == "collapse":
        t, j = remesh.subdivide(tm), jremesh.subdivide(jm)
        same_mesh(remesh.collapse_short_edges(t, 0.3), jremesh.collapse_short_edges(j, 0.3))
    else:
        same_mesh(remesh.tangential_smooth(tm, 0.4, 3), jremesh.tangential_smooth(jm, 0.4, 3))
    assert np.array_equal(remesh.edge_lengths(tm), jremesh.edge_lengths(jm))


def test_remesh_to_target():
    """tests/test_tooling.py's remeshing test on the port, each result equal
    to JAX's."""
    tm, jm = remesh_input()
    med0 = float(np.median(remesh.edge_lengths(tm)))
    fine, jfine = remesh.remesh_to_target(tm, med0 / 4.0), jremesh.remesh_to_target(jm, med0 / 4.0)
    same_mesh(fine, jfine)
    med_f = float(np.median(remesh.edge_lengths(fine)))
    assert med_f < med0 / 2.0 and fine.num_faces > 4 * tm.num_faces
    r = np.linalg.norm(fine.vertices.numpy(), axis=1)
    assert 0.8 < r.min() and r.max() < 1.1
    c = fine.attrs["c"].numpy()
    assert c.shape[0] == fine.num_vertices and (c >= -0.01).all() and (c <= 1.01).all()
    coarse = remesh.remesh_to_target(fine, med0)
    same_mesh(coarse, jremesh.remesh_to_target(jfine, med0))
    assert float(np.median(remesh.edge_lengths(coarse))) > med_f * 1.5
    f = coarse.faces.numpy()
    assert f.max() < coarse.num_vertices
    assert ((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 2] != f[:, 0])).all()


# ---- visualizer -------------------------------------------------------------


def vis_scene():
    jm = jmesh.make_icosphere([0.0, 0.0, 0.0], 1.0, subdiv=1)
    v = np.asarray(jm.vertices)
    jm = jmesh.TriangleMesh(jm.vertices, jm.faces, {
        "heat": jnp.asarray(v[:, 1:2] * 0.5 + 0.5),
        "base_color": jnp.asarray(np.abs(v).astype(np.float32))})
    pose = look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0])
    return both_meshes(jm), (CameraSpecs("v", 64, 48, pose, fov=45.0),
                             JCameraSpecs("v", 64, 48, pose, fov=45.0))


@pytest.mark.parametrize("attr", [None, "heat", "base_color"])
def test_render_mesh_attribute_matches_jax(attr):
    (tm, jm), (tcam, jcam) = vis_scene()
    got = visualizer.render_mesh_attribute(tm, tcam, attr)
    want = jvis.render_mesh_attribute(jm, jcam, attr)
    assert got.shape == want.shape == (48, 64, 3) and np.isfinite(got).all()
    # pixels whose hit differs between the packages are counted
    o, d = generate_rays(tcam, jitter=False, device="cpu")
    tv, _, tf, _ = mesh.intersect(tm, o, d, t_min=1e-4)
    jo, jd = jgenerate_rays(jcam, jitter=False)
    jv, _, jf, _ = jmesh.intersect(jm, jo, jd, t_min=1e-4)
    jv, jf = np.asarray(jv), np.asarray(jf)
    differ = ((tv.numpy() != jv) | (tv.numpy() & (tf.numpy() != jf))).reshape(48, 64)
    assert differ.sum() <= 0.01 * differ.size, int(differ.sum())
    np.testing.assert_allclose(got[~differ], want[~differ], **TOL)
    assert tv.any() and (~tv).any()


def test_overlays_equal_jax():
    (_, _), (tcam, jcam) = vis_scene()
    img = np.full((48, 64, 3), 0.5, np.float32)
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(20, 3)) * 0.8
    assert np.array_equal(visualizer.draw_points(img, tcam, torch.from_numpy(pts), radius=2),
                          jvis.draw_points(img, jcam, pts, radius=2))
    o, d = rng.normal(size=(6, 3)) * 0.5, rng.normal(size=(6, 3))
    assert np.array_equal(visualizer.draw_rays(img, tcam, o, d, 1.5),
                          jvis.draw_rays(img, jcam, o, d, 1.5))


def test_headless_visualizer(tmp_path):
    """tests/test_tooling.py::test_headless_visualizer on the port."""
    (tm, _), (tcam, _) = vis_scene()
    img = visualizer.visualize(
        str(tmp_path / "vis.png"), tm, tcam, attr="heat",
        points=np.asarray([[0.0, 1.2, 0.0]]),
        rays=(np.asarray([[0.0, 0.0, -2.0]]), np.asarray([[0.0, 1.0, 0.0]])),
    )
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    assert (tmp_path / "vis.png").exists()
    assert img[24, 32].mean() < 0.99 and img[2, 2].mean() > 0.99


# ---- utils.benchmark.measure ------------------------------------------------


def test_measure_first_call_and_runs():
    """tests/test_utils_filters.py:147-163 on the port."""
    x = torch.ones(128)
    res = benchmark.measure(lambda v: torch.sum(v * 2.0), x, label="double-sum", nb_runs=3,
                            log=False)
    assert res.label == "double-sum" and res.compile_ms > 0.0 and len(res.runs) == 3
    assert res.execute_ms_mean > 0.0 and res.execute_ms_std >= 0.0
    np.testing.assert_allclose(res.mrays_per_sec(num_rays=1_000_000),
                               1e6 / (res.execute_ms_mean * 1e-3) / 1e6)
    assert "double-sum" in repr(res)
    res = benchmark.measure(lambda v, n: v * n, torch.ones(8), 3, nb_runs=1, static_argnums=(1,),
                            log=False)
    assert res.execute_ms_mean > 0.0
    calls = []
    benchmark.measure(lambda: calls.append(1), nb_runs=2, nb_dry_runs=3, log=False)
    assert len(calls) == 1 + 3 + 2


# ---- the smaller public names -----------------------------------------------


def test_eval_emission_and_srgb():
    rng = np.random.default_rng(11)
    for k in (1, 4, 9, 16):
        c = rng.normal(size=(5, 7, k, 3)).astype(np.float32) * 0.5
        d = unit_dirs(35, k).reshape(5, 7, 3)
        np.testing.assert_allclose(
            sh.eval_emission(torch.from_numpy(c), torch.from_numpy(d)).numpy(),
            np.asarray(jsh.eval_emission(jnp.asarray(c), jnp.asarray(d))), **TOL)
    x = np.concatenate([np.linspace(-0.1, 1.5, 401), [0.0031308, 0.04045]]).astype(np.float32)
    got = ops.linear_to_srgb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.linear_to_srgb(jnp.asarray(x))), **TOL)
    back = ops.srgb_to_linear(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back[x >= 0], x[x >= 0], atol=1e-5)


def test_gaussian_peak_response():
    """tests/test_kernels.py:195 on the port (the peak against a brute-force
    minimum over 60,001 samples of t), and against JAX."""
    rng = np.random.default_rng(0)
    o = rng.normal(size=(16, 3)).astype(np.float32) * 2.0
    d = unit_dirs(16, 12)
    centers = rng.normal(size=(8, 3)).astype(np.float32)
    scales = rng.uniform(0.2, 1.5, size=(8, 3)).astype(np.float32)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    args = [torch.from_numpy(x) for x in (o, d, centers, scales, q)]
    peak = kernels.gaussian_peak_response(quadric.ray_prim_coeffs(*args)).numpy()
    jpeak = jkernels.gaussian_peak_response(jquadric.ray_prim_coeffs(
        *map(jnp.asarray, (o, d, centers, scales, q))))
    np.testing.assert_allclose(peak, np.asarray(jpeak), **TOL)
    rot = quaternion.to_rotation_matrix(args[4]).numpy()
    ts = np.linspace(-30.0, 30.0, 60001, dtype=np.float32)
    p = o[:, None, None, :] + d[:, None, None, :] * ts[None, None, :, None]
    rel = p - centers[None, :, None, :]
    local = np.einsum("cji,rctj->rcti", rot, rel) / scales[None, :, None, :]
    brute = np.exp(-0.5 * np.sum(local**2, axis=-1).min(axis=-1))
    np.testing.assert_allclose(peak, brute, rtol=1e-3, atol=1e-5)


def test_tile_cones_cull_and_shortlist():
    rng = np.random.default_rng(13)
    t, r = 6, 16
    o = np.repeat(rng.normal(size=(t, 3)) * 0.2, r, axis=0).astype(np.float32)
    d = rng.normal(size=(t * r, 3)) * 0.1 + [0.0, 0.0, 1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    got = tiles.tile_cones(torch.from_numpy(o), torch.from_numpy(d), r)
    want = jtiles.tile_cones(jnp.asarray(o), jnp.asarray(d), r)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    centers = (rng.normal(size=(300, 3)) * [1.0, 1.0, 2.0] + [0, 0, 3.0]).astype(np.float32)
    radii = rng.uniform(0.02, 0.3, 300).astype(np.float32)
    radii[:5] = -1.0  # inert slots are never culled in
    keys = []
    for i in range(t):
        k = tiles.cone_cull_keys(got[0][i], got[1][i], got[2][i], torch.from_numpy(centers),
                                 torch.from_numpy(radii))
        jk = np.asarray(jtiles.cone_cull_keys(want[0][i], want[1][i], want[2][i],
                                              jnp.asarray(centers), jnp.asarray(radii)))
        assert np.array_equal(np.isinf(k.numpy()), np.isinf(jk)) and np.isinf(jk[:5]).all()
        np.testing.assert_allclose(k.numpy()[np.isfinite(jk)], jk[np.isfinite(jk)], **TOL)
        keys.append(k)
    keys = torch.stack(keys)
    ids, valid = tiles.shortlist_approx(keys, 64)
    eids, evalid = tiles.shortlist(keys, 64)
    assert torch.equal(ids, eids) and torch.equal(valid, evalid)
    jids, jvalid = jtiles.shortlist(jnp.asarray(keys.numpy()), 64)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert np.array_equal(ids.numpy()[valid.numpy()], np.asarray(jids)[np.asarray(jvalid)])


def test_native_morton_argsort():
    """tests/test_native.py:36 on the port: the native Morton sort equals a
    stable argsort of the port's Morton codes, and JAX's native sort."""
    if native.get() is None:
        pytest.skip("the native module did not build (no g++)")
    centers = np.random.default_rng(0).normal(size=(4096, 3)).astype(np.float32)
    perm = native.morton_argsort(centers)
    codes = clusters.morton_codes(torch.from_numpy(centers)).numpy()
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(perm, np.argsort(codes.astype(np.uint32), kind="stable"))
    np.testing.assert_array_equal(native.morton_argsort(torch.from_numpy(centers)), perm)
    jperm = jnative.morton_argsort(centers)
    if jperm is not None:
        np.testing.assert_array_equal(perm, jperm)


def test_aliases():
    import volprim_tpu_torch as vt
    from volprim_tpu_torch.models import base
    from volprim_tpu_torch.utils import misc

    assert vt.cameras is vt.scene.cameras and callable(base.RadianceFn.__call__)
    assert envmap.Emitter.__args__ == (envmap.ConstantEmitter, envmap.EnvironmentMap)
    assert misc.concatenate_tensors is misc.concatenate_images
