"""The port's radiance cache and radiosity loss
(volprim_tpu_torch.tooling.radiance_cache) and the fit_radiosity_bsdf CLI
against the JAX package.

Tolerances:
- the ``rf`` cache's ``query`` is deterministic: within atol 1e-6 / rtol
  1e-5 of JAX's on the same numpy-made scene and rays, but where q = c -
  b^2/a cancels in f32. The port's f64 run is the yardstick there: rays
  where either package's f32 run leaves it by more than that tolerance are
  counted (at most 3%) and held within 1e-4 of it, rf's tolerance in
  tests/test_torch_rf_epan_emitter.py;
- the ``prb`` cache's ``query``, ``eval_li_mat`` and ``compute_loss`` with
  its ``base_color`` gradient draw from a generator where JAX draws from
  a key, so they are held in distribution: each per-channel mean within 4
  standard errors of its difference (the queries over their rays, the loss
  and gradient over 24 seeds against 24 JAX keys at fixed attributes);
- tests/test_tooling.py's own criteria on the port: the rf cache's
  incident hemisphere, and ``test_radiosity_loss_and_recovery`` (the
  base_color MAE below half its start after 25 steps);
- the rays ``eval_lo`` queries within 1e-6 of JAX's, ``eval_li_mat``'s
  spawned 1e-3 off the surface along the directions it returns;
- the cache's single zero-density primitive gives finite values and
  gradients under both walk backends;
- the CLI with ``--device cpu`` for 3 iterations writes the JAX CLI's
  ``.npz``, and without a card it raises unless told to use the CPU.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.models import rf as jrf
from volprim_tpu.ops import bsdf as jbsdf
from volprim_tpu.ops import envmap as jenvmap
from volprim_tpu.scene import mesh as jmesh
from volprim_tpu.scene.ellipsoids import EllipsoidScene as JScene
from volprim_tpu.tooling import radiance_cache as jrc
from volprim_tpu_torch import interop
from volprim_tpu_torch.examples import fit_radiosity_bsdf as fit_cli
from volprim_tpu_torch.models import prb, rf
from volprim_tpu_torch.ops import bsdf, envmap
from volprim_tpu_torch.optim import BoundedAdam
from volprim_tpu_torch.scene import mesh
from volprim_tpu_torch.tooling import radiance_cache as rc


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def both_meshes(jm):
    tm = interop.mesh_from_arrays(np.asarray(jm.vertices), np.asarray(jm.faces),
                                  {k: np.asarray(v) for k, v in jm.attrs.items()}, device="cpu")
    return tm, jm


def radiosity_scene(diffuse=True):
    """fit_radiosity_bsdf's ground-truth scene in both packages, built by
    the port's CLI and copied into JAX."""
    model = bsdf.Diffuse() if diffuse else bsdf.Principled(has_metallic=True)
    tm = fit_cli.build_scene(model, "cpu")
    jm = jmesh.TriangleMesh(jnp.asarray(tm.vertices.numpy()), jnp.asarray(tm.faces.numpy(),
                                                                           jnp.int32),
                            {k: jnp.asarray(v.numpy()) for k, v in tm.attrs.items()})
    jmodel = jbsdf.Diffuse() if diffuse else jbsdf.Principled(has_metallic=True)
    return (tm, model), (jm, jmodel)


def both_caches(walk_backend="xla", diffuse=True):
    (tm, model), (jm, jmodel) = radiosity_scene(diffuse)
    tsky = envmap.procedural_sky(h=32, w=64, device="cpu")
    jsky = jenvmap.procedural_sky(h=32, w=64)
    tcache = rc.RadianceCache(emitter=tsky, mesh=tm, bsdf=model, integrator="prb")
    tcache.cfg = prb.PRBConfig(max_overlaps=8, max_windows=2, bounce_cap=6, chunk_size=64,
                               cluster_size=8, walk_backend=walk_backend)
    jcache = jrc.RadianceCache(emitter=jsky, mesh=jm, bsdf=jmodel, integrator="prb")
    return tcache, jcache


def per_ray_stats(x):
    x = np.asarray(x, np.float64).reshape(-1, 3)
    return x.mean(0), x.std(0) / math.sqrt(x.shape[0])


def assert_agree(a, b, what):
    (ma, sa), (mb, sb) = a, b
    z = np.abs(ma - mb) / np.maximum(np.sqrt(sa**2 + sb**2), 1e-30)
    assert (z <= 4.0).all(), (what, ma, mb, z)
    return float(z.max())


def surface_points(n, seed):
    """Points on the floor and the ball of the radiosity scene, with their
    normals, as float32 numpy."""
    rng = np.random.default_rng(seed)
    k = n // 2
    floor = np.stack([rng.uniform(-2.5, 2.5, k), np.zeros(k), rng.uniform(-2.5, 2.5, k)], -1)
    dirs = rng.normal(size=(n - k, 3))
    dirs[:, 1] = np.abs(dirs[:, 1])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    p = np.concatenate([floor, np.asarray([0.0, 0.8, 0.0]) + 0.7 * dirs]).astype(np.float32)
    nrm = np.concatenate([np.tile([0.0, 1.0, 0.0], (k, 1)), dirs]).astype(np.float32)
    return p, nrm


def rf_scene(rotated=False):
    """tests/test_tooling.py's one-primitive rf scene (a sphere) plus 40
    random spheres, or with ``rotated`` random ellipsoids."""
    rng = np.random.default_rng(0)
    n = 41
    centers = np.concatenate([[[0.0, 0.0, 1.0]], rng.normal(size=(n - 1, 3)) * 0.6])
    scales = np.concatenate([[[0.2, 0.2, 0.2]], rng.uniform(0.05, 0.3, (n - 1, 3))])
    q = rng.normal(size=(n, 4))
    q[0] = [0.0, 0.0, 0.0, 1.0]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    if not rotated:
        scales[:] = scales[:, :1]
        q[:] = [0.0, 0.0, 0.0, 1.0]
    attrs = dict(opacities=rng.uniform(0.2, 0.95, (n, 1)),
                 sh_coeffs=rng.normal(size=(n, 12)) * 0.3)
    attrs["opacities"][0] = 0.9
    attrs["sh_coeffs"][0] = [1.0, 0.5, 0.2] + [0.0] * 9
    f32 = {k: np.asarray(v, np.float32) for k, v in dict(centers=centers, scales=scales,
                                                         quats=q, **attrs).items()}
    ts = interop.scene_from_arrays(f32["centers"], f32["scales"], f32["quats"],
                                   {k: f32[k] for k in attrs}, 3.0, device="cpu")
    js = JScene(centers=jnp.asarray(f32["centers"]), scales=jnp.asarray(f32["scales"]),
                quats=jnp.asarray(f32["quats"]), attrs={k: jnp.asarray(f32[k]) for k in attrs},
                extent=3.0)
    return ts, js


def test_rf_query_matches_jax():
    ts, js = rf_scene()
    cfg = dict(max_depth=8, srgb_primitives=False, chunk_size=8)
    tcache = rc.RadianceCache(ts, rf.RFConfig(**cfg))
    jcache = jrc.RadianceCache(js, jrf.RFConfig(**cfg))
    rng = np.random.default_rng(1)
    n = 256
    o = np.tile([[0.0, 0.0, -2.0]], (n, 1)).astype(np.float32) + rng.normal(
        size=(n, 3)).astype(np.float32) * 0.1
    d = rng.normal(size=(n, 3)) * 0.25 + [0.0, 0.0, 1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    got = tcache.query(torch.from_numpy(o), torch.from_numpy(d)).numpy()
    want = np.asarray(jcache.query(jnp.asarray(o), jnp.asarray(d)))
    assert got.shape == (n, 3) and float(np.abs(want).max()) > 0.1
    # the yardstick: the port's f64 run (JAX's rf loop pins f32)
    s64 = dataclasses.replace(ts, centers=ts.centers.double(), scales=ts.scales.double(),
                              quats=ts.quats.double(),
                              attrs={k: v.double() for k, v in ts.attrs.items()})
    y = rc.RadianceCache(s64, rf.RFConfig(**cfg)).query(
        torch.from_numpy(o).double(), torch.from_numpy(d).double()).numpy()

    def off(x):  # rays outside atol 1e-6 / rtol 1e-5 of the yardstick
        return (np.abs(x - y) > 1e-6 + 1e-5 * np.abs(y)).any(-1)

    excused = off(got) | off(want)
    assert excused.sum() <= 0.03 * n, int(excused.sum())
    np.testing.assert_allclose(got[~excused], want[~excused], atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got, y, atol=1e-4)
    np.testing.assert_allclose(want, y, atol=1e-4)
    # tests/test_tooling.py::test_radiance_cache_query's criteria on the port
    one = tcache.query(torch.tensor([[0.0, 0.0, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]]))
    assert one.shape == (1, 3) and float(one[0, 0]) > 0.0
    wi, li = tcache.incident_hemisphere(torch.tensor([[0.0, 0.0, -1.0]]),
                                        torch.tensor([[0.0, 0.0, 1.0]]), gen(0), 8)
    assert wi.shape == (1, 8, 3) and bool(torch.isfinite(li).all())
    assert float(wi[..., 2].min()) > 0.0


@pytest.mark.parametrize("walk_backend", ["xla", "pallas"])
def test_prb_query_in_distribution(walk_backend):
    """Rays from points above the scene in random downward directions."""
    tcache, jcache = both_caches(walk_backend)
    rng = np.random.default_rng(2)
    n = 3072
    o = (rng.uniform(-1.5, 1.5, (n, 3)) + [0.0, 3.0, 0.0]).astype(np.float32)
    d = rng.normal(size=(n, 3)) * 0.5
    d[:, 1] = -np.abs(d[:, 1]) - 1.0
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    got = tcache.query(torch.from_numpy(o), torch.from_numpy(d), gen(3))
    want = jcache.query(jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(3))
    assert bool(torch.isfinite(got).all()) and not got.requires_grad
    assert_agree(per_ray_stats(got.numpy()), per_ray_stats(want), "query")


def test_eval_li_mat_in_distribution():
    tcache, jcache = both_caches()
    p, n = surface_points(48, 4)
    li_t, wi_t = tcache.eval_li_mat(torch.from_numpy(p), torch.from_numpy(n), gen(5), 64)
    li_j, wi_j = jcache.eval_li_mat(jnp.asarray(p), jnp.asarray(n), jax.random.PRNGKey(5), 64)
    assert li_t.shape == (48, 64, 3) and wi_t.shape == (48, 64, 3)
    assert bool(torch.isfinite(li_t).all()) and float(wi_t[..., 2].min()) >= 0.0
    # the cosine-distributed directions: E[z] = 2/3 in both
    assert_agree(per_ray_stats(wi_t.numpy()), per_ray_stats(np.asarray(wi_j)), "wi")
    assert_agree(per_ray_stats(li_t.numpy()), per_ray_stats(np.asarray(li_j)), "li_w")
    wi, li = tcache.incident_hemisphere(torch.from_numpy(p), torch.from_numpy(n), gen(5), 64)
    np.testing.assert_allclose(li.numpy(), (li_t * torch.clamp(wi_t[..., 2:3] / math.pi,
                                                               min=1e-6)).numpy(), rtol=1e-6)


def captured_queries(cache, monkeypatch):
    """Replace ``cache.query`` by a recorder of its (o, d) that returns
    zeros; returns the list it appends to."""
    calls = []

    def record(o, d, *a):
        calls.append((np.asarray(o), np.asarray(d)))
        return np.zeros(o.shape) if isinstance(o, jnp.ndarray) else torch.zeros(o.shape)

    monkeypatch.setattr(cache, "query", record)
    return calls


def test_query_rays_match_jax(monkeypatch):
    """The rays eval_lo and eval_li_mat hand to the cache's query: eval_lo's
    within 1e-6 of JAX's for the same points and directions, eval_li_mat's
    spawned from p + 1e-3 n along the returned directions."""
    tcache, jcache = both_caches()
    t_calls, j_calls = captured_queries(tcache, monkeypatch), captured_queries(jcache, monkeypatch)
    p, n = surface_points(40, 10)
    wo = unit_hemisphere(40, 11)
    tcache.eval_lo(torch.from_numpy(p), torch.from_numpy(n), torch.from_numpy(wo), gen(0))
    jcache.eval_lo(jnp.asarray(p), jnp.asarray(n), jnp.asarray(wo), jax.random.PRNGKey(0))
    for got, want in zip(t_calls[0], j_calls[0]):
        np.testing.assert_allclose(got, want, atol=1e-6)
    _, wi = tcache.eval_li_mat(torch.from_numpy(p), torch.from_numpy(n), gen(1), 16)
    o, d = t_calls[1]
    np.testing.assert_allclose(o, np.repeat(p + n * 1e-3, 16, axis=0), atol=1e-6)
    want_d = bsdf.to_world(torch.from_numpy(n)[:, None, :], wi).reshape(-1, 3)
    np.testing.assert_allclose(d, want_d.numpy(), atol=1e-6)


def unit_hemisphere(n, seed):
    """Unit directions with z > 0.2, float32 numpy."""
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.2
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_compute_loss_and_gradient_in_distribution():
    """24 seeds against 24 keys at fixed trainable attributes, on
    tests/test_tooling.py's rectangle under a unit sky."""
    jm = jmesh.make_rect([0, 0, 0], [2, 0, 0], [0, 0, -2],
                         attrs={"base_color": [0.8, 0.3, 0.2]})
    tm, _ = both_meshes(jm)
    rng = np.random.default_rng(6)
    attrs = rng.uniform(0.2, 0.8, (tm.num_vertices, 3)).astype(np.float32)
    tcache = rc.RadianceCache(emitter=envmap.ConstantEmitter(radiance=torch.ones(3)), mesh=tm,
                              bsdf=bsdf.Diffuse(), integrator="prb")
    jcache = jrc.RadianceCache(emitter=jenvmap.ConstantEmitter(radiance=jnp.ones(3)), mesh=jm,
                               bsdf=jbsdf.Diffuse(), integrator="prb")
    jfn = jax.jit(jax.value_and_grad(lambda q, key: jrc.compute_loss(
        jcache, jm, q, jbsdf.Diffuse(), key, num_points=32, num_wi=48)))
    runs = {"port": [], "jax": []}
    for s in range(24):
        p = {"base_color": torch.from_numpy(attrs).requires_grad_(True)}
        loss = rc.compute_loss(tcache, tm, p, bsdf.Diffuse(), gen(100 + s), num_points=32,
                               num_wi=48)
        loss.backward()
        runs["port"].append(np.concatenate([[float(loss.detach())],
                                            p["base_color"].grad.numpy().ravel()]))
        jl, jg = jfn({"base_color": jnp.asarray(attrs)}, jax.random.PRNGKey(100 + s))
        runs["jax"].append(np.concatenate([[float(jl)], np.asarray(jg["base_color"]).ravel()]))
    st = {k: (np.mean(v, 0), np.std(v, 0, ddof=1) / math.sqrt(len(v))) for k, v in runs.items()}
    assert np.isfinite(st["port"][0]).all() and st["port"][0][0] > 0.0
    se = np.sqrt(st["port"][1] ** 2 + st["jax"][1] ** 2)
    z = np.abs(st["port"][0] - st["jax"][0]) / np.maximum(se, 1e-30)
    assert (z <= 4.0).all(), (st, z)


def test_radiosity_loss_and_recovery():
    """tests/test_tooling.py's recovery test on the port: the residual
    drives a flat base_color toward the ground truth."""
    model = bsdf.Diffuse()
    m = mesh.make_rect([0, 0, 0], [2, 0, 0], [0, 0, -2], attrs={"base_color": [0.8, 0.3, 0.2]},
                       device="cpu")
    cache = rc.RadianceCache(emitter=envmap.ConstantEmitter(radiance=torch.ones(3)), mesh=m,
                             bsdf=model, integrator="prb")
    params = {"base_color": torch.full((m.num_vertices, 3), 0.5, requires_grad=True)}
    opt = BoundedAdam(lr=5e-2)
    opt.set_bounds("base_color", lower=1e-3, upper=1.0 - 1e-3)
    mae0 = float(torch.mean(torch.abs(params["base_color"].detach() - m.attrs["base_color"])))
    g = gen(0)
    for _ in range(25):
        params["base_color"].grad = None
        loss = rc.compute_loss(cache, m, params, model, g, num_points=32, num_wi=48)
        loss.backward()
        opt.step(params)
    mae = float(torch.mean(torch.abs(params["base_color"].detach() - m.attrs["base_color"])))
    assert math.isfinite(float(loss.detach()))
    assert mae < 0.5 * mae0, (mae0, mae)


@pytest.mark.parametrize("walk_backend", ["xla", "pallas"])
def test_inert_medium_stays_finite(walk_backend):
    """The cache's zero-density primitive on tables of rays spawned 1e-3
    off the surfaces: finite radiance and a finite gradient."""
    tcache, _ = both_caches(walk_backend, diffuse=False)
    assert tcache.primitives.num_prims == 1
    assert float(tcache.primitives.attrs["sigma_t"].abs().max()) == 0.0
    tm = tcache.mesh
    p = {k: torch.full((tm.num_vertices, v), x, requires_grad=True)
         for k, v, x in (("base_color", 3, 0.5), ("roughness", 1, 0.6), ("metallic", 1, 0.1))}
    loss = rc.compute_loss(tcache, tm, p, tcache.bsdf, gen(7), num_points=16, num_wi=32)
    loss.backward()
    assert math.isfinite(float(loss.detach()))
    assert all(bool(torch.isfinite(v.grad).all()) for v in p.values())
    pts, nrm = surface_points(64, 8)
    wo = torch.tensor([[0.3, 0.2, 0.9327379]]).expand(64, 3)
    lo = tcache.eval_lo(torch.from_numpy(pts), torch.from_numpy(nrm), wo, gen(9))
    assert bool(torch.isfinite(lo).all()) and float(lo.max()) > 0.0


@pytest.mark.parametrize("model", ["diffuse", "principled"])
def test_fit_radiosity_cli(tmp_path, model):
    out = tmp_path / "fit"
    err = fit_cli.main(["--device", "cpu", "--iterations", "3", "--bsdf", model,
                        "--output", str(out)])
    z = np.load(str(out) + ".npz")
    want = {"base_color"} | ({"roughness", "metallic"} if model == "principled" else set())
    assert set(z.files) == want and z["base_color"].shape == (50, 3)
    assert all(np.isfinite(z[k]).all() for k in z.files) and 0.0 < err < 0.5
    (tmp_path / "cpu").mkdir()
    assert fit_cli.main(["--cpu", "--iterations", "1", "--output",
                         str(tmp_path / "cpu" / "fit")]) > 0.0
    if not torch.cuda.is_available():  # without --device the CLI takes the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_cli.main(["--iterations", "1", "--output", str(tmp_path / "x")])
