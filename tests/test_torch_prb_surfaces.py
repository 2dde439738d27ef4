"""The path tracer with triangle-mesh surfaces and its other
configurations (volprim_tpu_torch.models.prb.radiance): tests/test_surfaces.py's
surface tests on the port (the white furnace, a black plane blocking the
environment, smoke above a floor, no mesh leaving the render unchanged),
then radiance against the JAX package in distribution: per-channel means
within 4 standard errors of their difference, for surfaces, clusters,
``jump=False``, ``coeff_gemm`` and the Epanechnikov kernel (surfaces
under both walk backends, the rest under one each). The tolerances of the
analytic tests are tests/test_surfaces.py's (the furnace within 0.02 of 1, the black plane
below 1e-3, the open sky within 1e-4)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ffwalk import both_scenes, cloud_arrays, one_torch_thread, rays  # noqa: F401
from test_torch_mesh_bsdf import both_meshes
from volprim_tpu import scene as jscene
from volprim_tpu.models import prb as jprb
from volprim_tpu.ops import bsdf as jbsdf
from volprim_tpu.ops import envmap as jenvmap
from volprim_tpu.scene import mesh as jmesh
from volprim_tpu_torch.models import prb
from volprim_tpu_torch.ops import bsdf, envmap
from volprim_tpu_torch.scene import mesh


def tiny_smoke(n=8):
    """tests/test_surfaces.py's _tiny_smoke, as numpy arrays."""
    f = jscene.EllipsoidsFactory()
    rng = np.random.default_rng(0)
    for _ in range(n):
        f.add(mean=rng.normal(size=3) * 0.2 + [0, 0.8, 0], scale=0.25, sigma_t=1.0,
              albedo=[0.8, 0.8, 0.8])
    js = f.build()
    return dict(centers=np.asarray(js.centers), scales=np.asarray(js.scales),
                quats=np.asarray(js.quats), sigma_t=np.asarray(js.attrs["sigma_t"]),
                albedo=np.asarray(js.attrs["albedo"]))


def unit_sky():
    return envmap.ConstantEmitter(radiance=torch.ones(3))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_surface_white_furnace():
    """A white diffuse plane under a unit sky returns the sky."""
    m = mesh.make_rect([0, 0, 0], [50, 0, 0], [0, 0, -50], {"base_color": [1.0, 1.0, 1.0]},
                       device="cpu")
    a = tiny_smoke(1)
    a["sigma_t"] = a["sigma_t"] * 0.0  # an inert medium
    ts, _ = both_scenes(a)
    n = 4096
    o = torch.tensor([[0.0, 2.0, 0.0]]).expand(n, 3).contiguous()
    d = torch.nn.functional.normalize(torch.tensor([[0.2, -1.0, 0.1]]), dim=-1).expand(n, 3)
    for backend in ("xla", "pallas"):
        cfg = prb.PRBConfig(max_overlaps=4, max_windows=2, bounce_cap=24, chunk_size=8,
                            cluster_size=8, walk_backend=backend)
        out = prb.radiance(ts, unit_sky(), o, d.contiguous(), cfg, gen(0), mesh=m,
                           bsdf=bsdf.Diffuse())
        assert bool(torch.isfinite(out).all())
        assert abs(float(out.mean()) - 1.0) < 0.02, (backend, float(out.mean()))


def test_surface_blocks_env():
    m = mesh.make_rect([0, 0, 0], [50, 0, 0], [0, 0, -50], {"base_color": [0.0, 0.0, 0.0]},
                       device="cpu")
    a = tiny_smoke(1)
    a["sigma_t"] = a["sigma_t"] * 0.0
    ts, _ = both_scenes(a)
    o = torch.tensor([[0.0, 2.0, 0.0], [0.0, 2.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]])
    cfg = prb.PRBConfig(max_overlaps=4, max_windows=2, bounce_cap=4, chunk_size=8,
                        cluster_size=8)
    out = prb.radiance(ts, unit_sky(), o, d, cfg, gen(0), mesh=m).numpy()
    assert out[0].max() < 1e-3  # the black plane
    np.testing.assert_allclose(out[1], 1.0, rtol=1e-4)  # the open sky


def test_medium_above_surface():
    """Smoke over a 0.9-albedo floor under a unit sky: darker than without
    the floor, by no more than the floor's albedo allows."""
    m = mesh.make_rect([0, 0.0, 0], [5, 0, 0], [0, 0, -5], {"base_color": [0.9, 0.9, 0.9]},
                       device="cpu")
    ts, _ = both_scenes(tiny_smoke(8))
    n = 2048
    rng = np.random.default_rng(1)
    dd = rng.normal(size=(n, 3)) * 0.15 + [0, -1.0, 0]
    d = torch.from_numpy((dd / np.linalg.norm(dd, axis=-1, keepdims=True)).astype(np.float32))
    o = torch.tensor([[0.0, 2.5, 0.0]]).expand(n, 3).contiguous()
    cfg = prb.PRBConfig(max_overlaps=8, max_windows=3, bounce_cap=16, chunk_size=8,
                        cluster_size=8)
    with_floor = prb.radiance(ts, unit_sky(), o, d, cfg, gen(2), mesh=m)
    without = prb.radiance(ts, unit_sky(), o, d, cfg, gen(2))
    assert bool(torch.isfinite(with_floor).all())
    assert float(with_floor.mean()) < float(without.mean())
    assert float(with_floor.mean()) > 0.85 * float(without.mean())


def test_no_mesh_leaves_the_render_unchanged():
    ts, _ = both_scenes(tiny_smoke(8))
    n = 512
    o = torch.tensor([[0.0, 0.8, -3.0]]).expand(n, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    cfg = prb.PRBConfig(max_overlaps=8, max_windows=3, bounce_cap=8, chunk_size=8,
                        cluster_size=8)
    a = prb.radiance(ts, unit_sky(), o, d, cfg, gen(4))
    b = prb.radiance(ts, unit_sky(), o, d, cfg, gen(4), mesh=None, bsdf=bsdf.Principled())
    assert torch.equal(a, b)


def box_scene():
    """The cloud inside a Cornell box with Principled walls (roughness 0.5,
    metallic 0.2) and a white icosphere."""
    attrs = {"base_color": [0.73, 0.73, 0.73], "roughness": [0.5], "metallic": [0.2]}
    walls = {w: dict(attrs) for w in ("floor", "ceiling", "back", "left", "right")}
    walls["left"] = {**attrs, "base_color": [0.65, 0.05, 0.05]}
    jm = jmesh.merge([jmesh.cornell_box(1.5, walls), jmesh.make_icosphere(
        [0.5, -0.9, 0.4], 0.4, subdiv=1, attrs=attrs)])
    return both_meshes(jm)


SKY = np.asarray([0.6, 0.8, 1.0], np.float32)
BASE = dict(max_overlaps=8, max_windows=6, chunk_size=64, bounce_cap=8)
DIST_CASES = {
    "surfaces": dict(),
    "surfaces_sequential": dict(jump=False),
    "clusters": dict(use_clusters=True, cluster_size=8),
    "sequential": dict(jump=False),
    "coeff_gemm": dict(coeff_gemm=True),
    "epanechnikov": dict(kernel_type="epanechnikov"),
}
# surfaces under both backends; the rest once each (Epanechnikov walks the
# xla path under either backend)
DIST_RUNS = [("surfaces", "xla"), ("surfaces", "pallas"), ("surfaces_sequential", "xla"),
             ("clusters", "pallas"), ("sequential", "xla"), ("coeff_gemm", "pallas"),
             ("epanechnikov", "xla")]


@pytest.mark.parametrize("case,backend", DIST_RUNS)
def test_radiance_matches_jax_in_distribution(case, backend):
    a = cloud_arrays(10, 13, 0.4, 0.15, 0.5)
    ts, js = both_scenes(a)
    n = 1024
    o, d, _ = rays(n, 21)
    kw = dict(BASE, walk_backend=backend, **DIST_CASES[case])
    jcfg, tcfg = jprb.PRBConfig(**kw), prb.PRBConfig(**kw)
    surf = case.startswith("surfaces")
    tm, jm = box_scene() if surf else (None, None)
    if surf:  # rays from inside the box's open side
        o = o * np.asarray([1.0, 1.0, 0.0], np.float32) + np.asarray([0.0, 0.0, -1.4],
                                                                        np.float32)
    lj = np.asarray(jprb.radiance(js, jenvmap.ConstantEmitter(radiance=jnp.asarray(SKY)),
                                  jnp.asarray(o), jnp.asarray(d), jcfg, jax.random.PRNGKey(5),
                                  mesh=jm, bsdf=jbsdf.Principled() if surf else None))
    lt = prb.radiance(ts, envmap.ConstantEmitter(radiance=torch.from_numpy(SKY)),
                      torch.from_numpy(o), torch.from_numpy(d), tcfg, gen(5), mesh=tm,
                      bsdf=bsdf.Principled() if surf else None).numpy()
    assert np.all(np.isfinite(lt)) and lt.shape == (n, 3)
    se = np.sqrt(lt.var(0) / n + lj.var(0) / n)
    print(f"{case}/{backend}: means port {lt.mean(0)}, JAX {lj.mean(0)}, 4 se {4 * se}")
    assert np.all(se > 0)
    assert np.all(np.abs(lt.mean(0) - lj.mean(0)) <= 4 * se)
