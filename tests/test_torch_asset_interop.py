"""The port's reference "Python asset" interop
(volprim_tpu_torch.scene.asset_interop) against the JAX package's,
mirroring tests/test_scene_io.py:119-310, and across the two packages:

- save_reference_asset writes an ``__init__.py`` text-identical to JAX's
  and a byte-identical PLY for the same scene, cameras and emitter
  (constant; an environment map writes the same texture);
- each package reads what the other wrote to the same primitives,
  cameras, emitter and integrator;
- a file shaped like the reference toolchain's writer (``T().look_at``,
  ``np.load``) loads; hand-edited assets the stand-ins cannot execute fail
  as in JAX (nested imports, ``__import__``, unresolved ``mi.*``, unknown
  plugin types), and ``strict=False`` reads them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu.ops import envmap as jenv
from volprim_tpu.scene import asset_interop as jai
from volprim_tpu_torch import interop
from volprim_tpu_torch import scene as tscene
from volprim_tpu_torch.ops import envmap as tenv
from volprim_tpu_torch.scene import asset_interop as tai
from volprim_tpu_torch.scene import ply as tply


def medium_arrays(n=17, seed=0):
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return dict(centers=rng.normal(size=(n, 3)).astype(np.float32),
                scales=rng.uniform(0.05, 0.4, size=(n, 3)).astype(np.float32), quats=quats,
                attrs={"sigma_t": rng.uniform(0.1, 2.0, size=(n, 1)).astype(np.float32),
                       "albedo": rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)})


def both(a):
    j = jscene.EllipsoidScene(jnp.asarray(a["centers"]), jnp.asarray(a["scales"]),
                              jnp.asarray(a["quats"]),
                              {k: jnp.asarray(v) for k, v in a["attrs"].items()})
    t = interop.scene_from_arrays(a["centers"], a["scales"], a["quats"], a["attrs"],
                                  device="cpu")
    return j, t


def cameras(mod):
    return [mod.CameraSpecs(name=f"c{i}", width=64, height=48,
                            to_world=mod.look_at([0, 0.5, -3 - i], [0, 0, 0], [0, 1, 0]),
                            fov=40.0 + i) for i in range(2)]


def _check_loaded(back, a, cams, radiance):
    p2 = back["primitives"]
    np.testing.assert_allclose(p2.centers.numpy(), a["centers"], rtol=1e-5)
    np.testing.assert_allclose(p2.scales.numpy(), a["scales"], rtol=1e-4)
    np.testing.assert_allclose(p2.attrs["sigma_t"].numpy(), a["attrs"]["sigma_t"], rtol=1e-5)
    assert len(back["cameras"]) == 2
    c0 = back["cameras"][0]
    assert (c0.width, c0.height) == (64, 48) and c0.fov == 40.0
    np.testing.assert_allclose(c0.to_world, cams[0].to_world, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(back["emitter"].radiance.numpy(), radiance, rtol=1e-6)


@pytest.mark.parametrize("radiance", [(0.8, 0.8, 0.8), (0.8, 0.5, 0.25)])
def test_written_alike_and_read_across(tmp_path, radiance):
    a = medium_arrays()
    sj, st = both(a)
    rad = np.asarray(radiance, np.float32)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jai.save_reference_asset(str(jdir), sj, cameras(jscene),
                             jenv.ConstantEmitter(radiance=jnp.asarray(rad)))
    tai.save_reference_asset(str(tdir), st, cameras(tscene),
                             tenv.ConstantEmitter(radiance=torch.from_numpy(rad)))
    assert (tdir / "__init__.py").read_text() == (jdir / "__init__.py").read_text()
    assert ((tdir / "data" / "root.object.ply").read_bytes()
            == (jdir / "data" / "root.object.ply").read_bytes())
    for d in (jdir, tdir):  # the port reads either, JAX reads the port's
        _check_loaded(tai.load_reference_asset(str(d), device="cpu"), a, cameras(tscene), rad)
    back_j = jai.load_reference_asset(str(tdir))
    back_t = tai.load_reference_asset(str(tdir), device="cpu")
    for name in ("centers", "scales", "quats"):
        np.testing.assert_array_equal(getattr(back_t["primitives"], name).numpy(),
                                      np.asarray(getattr(back_j["primitives"], name)))
    for cj, ct in zip(back_j["cameras"], back_t["cameras"]):
        np.testing.assert_array_equal(ct.to_world, cj.to_world)
        assert (ct.name, ct.width, ct.height, ct.fov) == (cj.name, cj.width, cj.height, cj.fov)
    assert back_t["integrator"] is None and back_j["integrator"] is None


def test_envmap_emitter_across(tmp_path):
    a = medium_arrays(5, seed=2)
    sj, st = both(a)
    sky = np.random.default_rng(3).uniform(0.0, 2.0, size=(8, 16, 3)).astype(np.float32)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jai.save_reference_asset(str(jdir), sj, None, jenv.EnvironmentMap.from_array(sky))
    tai.save_reference_asset(str(tdir), st, None,
                             tenv.EnvironmentMap.from_array(sky, device="cpu"))
    assert (tdir / "__init__.py").read_text() == (jdir / "__init__.py").read_text()
    tex = ("textures", "environment.exr")
    assert (tdir.joinpath(*tex)).read_bytes() == (jdir.joinpath(*tex)).read_bytes()
    back = tai.load_reference_asset(str(jdir), device="cpu")
    assert isinstance(back["emitter"], tenv.EnvironmentMap) and back["cameras"] == []
    np.testing.assert_array_equal(back["emitter"].data.numpy(), sky)
    # a stripped texture: the procedural sky stands in, as in JAX
    (jdir.joinpath(*tex)).unlink()
    back = tai.load_reference_asset(str(jdir), device="cpu")
    want = jai.load_reference_asset(str(jdir))["emitter"]
    np.testing.assert_allclose(back["emitter"].data.numpy(), np.asarray(want.data), rtol=1e-6)


def test_reader_handles_reference_style_file(tmp_path):
    """An __init__.py shaped like the reference toolchain's writer, with an
    INTEGRATOR, T().look_at and an np.load of a data file."""
    out = tmp_path / "asset"
    (out / "data").mkdir(parents=True)
    np.save(out / "data" / "root.object.extras.npy", np.ones((4, 1)))
    a = medium_arrays(4, seed=1)
    tply.save_ply(both(a)[1], str(out / "data" / "root.object.ply"))
    (out / "__init__.py").write_text(
        "import os\n"
        "from os.path import join, dirname\n"
        "import numpy as np\n"
        "import drjit as dr\n"
        "import mitsuba as mi\n"
        "from mitsuba.scalar_rgb import ScalarTransform4f as T\n"
        "\n"
        "OBJECTS = {\n"
        "    'resources': { 'type': 'resources', 'path': dirname(__file__) },\n"
        "    'object': {\n"
        "        'type': 'ellipsoidsmesh',\n"
        "        'filename': r'data/root.object.ply',\n"
        "        'extra': np.load(join(dirname(__file__), 'data/root.object.extras.npy')),\n"
        "    },\n"
        "}\n"
        "\n"
        "SENSORS = {\n"
        "    'sensor': {\n"
        "        'type': 'perspective',\n"
        "        'fov': 39.0,\n"
        "        'to_world': T().look_at(\n"
        "             origin=[0, 1, -4],\n"
        "             target=[0, 0, 0],\n"
        "             up=[0, 1, 0],\n"
        "         ).rotate([0, 1, 0], 30.0).translate([0.1, 0, 0]),\n"
        "        'film': { 'type': 'hdrfilm', 'width': 32, 'height': 24 },\n"
        "    },\n"
        "}\n"
        "\n"
        "EMITTERS = {\n"
        "    'environment': { 'type': 'constant',\n"
        "        'radiance': { 'type': 'rgb', 'value': 1.0 } },\n"
        "}\n"
        "INTEGRATOR = { 'type': 'volprim_tomography', 'max_depth': 16 }\n"
    )
    back = tai.load_reference_asset(str(out), device="cpu")
    want = jai.load_reference_asset(str(out))
    assert back["primitives"].num_prims == 4 and back["cameras"][0].fov == 39.0
    np.testing.assert_array_equal(back["cameras"][0].to_world, want["cameras"][0].to_world)
    np.testing.assert_array_equal(back["emitter"].radiance.numpy(), [1.0, 1.0, 1.0])
    assert back["integrator"] == want["integrator"] == "volprim_tomography"
    assert back["raw"]["integrator"] == {"type": "volprim_tomography", "max_depth": 16}


def test_inline_arrays(tmp_path):
    """An ellipsoid object given by arrays in the file, not a PLY."""
    d = tmp_path / "asset"
    d.mkdir()
    (d / "__init__.py").write_text(
        "import numpy as np\n"
        "OBJECTS = { 'object': { 'type': 'ellipsoids',\n"
        "    'centers': np.zeros((2, 3)), 'scales': np.full((2, 3), 0.1),\n"
        "    'quaternions': np.tile([0.0, 0.0, 0.0, 1.0], (2, 1)),\n"
        "    'sigma_t': np.asarray([1.0, 2.0]) } }\n"
        "SENSORS = {}\nEMITTERS = {}\n")
    back = tai.load_reference_asset(str(d), extent=2.0, device="cpu")
    want = jai.load_reference_asset(str(d), extent=2.0)
    p, q = back["primitives"], want["primitives"]
    assert p.extent == q.extent == 2.0 and p.centers.dtype == torch.float32
    np.testing.assert_array_equal(p.attrs["sigma_t"].numpy(), np.asarray(q.attrs["sigma_t"]))
    np.testing.assert_array_equal(p.quats.numpy(), np.asarray(q.quats))


def test_mangled_asset_fails_loudly(tmp_path):
    def write(body):
        d = tmp_path / "asset"
        d.mkdir(exist_ok=True)
        (d / "__init__.py").write_text(body)
        return str(d)

    p = write("from mitsuba.scalar_rgb import (\n    ScalarTransform4f as T)\n"
              "OBJECTS = {}\nSENSORS = {}\nEMITTERS = {}\n")
    assert tai.load_reference_asset(p, device="cpu")["primitives"] is None
    p = write("def f():\n    import os\n    return 1\nOBJECTS = {}\nSENSORS = {}\nEMITTERS = {}\n")
    with pytest.raises(ValueError, match="import inside"):
        tai.load_reference_asset(p, device="cpu")
    p = write("x = __import__('os')\nOBJECTS = {}\nSENSORS = {}\nEMITTERS = {}\n")
    with pytest.raises(ValueError, match="__import__"):
        tai.load_reference_asset(p, device="cpu")
    p = write("import mitsuba as mi\nOBJECTS = { 'thing': { 'type': 'ply', 'weird': mi.Unknown } }\n"
              "SENSORS = {}\nEMITTERS = {}\n")
    with pytest.raises(ValueError, match="unresolved Mitsuba"):
        tai.load_reference_asset(p, device="cpu")
    tai.load_reference_asset(p, strict=False, device="cpu")
    p = write("OBJECTS = {}\nSENSORS = { 's': { 'type': 'radiancemeter' } }\nEMITTERS = {}\n")
    with pytest.raises(ValueError, match="unknown sensor type"):
        tai.load_reference_asset(p, device="cpu")
    p = write("OBJECTS = {}\nSENSORS = {}\nEMITTERS = { 'e': { 'type': 'projector' } }\n")
    with pytest.raises(ValueError, match="unknown emitter type"):
        tai.load_reference_asset(p, device="cpu")
    assert tai.load_reference_asset(p, strict=False, device="cpu")["emitter"] is None
    with pytest.raises(FileNotFoundError):
        tai.load_reference_asset(str(tmp_path / "nowhere"), device="cpu")
