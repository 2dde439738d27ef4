"""The port's dataset generation (volprim_tpu_torch.tooling.dataset) and
the generate_dataset CLI against the JAX package.

Tolerances:
- held exactly (both packages compute in f64 numpy): ``icosphere``,
  ``icosphere_rig`` (poses, fov, focal length, names), ``transforms_dict``,
  the HDR layout's transforms, and ``write_points3d_ply``'s bytes;
- ``sample_point_cloud`` draws from a generator where JAX draws from a key:
  the points' and colors' per-axis means within 4 standard errors of their
  difference, and on one elongated rotated primitive each element of the
  points' covariance within 4 of its standard errors;
- tests/test_tooling.py's layout tests on the port
  (``test_dataset_generation``, ``test_hdr_dataset_layout``);
- the CLI with ``--device cpu`` on ``synthetic.make_scene(2048)`` at 16x16,
  subdivisions 0, 1 spp, 256 points: the JAX CLI's layout, finite
  non-negative images, transforms that read back equal to the rig; without
  a card it raises unless told to use the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.scene import ply as jply
from volprim_tpu.scene.ellipsoids import EllipsoidScene as JScene
from volprim_tpu.tooling import dataset as jdataset
from volprim_tpu_torch import interop
from volprim_tpu_torch.examples import generate_dataset as cli
from volprim_tpu_torch.models import render, rf
from volprim_tpu_torch.scene import EllipsoidsFactory, save_ply, synthetic
from volprim_tpu_torch.tooling import dataset


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_cameras(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.to_world, y.to_world)
        assert (x.name, x.width, x.height, x.fov, x.focal_length, x.cx, x.cy) == (
            y.name, y.width, y.height, y.fov, y.focal_length, y.cx, y.cy)


@pytest.mark.parametrize("subdivisions", [0, 1, 2])
def test_icosphere_rig_equals_jax(subdivisions):
    assert np.array_equal(dataset.icosphere(subdivisions), jdataset.icosphere(subdivisions))
    center = [0.3, -0.2, 0.1]
    cams = dataset.icosphere_rig(center, 3.0, width=32, height=24, fov=40.0,
                                 subdivisions=subdivisions)
    same_cameras(cams, jdataset.icosphere_rig(center, 3.0, width=32, height=24, fov=40.0,
                                              subdivisions=subdivisions))
    assert dataset.transforms_dict(cams) == jdataset.transforms_dict(cams)
    assert len(cams) == [12, 42, 162][subdivisions]
    for cam in cams:  # tests/test_tooling.py: every camera looks at the center
        fwd = cam.to_world[:3, 2]
        to_center = np.asarray(center) - cam.to_world[:3, 3]
        assert np.dot(fwd, to_center) / np.linalg.norm(to_center) > 0.999


@pytest.mark.parametrize("with_normals", [False, True])
def test_points3d_ply_bytes(tmp_path, with_normals):
    rng = np.random.default_rng(0)
    pts, cols = rng.normal(size=(50, 3)), rng.uniform(-0.1, 1.1, (50, 3))
    nrm = rng.normal(size=(50, 3)) if with_normals else None
    dataset.write_points3d_ply(str(tmp_path / "t.ply"), pts, cols, nrm)
    jdataset.write_points3d_ply(str(tmp_path / "j.ply"), pts, cols, nrm)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def both_scenes(n):
    ts = synthetic.make_scene(n, device="cpu")
    a = interop.to_numpy(ts)
    js = JScene(centers=jnp.asarray(a["centers"]), scales=jnp.asarray(a["scales"]),
                quats=jnp.asarray(a["quats"]),
                attrs={k: jnp.asarray(v) for k, v in a["attrs"].items()}, extent=a["extent"])
    return ts, js


def test_sample_point_cloud_in_distribution():
    ts, js = both_scenes(2048)
    n = 20000
    pts, cols = dataset.sample_point_cloud(ts, n, torch.Generator().manual_seed(0))
    jpts, jcols = jdataset.sample_point_cloud(js, n, jax.random.PRNGKey(0))
    assert pts.shape == cols.shape == (n, 3) and pts.dtype == np.float32
    assert np.isfinite(pts).all() and cols.min() >= 0.0 and cols.max() <= 1.0
    for x, y in ((pts, jpts), (cols, jcols)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        se = np.sqrt((x.var(0) + y.var(0)) / n)
        z = np.abs(x.mean(0) - y.mean(0)) / se
        assert (z <= 4.0).all(), (x.mean(0), y.mean(0), z)
    # one elongated, rotated primitive: the points' covariance is R S^2 R^T
    a = dict(centers=np.zeros((1, 3), np.float32),
             scales=np.asarray([[0.5, 0.05, 0.1]], np.float32),
             quats=np.asarray([[0.2, -0.3, 0.4, 0.8]], np.float32) / np.float32(1.0488088),
             attrs=dict(opacities=np.ones((1, 1), np.float32)), extent=3.0)
    one_t = interop.scene_from_arrays(a["centers"], a["scales"], a["quats"], a["attrs"],
                                      device="cpu")
    one_j = JScene(centers=jnp.asarray(a["centers"]), scales=jnp.asarray(a["scales"]),
                   quats=jnp.asarray(a["quats"]), attrs={"opacities": jnp.ones((1, 1))},
                   extent=3.0)
    x = dataset.sample_point_cloud(one_t, n, torch.Generator().manual_seed(3))[0].astype(
        np.float64)
    y = np.asarray(jdataset.sample_point_cloud(one_j, n, jax.random.PRNGKey(3))[0], np.float64)
    cx, cy = np.cov(x.T), np.cov(y.T)
    se = np.sqrt((np.outer(np.diag(cx), np.diag(cx)) + cx**2) / n
                 + (np.outer(np.diag(cy), np.diag(cy)) + cy**2) / n)
    assert (np.abs(cx - cy) <= 4.0 * se).all(), (cx, cy)
    assert abs(cx[0, 1]) > 10 * se[0, 1]  # the rotation shows
    # a primitive of no volume is never drawn
    f = EllipsoidsFactory()
    f.add(mean=[0, 0, 0], scale=0.3, opacities=0.8, sh_coeffs=np.zeros(3, np.float32))
    f.add(mean=[5, 5, 5], scale=0.0, opacities=0.8, sh_coeffs=np.ones(3, np.float32))
    p, c = dataset.sample_point_cloud(f.build(device="cpu"), 512,
                                      torch.Generator().manual_seed(1))
    assert np.abs(p).max() < 3.0 and np.array_equal(c, np.full((512, 3), 0.5, np.float32))


def test_dataset_generation(tmp_path):
    """tests/test_tooling.py::test_dataset_generation on the port."""
    f = EllipsoidsFactory()
    f.add(mean=[0, 0, 0], scale=0.3, opacities=0.8, sh_coeffs=np.zeros(3, np.float32))
    prims = f.build(device="cpu")
    cams = dataset.icosphere_rig([0, 0, 0], 3.0, width=16, height=16, subdivisions=0)[:3]

    def render_fn(cam, i):
        return render(prims, cam, rf.radiance, rf.RFConfig(max_depth=8, chunk_size=8), None,
                      1, torch.Generator().manual_seed(i))

    pts, colors = dataset.sample_point_cloud(prims, 128, torch.Generator().manual_seed(0))
    dataset.generate(str(tmp_path), render_fn, cams[:2], cams[2:3], point_cloud=(pts, colors))
    for name in ("transforms_train.json", "transforms_test.json", "points3d.npz"):
        assert (tmp_path / name).exists()
    with open(tmp_path / "transforms_train.json") as fh:
        assert json.load(fh) == jdataset.transforms_dict(cams[:2])
    assert pts.shape == (128, 3)
    img = np.load(tmp_path / "images" / "r_0.npy")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0.0
    assert (tmp_path / "images" / "r_2.png").exists()


def test_hdr_dataset_layout(tmp_path):
    """tests/test_tooling.py::test_hdr_dataset_layout on the port; its
    transforms and seed PLY equal to JAX's."""
    cams = dataset.icosphere_rig([0, 0, 0], 3.0, width=8, height=8)[:2]
    pts = np.random.default_rng(0).normal(size=(32, 3))
    cols = np.random.default_rng(1).uniform(size=(32, 3))
    for out, mod, fill in ((tmp_path / "t", dataset, torch.full((8, 8, 3), 0.5)),
                           (tmp_path / "j", jdataset, jnp.full((8, 8, 3), 0.5))):
        mod.generate_hdr(str(out), lambda cam, i, fill=fill: fill, cams, point_cloud=(pts, cols))
    t = tmp_path / "t"
    assert (t / "exr" / "0.exr").exists()
    for e in range(5):
        assert (t / "images" / f"1_{e}.png").exists()
    assert (t / "sparse" / "0" / "points3D.ply").exists()
    with open(t / "transforms_train.json") as f:
        td = json.load(f)
    assert td["w"] == 8 and len(td["frames"]) == 2 and "cx" in td
    with open(tmp_path / "j" / "transforms_train.json") as f:
        assert td == json.load(f)
    ply = "sparse/0/points3D.ply"
    assert (t / ply).read_bytes() == (tmp_path / "j" / ply).read_bytes()
    back = jply.read_ply_vertex_table(str(t / ply), use_native=False)
    np.testing.assert_allclose(back["x"], pts[:, 0], rtol=1e-6)
    assert back["red"].max() <= 255


def test_generate_dataset_cli(tmp_path):
    ply = tmp_path / "scene.ply"
    save_ply(synthetic.make_scene(2048, device="cpu"), str(ply))
    out = tmp_path / "ds"
    res = cli.main(["--ply", str(ply), "--output", str(out), "--resolution", "16",
                    "--subdivisions", "0", "--spp", "1", "--points", "256", "--device", "cpu"])
    assert len(res["train"]) == 11 and len(res["test"]) == 1
    names = sorted(c.name for c in res["train"] + res["test"])
    assert sorted(os.listdir(out / "images")) == sorted(
        [f"{n}.png" for n in names] + [f"{n}.npy" for n in names])
    for n in names:
        img = np.load(out / "images" / f"{n}.npy")
        assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.min() >= 0.0
    center = synthetic.make_scene(2048, device="cpu").centers.mean(0).numpy().astype(np.float64)
    rig = jdataset.icosphere_rig(center, 4.0, width=16, height=16, fov=45.0, subdivisions=0)
    for split, cams in (("train", rig[1:]), ("test", rig[:1])):
        with open(out / f"transforms_{split}.json") as f:
            assert json.load(f) == jdataset.transforms_dict(cams)
    pc = np.load(out / "points3d.npz")
    assert pc["points"].shape == (256, 3) and pc["colors"].shape == (256, 3)
    if not torch.cuda.is_available():  # without --device the CLI takes the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--ply", str(ply), "--output", str(tmp_path / "x")])
