"""The port's COLMAP I/O (volprim_tpu_torch.scene.colmap) and
``ColmapCameraSpecsIO`` / ``CameraSpecs.viewmat`` / ``K``
(volprim_tpu_torch.scene.cameras) against the JAX package's.

Both packages read and write COLMAP models in f64 numpy, so everything is
held exactly: the text writers' bytes, every field the readers return
(text and binary, the binary files written with ``struct`` as
tests/test_cameras.py:98-138 writes them), ``points3D_to_arrays``, the
quaternion conversions, and each camera model's ``to_world``, focal
length, ``cx`` / ``cy`` and distortion terms through
``ColmapCameraSpecsIO.load`` (within 1e-12, and in fact equal).
"""

import struct

import numpy as np
import pytest

from volprim_tpu import scene as jscene
from volprim_tpu.scene import colmap as jcolmap
from volprim_tpu_torch import scene as tscene
from volprim_tpu_torch.scene import colmap

# model name -> parameter list (fx [fy] cx cy distortion...), one per model
PARAMS = {
    "SIMPLE_PINHOLE": [510.5, 321.25, 239.75],
    "PINHOLE": [510.5, 505.0, 321.25, 239.75],
    "SIMPLE_RADIAL": [510.5, 321.25, 239.75, -0.031],
    "RADIAL": [510.5, 321.25, 239.75, -0.031, 0.0042],
    "OPENCV": [510.5, 505.0, 321.25, 239.75, -0.031, 0.0042, 1.5e-4, -2.5e-4],
    "OPENCV_FISHEYE": [510.5, 505.0, 321.25, 239.75, 0.021, -0.0042, 3e-4, -1e-5],
    "FULL_OPENCV": [510.5, 505.0, 321.25, 239.75, -0.031, 0.0042, 1.5e-4, -2.5e-4,
                    1e-3, -2e-4, 3e-5, -4e-6],
}
FIELDS = ("width", "height", "focal_length", "fov", "cx", "cy", "k1", "k2", "k3", "k4", "k5",
          "k6", "p1", "p2", "near_clip", "far_clip", "name")


def random_model(rng, model, n_images=3):
    """(cameras, images) dicts of one camera of ``model`` and ``n_images``
    posed images, as the JAX package's records."""
    cams = {4: jcolmap.Camera(4, model, 640, 480, np.asarray(PARAMS[model], np.float64))}
    images = {}
    for i in range(n_images):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[10 + i] = jcolmap.Image(10 + i, q, rng.normal(size=3) * 2.0, 4, f"img{i:03d}.png")
    return cams, images


def write_binary(base, cams, images, n_pts=2):
    """cameras.bin and images.bin in COLMAP's layout (with ``n_pts`` 2D
    point records per image, which the readers skip)."""
    with open(base / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, jcolmap.MODEL_NAME_TO_ID[c.model], c.width,
                                c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))
    with open(base / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", n_pts))
            for j in range(n_pts):
                f.write(struct.pack("<ddq", 1.5 * j, 2.5 * j, -1))


def model_dir(tmp_path, model, form, seed=0):
    cams, images = random_model(np.random.default_rng(seed), model)
    base = tmp_path / "sparse" / "0"
    base.mkdir(parents=True)
    if form == "binary":
        write_binary(base, cams, images)
    else:
        jcolmap.write_intrinsics_text(cams, str(base / "cameras.txt"))
        write_images_text(base / "images.txt", images)
    return cams, images


def write_images_text(path, images):
    """images.txt as COLMAP writes it: a pose line, then a 2D-points line."""
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image\n")
        for im in images.values():
            pose = " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec))
            f.write(f"{im.id} {pose} {im.camera_id} {im.name}\n")
            f.write("12.5 7.25 -1 3.0 4.0 17\n")


def same_records(a, b, names):
    assert sorted(a) == sorted(b)
    for k in a:
        for name in names:
            x, y = getattr(a[k], name), getattr(b[k], name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), (k, name)
            else:
                assert type(x) is type(y) and x == y, (k, name)


@pytest.mark.parametrize("model", sorted(PARAMS))
@pytest.mark.parametrize("form", ["binary", "text"])
def test_camera_specs_load_every_model(tmp_path, model, form):
    model_dir(tmp_path, model, form)
    want = jscene.ColmapCameraSpecsIO.load(str(tmp_path))
    got = tscene.ColmapCameraSpecsIO.load(str(tmp_path))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.to_world, w.to_world, rtol=0, atol=1e-12)
        assert np.array_equal(g.to_world, w.to_world)
        for name in FIELDS:
            gv, wv = getattr(g, name), getattr(w, name)
            if isinstance(wv, str):
                assert gv == wv
            else:
                assert abs(gv - wv) <= 1e-12 and gv == wv, (name, gv, wv)
    assert got[0].name == "img000_png" and got[0].width == 640


def test_unhandled_camera_model_raises(tmp_path):
    base = tmp_path / "sparse" / "0"
    base.mkdir(parents=True)
    (base / "cameras.txt").write_text("1 FOV 64 48 50.0 32.0 24.0 0.1\n")
    (base / "images.txt").write_text("1 1 0 0 0 0 0 0 1 a.png\n\n")
    with pytest.raises(ValueError, match="FOV"):
        tscene.ColmapCameraSpecsIO.load(str(tmp_path))


@pytest.mark.parametrize("model", ["PINHOLE", "FULL_OPENCV"])
def test_text_writers_and_readers(tmp_path, model):
    cams, images = random_model(np.random.default_rng(1), model, n_images=4)
    # the port's records, built from the same numbers
    tcams = {k: colmap.Camera(c.id, c.model, c.width, c.height, c.params.copy())
             for k, c in cams.items()}
    timgs = {k: colmap.Image(i.id, i.qvec.copy(), i.tvec.copy(), i.camera_id, i.name)
             for k, i in images.items()}
    for stem, jwrite, twrite in (("cameras", jcolmap.write_intrinsics_text,
                                  colmap.write_intrinsics_text),
                                 ("images", jcolmap.write_extrinsics_text,
                                  colmap.write_extrinsics_text)):
        jwrite(cams if stem == "cameras" else images, str(tmp_path / f"j_{stem}.txt"))
        twrite(tcams if stem == "cameras" else timgs, str(tmp_path / f"t_{stem}.txt"))
        assert (tmp_path / f"j_{stem}.txt").read_bytes() == (
            tmp_path / f"t_{stem}.txt").read_bytes()
    same_records(colmap.read_intrinsics_text(str(tmp_path / "t_cameras.txt")),
                 jcolmap.read_intrinsics_text(str(tmp_path / "j_cameras.txt")),
                 ("id", "model", "width", "height", "params"))
    back = colmap.read_extrinsics_text(str(tmp_path / "t_images.txt"))
    same_records(back, jcolmap.read_extrinsics_text(str(tmp_path / "j_images.txt")),
                 ("id", "qvec", "tvec", "camera_id", "name"))
    # the writer leaves each image's 2D-points line empty and the reader
    # drops empty lines before taking every other one: in both packages a
    # round trip keeps images 1 and 3 of 4 (ROADMAP.md §D)
    assert sorted(back) == [10, 12]
    write_images_text(tmp_path / "full.txt", images)
    same_records(colmap.read_extrinsics_text(str(tmp_path / "full.txt")), images,
                 ("id", "qvec", "tvec", "camera_id", "name"))


def test_binary_readers(tmp_path):
    cams, images = random_model(np.random.default_rng(2), "OPENCV", n_images=5)
    write_binary(tmp_path, cams, images, n_pts=3)
    same_records(colmap.read_intrinsics_binary(str(tmp_path / "cameras.bin")),
                 jcolmap.read_intrinsics_binary(str(tmp_path / "cameras.bin")),
                 ("id", "model", "width", "height", "params"))
    got = colmap.read_extrinsics_binary(str(tmp_path / "images.bin"))
    same_records(got, jcolmap.read_extrinsics_binary(str(tmp_path / "images.bin")),
                 ("id", "qvec", "tvec", "camera_id", "name"))
    assert got[12].name == "img002.png"


def test_points3d_round_trips(tmp_path):
    """tests/test_cameras.py's points3D round trip on the port, held to JAX:
    the text writer's bytes, both readers and points3D_to_arrays."""
    rng = np.random.default_rng(3)
    pts = {}
    for pid in (7, 9, 12):
        track = int(rng.integers(0, 4))
        pts[pid] = colmap.Point3D(
            pid, rng.normal(size=3), rng.integers(0, 256, 3).astype(np.uint8),
            float(rng.uniform()), rng.integers(0, 50, track).astype(np.int32),
            rng.integers(0, 500, track).astype(np.int32))
    colmap.write_points3D_text(pts, str(tmp_path / "t.txt"))
    jcolmap.write_points3D_text(pts, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    fields = ("id", "xyz", "rgb", "error", "image_ids", "point2d_idxs")
    back = colmap.read_points3D_text(str(tmp_path / "t.txt"))
    same_records(back, jcolmap.read_points3D_text(str(tmp_path / "t.txt")), fields)
    np.testing.assert_array_equal(back[7].xyz, pts[7].xyz)

    with open(tmp_path / "p.bin", "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz, *p.rgb.tolist(), p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for i, j in zip(p.image_ids, p.point2d_idxs):
                f.write(struct.pack("<ii", int(i), int(j)))
    backb = colmap.read_points3D_binary(str(tmp_path / "p.bin"))
    same_records(backb, jcolmap.read_points3D_binary(str(tmp_path / "p.bin")), fields)
    xyz, rgb = colmap.points3D_to_arrays(backb)
    jxyz, jrgb = jcolmap.points3D_to_arrays(backb)
    assert xyz.dtype == np.float32 and np.array_equal(xyz, jxyz) and np.array_equal(rgb, jrgb)


def test_quaternion_conversions():
    rng = np.random.default_rng(4)
    for _ in range(16):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r = colmap.qvec2rotmat(q)
        assert np.array_equal(r, jcolmap.qvec2rotmat(q))
        back = colmap.rotmat2qvec(r)
        assert np.array_equal(back, jcolmap.rotmat2qvec(r))
        np.testing.assert_allclose(back, q * np.sign(q[0]), atol=1e-12)
    assert colmap.CAMERA_MODELS == jcolmap.CAMERA_MODELS
    assert colmap.MODEL_NAME_TO_ID == jcolmap.MODEL_NAME_TO_ID


@pytest.mark.parametrize("spec", [dict(fov=50.0), dict(focal_length=432.5, cx=3.5, cy=-2.0)])
def test_viewmat_and_intrinsics(spec):
    pose = np.asarray(jscene.look_at([0.3, 0.4, -3.0], [0.1, 0, 0.2], [0, 1, 0]))
    jcam = jscene.CameraSpecs("c", 64, 48, pose, **spec)
    tcam = tscene.CameraSpecs("c", 64, 48, pose, **spec)
    assert np.array_equal(tcam.viewmat(), jcam.viewmat())
    assert np.array_equal(tcam.K(), jcam.K())
    # the view matrix takes the camera's center to the origin, its forward
    # axis (+z in both conventions) to +z
    np.testing.assert_allclose(tcam.viewmat() @ np.append(pose[:3, 3], 1.0), [0, 0, 0, 1],
                               atol=1e-12)
    np.testing.assert_allclose(tcam.viewmat()[:3, :3] @ pose[:3, 2], [0, 0, 1], atol=1e-12)
