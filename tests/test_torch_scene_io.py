"""The port's PLY, camera, asset and image I/O against the JAX package's.

- PLY: a file the JAX package wrote loads in the port to the arrays JAX
  loads from it, bit for bit (through the native parser and through
  numpy); the file the port writes for a scene is byte-identical to
  JAX's; an ASCII PLY parses alike; the round trip holds JAX's tolerances
  (tests/test_scene_io.py).
- Cameras: cameras.json written by either package loads alike in the
  other, the bytes written are identical; KRT files with ``faithful`` on
  and off; ``scaled``, ``to_dict`` and ``from_dict``.
- Assets (volprim_tpu_asset_v1): written by one package, read by the
  other.
- Images: EXR (1 and 3 channels) and PNG bytes identical to JAX's
  writers, ``read_exr`` round trips.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu.scene import asset as jasset
from volprim_tpu.scene import cameras as jcams
from volprim_tpu.scene import ply as jply
from volprim_tpu.utils import image as jimage
from volprim_tpu_torch import native, scene as tscene
from volprim_tpu_torch.scene import asset as tasset
from volprim_tpu_torch.scene import cameras as tcams
from volprim_tpu_torch.scene import ply as tply
from volprim_tpu_torch.utils import image as timage

from test_rf_tiled import surface_scene
from test_scene_io import make_scene as medium_scene
from test_torch_rf_tiled import _port_scene


def _arrays(s):
    out = dict(centers=s.centers, scales=s.scales, quats=s.quats, **s.attrs)
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("which", ["3dgs", "medium"])
def test_ply_across_packages(which, tmp_path):
    s = surface_scene(64) if which == "3dgs" else medium_scene()
    jax_file, port_file = tmp_path / "jax.ply", tmp_path / "port.ply"
    jply.save_ply(s, str(jax_file))
    tply.save_ply(_port_scene(s), str(port_file))
    assert port_file.read_bytes() == jax_file.read_bytes()
    want = _arrays(jply.load_ply(str(jax_file)))
    assert native.get() is not None
    for use_native in (True, False):
        got = _arrays(tply.load_ply(str(jax_file), device="cpu", use_native=use_native))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # JAX's round-trip tolerances against the scene itself
    got, orig = _arrays(tply.load_ply(str(port_file), device="cpu")), _arrays(s)
    for k, (rtol, atol) in dict(centers=(1e-5, 0), scales=(1e-5, 0), quats=(1e-5, 1e-6),
                                opacities=(1e-4, 1e-5), sh_coeffs=(1e-4, 1e-5),
                                sigma_t=(1e-5, 0), albedo=(1e-5, 0)).items():
        if k in orig:
            np.testing.assert_allclose(got[k], orig[k], rtol=rtol, atol=atol, err_msg=k)


def test_ascii_ply(tmp_path):
    path = tmp_path / "a.ply"
    rows = np.random.default_rng(0).normal(size=(5, 14)).astype(np.float32)
    names = ["x", "y", "z", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2",
             "rot_3", "opacity", "f_dc_0", "f_dc_1", "f_dc_2"]
    head = ["ply", "format ascii 1.0", "element vertex 5"]
    head += [f"property float {n}" for n in names] + ["end_header"]
    path.write_text("\n".join(head + [" ".join(f"{v:.6f}" for v in r) for r in rows]) + "\n")
    assert native.parse_ply_columns(str(path)) is None  # the native parser reads binary only
    got, want = _arrays(tply.load_ply(str(path), device="cpu")), _arrays(jply.load_ply(str(path)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _camera_pair():
    pose = dict(name="cam0", width=64, height=48, fov=55.0, cx=1.5, cy=-2.0)
    at = ([0.3, 0.4, -3.2], [0, 0, 0], [0, 1, 0])
    return (jscene.CameraSpecs(to_world=jscene.look_at(*at), **pose),
            tscene.CameraSpecs(to_world=tscene.look_at(*at), **pose))


def _same_camera(t, j):
    for f in ("name", "width", "height", "near_clip", "far_clip", "cx", "cy", "k1", "k2",
              "k3", "k4", "k5", "k6", "p1", "p2"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.fov == pytest.approx(j.fov, rel=1e-12)
    assert t.focal_length == pytest.approx(j.focal_length, rel=1e-12)
    np.testing.assert_array_equal(t.to_world, j.to_world)


def test_camera_json_across_packages(tmp_path):
    cams_j, cams_t = zip(*(_camera_pair() for _ in range(1)))
    cams_j = list(cams_j) + [cams_j[0].scaled(0.5)]
    cams_t = list(cams_t) + [cams_t[0].scaled(0.5)]
    _same_camera(cams_t[1], cams_j[1])
    jcams.JSONCameraSpecsIO.write(cams_j, str(tmp_path / "j.json"))
    tcams.JSONCameraSpecsIO.write(cams_t, str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    for t, j in zip(tcams.JSONCameraSpecsIO.load(str(tmp_path / "j.json")),
                    jcams.JSONCameraSpecsIO.load(str(tmp_path / "t.json"))):
        _same_camera(t, j)
    d = cams_t[0].to_dict()
    assert d == cams_j[0].to_dict()
    _same_camera(tscene.CameraSpecs.from_dict(json.loads(json.dumps(d))),
                 jscene.CameraSpecs.from_dict(d))


@pytest.mark.parametrize("faithful", [True, False])
def test_krt_loader(tmp_path, faithful):
    krt = {"KRT": [
        {"cameraId": "a", "distortionModel": "RadialAndTangential", "projectionModel": "Pinhole",
         "K": [[500.0, 0, 0], [0, 500.0, 0], [320.0, 240.0, 1.0]],
         "T": np.eye(4).tolist(), "distortion": [[0.1, -0.05, 0.01, 0.002]]},
        {"cameraId": "b", "distortionModel": "Fisheye", "projectionModel": "Pinhole",
         "K": np.eye(3).tolist(), "T": np.eye(4).tolist(), "distortion": [[0, 0, 0, 0]]},
    ]}
    path = tmp_path / "krt.json"
    path.write_text(json.dumps(krt))
    got = tcams.KRTCameraSpecsIO.load(str(path), faithful=faithful)
    want = jcams.KRTCameraSpecsIO.load(str(path), faithful=faithful)
    assert len(got) == len(want) == 1
    _same_camera(got[0], want[0])
    assert got[0].width == (480 if faithful else 640)


def test_asset_across_packages(tmp_path):
    s = surface_scene(64)
    cams_j, cams_t = _camera_pair()
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    meta = dict(integrator={"type": "volprim_rf", "max_depth": 64}, arrays={"extra": arr})
    tasset.save_asset(str(tmp_path / "t"), _port_scene(s), [cams_t], **meta)
    jasset.save_asset(str(tmp_path / "j"), s, [cams_j], **meta)
    assert (tmp_path / "t" / "scene.json").read_bytes() == (tmp_path / "j" / "scene.json").read_bytes()
    for src, reader in (("t", jasset.load_asset), ("j", lambda p: tasset.load_asset(p, "cpu"))):
        a = reader(str(tmp_path / src))
        assert a["primitives"].num_prims == 64
        assert a["integrator"] == meta["integrator"]
        np.testing.assert_array_equal(a["arrays"]["extra"], arr)
        assert a["cameras"][0].name == "cam0"
    with pytest.raises(ValueError, match="format"):
        (tmp_path / "t" / "scene.json").write_text(json.dumps({"format": "other"}))
        tasset.load_asset(str(tmp_path / "t"), "cpu")


@pytest.mark.parametrize("channels", [1, 3])
def test_image_writers_match_jax(tmp_path, channels):
    img = np.random.default_rng(channels).uniform(-0.1, 1.3, (12, 20, channels)).astype(
        np.float32)
    img[0, 0, 0] = np.nan
    for ext in ("exr", "png", "npy"):
        jimage.write_image(str(tmp_path / f"j.{ext}"), jnp.asarray(img))
        timage.write_image(str(tmp_path / f"t.{ext}"), torch.from_numpy(img))
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes(), ext
    back = timage.read_exr(str(tmp_path / "j.exr"))
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(back, jimage.read_exr(str(tmp_path / "t.exr")))
    with pytest.raises(ValueError, match="extension"):
        timage.write_image(str(tmp_path / "x.tiff"), img)
