"""The port's example CLIs (``python -m volprim_tpu_torch.examples.<name>``)
with ``--device cpu`` on a PLY and cameras.json the port writes itself:
the synthetic surface scene at 2,048 primitives and four 32x32 orbit
cameras, two refine iterations."""

import os

import numpy as np
import pytest
import torch

from volprim_tpu_torch.examples import refine_3dg_dataset as refine
from volprim_tpu_torch.examples import render_3dg_asset as render_cli
from volprim_tpu_torch.models import rf_tiled
from volprim_tpu_torch.scene import JSONCameraSpecsIO, load_asset, load_ply, save_ply, synthetic
from volprim_tpu_torch.utils.image import read_exr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def asset(tmp_path_factory):
    d = tmp_path_factory.mktemp("asset")
    save_ply(synthetic.make_scene(2048, device="cpu"), str(d / "scene.ply"))
    JSONCameraSpecsIO.write(synthetic.orbit_cameras(32, 4), str(d / "cameras.json"))
    return dict(ply=str(d / "scene.ply"), cameras=str(d / "cameras.json"), dir=d)


def test_render_tiled_equals_in_process_render(asset, tmp_path):
    out = tmp_path / "out"
    img = render_cli.main(["--ply", asset["ply"], "--cameras", asset["cameras"], "--output",
                           str(out), "--renderer", "tiled", "--spp", "2", "--device", "cpu"])
    exr = read_exr(str(out / "output.exr"))
    assert exr.shape == (32, 32, 3) and (out / "output.png").exists()
    np.testing.assert_array_equal(exr, img.numpy())
    cam = JSONCameraSpecsIO.load(asset["cameras"])[0]
    cfg = render_cli.tiled_config(cam, 128, "gaussian")
    assert cfg.backend == "fused" and cfg.kernel_compact
    assert render_cli.tiled_config(cam, 128, "epanechnikov").backend == "xla"
    want = rf_tiled.render(load_ply(asset["ply"], device="cpu"), cam, cfg, None, spp=2, seed=0)
    assert torch.equal(img, want)


def test_render_exact_epanechnikov_white_background(asset, tmp_path):
    args = ["--ply", asset["ply"], "--cameras", asset["cameras"], "--renderer", "exact",
            "--kernel", "epanechnikov", "--cam_index", "1", "--device", "cpu"]
    lit = render_cli.main(args + ["--output", str(tmp_path / "w"), "--white_background"])
    dark = render_cli.main(args + ["--output", str(tmp_path / "b")])
    assert lit.shape == (32, 32, 3) and bool(torch.isfinite(lit).all())
    assert float((lit - dark).min()) >= -1e-6 and float((lit - dark).max()) > 0.1
    if not torch.cuda.is_available():  # without --device the CLI takes the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            render_cli.main(args[:-2] + ["--output", str(tmp_path / "x")])


@pytest.mark.parametrize("kernel,renderer,refs", [
    ("epanechnikov", "tiled", "selfref"), ("gaussian", "tiled", "images"),
    ("gaussian", "exact", "selfref")])
def test_refine(asset, tmp_path, kernel, renderer, refs):
    args = ["--ply", asset["ply"], "--cameras", asset["cameras"], "--output", str(tmp_path),
            "--kernel", kernel, "--renderer", renderer, "--iterations", "2", "--cam_count", "4",
            "--cam_scale", "1.0", "--ref_spp", "1", "--write_image_every", "1",
            "--device", "cpu"]
    if refs == "images":
        ref_dir = tmp_path / "refs"
        os.makedirs(ref_dir)
        rng = np.random.default_rng(0)
        for cam in JSONCameraSpecsIO.load(asset["cameras"]):
            np.save(ref_dir / f"{cam.name}.npy", rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
        args += ["--images", str(ref_dir)]
    else:
        args += ["--selfref"]
    out = refine.main(args)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert len(out["step_seconds"]) == 2 and min(out["step_seconds"]) > 0.0
    assert out["final_seconds"] > 0.0 and out["train_peak_bytes"] is None
    assert (tmp_path / "reference.png").exists() and (tmp_path / "frame_0001.png").exists()
    a = load_asset(str(tmp_path / "refined_asset"), device="cpu")
    assert a["primitives"].num_prims == 2048 and len(a["cameras"]) == 4
    assert a["integrator"]["kernel_type"] == kernel
    op = a["primitives"].attrs["opacities"]
    assert float(op.min()) > 0.0 and float(op.max()) < 1.0
