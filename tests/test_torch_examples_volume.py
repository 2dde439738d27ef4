"""The port's volume-fitting CLIs, ``optimize_volume`` and ``render_asset``
(``python -m volprim_tpu_torch.examples.<name>``), in-process through
``main(argv)`` with ``--device cpu`` at tests/test_examples.py:122-160's
sizes.

- optimize_volume (24x24, 2 cameras, 3 steps, an 8^3 lattice) in both
  reference modes and with ``--grad_spp``: the images, ``curves.json``
  (its curves are the printed ones), the asset (integrator
  volprim_tomography, a constant emitter) that loads back pruned.
- render_asset on the asset the CLI wrote (scene.json) and on a
  reference-format asset that save_reference_asset wrote: each equals an
  in-process render of the same scene through models.REGISTRY; an envmap
  emitter; a volprim_prb asset renders with its default walk and with
  walk_backend="pallas".
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from volprim_tpu_torch import models
from volprim_tpu_torch.examples import optimize_volume as ov
from volprim_tpu_torch.examples import render_asset as ra
from volprim_tpu_torch.ops import envmap
from volprim_tpu_torch.scene import (
    CameraSpecs, asset_interop, load_asset, look_at, save_asset, synthetic,
)
from volprim_tpu_torch.utils.image import read_exr

SMALL = ["--cam_res", "24", "--cam_count", "2", "--iterations", "3", "--volprim_count", "8",
         "--ref_spp", "1", "--opt_spp", "1", "--write_image_every", "2", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra", [["--ref_mode", "absorption"], ["--grad_spp", "2"]],
                         ids=["absorption", "scattering_grad_spp"])
def test_optimize_volume_cli(tmp_path, capsys, extra):
    out = tmp_path / "opt"
    res = ov.main(["--output", str(out)] + SMALL + extra)
    printed = [float(x) for x in
               re.findall(r"\| loss=([0-9.]+)", capsys.readouterr().out)]
    for name in ("reference.png", "reference.exr", "initial.png", "optimized.png",
                 "optimized.exr", "frames/image_0001.png"):
        assert (out / name).exists(), name
    curves = json.loads((out / "curves.json").read_text())
    assert curves == {"loss": res["losses"], "psnr": res["psnrs"]}
    assert len(curves["loss"]) == 3 and np.isfinite(curves["loss"] + curves["psnr"]).all()
    np.testing.assert_allclose(printed, curves["loss"], atol=5e-5)
    assert curves["loss"][-1] < curves["loss"][0]
    ref = read_exr(str(out / "reference.exr"))
    assert ref.shape == (24, 48, 3) and ref.min() >= 0.0 and ref.max() <= 1.0
    asset = load_asset(res["asset"], device="cpu")
    assert asset["integrator"] == {"type": "volprim_tomography", "max_depth": -1}
    assert asset["emitters"] == {"environment": {"type": "constant"}}
    assert asset["primitives"].num_prims == res["num_prims"] <= 512
    assert len(asset["cameras"]) == 2
    img = ra.main([res["asset"], "--output", str(tmp_path / "ra.exr"), "--spp", "1",
                   "--device", "cpu"])
    assert img.shape == (24, 24, 3) and float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_optimize_volume_without_matplotlib(tmp_path, capsys, monkeypatch):
    """Where matplotlib does not import the CLI writes curves.json, prints
    one line and draws no plot."""
    import builtins

    real_import = builtins.__import__

    def no_mpl(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    out = tmp_path / "opt"
    ov.main(["--output", str(out), "--ref_mode", "absorption", "--no_prune"] + SMALL)
    assert "curves are in curves.json only" in capsys.readouterr().out
    assert (out / "curves.json").exists() and not (out / "loss.png").exists()


def _render(scene, camera, name, cfg, emitter, spp=1):
    gen = torch.Generator().manual_seed(0)
    return models.render(scene, camera, models.REGISTRY[name], cfg, emitter, spp=spp,
                         generator=gen)


@pytest.fixture(scope="module")
def medium():
    s = synthetic.make_medium(128, seed=1, device="cpu")
    cam = CameraSpecs(name="c0", width=20, height=16,
                      to_world=look_at([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0]), fov=45.0)
    return s, cam


def test_render_asset_reference_format(tmp_path, medium):
    s, cam = medium
    asset_dir = str(tmp_path / "asset")
    asset_interop.save_reference_asset(asset_dir, s, [cam],
                                       envmap.ConstantEmitter(radiance=torch.full((3,), 0.7)))
    out = str(tmp_path / "ra.exr")
    img = ra.main([asset_dir, "--output", out, "--spp", "1", "--device", "cpu"])
    exr = read_exr(out)
    assert exr.shape == (16, 20, 3) and np.isfinite(exr).all()
    assert os.path.exists(str(tmp_path / "ra.png"))
    back = asset_interop.load_reference_asset(asset_dir, device="cpu")
    want = _render(back["primitives"], back["cameras"][0], "volprim_tomography",
                   models.CONFIGS["volprim_tomography"](), back["emitter"])
    assert torch.equal(img, want)
    np.testing.assert_array_equal(exr, want.numpy())
    assert 0.0 <= float(img.min()) < 0.6 and float(img.max()) <= 0.7 + 1e-6


def test_render_asset_scene_json(tmp_path, medium):
    s, cam = medium
    d = str(tmp_path / "asset")
    sky = np.random.default_rng(0).uniform(0.2, 1.0, size=(8, 16, 3)).astype(np.float32)
    save_asset(d, s, [cam], integrator={"type": "volprim_tomography", "max_depth": 8},
               emitters={"sky": {"type": "envmap", "array": "sky"}}, arrays={"sky": sky})
    img = ra.main([d, "--output", str(tmp_path / "o.exr"), "--spp", "2", "--cam_scale", "0.5",
                   "--device", "cpu"])
    assert img.shape == (8, 10, 3)
    cfg = models.CONFIGS["volprim_tomography"](max_depth=8)
    want = _render(load_asset(d, device="cpu")["primitives"], cam.scaled(0.5),
                   "volprim_tomography", cfg,
                   envmap.EnvironmentMap.from_array(sky, device="cpu"), spp=2)
    assert torch.equal(img, want)


def test_render_asset_prb_needs_the_pallas_walk(tmp_path, medium):
    s, cam = medium
    d = str(tmp_path / "asset")
    # the path tracer renders with its default (xla) walk and with the fused one
    for extra in ({}, {"walk_backend": "pallas"}):
        save_asset(d, s, [cam], integrator={"type": "volprim_prb", "max_depth": 4, **extra},
                   emitters={"environment": {"type": "constant", "radiance": 1.0}})
        img = ra.main([d, "--output", str(tmp_path / "o.exr"), "--spp", "1", "--device",
                       "cpu"])
        assert img.shape == (16, 20, 3) and bool(torch.isfinite(img).all())
