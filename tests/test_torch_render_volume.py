"""The render loop's filters and sample groups (volprim_tpu_torch.models.base,
ops.filters) and the port's ``render_volume`` CLI
(``python -m volprim_tpu_torch.examples.render_volume``), in-process through
``main(argv)`` with ``--device cpu``.

- ``splat_tent`` against the JAX package's on the same px, py (inside and
  outside the film): images and weights within 1e-6 (scatter-adds in
  another order);
- ``spp_group`` g = 1 is reproducible bit for bit (the ungrouped loop);
  g = 2 and 4 (and 3, which falls back to 2)
  are the same estimator: their mean radiance within 4 standard errors of
  the ungrouped one's (tests/test_prb.py::test_spp_group_estimator_equivalent);
- the tent filter in ``render`` and ``render_batch``;
- the CLI at 32^2 and 1-2 spp under both walk backends, with
  ``--auto_budget``, from a PLY and from the plume, with an .npy envmap: a
  finite image, the EXR read back equal to it, the PNG beside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ffwalk import one_torch_thread  # noqa: F401
from volprim_tpu.ops import filters as jfilters
from volprim_tpu_torch.examples import render_volume
from volprim_tpu_torch.models import base, prb, render, render_batch
from volprim_tpu_torch.ops import envmap, filters
from volprim_tpu_torch.scene import save_ply, synthetic
from volprim_tpu_torch.utils import image


def test_splat_tent_matches_jax():
    rng = np.random.default_rng(0)
    n, w, h = 5000, 23, 17
    px = rng.uniform(-1.0, w + 1.0, n).astype(np.float32)
    py = rng.uniform(-1.0, h + 1.0, n).astype(np.float32)
    vals = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    img_t, wgt_t = filters.splat_tent(torch.from_numpy(vals), torch.from_numpy(px),
                                      torch.from_numpy(py), w, h)
    img_j, wgt_j = jfilters.splat_tent(jnp.asarray(vals), jnp.asarray(px), jnp.asarray(py), w, h)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wgt_t.numpy(), np.asarray(wgt_j), rtol=1e-5, atol=1e-6)
    # a sample on a pixel centre puts its whole weight there
    img, wgt = filters.splat_tent(torch.ones(1, 3), torch.tensor([3.5]), torch.tensor([2.5]), 8, 8)
    assert float(wgt[2, 3]) == 1.0 and float(wgt.sum()) == 1.0


def plume_frame(spp, g, seed=7, rfilter="box"):
    scene = synthetic.make_medium(1024, seed=0, device="cpu")
    cam = synthetic.medium_camera(16, 16)
    cfg = prb.PRBConfig(max_overlaps=8, max_windows=4, chunk_size=256, bounce_cap=8)
    return render(scene, cam, prb.radiance, cfg, envmap.procedural_sky(32, 64, device="cpu"),
                  spp, torch.Generator().manual_seed(seed), rfilter=rfilter, spp_group=g)


def test_spp_group_is_the_same_estimator():
    img_a = plume_frame(8, 1)
    assert torch.equal(img_a, plume_frame(8, 1))
    n_pix = img_a.numel() / 3
    for g in (2, 4, 3):  # 3 falls back to 2
        img_g = plume_frame(8, g)
        assert bool(torch.isfinite(img_g).all())
        assert not torch.equal(img_g, img_a)
        se = float(img_a.std()) * np.sqrt(2.0 / n_pix)
        print(f"g={g}: mean {float(img_g.mean()):.5f} vs {float(img_a.mean()):.5f}, "
              f"4 se {4 * se:.5f}")
        assert abs(float(img_g.mean()) - float(img_a.mean())) <= 4.0 * se


def test_tent_filter_in_render_and_render_batch():
    img = plume_frame(2, 1, rfilter="tent")
    assert bool(torch.isfinite(img).all()) and not torch.equal(img, plume_frame(2, 1))
    scene = synthetic.make_medium(1024, seed=0, device="cpu")
    cams = [synthetic.medium_camera(8, 8), synthetic.medium_camera(8, 8)]
    cfg = prb.PRBConfig(max_overlaps=8, max_windows=4, chunk_size=256, bounce_cap=4)
    wide = render_batch(scene, cams, prb.radiance, cfg, envmap.ConstantEmitter(
        radiance=torch.ones(3)), 2, torch.Generator().manual_seed(1), rfilter="tent")
    assert wide.shape == (8, 16, 3) and bool(torch.isfinite(wide).all())
    assert base._splat("tent") is filters.splat_tent
    assert base._splat("gaussian") is filters.splat_box  # as the JAX package


@pytest.mark.parametrize("backend,extra", [
    ("xla", ["--auto_budget"]), ("pallas", []), ("xla", ["--volume", "PLY", "--envmap", "NPY"]),
])
def test_render_volume_cli(tmp_path, backend, extra):
    argv = ["--output", str(tmp_path / "out.exr"), "--width", "32", "--height", "32",
            "--spp", "2" if backend == "pallas" else "1", "--walk_backend", backend,
            "--device", "cpu"]
    if "--volume" in extra:
        ply = str(tmp_path / "m.ply")
        save_ply(synthetic.make_medium(512, seed=1, device="cpu"), ply)
        sky = np.random.default_rng(0).uniform(0.2, 1.0, (8, 16, 3)).astype(np.float32)
        np.save(tmp_path / "sky.npy", sky)
        extra = ["--volume", ply, "--envmap", str(tmp_path / "sky.npy"), "--sigmat_scale", "1.0",
                 "--max_depth", "4"]
    img = render_volume.main(argv + extra)
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0.0
    np.testing.assert_array_equal(image.read_exr(str(tmp_path / "out.exr")), img.numpy())
    assert (tmp_path / "out.png").exists()


def test_render_volume_parser_defaults():
    args = render_volume.parser().parse_args([])
    assert (args.walk_backend, args.spp, args.width, args.height, args.max_depth) == (
        "xla", 64, 512, 512, -1)
    assert args.volume is None and args.sigmat_scale is None and not args.auto_budget
