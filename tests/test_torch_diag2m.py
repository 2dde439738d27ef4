"""The port's 2M quality attribution (volprim_tpu_torch.tools.diag2m)
against the root tools/diag2m.py, on the CPU at a small size.

The root script is imported (it pins JAX to the CPU, as the tests do) for
its configurations, its subsample, its camera and its exact reference
(``_exact_ref`` without the cache file); its per-configuration frame is
restated below at test size (it runs inline in its ``main``): bench's scene
of 2,000 primitives at 32 x 32 instead of 2,097,152 at 512 x 512, so the
subsample is the whole film (1,024 rays).

- The port's configurations, reference depth, subsample and camera are the
  root script's.
- By configuration (the default five), the PSNR against the exact
  reference, held in f64 to JAX in f64 where q = c - b^2/a cancels
  (ROADMAP.md §D): the xla frames through the f64 yardstick of
  tests/test_torch_rf_tiled_xla.py, the exact reference the port's in f64
  (JAX's rf.radiance does not trace under jax_enable_x64); the f32 frames,
  references and PSNRs no further from f64 than the rules of that file
  allow (RMS 2x, largest 4x, PSNR 2x JAX's own deviation).
- The noise floor (the exact reference with the primitives permuted) is at
  the MSE floor: an exact render on the CPU does not depend on the
  primitives' order.
- The hit counts equal a direct count with the JAX package's
  ``quadric.pair_coeffs`` (the root script's body over one chunk) but on
  rays with a pair that grazes an extent ellipsoid within f32 rounding.
- The entry point runs with ``--cpu`` at its smallest size, in a
  subprocess, and prints a line per configuration and a JSON line.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from volprim_tpu import scene as jscene
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu.ops import quadric as jquadric
from volprim_tpu_torch.models import rf_tiled as trt
from volprim_tpu_torch.ops import quadric
from volprim_tpu_torch.scene import generate_rays, synthetic
from volprim_tpu_torch.tools import diag2m, studies

from test_torch_rf_tiled_xla import FRAME_TOL, _render64, _scene64, jax_render64

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, WIDTH = 2000, 32


def _root_module():
    spec = importlib.util.spec_from_file_location(
        "root_diag2m", os.path.join(ROOT, "tools", "diag2m.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root():
    return _root_module()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_protocol_is_the_root_scripts(root):
    assert diag2m.CONFIGS == root.CONFIGS
    assert diag2m.MD_REF == root.MD_REF and diag2m.N2M == root.N2M
    src = open(os.path.join(ROOT, "tools", "diag2m.py")).read()
    default = re.search(r'names = sys.argv\[1:\] or \[([^\]]*)\]', src).group(1)
    assert list(diag2m.DEFAULT) == re.findall(r'"([^"]+)"', default)
    np.testing.assert_array_equal(studies.subsample(512 * 512, diag2m.SUBSAMPLE_SEED),
                                  root._subsample())
    np.testing.assert_array_equal(synthetic.headline_camera(512).to_world,
                                  root._camera().to_world)


def _jax_camera():
    return jscene.CameraSpecs(
        name="bench2m", width=WIDTH, height=WIDTH,
        to_world=jscene.look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]), fov=50.0)


def _jax_kw(p):
    """The root script's RFTiledConfig arguments of a CONFIGS entry."""
    return dict(
        max_depth=p["md"], tile_pixels=256, max_candidates=p["mc"],
        segment=min(256, p["mc"]), cluster_size=16, backend="xla",
        coarse_group=p["gc"], coarse_factor=8, super_group=4,
        refine_fraction=0.0, prim_resort=p["resort"],
        srgb_primitives=True, order_band=p.get("band", 0),
    )


def _jax_frame(scene, camera, sel, p):
    """The root script's frame of one configuration, on the subsample."""
    cfg = jrt.RFTiledConfig(**_jax_kw(p))
    state = jax.jit(lambda pr: jrt.build_state(pr, cfg))(scene)
    img = jrt.render_state(state, camera, cfg, None, spp=1, seed=jnp.int32(0), jitter=False)
    return np.asarray(img).reshape(-1, 3)[sel]


def _rms_max(a, b):
    e = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.sqrt(np.mean(e * e))), float(e.max())


def test_attribution_by_config_matches_jax(root, capsys):
    """The default configurations' PSNRs as the tool reports them, held to
    the JAX package's: in f64 the frames within 1e-5 of each other and the
    PSNRs (both against the port's f64 exact reference) within 1e-4 dB; in
    f32 each frame's RMS and largest deviation from JAX's f64 frame at most
    twice and four times JAX's f32 frame's, and each PSNR at most twice as
    far from the f64 PSNR as JAX's (measured
    0.69x and 0.79x). At 2,000 primitives no budget binds: budget, pool and
    pool-hi give the port's ordering frame (test_torch_diag2m_budget.py
    holds them to JAX where it binds)."""
    res = diag2m.main(["--cpu", "--prims", str(N), "--width", str(WIDTH), *diag2m.DEFAULT,
                       "noise"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    js, jcam = bench.make_scene(N), _jax_camera()
    ts, tcam = synthetic.make_scene(N, device="cpu"), synthetic.headline_camera(WIDTH)
    sel = studies.subsample(WIDTH * WIDTH, diag2m.SUBSAMPLE_SEED)
    idx = torch.from_numpy(sel)
    o, d = generate_rays(tcam, jitter=False, device="cpu")
    exact = diag2m.exact_reference(ts, o[idx], d[idx])
    exact64 = diag2m.exact_reference(_scene64(js), o[idx].double(), d[idx].double()).numpy()
    exact_j = root._exact_ref(js, jcam, sel, cache=None)
    dev_t, dev_j = _rms_max(exact, exact64), _rms_max(exact_j, exact64)
    print(f"exact references from f64 (rms, max): port {dev_t} JAX {dev_j}")
    assert dev_t[0] <= 2 * dev_j[0] and dev_t[1] <= 4 * dev_j[1]
    frames = {}
    for name in diag2m.DEFAULT:
        p = diag2m.CONFIGS[name]
        cfg = diag2m.config(p)
        got = trt.render_state(trt.build_state(ts, cfg), tcam, cfg, None, spp=1, seed=0,
                               jitter=False).reshape(-1, 3)[idx]
        assert res["configs"][name]["psnr_db"] == pytest.approx(studies.psnr(got, exact),
                                                                abs=1e-9)
        frames[name] = got
        if name not in ("ceiling", "ordering"):
            torch.testing.assert_close(got, frames["ordering"], rtol=0, atol=0)
            continue
        want = _jax_frame(js, jcam, sel, p)
        got64 = _render64(_scene64(js), tcam, cfg).reshape(-1, 3)[idx].numpy()
        want64 = jax_render64(js, jcam, _jax_kw(p)).reshape(-1, 3)[sel]
        np.testing.assert_allclose(got64, want64, rtol=0, atol=FRAME_TOL)
        psnr64 = root._psnr(want64, exact64)
        assert abs(root._psnr(got64, exact64) - psnr64) <= 1e-4, name
        d_t, d_j = _rms_max(got, want64), _rms_max(want, want64)
        psnr_t, psnr_j = studies.psnr(got, exact), root._psnr(want, exact_j)
        print(f"{name}: f64 {psnr64:.5f} dB; port {psnr_t:.5f}, JAX {psnr_j:.5f} dB; "
              f"frames from f64 (rms, max) port {d_t} JAX {d_j}")
        assert d_t[0] <= 2 * d_j[0] and d_t[1] <= 4 * d_j[1], name
        assert abs(psnr_t - psnr64) <= 2 * abs(psnr_j - psnr64), name
    psnr = {k: v["psnr_db"] for k, v in res["configs"].items()}
    assert psnr["ceiling"] > psnr["ordering"] + 1.0  # the resort's gain shows
    # the exact render sorts each ray's hits: on the CPU the primitives'
    # order leaves it unchanged (the MSE floor's 120 dB; the root script
    # records 101 dB at 2M)
    assert res["noise"]["psnr_db"] >= 100.0


def _jax_hits(js, o, d):
    """The root script's per-pair hit test in the JAX package, [R, N]."""
    a, b, c0 = jquadric.pair_coeffs(jnp.asarray(o.numpy())[:, None, :],
                                    jnp.asarray(d.numpy())[:, None, :], js.centers[None],
                                    js.scales[None], js.quats[None])
    return np.asarray(((c0 - b * b / a) < float(js.extent) ** 2) & (-b / a > 0))


def test_hit_counts_match_jax():
    """count_hits against the root script's test with the JAX package's
    pair_coeffs over one chunk: the rays whose counts differ (3 of 1,024
    here, by one hit) differ only on grazing pairs, whose f64 q minimum
    lies within 8 f32 ulps of c (the term that cancels) of extent^2."""
    scene = synthetic.make_scene(N, device="cpu")
    o, d = generate_rays(synthetic.headline_camera(WIDTH), jitter=False, device="cpu")
    sel = torch.from_numpy(studies.subsample(WIDTH * WIDTH, diag2m.SUBSAMPLE_SEED))
    o, d = o[sel], d[sel]
    js = bench.make_scene(N)
    got = diag2m.count_hits(scene, o, d, chunk=512).numpy()
    want = _jax_hits(js, o, d).sum(axis=1)
    rays = np.nonzero(got != want)[0]
    print("rays whose hit count differs:", rays.size)
    assert want.max() > 5 and rays.size <= 0.01 * o.shape[0]
    r = torch.from_numpy(rays)
    c = quadric.pair_coeffs(o[r].double()[:, None], d[r].double()[:, None],
                            scene.centers.double()[None], scene.scales.double()[None],
                            scene.quats.double()[None])
    q64 = (c.c - c.b * c.b / c.a).numpy()
    t = quadric.pair_coeffs(o[r][:, None], d[r][:, None], scene.centers[None],
                            scene.scales[None], scene.quats[None])
    hit_t = (((t.c - t.b * t.b / t.a) < 9.0) & (-t.b / t.a > 0)).numpy()
    assert (hit_t.sum(axis=1) == got[rays]).all()
    ri, pi = np.nonzero(hit_t != _jax_hits(js, o[r], d[r]))
    grazing = np.abs(q64[ri, pi] - 9.0) <= 8 * np.finfo(np.float32).eps * c.c.numpy()[ri, pi]
    assert ri.size > 0 and grazing.all(), (q64[ri, pi], c.c.numpy()[ri, pi])


def test_entry_point_prints_lines_and_json():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "volprim_tpu_torch.tools.diag2m", "--cpu", "--prims", "512",
         "--width", "16", "budget", "pool", "hits"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    res = json.loads(lines[-1])
    assert res["tool"] == "diag2m" and res["card"] == "cpu" and res["rays"] == 256
    assert list(res["configs"]) == ["budget", "pool"] and "hits" in res
    assert res["exact"]["max_depth"] == 512 and res["exact"]["seconds"] > 0
    for name in ("budget", "pool"):
        assert np.isfinite(res["configs"][name]["psnr_db"])
        assert any(line.startswith(f"{name:9s} gc=") for line in lines), name
    assert any(line.startswith("hits: p50=") for line in lines)
    assert lines[0].startswith("exact reference: 256 rays at max_depth 512")


def test_unknown_config_exits():
    with pytest.raises(SystemExit, match="unknown configurations"):
        diag2m.main(["--cpu", "nosuch"])
