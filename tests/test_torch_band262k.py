"""The port's 262k budget x ordering probe (volprim_tpu_torch.tools.band262k)
against the root tools/band262k.py, on the CPU at a small size.

The root script is imported (it pins JAX to the CPU, as the tests do) for
its configurations and constants; its camera, subsample and per-
configuration frame run inline in its ``main`` and are restated below.

- The port's CONFIGS, N, MD, camera, subsample and tiled configurations are
  the root script's (the configurations field for field, the TPU's
  ``kernel_batch`` and ``feat_major`` aside: ROADMAP.md §D).
- One configuration per mechanism (truncation, the cluster-entry resort,
  the band at 8 and at 16 on larger budgets) on bench's scene of 16,384
  primitives at 64 x 64, where 2,048 candidates truncate
  (test_torch_diag2m_budget.py): in f64 the port's xla frame within
  FRAME_TOL (1e-5) of JAX's on the f32 frame's shortlists and its PSNR
  against the exact reference within 1e-4 dB of JAX's; in f32 the port's
  RMS and largest deviation from JAX's f64 frame at most twice and four
  times JAX's f32 frame's, and its PSNR at most twice as far from the f64
  frame's as JAX's (tests/test_torch_diag2m.py's rules, ROADMAP.md §D).
- The entry point runs with ``--cpu`` at a small size, in a subprocess,
  and prints the root script's row per configuration and a JSON line.
"""

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from volprim_tpu import scene as jscene
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch.models import rf_tiled as trt
from volprim_tpu_torch.scene import generate_rays, synthetic
from volprim_tpu_torch.tools import analyze_rf, band262k, studies

from test_torch_diag2m import _rms_max
from test_torch_rf_tiled_xla import FRAME_TOL, _render64, _scene64, jax_render64

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tools", "band262k.py")
N, WIDTH = 16384, 64
MECHANISMS = ("mc2048", "mc2048-csort", "mc4096-csort-band8", "mc8192-csort-band16")


@pytest.fixture(scope="module")
def root():
    spec = importlib.util.spec_from_file_location("root_band262k", SOURCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_camera(width):
    """The root script's camera (tools/band262k.py:90-94) at ``width``."""
    return jscene.CameraSpecs(
        name="bench", width=width, height=width,
        to_world=jscene.look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]), fov=50.0)


def _jax_kw(p):
    """The root script's RFTiledConfig arguments (tools/band262k.py:117-123)."""
    return dict(
        max_depth=band262k.MD, tile_pixels=256, max_candidates=p["mc"],
        segment=min(256, p["mc"]), cluster_size=16, backend="xla",
        coarse_group=p["gc"], coarse_factor=8, super_group=4,
        refine_fraction=0.0, prim_resort=p["resort"],
        srgb_primitives=True, order_band=p.get("band", 0),
    )


def assert_config_is_roots(port_cfg, jax_cfg):
    """Every field of the port's configuration equals JAX's; JAX's fields
    without a counterpart are the TPU's layout knobs alone."""
    port = {f.name for f in dataclasses.fields(port_cfg)}
    assert {f.name for f in dataclasses.fields(jax_cfg)} - port <= {"kernel_batch",
                                                                     "feat_major"}
    for name in port:
        assert getattr(port_cfg, name) == getattr(jax_cfg, name), name


def test_protocol_is_the_root_scripts(root):
    assert band262k.CONFIGS == root.CONFIGS
    assert (band262k.N, band262k.MD) == (root.N, root.MD)
    src = open(SOURCE).read()
    assert "rng = np.random.default_rng(42)" in src
    assert "sel = rng.choice(512 * 512, size=4096, replace=False)" in src
    assert re.search(r"look_at\(\[0, 0\.4, -3\.2\], \[0, 0, 0\], \[0, 1, 0\]\),\s*fov=50\.0",
                     src)
    rng = np.random.default_rng(42)
    np.testing.assert_array_equal(studies.subsample(512 * 512, band262k.SUBSAMPLE_SEED),
                                  rng.choice(512 * 512, size=4096, replace=False))
    cam, jcam = synthetic.headline_camera(512), _jax_camera(512)
    np.testing.assert_array_equal(cam.to_world, jcam.to_world)
    assert (cam.width, cam.height, cam.fov) == (jcam.width, jcam.height, jcam.fov)
    for p in band262k.CONFIGS.values():
        assert_config_is_roots(band262k.config(p), jrt.RFTiledConfig(**_jax_kw(p)))


@pytest.fixture(scope="module")
def study():
    """Both packages' scenes and cameras, the subsample (the whole film)
    and the port's exact reference on it (analyze_rf's, max_depth 128)."""
    ts, tcam = synthetic.make_scene(N, device="cpu"), synthetic.headline_camera(WIDTH)
    sel = studies.subsample(WIDTH * WIDTH, band262k.SUBSAMPLE_SEED)
    idx = torch.from_numpy(sel)
    o, d = generate_rays(tcam, jitter=False, device="cpu")
    exact = analyze_rf.exact_reference(ts, o[idx], d[idx], chunk=1024)
    return dict(ts=ts, tcam=tcam, js=bench.make_scene(N), jcam=_jax_camera(WIDTH), sel=sel,
                idx=idx, exact=exact, frames={})


def _port_frame(study, name):
    """The port's f32 xla frame of a configuration [H W, 3], made once."""
    if name not in study["frames"]:
        cfg = band262k.config(band262k.CONFIGS[name])
        study["frames"][name] = trt.render_state(trt.build_state(study["ts"], cfg),
                                                 study["tcam"], cfg, None, spp=1, seed=0,
                                                 jitter=False).reshape(-1, 3)
    return study["frames"][name]


@pytest.mark.parametrize("name", MECHANISMS)
def test_frame_matches_jax(study, name):
    import jax
    import jax.numpy as jnp

    p = band262k.CONFIGS[name]
    cfg = band262k.config(p)
    idx, sel, exact = study["idx"], study["sel"], study["exact"]
    got = _port_frame(study, name)[idx]
    jcfg = jrt.RFTiledConfig(**_jax_kw(p))
    jstate = jax.jit(lambda pr: jrt.build_state(pr, jcfg))(study["js"])
    want = np.asarray(jrt.render_state(jstate, study["jcam"], jcfg, None, spp=1,
                                       seed=jnp.int32(0), jitter=False)).reshape(-1, 3)[sel]
    got64 = _render64(_scene64(study["js"]), study["tcam"], cfg).reshape(-1, 3)[idx]
    want64 = jax_render64(study["js"], study["jcam"], _jax_kw(p)).reshape(-1, 3)[sel]
    np.testing.assert_allclose(got64.numpy(), want64, rtol=0, atol=FRAME_TOL)
    psnr64 = studies.psnr(torch.from_numpy(want64), exact)
    assert abs(studies.psnr(got64, exact) - psnr64) <= 1e-4
    d_t, d_j = _rms_max(got, want64), _rms_max(want, want64)
    psnr_t = studies.psnr(got, exact)
    psnr_j = studies.psnr(torch.from_numpy(want), exact)
    print(f"{name}: f64 {psnr64:.5f} dB; port {psnr_t:.5f}, JAX {psnr_j:.5f} dB; "
          f"frames from f64 (rms, max) port {d_t} JAX {d_j}")
    assert d_t[0] <= 2 * d_j[0] and d_t[1] <= 4 * d_j[1]
    assert abs(psnr_t - psnr64) <= 2 * abs(psnr_j - psnr64)


def test_budget_truncates_and_band_orders(study):
    """The study's mechanisms show at this size: 2,048 candidates lose to
    8,192, and the band moves the frame."""
    frames = {name: _port_frame(study, name)
              for name in ("mc2048", "mc8192-csort-band8", "mc8192-csort-band16")}
    psnr = {k: studies.psnr(v[study["idx"]], study["exact"]) for k, v in frames.items()}
    print(psnr)
    assert psnr["mc8192-csort-band16"] > psnr["mc2048"] + 3.0
    assert not torch.equal(frames["mc8192-csort-band8"], frames["mc8192-csort-band16"])


def test_entry_point_prints_lines_and_json():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    names = ["mc2048", "mc4096-csort-band16"]
    proc = subprocess.run(
        [sys.executable, "-m", "volprim_tpu_torch.tools.band262k", "--cpu", "--prims", "2048",
         "--width", "32", *names],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    res = json.loads(lines[-1])
    assert res["tool"] == "band262k" and res["card"] == "cpu" and res["rays"] == 1024
    assert list(res["configs"]) == names
    assert res["exact"]["max_depth"] == 128 and res["exact"]["seconds"] > 0
    assert lines[0].startswith("exact reference: 1024 rays at max_depth 128")
    for name in names:
        p = band262k.CONFIGS[name]
        row = res["configs"][name]
        assert np.isfinite(row["psnr_db"]) and row["band"] == p.get("band", 0)
        assert any(line.startswith(f"{name:22s} gc=4 mc={p['mc']} resort={p['resort']} "
                                   f"band={p.get('band', 0)}: PSNR ") for line in lines), name


def test_unknown_config_exits():
    with pytest.raises(SystemExit, match="unknown configurations"):
        band262k.main(["--cpu", "nosuch"])
