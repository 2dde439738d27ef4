"""The port's truck-scale refine study and its bound probe
(volprim_tpu_torch.tools.refine_truck, truck_bound) against the root
tools/refine_truck.py and tools/truck_bound.py, on the CPU at small sizes.

Both root scripts run at import, so their protocols are restated below in
the JAX package, as tests/test_torch_convergence_eval.py restates its
script's:

- The ring cameras (training, held-out, and truck_bound's) agree with the
  root scripts' within one f64 ulp, and the exact, tiled-evaluation and
  bound configurations are the root scripts' field for field (the TPU's
  ``kernel_batch`` and ``feat_major`` aside: ROADMAP.md §D).
- The mild and the strong perturbation of the same scene arrays are the
  root script's bits.
- The block-streamed exact image equals one unblocked ``rf.radiance`` call
  on the same rays, within 4 f32 ulps (the CPU's vectorised ops take their
  scalar path on a block's tail). On shared jittered pixel coordinates the
  port's exact radiance meets JAX's ``rf.radiance`` by
  test_torch_diag2m.py's rules: its RMS and largest deviation from the
  port's f64 run (the yardstick where q = c - b^2/a cancels) at most twice
  and four times JAX's (measured 1.6x and 1.45x: 2.7e-4 and 4.6e-3 against
  1.7e-4 and 3.2e-3); the rays on which the two packages differ by more
  than 1e-3 are counted and printed (20 of 1,024 measured, with f32 hit
  counts off f64's on 11 rays: grazing pairs and cancelling q; on them
  both packages stray from f64, the port by 2.3x JAX's RMS; ROADMAP.md
  §D).
- The ground-truth cache takes a view of the run's shape and renders one
  of another shape anew; the resume check reads the splat count.
- ``--tiny`` sets the root script's sizes. A run with ``--cpu`` as a
  subprocess (at half --tiny's width, a sixteenth of its rays: 2,048
  splats, 32^2, 1 spp, 8 steps, 3 + 1 cameras) writes
  ``<workdir>/REFINE_TRUCK.json`` keyed by its perturbation with the root
  block's field names, its loss falls, and the repo's REFINE_TRUCK.json is
  left as it was.
- truck_bound's xla frame at both budgets, in f64 within FRAME_TOL of
  JAX's in f64 and in f32 by the rules above, and the tool as a subprocess
  on held-out views written by refine_truck's ground-truth function:
  ``bound_mc2048_db`` and ``bound_mc8192_db``.
"""

import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from volprim_tpu import scene as jscene
from volprim_tpu.scene import cameras as jcameras
from volprim_tpu.models import rf as jrf
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch.models import rf, rf_tiled as trt
from volprim_tpu_torch.scene import rays_from_pixels, save_asset, synthetic
from volprim_tpu_torch.scene.cameras import film_coords
from volprim_tpu_torch.tools import refine_truck, studies, truck_bound

from test_torch_band262k import assert_config_is_roots
from test_torch_diag2m import _rms_max
from test_torch_rf_tiled_xla import FRAME_TOL, _render64, _scene64, jax_render64

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, RES = 4096, 32
GRAZING_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_ring_cam(name, idx, count, elev, res):
    """tools/refine_truck.py:82-88 (and tools/truck_bound.py:44-50)."""
    ang = 2.0 * np.pi * idx / count
    pos = [3.3 * np.sin(ang), elev, -3.3 * np.cos(ang)]
    return jscene.CameraSpecs(name=name, width=res, height=res,
                              to_world=jscene.look_at(pos, [0, 0, 0], [0, 1, 0]), fov=50.0)


def _root_perturb(op, sh, kind):
    """tools/refine_truck.py:79 and :164-179, verbatim."""
    rng = np.random.default_rng(42)
    if kind == "strong":
        op_p = np.clip(
            op * rng.uniform(0.05, 0.5, op.shape).astype(np.float32),
            1e-4, 0.995,
        )
        sh_p = sh * rng.uniform(0.0, 0.6, sh.shape).astype(np.float32) \
            + rng.normal(0, 0.6, sh.shape).astype(np.float32)
    else:
        op_p = np.clip(
            op * rng.uniform(0.15, 0.9, op.shape).astype(np.float32),
            1e-4, 0.995,
        )
        sh_p = sh * rng.uniform(0.2, 1.0, sh.shape).astype(np.float32) \
            + rng.normal(0, 0.25, sh.shape).astype(np.float32)
    return op_p, sh_p


def _assert_same_cameras(got, want):
    assert [c.name for c in got] == [c.name for c in want]
    for g, w in zip(got, want):
        assert (g.width, g.height, g.fov, g.focal_length) == (w.width, w.height, w.fov,
                                                              w.focal_length)
        np.testing.assert_array_max_ulp(g.to_world, w.to_world, maxulp=1)


@pytest.mark.parametrize("train_cams,test_cams,res", [(8, 2, 256), (3, 1, 64)])
def test_ring_cameras_are_the_root_scripts(train_cams, test_cams, res):
    train, test = refine_truck.cameras(res, train_cams, test_cams)
    _assert_same_cameras(train, [_root_ring_cam(f"train_{i:02d}", i, train_cams, 0.35, res)
                                 for i in range(train_cams)])
    _assert_same_cameras(test, [_root_ring_cam(f"test_{i:02d}", i + 0.5, train_cams, 0.6, res)
                                for i in range(test_cams)])


def test_truck_bound_cameras_are_the_root_scripts_and_refine_trucks_at_8():
    cams = truck_bound.cameras(256)
    _assert_same_cameras(cams, [_root_ring_cam(f"test_{i:02d}", i + 0.5, 8, 0.6, 256)
                                for i in range(2)])
    _assert_same_cameras(cams, refine_truck.cameras(256, 8, 2)[1])


def test_configs_are_the_root_scripts():
    """The exact renderer's (tools/refine_truck.py:101), the tiled
    evaluation's less kernel_batch (:212-217) and truck_bound's (its
    :56-61) at both budgets."""
    assert dataclasses.asdict(refine_truck.exact_config()) == dataclasses.asdict(
        jrf.RFConfig(max_depth=128, kernel_type="gaussian", chunk_size=2048))
    assert_config_is_roots(refine_truck.tiled_config(), jrt.RFTiledConfig(
        max_depth=128, kernel_type="gaussian", tile_pixels=256, max_candidates=2048,
        segment=256, cluster_size=16, backend="fused", early_exit=True, coarse_group=4,
        coarse_factor=8, super_group=4, kernel_batch=4))
    for mc in (2048, 8192):
        assert_config_is_roots(truck_bound.config(mc), jrt.RFTiledConfig(**_bound_kw(mc)))


@pytest.mark.parametrize("kind", ["mild", "strong"])
def test_perturbation_is_bit_equal(kind):
    js, ts = bench.make_scene(N), synthetic.make_scene(N, device="cpu")
    want = _root_perturb(np.asarray(js.attrs["opacities"]), np.asarray(js.attrs["sh_coeffs"]),
                         kind)
    got = refine_truck.perturb(ts.attrs["opacities"].numpy(), ts.attrs["sh_coeffs"].numpy(),
                               kind)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], np.asarray(js.attrs["opacities"]))


@pytest.fixture(scope="module")
def scenes():
    return synthetic.make_scene(N, device="cpu"), bench.make_scene(N)


def test_block_streamed_exact_image_is_one_call(scenes):
    ts, _ = scenes
    cam = refine_truck.cameras(RES, 8, 1)[1][0]
    cfg = refine_truck.exact_config()
    spp, seed = 2, 1000
    got = studies.exact_image(ts, cam, spp, seed, cfg, block=300)
    acc = torch.zeros((RES * RES, 3))
    for s in range(spp):
        gen = torch.Generator().manual_seed(studies.sample_seed(seed, s))
        o, d = rays_from_pixels(cam, *film_coords(cam, gen, jitter=True, device="cpu"))
        acc += rf.radiance(ts, None, o, d, cfg)
    # within 4 f32 ulps: on the CPU a vectorised elementwise op takes its
    # scalar path (another exp / sqrt) on a block's tail
    want = (acc / spp).reshape(RES, RES, 3)
    torch.testing.assert_close(got, want, rtol=4 * 2.0**-23, atol=0)
    # one block of every ray: the same bits
    torch.testing.assert_close(studies.exact_image(ts, cam, spp, seed, cfg), want, rtol=0,
                               atol=0)
    assert float(got.mean()) > 0.01


def test_exact_radiance_meets_jax_on_shared_pixels(scenes):
    ts, js = scenes
    cam = refine_truck.cameras(RES, 8, 1)[1][0]
    jcam = _root_ring_cam(cam.name, 0.5, 8, 0.6, RES)
    gen = torch.Generator().manual_seed(studies.sample_seed(1000, 0))
    px, py = film_coords(cam, gen, jitter=True, device="cpu")
    o, d = rays_from_pixels(cam, px, py)
    cfg = refine_truck.exact_config()
    got = rf.radiance(ts, None, o, d, cfg).numpy()
    yard = rf.radiance(_scene64(js), None, o.double(), d.double(), cfg).numpy()
    jo, jd = jcameras.rays_from_pixels(jcam, jnp.asarray(px.numpy()), jnp.asarray(py.numpy()))
    jcfg = jrf.RFConfig(max_depth=128, kernel_type="gaussian", chunk_size=2048)
    want = np.asarray(jax.jit(lambda o_, d_: jrf.radiance(js, None, o_, d_, jcfg,
                                                          jax.random.PRNGKey(1000)))(jo, jd))
    d_t, d_j = _rms_max(got, yard), _rms_max(want, yard)
    apart = np.abs(got - want).max(axis=1) > GRAZING_ATOL
    print(f"from the port's f64 (rms, max): port {d_t} JAX {d_j}; rays apart by more than "
          f"{GRAZING_ATOL}: {int(apart.sum())} of {apart.size}")
    assert d_t[0] <= 2 * d_j[0] and d_t[1] <= 4 * d_j[1]
    assert float(np.mean(got)) > 0.01


def test_ground_truth_cache_checks_the_shape(tmp_path):
    cams = refine_truck.cameras(16, 2, 1)[0]
    np.save(tmp_path / "train_00.npy", np.zeros((32, 32, 3), np.float32))
    np.save(tmp_path / "train_01.npy", np.ones((16, 16, 3), np.float32))
    calls = []

    def render(cam, i):
        calls.append((cam.name, i))
        return torch.full((16, 16, 3), 0.5)

    gt, secs = refine_truck.ground_truth(cams, str(tmp_path), render)
    assert calls == [("train_00", 0)]
    assert (gt["train_00"] == 0.5).all() and (gt["train_01"] == 1.0).all()
    assert np.load(tmp_path / "train_00.npy").shape == (16, 16, 3)
    assert secs["train_01"] is None and secs["train_00"] >= 0.0


def test_resume_reads_the_splat_count(tmp_path, scenes):
    ts, _ = scenes
    asset = tmp_path / "refined_asset"
    assert not refine_truck._resumable(str(asset), N, "cpu")
    save_asset(str(asset), ts, [])
    assert refine_truck._resumable(str(asset), N, "cpu")
    assert not refine_truck._resumable(str(asset), 2 * N, "cpu")


def _root_block_fields():
    """The field names of the root script's JSON block
    (tools/refine_truck.py:295-311)."""
    src = open(os.path.join(ROOT, "tools", "refine_truck.py")).read()
    body = src[src.index("block = {"):src.index("}", src.index("block = {"))]
    return re.findall(r'^\s*"(\w+)":', body, flags=re.M)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_tiny_run_writes_its_workdir_json(tmp_path):
    src = open(os.path.join(ROOT, "tools", "refine_truck.py")).read()
    assert ("if args.tiny:\n    args.n_splats, args.res, args.iterations = 4096, 64, 8\n"
            "    args.train_cams, args.test_cams, args.spp = 3, 1, 2\n    args.cpu = True\n"
            in src)
    tiny = refine_truck.parse_args(["--tiny"])
    assert (tiny.n_splats, tiny.res, tiny.iterations, tiny.train_cams, tiny.test_cams,
            tiny.spp, tiny.cpu) == (4096, 64, 8, 3, 1, 2, True)
    assert refine_truck.parse_args([]).workdir == os.path.join(tempfile.gettempdir(),
                                                               "refine_truck")
    assert refine_truck.parse_args(["--workdir", "w"]).workdir == "w"
    repo_json = os.path.join(ROOT, "REFINE_TRUCK.json")
    before = _sha(repo_json)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "volprim_tpu_torch.tools.refine_truck", "--cpu", "--n_splats",
         "2048", "--res", "32", "--spp", "1", "--iterations", "8", "--train_cams", "3",
         "--test_cams", "1", "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    res = json.loads(lines[-1])
    fields = _root_block_fields()
    assert len(fields) == 16 and set(fields) <= set(res)
    on_disk = json.load(open(tmp_path / "REFINE_TRUCK.json"))
    assert list(on_disk) == ["mild"]
    assert {k: v for k, v in res.items() if k != "tool"} == on_disk["mild"]
    assert (res["n_splats"], res["res"], res["iterations"], res["train_cams"],
            res["test_cams"], res["spp"], res["device"]) == (2048, 32, 8, 3, 1, 1, "cpu")
    losses = [float(m) for m in re.findall(r"^-- step \d+/8 \| psnr=\S+ \| loss=(\S+)",
                                           proc.stdout, flags=re.M)]
    assert len(losses) == 8 and losses[-1] < losses[0]
    # the CLI prints 6 decimals: half a unit of the last
    assert res["loss_first"] == pytest.approx(losses[0], rel=0, abs=5e-7)
    assert res["loss_last"] == pytest.approx(losses[-1], rel=0, abs=5e-7)
    assert res["heldout_psnr_refined_tiled_db"] > res["heldout_psnr_init_tiled_db"]
    assert res["heldout_psnr_noise_floor_db"] > res["heldout_psnr_init_db"]
    assert sorted(res["seconds"]["gt_views"]) == ["test_00", "train_00", "train_01",
                                                  "train_02"]
    assert len(res["seconds"]["exact_eval_views"]) == 3
    sec = res["seconds"]
    assert len(sec["train_step_seconds"]) == 8 and sec["train_step0"] > 0
    assert sec["train_ms_per_step"] > 0 and sec["train_ms_per_step_mean"] > 0
    assert sec["train_steps"] == pytest.approx(sum(sec["train_step_seconds"]))
    assert sec["kernel_build"] == {} and res["train_peak_gib"] is None
    for tag in ("GT: 2048 splats, 3+1 cams at 32^2, spp 1", "held-out PSNR (initial): ",
                "held-out PSNR tiled (true scene (approx bound)): "):
        assert any(line.startswith(f"[refine_truck] {tag}") for line in lines), tag
    for name in ("init.ply", "cameras.json", "images/test_00.npy",
                 "out/refined_asset/primitives.ply"):
        assert (tmp_path / name).exists(), name
    assert _sha(repo_json) == before


def _bound_kw(mc):
    """tools/truck_bound.py:56-61."""
    return dict(max_depth=128, kernel_type="gaussian", tile_pixels=256, max_candidates=mc,
                segment=256, cluster_size=16, backend="xla", coarse_group=4, coarse_factor=16,
                super_group=4)


@pytest.mark.parametrize("mc", [2048, 8192])
def test_bound_frame_matches_jax(scenes, mc):
    ts, js = scenes
    cam = truck_bound.cameras(RES)[1]
    jcam = _root_ring_cam(cam.name, 1.5, 8, 0.6, RES)
    cfg = truck_bound.config(mc)
    got = trt.render_state(trt.build_state(ts, cfg), cam, cfg, None, spp=1, seed=0,
                           jitter=False).numpy()
    jcfg = jrt.RFTiledConfig(**_bound_kw(mc))
    want = np.asarray(jrt.render_state(jax.jit(lambda p: jrt.build_state(p, jcfg))(js), jcam,
                                       jcfg, None, spp=1, seed=jnp.int32(0), jitter=False))
    got64 = _render64(_scene64(js), cam, cfg).numpy()
    want64 = jax_render64(js, jcam, _bound_kw(mc))
    np.testing.assert_allclose(got64, want64, rtol=0, atol=FRAME_TOL)
    d_t, d_j = _rms_max(got, want64), _rms_max(want, want64)
    print(f"mc{mc}: frames from JAX's f64 (rms, max) port {d_t} JAX {d_j}")
    assert d_t[0] <= 2 * d_j[0] and d_t[1] <= 4 * d_j[1]
    assert float(got.mean()) > 0.01


def test_truck_bound_on_refine_trucks_views(tmp_path, scenes):
    ts, _ = scenes
    cfg = refine_truck.exact_config()
    cams = refine_truck.cameras(RES, 8, 2)[1]
    refine_truck.ground_truth(cams, str(tmp_path),
                              lambda cam, i: studies.exact_image(ts, cam, 1, 1000 + i, cfg))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    argv = [sys.executable, "-m", "volprim_tpu_torch.tools.truck_bound", "--cpu", "--n_splats",
            str(N), "--spp", "1", "--images", str(tmp_path)]
    proc = subprocess.run(argv + ["--res", str(RES)], capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    res = json.loads(lines[-1])
    assert res["tool"] == "truck_bound" and res["card"] == "cpu"
    for mc in (2048, 8192):
        assert np.isfinite(res[f"bound_mc{mc}_db"]) and res[f"bound_mc{mc}_db"] > 10.0
        for i in range(2):
            assert any(line.startswith(f"mc{mc} test_{i:02d}: ") for line in lines)
    wrong = subprocess.run(argv + ["--res", str(2 * RES)], capture_output=True, text=True,
                           timeout=600, env=env, cwd=ROOT)
    assert wrong.returncode != 0 and "pass refine_truck's --res" in wrong.stderr
