"""The port's budget study (volprim_tpu_torch.tools.analyze_rf) against the
root tools/analyze_rf.py, on the CPU at a small size.

The JAX side below is the root script's measurement code at test size, step
for step with the JAX package (its ``main`` runs everything inline, so the
test restates it): bench.make_scene, the headline camera, build_state with
the study's fused configuration (kernel_batch 4, a TPU knob the port has
not), the tile cones from the film's rays, the exact cull against every
cluster, the quarter-tile cones, and the primitive survival inside each
tile's first K_COV clusters (``tiles.shortlist``, which is ``lax.top_k`` in
JAX: exact, as the port's; the JAX package's ``approx_max_k`` is only its
``shortlist_approx``, which the study does not call).

- On the same tile and quarter cones, the per-tile need, the per-quarter
  need and the primitive survival (live and total, per tile and per
  quarter) are equal, count for count.
- On each package's own cones (within 2 f32 ulps of each other) the same
  holds but for a primitive on a quarter's edge (ROADMAP.md §D).
- The per-tile MSE from a subsample that covers the film equals the root
  script's per-tile MSE of the whole image.
- The entry point runs with ``--cpu`` at its smallest size, in a
  subprocess, and its printed lines and JSON line agree with the counts.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from volprim_tpu import scene as jscene
from volprim_tpu.accel import tiles as jtiles
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch.models import rf_tiled as trt
from volprim_tpu_torch.scene import generate_rays, synthetic
from volprim_tpu_torch.tools import analyze_rf, studies

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, WIDTH, TP, MC, CS, K_COV = 16384, 64, 256, 2048, 16, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_setup():
    """The root script's scene, camera, state and film geometry."""
    scene = bench.make_scene(N)
    camera = jscene.CameraSpecs(
        name="bench", width=WIDTH, height=WIDTH,
        to_world=jscene.look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]), fov=50.0)
    cfg = jrt.RFTiledConfig(
        max_depth=128, tile_pixels=TP, max_candidates=MC, segment=min(256, MC),
        cluster_size=CS, backend="fused", early_exit=True, coarse_group=4,
        refine_fraction=0.0, refine_factor=4, kernel_batch=4, coarse_factor=8,
        super_group=4)
    state = jax.jit(lambda p: jrt.build_state(p, cfg))(scene)
    return camera, state


def _jax_cones(camera):
    """The root script's tile and quarter-tile cones: {sub: (axis, cos_half)}."""
    h = w = WIDTH
    th = int(TP ** 0.5)
    while TP % th or h % th:
        th -= 1
    tw = TP // th
    n_ty, n_tx = h // th, w // tw
    n_tiles = n_ty * n_tx

    def dirs(sub):
        _, d = jscene.generate_rays(camera, jitter=False)
        if sub:
            sh_, sw_ = th // 2, tw // 2
            d = d.reshape(n_ty, 2, sh_, n_tx, 2, sw_, 3)
            return d.transpose(0, 3, 1, 4, 2, 5, 6).reshape(n_tiles * 4, sh_ * sw_, 3)
        d = d.reshape(n_ty, th, n_tx, tw, 3).transpose(0, 2, 1, 3, 4)
        return d.reshape(n_tiles, TP, 3)

    def cone(d):
        ax = d.mean(axis=1)
        axis = ax / jnp.linalg.norm(ax, axis=-1, keepdims=True)
        return axis, jnp.min(jnp.einsum("tri,ti->tr", d, axis), axis=1)

    return {sub: jax.jit(lambda sub=sub: cone(dirs(sub)))() for sub in (False, True)}


def _jax_counts(camera, state, cones):
    """The root script's n_fin, n_fin_sub and primitive survival on the
    cones ``cones`` ({sub: (axis, cos_half)})."""
    origin = jnp.asarray(camera.to_world[:3, 3], jnp.float32)

    def counts(sub):
        keys = jtiles.cone_cull_keys_batch(origin, *cones[sub], state.cull_centers,
                                           state.cull_radii)
        return jnp.sum(jnp.isfinite(keys), axis=-1)

    prim_r = float(state.prims.extent) * jnp.max(state.prims.scales, axis=-1)

    def prim_survival(sub):
        axis, cos_half = cones[sub]
        keys = jtiles.cone_cull_keys_batch(origin, *cones[False], state.cull_centers,
                                           state.cull_radii)
        cl_ids, cl_valid = jtiles.shortlist(keys, K_COV)
        if sub:
            cl_ids = jnp.repeat(cl_ids, 4, axis=0)
            cl_valid = jnp.repeat(cl_valid, 4, axis=0)
        cs = state.cluster_size
        pids = (cl_ids[..., None] * cs + jnp.arange(cs, dtype=cl_ids.dtype)).reshape(
            cl_ids.shape[0], K_COV * cs)
        pval = jnp.repeat(cl_valid, cs, axis=-1)
        c = state.prims.centers
        pr = jnp.where(pval, prim_r[pids], -1.0)
        pkeys = jtiles.cone_cull_keys_cols(origin, axis, cos_half, c[:, 0][pids],
                                           c[:, 1][pids], c[:, 2][pids], pr)
        return jnp.sum(jnp.isfinite(pkeys), axis=-1), jnp.sum(pval, axis=-1)

    out = dict(n_fin=jax.jit(lambda: counts(False))(), n_fin_sub=jax.jit(lambda: counts(True))())
    out["live_t"], out["tot_t"] = jax.jit(lambda: prim_survival(False))()
    out["live_s"], out["tot_s"] = jax.jit(lambda: prim_survival(True))()
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port():
    """The port's state, origin, film directions and cones ({sub: (axis,
    cos_half)})."""
    scene = synthetic.make_scene(N, device="cpu")
    camera = synthetic.headline_camera(WIDTH)
    state = trt.build_state(scene, analyze_rf.config(MC, TP, CS))
    origin = torch.as_tensor(camera.to_world[:3, 3], dtype=torch.float32)
    _, d = generate_rays(camera, jitter=False, device="cpu")
    cones = {sub: analyze_rf.cones(analyze_rf.tile_rays(d, WIDTH, WIDTH, TP, sub))
             for sub in (False, True)}
    return state, origin, d, cones


def _port_counts(port):
    state, origin, d, cones = port
    out = {"n_fin": analyze_rf.need(state, origin, *cones[False]),
           "n_fin_sub": analyze_rf.need(state, origin, *cones[True])}
    for tag, sub in (("t", False), ("s", True)):
        out[f"live_{tag}"], out[f"tot_{tag}"] = analyze_rf.prim_survival(
            state, origin, d, WIDTH, WIDTH, TP, sub, k_cov=K_COV)
    return {k: v.numpy() for k, v in out.items()}


def test_need_and_survival_counts_equal_jax(jax_setup, port):
    """On the same cones the two packages' counts are equal, count for
    count."""
    cones = {sub: tuple(jnp.asarray(x.numpy()) for x in c) for sub, c in port[3].items()}
    want, got = _jax_counts(*jax_setup, cones), _port_counts(port)
    n_tiles = (WIDTH // 16) ** 2
    assert got["n_fin"].shape == (n_tiles,) and got["live_s"].shape == (4 * n_tiles,)
    # the study is not trivial here: tiles over budget, clusters cut at K_COV
    assert (got["n_fin"] > MC // CS).any() and (got["n_fin"] > K_COV).any()
    assert (got["live_t"] < got["tot_t"]).all() and (got["live_s"] > 0).any()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_counts_on_each_packages_own_cones(jax_setup, port):
    """Each package's own cones from its own rays: the directions differ by
    an f32 ulp and the cones' means and products are summed in another
    order, so the cones lie within 2 ulps (2.4e-7) of each other. The
    cluster counts stay equal; a primitive whose sphere lies within that of
    a quarter tile's edge may count in one package only: measured one
    primitive of 591 in one of the 64 quarters; at most one primitive in at
    most two quarters is allowed, every other count equal."""
    jc = _jax_cones(jax_setup[0])
    for sub in (False, True):
        for a, b in zip(port[3][sub], jc[sub]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2.4e-7)
    want, got = _jax_counts(*jax_setup, jc), _port_counts(port)
    for k in ("n_fin", "n_fin_sub", "tot_t", "tot_s", "live_t"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    diff = np.abs(got["live_s"] - want["live_s"])
    print("quarters whose live count differs:", np.nonzero(diff)[0], diff[diff > 0])
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 2


def test_tile_mse_of_a_covering_subsample_is_the_whole_images():
    """tile_mse on a subsample that holds every pixel once, in a random
    order, equals the root script's per_tile_mse of the whole image."""
    h = w = 64
    th, tw, n_ty, n_tx = analyze_rf.tile_grid(h, w, TP)
    rng = np.random.default_rng(5)
    img, exact = rng.random((h * w, 3)), rng.random((h * w, 3))
    sel = studies.subsample(h * w, analyze_rf.SUBSAMPLE_SEED)
    assert sorted(sel) == list(range(h * w))
    got = analyze_rf.tile_mse((img[sel] - exact[sel]) ** 2, sel, h, w, TP)
    e = ((img - exact) ** 2).reshape(n_ty, th, n_tx, tw, 3).transpose(0, 2, 1, 3, 4)
    np.testing.assert_allclose(got, e.reshape(n_ty * n_tx, -1).mean(axis=1), rtol=1e-12)
    # a tile without subsample pixels has no error
    assert analyze_rf.tile_mse(np.ones((1, 3)), np.array([0]), h, w, TP)[1:].sum() == 0


def test_entry_point_prints_lines_and_json(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    save = tmp_path / "need.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "volprim_tpu_torch.tools.analyze_rf", "--cpu", "--prims",
         "4096", "--width", "32", "--save", str(save)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    res = json.loads(lines[-1])
    assert res["tool"] == "analyze_rf" and res["card"] == "cpu" and res["prims"] == 4096
    arrays = np.load(save)
    assert res["need"]["sum"] == int(arrays["n_fin"].sum())
    assert res["need"]["max"] == int(arrays["n_fin"].max())
    assert res["exact"]["pixels"] == 32 * 32 and res["exact"]["max_depth"] == 128
    q = res["quality"]
    assert set(q["psnr_db"]) == set(q["frame_ms"]) == {"2048", "8192"}
    assert all(np.isfinite(v) for v in q["psnr_db"].values())
    assert list(q["top_tiles_share"]) == ["0.05", "0.125", "0.25", "0.5"]
    for start in ("n_finite clusters/tile (k_cl budget 128):", "subtile(8x8) survival",
                  "prim-in-cluster survival:", "exact reference:", "top 5% tiles hold",
                  "PSNR vs exact: mc2048", "signal n_finite:", "signal n_fin_over_budget:"):
        assert any(line.startswith(start) for line in lines), start
