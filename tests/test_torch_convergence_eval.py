"""The port's convergence study (volprim_tpu_torch.tools.convergence_eval)
against the root tools/convergence_eval.py, on the CPU at a small size.

The JAX side below is the root script's protocol at test size, step for
step with the JAX package (its ``main`` runs everything inline, so the test
restates it): the numpy-seeded scene, the six ring cameras, the exact
references (rf.RFConfig(max_depth=64), jitted per camera), the
perturbation, BoundedAdam at lr 5e-3 with bounded opacities, one jitted
value_and_grad step per camera, and the exact-scored PSNR on the held-out
camera. 300 primitives, 32 x 32 films, 3 steps.

- The ground truth and the perturbation are the same bits (the quaternions
  within one f32 ulp: their trigonometry is computed in each package).
- After 3 steps, for each backend of the tiled training (the root script's
  ``xla`` and the port's ``fused``, against JAX's fused backend in Pallas
  interpret mode): the losses within rtol 1e-3, the tolerance of
  tests/test_torch_train.py::test_train_steps_match_jax_loop; each PSNR
  (the initial scene, the tiled-trained and the exact-trained) within the
  same 1e-3 of its MSE, that is within 10 log10(1.001) = 4.3e-3 dB. The
  largest difference measured was 5.8e-4 dB (the exact-trained scene).
  The f32 references themselves differ by up to 3.4e-3 on one pixel: a ray
  grazing one primitive's extent ellipsoid is counted by one package and
  not the other, as q = c - b^2/a rounds; JAX's rf.radiance does not trace
  under jax_enable_x64 (ROADMAP.md §D), so the scores are held in f32.
- The entry point runs with ``--cpu`` at its smallest size, in a
  subprocess, and prints the root script's lines and a JSON line.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import optim as joptim
from volprim_tpu import scene as jscene
from volprim_tpu.models import rf as jrf
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch.tools import convergence_eval as ce

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, RES, ITERS = 300, 32, 3
RTOL = 1e-3
PSNR_TOL = 10.0 * math.log10(1.0 + RTOL)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_study():
    """The root script's set-up in the JAX package: (ground truth, cameras,
    jitted exact renders, train references, test reference, initial
    parameters)."""
    rng = np.random.default_rng(0)
    f = jscene.EllipsoidsFactory()
    for _ in range(N):
        p = rng.normal(size=3)
        p /= np.linalg.norm(p)
        f.add(mean=p * rng.uniform(0.9, 1.1), scale=rng.uniform(0.03, 0.1, size=3),
              euler_deg=rng.uniform(-90, 90, size=3), opacities=rng.uniform(0.3, 0.95),
              sh_coeffs=rng.normal(size=3).astype(np.float32) * 0.4)
    gt = f.build()
    cams = [jscene.CameraSpecs(
        name=f"c{i}", width=RES, height=RES,
        to_world=jscene.look_at([3.5 * np.sin(th), 0.3, -3.5 * np.cos(th)], [0, 0, 0],
                                [0, 1, 0]), fov=45.0)
        for i, th in enumerate(np.linspace(0, 2 * np.pi, 6, endpoint=False))]
    ecfg = jrf.RFConfig(**ce.EXACT)

    def render_exact(prims, cam):
        o, d = jscene.generate_rays(cam, jitter=False)
        return jrf.radiance(prims, None, o, d, ecfg, jax.random.PRNGKey(0)).reshape(RES, RES, 3)

    jexact = [jax.jit(lambda p_, c=c: render_exact(p_, c)) for c in cams]
    refs = [np.asarray(jexact[i](gt)) for i in range(5)]
    ref_test = np.asarray(jexact[5](gt))
    init = {
        "opacities": jnp.clip(gt.attrs["opacities"] + jnp.asarray(
            rng.normal(0, 0.25, (N, 1)).astype(np.float32)), 1e-3, 1.0 - 1e-3),
        "sh_coeffs": gt.attrs["sh_coeffs"] + jnp.asarray(
            rng.normal(0, 0.3, (N, 3)).astype(np.float32)),
        "centers": gt.centers + jnp.asarray(rng.normal(0, 0.01, (N, 3)).astype(np.float32)),
    }
    return dict(gt=gt, cams=cams, render_exact=render_exact, jexact=jexact, refs=refs,
                ref_test=ref_test, init=init)


def _jax_scene(js, p):
    gt = js["gt"]
    return jscene.EllipsoidScene(
        centers=p["centers"], scales=gt.scales, quats=gt.quats,
        attrs={"opacities": p["opacities"], "sh_coeffs": p["sh_coeffs"]}, extent=gt.extent)


def _jax_psnr(js, p):
    img = np.asarray(js["jexact"][5](_jax_scene(js, p)))
    return -10 * np.log10(max(np.mean((img - js["ref_test"]) ** 2), 1e-12))


def _jax_train(js, renderer, backend):
    """The root script's train(): (params, losses) after ITERS steps."""
    tcfg = jrt.RFTiledConfig(backend=backend, **ce.TILED)
    opt = joptim.BoundedAdam(lr=5e-3)
    opt.set_bounds("opacities", lower=1e-4, upper=1.0 - 1e-4)
    params = dict(js["init"])
    state = opt.init(params)

    def loss_fn(p, ci):
        prims = _jax_scene(js, p)
        if renderer == "exact":
            img = js["render_exact"](prims, js["cams"][ci])
        else:
            st = jrt.build_state(prims, tcfg)
            img = jrt.render_state(st, js["cams"][ci], tcfg, None, spp=1, seed=0,
                                   jitter=False)
        return joptim.l1(jnp.asarray(js["refs"][ci]), img)

    def step(p, s, ci):
        loss, grads = jax.value_and_grad(loss_fn)(p, ci)
        p, s = opt.step(p, grads, s)
        return p, s, loss

    steps = [jax.jit(lambda p, s, ci=ci: step(p, s, ci)) for ci in range(5)]
    losses = []
    for it in range(ITERS):
        params, state, loss = steps[it % 5](params, state)
        losses.append(float(loss))
    return params, losses


@pytest.fixture(scope="module")
def jax_exact_trained(jax_study):
    params, losses = _jax_train(jax_study, "exact", "xla")
    return _jax_psnr(jax_study, params), losses


def test_scene_and_perturbation_match_jax(jax_study):
    rng = np.random.default_rng(0)
    gt = ce.ground_truth(N, rng, "cpu")
    init = ce.perturb(gt, rng)
    jgt = jax_study["gt"]
    for k in ("centers", "scales"):
        np.testing.assert_array_equal(getattr(gt, k).numpy(), np.asarray(getattr(jgt, k)))
    np.testing.assert_allclose(gt.quats.numpy(), np.asarray(jgt.quats), rtol=0, atol=2.4e-7)
    for k in ("opacities", "sh_coeffs"):
        np.testing.assert_array_equal(gt.attrs[k].numpy(), np.asarray(jgt.attrs[k]))
    for k, v in jax_study["init"].items():
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(v), err_msg=k)
    for cam_t, cam_j in zip(ce.cameras(RES), jax_study["cams"]):
        np.testing.assert_array_equal(np.asarray(cam_t.to_world), np.asarray(cam_j.to_world))


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_psnr_after_three_steps_matches_jax(jax_study, jax_exact_trained, backend, capsys):
    res = ce.main(["--cpu", "--prims", str(N), "--res", str(RES), "--iters", str(ITERS),
                   "--backend", backend])
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[-1]) == res
    p_tiled, loss_tiled = _jax_train(jax_study, "tiled", backend)
    psnr_exact, loss_exact = jax_exact_trained
    want = dict(psnr_init=_jax_psnr(jax_study, jax_study["init"]),
                psnr_tiled=_jax_psnr(jax_study, p_tiled), psnr_exact=psnr_exact)
    print(backend, {k: (res[k], float(v)) for k, v in want.items()})
    for k, v in want.items():
        assert abs(res[k] - float(v)) <= PSNR_TOL, (k, res[k], v)
    for renderer, losses in (("tiled", loss_tiled), ("exact", loss_exact)):
        ends = res["loss"][renderer]
        np.testing.assert_allclose(ends["last"], losses[-1], rtol=RTOL)
        np.testing.assert_allclose(ends["start"], np.mean(losses[:5]), rtol=RTOL)
    assert res["launches_fwd"] == res["launches_bwd"] == 0  # plain versions on the CPU
    assert set(res["ms_per_step"]) == {"tiled", "exact"}


def test_entry_point_prints_lines_and_json():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "volprim_tpu_torch.tools.convergence_eval", "--cpu", "--prims",
         "64", "--res", "16", "--iters", "2", "--backend", "fused", "--band"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    res = json.loads(lines[-1])
    assert res["tool"] == "convergence_eval" and res["backend"] == "fused"
    assert res["card"] == "cpu" and res["iters"] == 2
    for k in ("psnr_init", "psnr_tiled", "psnr_band", "psnr_exact", "delta_tiled",
              "delta_band"):
        assert np.isfinite(res[k]), k
    assert set(res["loss"]) == set(res["ms_per_step"]) == {"tiled", "band", "exact"}
    for label in ("init held-out PSNR (exact render):", "tiled-trained, exact-evaluated:",
                  "band-trained (csort+band16), exact-evaluated:",
                  "exact-trained, exact-evaluated:", "delta (tiled-trained - exact-trained):",
                  "delta (band-trained - exact-trained):"):
        assert any(line.startswith(label) for line in lines), label
    assert any(line.startswith("  [tiled] iter 0 loss ") for line in lines)
    assert any("ms a step (cpu)" in line for line in lines)


def test_without_a_card_it_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        ce.main(["--iters", "1"])
