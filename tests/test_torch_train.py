"""The port's training slice against the JAX package: gradients of the L1
loss through the tiled renderer, BoundedAdam, and a few steps of the
refine loop.

The configuration is bench.py's train step at test size: the fused
backend with the two-level cull and kernel compaction, no budget classes
(one compositor launch), on a 6400-primitive shell seen at 64x64 with
64-pixel tiles, 256 candidates and 128-column segments. Jitter is off
(the port draws its offsets from torch's Philox, not jax.random).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import optim as joptim
from volprim_tpu import scene as jscene
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch import interop, optim, train
from volprim_tpu_torch import scene as tscene
from volprim_tpu_torch.models import rf_tiled as trt

from test_rf_tiled import surface_scene
from test_torch_rf_tiled import _cameras, _port_scene

TRAIN_AT_TEST_SIZE = dict(
    max_depth=128, tile_pixels=64, max_candidates=256, segment=128,
    cluster_size=16, backend="fused", early_exit=True,
    coarse_group=4, coarse_factor=8, super_group=4, kernel_compact=True,
)
KEYS = ("centers", "scales", "quats", "opacities", "sh_coeffs")


def _jax_scene(s, p):
    return jscene.EllipsoidScene(
        centers=p.get("centers", s.centers), scales=p.get("scales", s.scales),
        quats=p.get("quats", s.quats),
        attrs={**s.attrs, "opacities": p["opacities"], "sh_coeffs": p["sh_coeffs"]},
        extent=s.extent,
    )


def test_gradients_match_jax():
    """jax.value_and_grad of the L1 loss (against a zero image) against
    loss.backward() in the port, for all five parameters, each normalised
    by the largest JAX gradient: atol 1e-4 for the geometry and opacities
    (the same algorithm; the compositor's adjoints are f32-conditioned, see
    test_torch_composite3_bwd) and 1e-2 for sh_coeffs (their gradient is
    bf16: the compositor writes it in bf16 and the cluster gather sums it
    per primitive in bf16, in another order in each package)."""
    s = surface_scene(6400, seed=3)
    cam_j, cam_t = _cameras(64, 64)
    jcfg = jrt.RFTiledConfig(**TRAIN_AT_TEST_SIZE)
    tcfg = trt.RFTiledConfig(**TRAIN_AT_TEST_SIZE)

    def loss_j(p):
        st = jrt.build_state(_jax_scene(s, p), jcfg)
        img = jrt.render_state(st, cam_j, jcfg, None, spp=1, seed=0, jitter=False)
        return jnp.mean(jnp.abs(img - 0.0))

    arrays = {
        "centers": s.centers, "scales": s.scales, "quats": s.quats,
        "opacities": s.attrs["opacities"], "sh_coeffs": s.attrs["sh_coeffs"],
    }
    l_j, g_j = jax.jit(jax.value_and_grad(loss_j))(arrays)

    params = interop.params_from_jax(
        {k: np.asarray(v) for k, v in arrays.items()}, device="cpu"
    )
    img = train.render_cameras(
        train.to_scene(params, _port_scene(s)), [cam_t], tcfg, jitter=False
    )
    loss = optim.l1(torch.zeros_like(img), img)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    for k in KEYS:
        a, b = np.asarray(g_j[k]), params[k].grad.numpy()
        assert np.isfinite(b).all() and np.abs(a).max() > 0, k
        scale = np.abs(a).max()
        err = np.abs(b - a).max() / scale
        print(f"{k}: max |g| {scale:.4g}, max diff / max |g| {err:.3g}")
        assert err <= (1e-2 if k == "sh_coeffs" else 1e-4), k


# ---- BoundedAdam against the JAX optimizer at fixed gradients -----------

def _run_both(x0, grads, lr=1e-3, bounds=None, **kw):
    """The same numpy gradients through both optimizers; returns the
    (param, m, v, t) of each after the last step."""
    jopt, topt = joptim.BoundedAdam(lr=lr, **kw), optim.BoundedAdam(lr=lr, **kw)
    for o in (jopt, topt):
        if bounds:
            o.set_bounds("x", **bounds)
    jp = {"x": jnp.asarray(x0)}
    js = jopt.init(jp)
    tp = {"x": torch.tensor(x0, requires_grad=True)}
    for g in grads:
        g = np.asarray(g(np.asarray(jp["x"])) if callable(g) else g, np.float32)
        jp, js = jopt.step(jp, {"x": jnp.asarray(g)}, js)
        topt.step(tp, {"x": torch.from_numpy(g)})
    st = topt.state["x"]
    return (
        (np.asarray(jp["x"]), np.asarray(js.m["x"]), np.asarray(js.v["x"]), int(js.t["x"])),
        (tp["x"].detach().numpy(), st.m.numpy(), st.v.numpy(), st.t),
    )


def _assert_same(jax_out, port_out, rtol=1e-6):
    for a, b in zip(jax_out[:3], port_out[:3]):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-7)
    assert jax_out[3] == port_out[3]


def test_adam_converges_quadratic():
    x0 = np.asarray([3.0, -2.0], np.float32)
    j, t = _run_both(x0, [lambda x: 2.0 * x] * 200, lr=0.1)
    np.testing.assert_allclose(t[0], 0.0, atol=1e-3)
    _assert_same(j, t, rtol=1e-4)  # 200 steps compound the last-bit differences


def test_adam_bounds_halving():
    # a step over the bound moves half-way to it and resets the moments
    j, t = _run_both(np.asarray([0.1], np.float32), [[10.0]], lr=1.0,
                     bounds=dict(lower=0.0))
    np.testing.assert_allclose(t[0], [0.05], rtol=1e-5)
    np.testing.assert_allclose(t[1], [0.0])
    _assert_same(j, t)


def test_adam_nan_grads_zeroed():
    j, t = _run_both(np.asarray([1.0], np.float32), [[np.nan]], lr=0.1)
    np.testing.assert_allclose(t[0], [1.0])
    _assert_same(j, t)


@pytest.mark.parametrize(
    "kw", [dict(mask_updates=True), dict(uniform=True),
           dict(bounds=dict(lower=-0.5, upper=0.7))],
    ids=["mask_updates", "uniform", "two_bounds"],
)
def test_adam_variants_match_jax(kw):
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-0.4, 0.6, 16).astype(np.float32)
    grads = []
    for _ in range(6):
        g = rng.normal(0.0, 1.0, 16).astype(np.float32)
        g[rng.uniform(size=16) < 0.3] = 0.0  # masked_updates skips these
        grads.append(g)
    j, t = _run_both(x0, grads, lr=0.2, **kw)
    _assert_same(j, t)


def test_state_checkpoint_roundtrip(tmp_path):
    opt = optim.BoundedAdam(lr=0.1)
    params = {"x": torch.tensor([1.0, 2.0], requires_grad=True)}
    opt.step(params, {"x": torch.tensor([0.5, -0.5])})
    path = str(tmp_path / "ckpt.npz")
    optim.save_state(path, params, opt)
    opt2 = optim.BoundedAdam(lr=0.1)
    p2 = optim.load_state(path, opt2, device="cpu")
    assert torch.equal(p2["x"].detach(), params["x"].detach()) and p2["x"].requires_grad
    assert torch.equal(opt2.state["x"].m, opt.state["x"].m)
    assert opt2.state["x"].t == 1


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX save_state checkpoint loaded by the port's load_state: one more
    step on each side gives equal parameters."""
    rng = np.random.default_rng(9)
    x0 = rng.normal(size=8).astype(np.float32)
    g1, g2 = (rng.normal(size=8).astype(np.float32) for _ in range(2))
    jopt = joptim.BoundedAdam(lr=0.05)
    jopt.set_bounds("x", lower=-0.2)
    jp = {"x": jnp.asarray(x0)}
    jp, js = jopt.step(jp, {"x": jnp.asarray(g1)}, jopt.init(jp))
    path = str(tmp_path / "jax.npz")
    joptim.save_state(path, jp, js)
    jp, js = jopt.step(jp, {"x": jnp.asarray(g2)}, js)

    topt = optim.BoundedAdam(lr=0.05)
    topt.set_bounds("x", lower=-0.2)
    tp = optim.load_state(path, topt, device="cpu")
    topt.step(tp, {"x": torch.from_numpy(g2)})
    np.testing.assert_allclose(tp["x"].detach().numpy(), np.asarray(jp["x"]), rtol=1e-6)
    assert topt.state["x"].t == int(js.t["x"]) == 2


# ---- the refine loop ------------------------------------------------------

def test_train_steps_match_jax_loop():
    """Three train.train_step calls against the JAX refine loop (tiled
    branch of examples/refine_3dg_dataset.py) from the same perturbed
    start and reference: the losses agree to rtol 1e-3."""
    s = surface_scene(6400, seed=3)
    cams = [_cameras(64, 64)]
    pose = dict(name="d", width=64, height=64, fov=45.0)
    at = ([0.8, 0.4, -3.4], [0, 0, 0], [0, 1, 0])
    cams.append((jscene.CameraSpecs(to_world=jscene.look_at(*at), **pose),
                 tscene.CameraSpecs(to_world=tscene.look_at(*at), **pose)))
    jcfg = jrt.RFTiledConfig(**TRAIN_AT_TEST_SIZE)
    tcfg = trt.RFTiledConfig(**TRAIN_AT_TEST_SIZE)

    def render_j(p, seed):
        st = jrt.build_state(_jax_scene(s, p), jcfg)
        return jnp.concatenate(
            [jrt.render_state(st, c, jcfg, None, spp=1, seed=seed * 131 + i, jitter=False)
             for i, (c, _) in enumerate(cams)],
            axis=1,
        )

    rng = np.random.default_rng(1)
    start = {
        "opacities": np.asarray(s.attrs["opacities"]) * 0.5,
        "sh_coeffs": np.asarray(s.attrs["sh_coeffs"])
        + rng.normal(0.0, 0.05, s.attrs["sh_coeffs"].shape).astype(np.float32),
        "centers": np.asarray(s.centers),
    }
    ref = np.asarray(render_j({k: s.attrs[k] for k in ("opacities", "sh_coeffs")}, 0))

    jopt = joptim.BoundedAdam()
    jopt.set_learning_rate({"opacities": 0.05, "sh_coeffs": 0.01, "centers": 0.0})
    jopt.set_bounds("opacities", lower=1e-6, upper=1.0 - 1e-6)

    @jax.jit
    def step_j(p, state, seed):
        loss, grads = jax.value_and_grad(
            lambda p: joptim.l1(jnp.asarray(ref), render_j(p, seed))
        )(p)
        p, state = jopt.step(p, grads, state)
        return p, state, loss

    jp = {k: jnp.asarray(v) for k, v in start.items()}
    js = jopt.init(jp)
    tp = interop.params_from_jax(start, device="cpu")
    topt = train.make_optimizer()
    ref_t = torch.from_numpy(ref.copy())
    losses_j, losses_t = [], []
    for it in range(3):
        jp, js, l_j = step_j(jp, js, it)
        l_t, psnr_t, img = train.train_step(
            tp, topt, ref_t, [c for _, c in cams], tcfg, spp=1, seed=it,
            base=_port_scene(s), jitter=False,
        )
        losses_j.append(float(l_j))
        losses_t.append(float(l_t))
        assert img.shape == (64, 128, 3) and np.isfinite(float(psnr_t))
    print("losses JAX", losses_j, "port", losses_t)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    assert losses_t[-1] < losses_t[0]
    np.testing.assert_array_equal(tp["centers"].detach().numpy(), start["centers"])
    o = tp["opacities"].detach()
    assert float(o.min()) >= 1e-6 and float(o.max()) <= 1.0 - 1e-6
