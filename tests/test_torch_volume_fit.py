"""The port's volume-fitting pieces against the JAX package's: the lattice
initialisation, EllipsoidsFactory, the quaternion and camera helpers, the
optimize_volume CLI's ring cameras, one optimize step, a miniature fit,
render_with_spp_grad and the integrator registry.

- lattice_init, rotate_x / rotate_y and the ring cameras are numpy in both
  packages: equal. The factory's quaternions go through from_euler in f32
  (XLA's sin / cos against torch's): within 1e-7.
- One optimize step of a 4^3 lattice on the same pixel-centre rays of two
  ring cameras, against the same target (JAX's absorption reference of the
  procedural smoke, clipped): the L1 loss within rtol 1e-5, the gradients
  of centers, scales, quats and sigma_t within 1e-4 of each maximum (the
  port's albedo gets none, JAX's a zero one), the parameters after one
  BoundedAdam step: within 1e-7 of JAX's optimizer on the port's
  gradients; on each package's own gradients within 1e-6 where |g| is at
  least 0.1 of its maximum, elsewhere (Adam's first step is about
  lr * sign(g)) within twice the learning rate; so are the quaternions,
  whose gradient on the isotropic lattice is 0 in f64 and f32 noise.
- The miniature fit of tests/test_optim.py:59-130: the loss falls by 5% or
  more over 12 steps, and sigma_t stays in its bounds.
- render_with_spp_grad (tests/test_optim.py:132-187): with spp_grad == spp
  the gradient equals plain autograd's (rtol 1e-6); with spp_grad = 1 its
  cosine with it exceeds 0.9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import models as jmodels
from volprim_tpu import optim as joptim
from volprim_tpu import scene as jscene
from volprim_tpu.models import gridvol as jgv
from volprim_tpu.models import tomography as jtomo
from volprim_tpu.ops import envmap as jenv
from volprim_tpu.ops import quaternion as jquat
from volprim_tpu.scene import cameras as jcams
from volprim_tpu_torch import interop, models, optim
from volprim_tpu_torch import scene as tscene
from volprim_tpu_torch.examples import optimize_volume as tov
from volprim_tpu_torch.models import base, gridvol, prb, tomography
from volprim_tpu_torch.ops import envmap, quaternion
from volprim_tpu_torch.scene import cameras as tcams

from test_torch_tomography import hold_to_jax

KEYS = ("centers", "scales", "quats", "sigmat", "albedo")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lattice_init_equals_jax():
    for count, sig, alb in ((4, 1e-4, 0.9), (3, 0.5, 0.2)):
        j = jscene.lattice_init(count, sig, alb)
        t = tscene.lattice_init(count, sig, alb, device="cpu")
        for name in ("centers", "scales", "quats"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
        for k in ("sigma_t", "albedo"):
            np.testing.assert_array_equal(t.attrs[k].numpy(), np.asarray(j.attrs[k]))
        assert t.extent == j.extent and t.num_prims == count ** 3


def test_factory_and_quaternions_equal_jax():
    rng = np.random.default_rng(0)
    fj, ft = jscene.EllipsoidsFactory(), tscene.EllipsoidsFactory()
    for _ in range(9):
        kw = dict(mean=rng.normal(size=3), scale=rng.uniform(0.05, 0.3, size=3),
                  euler_deg=rng.uniform(-180, 180, size=3), sigma_t=rng.uniform(0.1, 1.0),
                  albedo=rng.uniform(0.2, 0.9, size=3))
        fj.add(**kw)
        ft.add(**kw)
    fj.add(mean=[0, 0, 0], scale=0.2, sigma_t=1.0, albedo=[0.5] * 3)
    ft.add(mean=[0, 0, 0], scale=0.2, sigma_t=1.0, albedo=[0.5] * 3)
    j, t = fj.build(extent=2.5), ft.build(extent=2.5, device="cpu")
    assert t.extent == 2.5
    np.testing.assert_array_equal(t.centers.numpy(), np.asarray(j.centers))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_allclose(t.quats.numpy(), np.asarray(j.quats), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(t.quats[-1].numpy(), [0.0, 0.0, 0.0, 1.0])
    for k in ("sigma_t", "albedo"):
        np.testing.assert_array_equal(t.attrs[k].numpy(), np.asarray(j.attrs[k]))
    # packing, rotations
    np.testing.assert_allclose(t.pack_data().numpy(), np.asarray(j.pack_data()), rtol=0,
                               atol=1e-7)
    back = tscene.EllipsoidScene.from_packed_data(t.pack_data(), t.attrs, 2.5)
    assert torch.equal(back.quats, t.quats) and back.extent == 2.5
    np.testing.assert_allclose(t.rotations().numpy(), np.asarray(j.rotations()), atol=1e-6)
    a = rng.normal(size=(16, 4)).astype(np.float32)
    b = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(quaternion.multiply(torch.from_numpy(a), torch.from_numpy(b)),
                               np.asarray(jquat.multiply(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)
    e = rng.uniform(-3, 3, size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(quaternion.from_euler(torch.from_numpy(e)),
                               np.asarray(jquat.from_euler(jnp.asarray(e))), atol=1e-6)
    ft.add(mean=[0, 0, 0], scale=0.1)  # no attributes
    with pytest.raises(ValueError, match="missing"):
        ft.build(device="cpu")


def test_rotations_and_ring_cameras_equal_jax():
    for deg in (-90.0, -37.5, 0.0, 12.0, 135.0):
        np.testing.assert_array_equal(tcams.rotate_x(deg), jcams.rotate_x(deg))
        np.testing.assert_array_equal(tcams.rotate_y(deg), jcams.rotate_y(deg))
    # the JAX script's draws: np.random.seed(0), one rand() per camera
    np.random.seed(0)
    want = [jcams.rotate_y(180.0 / 8 * i - 90.0) @ jcams.rotate_x(90.0 * np.random.rand() - 45.0)
            @ jcams.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]) for i in range(8)]
    cams = tov.ring_cameras(8, 32)
    assert [c.name for c in cams] == [f"cam_{i:04d}" for i in range(8)]
    for c, w in zip(cams, want):
        np.testing.assert_array_equal(c.to_world, w)
        assert (c.width, c.height, c.fov) == (32, 32, 40.0)


def _pixel_rays(cameras):
    """Pixel-centre rays of the cameras, camera after camera (numpy)."""
    h, w = cameras[0].height, cameras[0].width
    px = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w).reshape(1, -1) + 0.5
    py = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w).reshape(1, -1) + 0.5
    n = len(cameras)
    o, d = base.batch_rays(cameras, px.expand(n, -1), py.expand(n, -1))
    return o.numpy(), d.numpy()


def _jax_step(arrays, o, d, target, opt_lrs, f64=False, grads=None):
    """JAX's loss, gradients and parameters after one BoundedAdam step
    (with ``f64``: the loss and gradients in f64; with ``grads``: the step
    takes these gradients)."""
    dt = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        cfg = jtomo.TomographyConfig(max_depth=-1, chunk_size=16)
        em = jenv.ConstantEmitter(radiance=jnp.ones(3, dt))

        def loss_fn(p):
            s = jscene.EllipsoidScene(p["centers"], p["scales"], p["quats"],
                                      {"sigma_t": p["sigmat"], "albedo": p["albedo"]}, 3.0)
            return joptim.l1(jnp.asarray(target, dt),
                             jtomo.radiance(s, em, jnp.asarray(o, dt), jnp.asarray(d, dt), cfg))

        params = {k: jnp.asarray(v, dt) for k, v in arrays.items()}
        given = grads
        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = {k: np.asarray(v) for k, v in (given or grads).items()}
        if f64:
            return float(loss), grads, None
    opt = joptim.BoundedAdam()
    opt.set_learning_rate(opt_lrs)
    opt.set_bounds("scales", lower=1e-6)
    opt.set_bounds("sigmat", lower=1e-8, upper=1e-3)
    opt.set_bounds("albedo", lower=1e-8, upper=1.0)
    new, _ = opt.step(params, {k: jnp.asarray(v) for k, v in grads.items()}, opt.init(params))
    return float(loss), grads, {k: np.asarray(v) for k, v in new.items()}


def _port_step(arrays, o, d, target, f64=False):
    """The port's loss and parameters with their gradients."""
    dt = torch.float64 if f64 else torch.float32
    params = {k: torch.tensor(v, dtype=dt, requires_grad=True) for k, v in arrays.items()}
    cfg = tomography.TomographyConfig(max_depth=-1, chunk_size=16)
    img = tomography.radiance(tov.to_scene(params, 3.0),
                              envmap.ConstantEmitter(radiance=torch.ones(3, dtype=dt)),
                              torch.tensor(o, dtype=dt), torch.tensor(d, dtype=dt), cfg)
    loss = optim.l1(torch.tensor(target, dtype=dt), img)
    loss.backward()
    return float(loss.detach()), params


def test_one_optimize_step_matches_jax():
    cameras = tov.ring_cameras(2, 12)
    o, d = _pixel_rays(cameras)
    smoke = jscene.procedural_smoke(16)
    gcfg = jgv.GridVolumeConfig(sigma_scale=5.0, num_steps=64)
    target = np.clip(np.asarray(jgv.radiance(jgv.transform_grid(smoke, gcfg),
                                             jenv.ConstantEmitter(radiance=jnp.ones(3)),
                                             jnp.asarray(o), jnp.asarray(d), gcfg)), 0.0, 1.0)
    j = jscene.lattice_init(4, 5e-4, 0.9)
    arrays = dict(centers=j.centers, scales=j.scales, quats=j.quats, sigmat=j.attrs["sigma_t"],
                  albedo=j.attrs["albedo"])
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    opt = tov.make_optimizer(tov.parser().parse_args(["--output", "unused"]))
    loss_j, g_j, new_j = _jax_step(arrays, o, d, target, dict(opt.lr))
    _, g_j64, _ = _jax_step(arrays, o, d, target, dict(opt.lr), f64=True)
    loss, params = _port_step(arrays, o, d, target)
    _, params64 = _port_step(arrays, o, d, target, f64=True)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    assert params["albedo"].grad is None and not np.any(g_j["albedo"])
    for k in KEYS[:4]:
        g = params[k].grad.numpy()
        scale = np.abs(g_j[k]).max()
        assert scale > 0 and np.isfinite(g).all(), k
        print(f"{k}: max diff / max |g| {np.abs(g - g_j[k]).max() / scale:.3g}")
        hold_to_jax(g / scale, g_j[k] / scale, params64[k].grad.numpy() / scale,
                    g_j64[k] / scale, 0.0, 1e-4, 1e-4, f"gradient {k}")
    # the optimizer alone: JAX's BoundedAdam on the port's gradients
    grads_t = {k: (np.zeros_like(v) if params[k].grad is None else params[k].grad.numpy())
               for k, v in arrays.items()}
    _, _, new_jt = _jax_step(arrays, o, d, target, dict(opt.lr), grads=grads_t)
    opt.step(params)
    for k in KEYS:
        got = params[k].detach().numpy()
        np.testing.assert_allclose(got, new_jt[k], rtol=0, atol=1e-7, err_msg=k)
        # each package on its own gradients: Adam's first step is about
        # lr * sign(g), so it follows the f32 noise where |g| is small
        robust = np.abs(g_j[k]) >= 0.1 * max(np.abs(g_j[k]).max(), 1e-30)
        if np.abs(g_j64[k]).max() < 1e-3 * np.abs(g_j[k]).max():
            robust[...] = False  # the isotropic lattice: dL/dq is 0 but for f32 noise
        diff = np.abs(got - new_j[k])
        print(f"{k}: after the step {diff.max():.3g}; {(~robust).sum()} small gradients")
        assert diff[robust].max(initial=0.0) <= 1e-6, k
        assert diff.max() <= 2.0 * opt.lr[k] + 1e-6, k
    sig = params["sigmat"].detach().numpy()
    assert sig.min() >= np.float32(1e-8) and sig.max() <= np.float32(1e-3)


def test_miniature_fit():
    """tests/test_optim.py's miniature optimize_volume: a 4^3 lattice fitted
    to the absorption reference of a 16^3 plume through three 24x24
    cameras."""
    res, cam_count = 24, 3
    cameras = [tcams.CameraSpecs(name=f"c{i}", width=res, height=res,
                                 to_world=tcams.rotate_y(120.0 * i - 60.0)
                                 @ tcams.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]), fov=40.0)
               for i in range(cam_count)]
    grid = tscene.procedural_smoke(res=16, device="cpu")
    gcfg = gridvol.GridVolumeConfig(sigma_scale=5.0, num_steps=64)
    emitter = envmap.ConstantEmitter(radiance=torch.ones(3))
    gen = torch.Generator().manual_seed(0)
    ref = torch.clamp(models.render_batch(gridvol.transform_grid(grid, gcfg), cameras,
                                          gridvol.radiance, gcfg, emitter, spp=4,
                                          generator=gen), 0.0, 1.0)
    prims = tscene.lattice_init(4, init_sigmat=1e-4, init_albedo=0.9, device="cpu")
    cfg = tomography.TomographyConfig(max_depth=-1, chunk_size=64)
    opt = optim.BoundedAdam()
    opt.set_learning_rate({"centers": 0.015, "scales": 1e-4, "sigmat": 1e-4})
    opt.set_bounds("scales", lower=1e-6)
    opt.set_bounds("sigmat", lower=1e-8, upper=1e-3)
    params = {"centers": prims.centers.clone().requires_grad_(True),
              "scales": prims.scales.clone().requires_grad_(True),
              "sigmat": prims.attrs["sigma_t"].clone().requires_grad_(True)}
    losses = []
    for it in range(12):
        for p in params.values():
            p.grad = None
        s = tscene.EllipsoidScene(params["centers"], params["scales"], prims.quats,
                                  {"sigma_t": params["sigmat"], "albedo": prims.attrs["albedo"]},
                                  prims.extent)
        img = models.render_batch(s, cameras, tomography.radiance, cfg, emitter, spp=1,
                                  generator=torch.Generator().manual_seed(it))
        loss = optim.l1(ref, img)
        loss.backward()
        opt.step(params)
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.95, f"no convergence: {losses}"
    assert losses[-1] < min(losses[:3]), f"not descending: {losses}"
    sig = params["sigmat"].detach()
    assert float(sig.min()) >= 1e-8 and float(sig.max()) <= 1e-3


def _spp_scene():
    f = tscene.EllipsoidsFactory()
    rng = np.random.default_rng(0)
    for _ in range(12):
        f.add(mean=rng.normal(size=3) * 0.4, scale=0.2, sigma_t=rng.uniform(0.5, 2.0),
              albedo=0.8)
    return f.build(device="cpu")


def test_render_with_spp_grad():
    """spp_grad == spp reproduces plain autograd; spp_grad < spp gives a
    cheaper adjoint of the same gradient (mi.render's spp / spp_grad)."""
    s = _spp_scene()
    em = envmap.ConstantEmitter(radiance=torch.ones(3))
    cam = tscene.CameraSpecs(name="c", width=16, height=16,
                             to_world=tscene.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), fov=45.0)
    cfg = tomography.TomographyConfig(chunk_size=16)

    def grad(fn):
        sig = s.attrs["sigma_t"].clone().requires_grad_(True)
        s2 = dataclasses.replace(s, attrs={**s.attrs, "sigma_t": sig})
        img = fn(s2)
        torch.mean(img ** 2).backward()
        return img.detach(), sig.grad.numpy()

    def plain(s2):
        return models.render(s2, cam, tomography.radiance, cfg, em, spp=4,
                             generator=torch.Generator().manual_seed(3))

    img_p, g_plain = grad(plain)
    img_s, g_same = grad(models.render_with_spp_grad(cam, tomography.radiance, cfg, em, spp=4,
                                                     spp_grad=4, seed=3))
    assert torch.equal(img_p, img_s)
    np.testing.assert_allclose(g_same, g_plain, rtol=1e-6)
    img_c, g_cheap = grad(models.render_with_spp_grad(cam, tomography.radiance, cfg, em, spp=4,
                                                      spp_grad=1, seed=3))
    assert torch.equal(img_c, img_p) and np.isfinite(g_cheap).all()
    cos = (g_cheap * g_plain).sum() / (np.linalg.norm(g_cheap) * np.linalg.norm(g_plain))
    assert cos > 0.9, cos
    # a list of cameras takes the batch sensor; centers get gradients too
    cams = [cam, dataclasses.replace(cam, name="d", to_world=tscene.look_at(
        [4, 0, 0], [0, 0, 0], [0, 1, 0]))]
    ctr = s.centers.clone().requires_grad_(True)
    f = models.render_with_spp_grad(cams, tomography.radiance, cfg, em, spp=2, spp_grad=2, seed=1)
    img = f(dataclasses.replace(s, centers=ctr))
    assert img.shape == (16, 32, 3)
    torch.mean(img ** 2).backward()
    ctr2 = s.centers.clone().requires_grad_(True)
    want = models.render_batch(dataclasses.replace(s, centers=ctr2), cams, tomography.radiance,
                               cfg, em, spp=2, generator=torch.Generator().manual_seed(1))
    torch.mean(want ** 2).backward()
    np.testing.assert_allclose(ctr.grad.numpy(), ctr2.grad.numpy(), rtol=1e-6, atol=1e-12)


def test_registry_matches_jax():
    assert sorted(models.REGISTRY) == sorted(jmodels.REGISTRY)
    assert sorted(models.CONFIGS) == sorted(jmodels.CONFIGS)
    assert models.REGISTRY["volprim_rf"] is models.rf.radiance
    assert models.REGISTRY["volprim_prb"] is prb.radiance
    for name, cls in models.CONFIGS.items():
        assert set(cls.__dataclass_fields__) <= set(jmodels.CONFIGS[name].__dataclass_fields__) | {
            "walk_backend"}, name
    # the path tracer's default walk is not ported: it raises, naming §A5
    s = _spp_scene()
    o, d = torch.zeros(4, 3), torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    with pytest.raises(NotImplementedError, match="§A5"):
        models.REGISTRY["volprim_prb"](s, envmap.ConstantEmitter(radiance=torch.ones(3)),
                                       o - 4.0, d, models.CONFIGS["volprim_prb"](),
                                       torch.Generator())


def test_params_and_grids_through_interop():
    arrays = {"sigmat": np.full((8, 1), 1e-4, np.float32),
              "albedo": np.full((8, 3), 0.9, np.float32),
              "centers": np.zeros((8, 3), np.float32)}
    p = interop.params_from_jax(arrays, device="cpu")
    assert all(v.requires_grad and v.dtype == torch.float32 for v in p.values())
    assert {k: v.tolist() for k, v in interop.params_to_numpy(p).items()} == {
        k: v.tolist() for k, v in arrays.items()}
    with pytest.raises(KeyError, match="not training parameters"):
        interop.params_from_jax({"density": np.zeros(3)}, device="cpu")
    g = jscene.procedural_smoke(8)
    t = interop.grid_from_arrays(np.asarray(g.data), np.asarray(g.bbox_min),
                                 np.asarray(g.bbox_max), device="cpu")
    assert isinstance(t, tscene.GridVolume)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(g.data))
