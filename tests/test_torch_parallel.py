"""volprim_tpu_torch.parallel and the sharded render paths against
tests/test_sharding.py, on four gloo ranks.

One module-scoped launch runs four rank processes of a worker script
written to a temporary directory (JAX's own pattern in
test_sharding.py::test_init_multihost_two_process_collective). They import
torch and volprim_tpu_torch only, run every sharded case in that one
process group (one torch thread each) and save their outputs as ``.npz``
files that this process reads. The scenes are made here with the JAX
package (test_sharding.py's ``make_scene`` and ``surface_scene_big``) and
handed to the ranks as arrays; the JAX side runs here on a 4-device
submesh, so that per-shard budget classes match the port's four ranks.

Tolerances are test_sharding.py's: images rtol 1e-4 / atol 1e-5, gradients
rtol 1e-3, bitwise for the tiled frames (fused with ``order_band=8``, xla,
compact), PSNR > 25 dB with budget classes. The port's jitter is not
``jax.random``'s bits, so jittered frames are held to the port's single
process, and the tiled frames with ``jitter=False`` to JAX's 4-device
mesh as well. ``models.render`` always jitters: its sharded images and
gradients are held to the port's single process. A one-rank mesh (a
process group of one) equals ``mesh=None`` bit for bit for ``rf``,
``tomography`` and ``prb``. ``prb`` on four ranks draws each rank's rays
from a stream of its own: its image mean lies within 4 standard errors of
the single process's, its gradients are finite and equal on every rank.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volprim_tpu import models as jmodels
from volprim_tpu import parallel as jparallel
from volprim_tpu import scene as jscene
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch import parallel

from test_rf_tiled import surface_scene
from test_sharding import make_scene
from test_torch_rf_tiled_xla import hold_to_jax, jax_scene64, jax_state64, jax_xla64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
IMG_TOL = dict(rtol=1e-4, atol=1e-5)

# test_sharding.py's tiled configurations (kernel_batch, a TPU knob, has no
# counterpart in the port)
BITMATCH = dict(max_depth=48, srgb_primitives=False, tile_pixels=256, max_candidates=512,
                segment=128, tile_group=2, use_clusters=True, cluster_size=32,
                order_band=8)
GRADS = dict(max_depth=32, srgb_primitives=False, tile_pixels=256, max_candidates=256,
             segment=64, tile_group=2, use_clusters=True, cluster_size=32)
COMPACT = dict(max_depth=48, srgb_primitives=False, tile_pixels=256, max_candidates=512,
               segment=128, use_clusters=True, cluster_size=16, backend="fused",
               kernel_compact=True)
CLASSES = dict(max_depth=48, srgb_primitives=False, tile_pixels=256, max_candidates=512,
               segment=128, use_clusters=True, cluster_size=16, backend="fused",
               budget_classes=((0.5, 64), (0.5, 200)))
PRB = dict(max_overlaps=8, max_windows=3, bounce_cap=6, chunk_size=32, cluster_size=8)
# the dryrun's batch-sensor step (__graft_entry__.dryrun_multichip)
DRYRUN_RF = dict(max_depth=8, chunk_size=64)

WORKER = r'''
import dataclasses, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

out_dir, port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
torch.set_num_threads(1)
from volprim_tpu_torch import interop, models, parallel, train
from volprim_tpu_torch.models import prb, rf, rf_tiled, tomography
from volprim_tpu_torch.ops import envmap
from volprim_tpu_torch.optim import BoundedAdam, l1
from volprim_tpu_torch.scene import CameraSpecs, EllipsoidScene, look_at

CFG = @CFG@
res = {}
res["init"] = parallel.init_multihost(f"127.0.0.1:{port}", world, rank, timeout_s=120,
                                      device="cpu")
mesh = parallel.data_mesh("cpu")
alone, _ = dist.new_subgroups(1)  # this rank alone: a one-rank mesh with collectives
mesh1 = parallel.data_mesh("cpu", group=alone)
ones = torch.ones(3)
dist.all_reduce(ones)
res["mesh"] = np.array([mesh.rank, mesh.size, mesh1.rank, mesh1.size])
res["all_reduce"] = ones.numpy()

path = os.path.join(out_dir, "scenes.npz")
deadline = time.time() + 300
while not os.path.exists(path):
    if time.time() > deadline:
        raise SystemExit("no scenes.npz")
    time.sleep(0.05)
arrays = np.load(path)


def scene_of(tag, **extra):
    attrs = {k.split("/")[2]: arrays[k] for k in arrays.files if k.startswith(tag + "/attr/")}
    attrs.update(extra)
    return interop.scene_from_arrays(arrays[tag + "/centers"], arrays[tag + "/scales"],
                                     arrays[tag + "/quats"], attrs, 3.0, device="cpu")


def camera(w, h, eye):
    return CameraSpecs(name="c", width=w, height=h, fov=45.0,
                       to_world=look_at(eye, [0, 0, 0], [0, 1, 0]))


def gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def with_attr(s, key, value):
    return EllipsoidScene(s.centers, s.scales, s.quats, {**s.attrs, key: value}, s.extent)


def scene64(s):
    return EllipsoidScene(s.centers.double(), s.scales.double(), s.quats.double(),
                          {k: v.double() for k, v in s.attrs.items()}, s.extent)


def state64(s, cfg):
    """The xla route in f64 on the f32 frame's shortlists (the cull
    geometry in f32), as test_torch_rf_tiled_xla._render64 builds it."""
    st = rf_tiled.build_state(s, cfg)
    return dataclasses.replace(st, **{
        k: getattr(st, k).float()
        for k in ("cull_centers", "cull_radii", "sup_centers", "sup_radii", "suprows")
        if getattr(st, k) is not None})


single = {}  # single-process references, computed after the sharded cases
cam_t = camera(32, 16, [0, 0, -4])
cam_p = camera(16, 16, [0, 0, -4])
cam_s = camera(64, 64, [0, 0.3, -3.5])
cam_g = camera(64, 32, [0, 0.3, -3.5])
em = envmap.ConstantEmitter(radiance=torch.ones(3))

# ---- tomography through models.render: the film all-reduce -----------------
s_t = scene_of("tomo")
t_cfg = tomography.TomographyConfig(chunk_size=32)


def tomo_img(mesh_, s=s_t, spp=2):
    return models.render(s, cam_t, tomography.radiance, t_cfg, em, spp=spp,
                         generator=gen(0), mesh=mesh_)


def tomo_loss(mesh_):
    return lambda sig: torch.mean(tomo_img(mesh_, with_attr(s_t, "sigma_t", sig), 1) ** 2)


res["tomo_img"] = tomo_img(mesh).numpy()
res["tomo_grad"] = parallel.sharded_grad_step(tomo_loss(mesh), mesh)(
    s_t.attrs["sigma_t"])[1].numpy()
single["tomo_img"] = lambda: tomo_img(None).numpy()
single["tomo_grad"] = lambda: parallel.sharded_grad_step(tomo_loss(None))(
    s_t.attrs["sigma_t"])[1].numpy()
res["tomo_img_w1"] = tomo_img(mesh1).numpy()


def spp_grad_loss(mesh_):
    f = models.render_with_spp_grad(cam_t, tomography.radiance, t_cfg, em, spp=2, spp_grad=1,
                                    mesh=mesh_)
    return lambda sig: torch.mean(f(with_attr(s_t, "sigma_t", sig)) ** 2)


res["spp_grad"] = parallel.sharded_grad_step(spp_grad_loss(mesh), mesh)(
    s_t.attrs["sigma_t"])[1].numpy()
single["spp_grad"] = lambda: parallel.sharded_grad_step(spp_grad_loss(None))(
    s_t.attrs["sigma_t"])[1].numpy()
res["tomo_grad_w1"] = parallel.sharded_grad_step(tomo_loss(mesh1), mesh1)(
    s_t.attrs["sigma_t"])[1].numpy()

# ---- prb through models.render: a stream per rank --------------------------
s_p = scene_of("tomo", albedo=np.full((20, 3), 0.8, np.float32))
p_cfg = prb.PRBConfig(**CFG["PRB"])


def prb_img(mesh_, s=s_p, spp=2):
    return models.render(s, cam_p, prb.radiance, p_cfg, em, spp=spp, generator=gen(3),
                         mesh=mesh_)


res["prb_img"] = prb_img(mesh).numpy()
res["prb_grad"] = parallel.sharded_grad_step(
    lambda sig: torch.mean(prb_img(mesh, with_attr(s_p, "sigma_t", sig), 1) ** 2), mesh
)(s_p.attrs["sigma_t"])[1].numpy()
res["prb_img_w1"] = prb_img(mesh1).numpy()
single["prb_img"] = lambda: prb_img(None).numpy()

# ---- rf through render_batch: the dryrun's batch-sensor step ---------------
s_small = scene_of("small")
r_cfg = rf.RFConfig(**CFG["DRYRUN_RF"])
cams_b = [camera(16, 8, [0, 0, -4 + i]) for i in range(2)]
ref_b = torch.zeros((8, 32, 3))


def batch_loss(mesh_):
    def loss(p):
        s = EllipsoidScene(p["centers"], s_small.scales, s_small.quats,
                           {"opacities": p["opacities"], "sh_coeffs": p["sh_coeffs"]})
        return l1(ref_b, models.render_batch(s, cams_b, rf.radiance, r_cfg, None, spp=1,
                                              generator=gen(0), mesh=mesh_))
    return loss


def batch_step(mesh_):
    params = {k: v.clone() for k, v in (("opacities", s_small.attrs["opacities"]),
                                        ("sh_coeffs", s_small.attrs["sh_coeffs"]),
                                        ("centers", s_small.centers))}
    parallel.replicate(mesh_, params)
    loss, grads = parallel.sharded_grad_step(batch_loss(mesh_), mesh_)(params)
    opt = BoundedAdam(lr=1e-2)
    opt.set_bounds("opacities", lower=1e-6, upper=1.0 - 1e-6)
    opt.step(params, grads)
    out = {f"batch_grad_{k}": v.numpy() for k, v in grads.items()}
    out.update({f"batch_param_{k}": v.numpy() for k, v in params.items()})
    out["batch_loss"] = loss.numpy()
    return out


res.update(batch_step(mesh))
single["batch"] = lambda: batch_step(None)
rf_cam = camera(16, 16, [0, 0.3, -3.5])


def rf_img(mesh_):
    return models.render(s_small, rf_cam, rf.radiance, rf.RFConfig(max_depth=16, chunk_size=64),
                         None, spp=2, generator=gen(5), mesh=mesh_)


res["rf_img_w1"] = rf_img(mesh1).numpy()
single["rf_img"] = lambda: rf_img(None).numpy()

# ---- rf_tiled: the tile all-gather ----------------------------------------
s_big = scene_of("big")
for backend in ("xla", "fused"):
    cfg = rf_tiled.RFTiledConfig(backend=backend, **CFG["BITMATCH"])
    state = rf_tiled.build_state(s_big, cfg)
    res[f"band_{backend}"] = rf_tiled.render_state(state, cam_s, cfg, None, spp=2, seed=1,
                                                   mesh=mesh).numpy()
    res[f"band_{backend}_nojit"] = rf_tiled.render_state(state, cam_s, cfg, None, spp=1,
                                                         jitter=False, mesh=mesh).numpy()
    single[f"band_{backend}"] = (lambda st, c: lambda: rf_tiled.render_state(
        st, cam_s, c, None, spp=2, seed=1).numpy())(state, cfg)
    if backend == "xla":  # the xla route's yardstick against JAX: f64
        res["band_xla_nojit64"] = rf_tiled.render_state(
            state64(scene64(s_big), cfg), cam_s, cfg, None, spp=1, jitter=False,
            mesh=mesh).numpy()
for name in ("COMPACT", "CLASSES"):
    cfg = rf_tiled.RFTiledConfig(**CFG[name])
    state = rf_tiled.build_state(s_big, cfg)
    tag = name.lower()
    res[tag] = rf_tiled.render_state(state, cam_s, cfg, None, spp=1, seed=1,
                                     mesh=mesh).numpy()
    res[tag + "_nojit"] = rf_tiled.render_state(state, cam_s, cfg, None, spp=1,
                                                jitter=False, mesh=mesh).numpy()
    single[tag] = (lambda st, c: lambda: rf_tiled.render_state(
        st, cam_s, c, None, spp=1, seed=1).numpy())(state, cfg)

s_g = scene_of("grads")
g_cfg = rf_tiled.RFTiledConfig(**CFG["GRADS"])


def tiled_loss(mesh_, s=s_g, build=rf_tiled.build_state):
    def loss(opac):
        st = build(with_attr(s, "opacities", opac), g_cfg)
        img = rf_tiled.render_state(st, cam_g, g_cfg, None, spp=1, seed=0, jitter=False,
                                    mesh=mesh_)
        return torch.mean(img ** 2)
    return loss


res["tiled_grad"] = parallel.sharded_grad_step(tiled_loss(mesh), mesh)(
    s_g.attrs["opacities"])[1].numpy()
res["tiled_grad64"] = parallel.sharded_grad_step(
    tiled_loss(mesh, scene64(s_g), state64), mesh)(s_g.attrs["opacities"].double())[1].numpy()
single["tiled_grad"] = lambda: parallel.sharded_grad_step(tiled_loss(None))(
    s_g.attrs["opacities"])[1].numpy()


def train_run(mesh_):
    """train.py's step on the mesh: rays jittered, L1, BoundedAdam."""
    params = {"opacities": s_g.attrs["opacities"].clone().requires_grad_(True),
              "sh_coeffs": s_g.attrs["sh_coeffs"].clone().requires_grad_(True)}
    loss = train.train_step(params, train.make_optimizer(), torch.zeros((32, 64, 3)),
                            [cam_g], g_cfg, seed=2, base=s_g, mesh=mesh_)[0]
    out = {f"train_{k}": v.detach().numpy() for k, v in params.items()}
    out.update({f"train_grad_{k}": v.grad.numpy() for k, v in params.items()})
    out["train_loss"] = loss.numpy()
    return out


res.update(train_run(mesh))
single["train"] = lambda: train_run(None)

dist.barrier()
dist.destroy_process_group()
# the single-process references, shared out over the ranks
for i, key in enumerate(sorted(single)):
    if i % world == rank:
        out = single[key]()
        if isinstance(out, dict):
            res.update({f"single_{k}": v for k, v in out.items()})
        else:
            res[f"single_{key}"] = out
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
print(f"rank{rank} OK", flush=True)
'''.replace("@CFG@", repr(dict(BITMATCH=BITMATCH, GRADS=GRADS, COMPACT=COMPACT,
                                    CLASSES=CLASSES, PRB=PRB, DRYRUN_RF=DRYRUN_RF)))

INIT_WORKER = r'''
import sys, time
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from volprim_tpu_torch import parallel
if sys.argv[1] == "env":  # torchrun's environment, no arguments
    assert parallel.init_multihost(device="cpu") is True
    mesh = parallel.data_mesh("cpu")
    x = torch.full((2,), float(mesh.rank + 1))
    y = parallel.sum_parts(mesh, x)
    assert mesh.size == 2 and dist.get_world_size() == 2, mesh
    assert y.tolist() == [3.0, 3.0], y
    assert parallel.init_multihost() is True  # idempotent
    print(f"rank{mesh.rank} OK", flush=True)
else:  # a coordinator nobody joins
    t0 = time.perf_counter()
    ok = parallel.init_multihost("127.0.0.1:1", 2, 0, timeout_s=5, backend="gloo")
    print(f"returned {ok} after {time.perf_counter() - t0:.2f} s", flush=True)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _arrays(tag, s):
    out = {f"{tag}/centers": s.centers, f"{tag}/scales": s.scales, f"{tag}/quats": s.quats}
    out.update({f"{tag}/attr/{k}": v for k, v in s.attrs.items()})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _jax_side(scenes):
    """JAX's sharded frames (jitter off) and gradients on 4 devices."""
    mesh = jparallel.data_mesh(jax.devices()[:WORLD])
    cam_s = jscene.CameraSpecs(name="c", width=64, height=64, fov=45.0,
                               to_world=jscene.look_at([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0]))
    cam_g = jscene.CameraSpecs(name="c", width=64, height=32, fov=45.0,
                               to_world=jscene.look_at([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0]))
    out = {}
    big = scenes["big"]
    for tag, kw in (("band_xla", dict(BITMATCH, backend="xla")),
                    ("band_fused", dict(BITMATCH, backend="fused")),
                    ("compact", COMPACT), ("classes", CLASSES)):
        cfg = jrt.RFTiledConfig(**kw)
        state = jrt.build_state(big, cfg)
        out[tag + "_nojit"] = np.asarray(jax.jit(lambda st: jrt.render_state(
            st, cam_s, cfg, None, spp=1, jitter=False, mesh=mesh))(state))
    s = scenes["grads"]
    cfg = jrt.RFTiledConfig(**GRADS)

    def loss(opac, f64=False):
        s2 = jscene.EllipsoidScene(s.centers, s.scales, s.quats,
                                   {**s.attrs, "opacities": opac}, s.extent)
        st = jax_state64(jax_scene64(s2), cfg) if f64 else jrt.build_state(s2, cfg)
        img = jrt.render_state(st, cam_g, cfg, None, spp=1, seed=0, jitter=False, mesh=mesh)
        return jnp.mean(img ** 2)

    out["tiled_grad"] = np.asarray(jax.jit(jax.grad(loss))(s.attrs["opacities"]))
    # the xla route's yardstick: JAX in f64 on the f32 shortlists
    cfg_x = jrt.RFTiledConfig(**BITMATCH, backend="xla")
    with jax.enable_x64(True), jax_xla64():
        st = jax_state64(jax_scene64(big), cfg_x)
        out["band_xla_nojit64"] = np.asarray(jax.jit(lambda st: jrt.render_state(
            st, cam_s, cfg_x, None, spp=1, jitter=False, mesh=mesh))(st))
        out["tiled_grad64"] = np.asarray(jax.jit(jax.grad(lambda o: loss(o, True)))(
            jnp.asarray(s.attrs["opacities"], jnp.float64)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch the four ranks (and the two init_multihost checks), hand them
    the scenes, compute JAX's side meanwhile, and read what the ranks
    saved: ``(port, jax, logs)``, port[r] the arrays of rank r."""
    tmp = tmp_path_factory.mktemp("parallel")
    worker = tmp / "worker.py"
    worker.write_text(WORKER)
    init_worker = tmp / "init_worker.py"
    init_worker.write_text(INIT_WORKER)
    port = _free_port()
    procs = {}
    for r in range(WORLD):
        procs[f"rank{r}"] = subprocess.Popen(
            [sys.executable, str(worker), str(tmp), str(port), str(r), str(WORLD)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env())
    env_port = _free_port()
    for r in range(2):
        procs[f"env{r}"] = subprocess.Popen(
            [sys.executable, str(init_worker), "env"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(env_port), WORLD_SIZE="2",
                     RANK=str(r), LOCAL_RANK=str(r)))
    procs["unreachable"] = subprocess.Popen(
        [sys.executable, str(init_worker), "unreachable"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env())
    try:
        scenes = {"tomo": make_scene(), "big": surface_scene(3200, 3),
                  "grads": surface_scene(800, 5), "small": surface_scene(64, 7)}
        arrays = {}
        for tag, s in scenes.items():
            arrays.update(_arrays(tag, s))
        np.savez(tmp / "scenes.tmp.npz", **arrays)
        os.replace(tmp / "scenes.tmp.npz", tmp / "scenes.npz")
        jax_out = _jax_side(scenes)
        logs = {name: p.communicate(timeout=600)[0] for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-3000:]}"
    port_out = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    merged = {k: v for r in port_out for k, v in r.items() if k.startswith("single_")}
    return port_out, merged, jax_out, logs


def test_four_ranks(runs):
    """The counterpart of test_eight_devices: four ranks, each with a
    one-rank subgroup mesh, and an all-reduce over them."""
    port, _, _, logs = runs
    for r in range(WORLD):
        assert bool(port[r]["init"])
        np.testing.assert_array_equal(port[r]["mesh"], [r, WORLD, 0, 1])
        np.testing.assert_array_equal(port[r]["all_reduce"], [WORLD] * 3)
        assert f"rank{r} OK" in logs[f"rank{r}"]


def _same_on_every_rank(port, key):
    for r in range(1, WORLD):
        np.testing.assert_array_equal(port[r][key], port[0][key], err_msg=f"{key} rank {r}")
    return port[0][key]


def test_sharded_render_matches_single(runs):
    port, single, _, _ = runs
    img = _same_on_every_rank(port, "tomo_img")
    assert img.shape == (16, 32, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, single["single_tomo_img"], **IMG_TOL)


def test_sharded_gradient_matches_single(runs):
    """The tomography frame's sigma_t gradient, through models.render and
    through render_with_spp_grad (its adjoint re-render on the mesh)."""
    port, single, _, _ = runs
    for key in ("tomo_grad", "spp_grad"):
        g = _same_on_every_rank(port, key)
        want = single[f"single_{key}"]
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-7, err_msg=key)


def test_one_rank_mesh_is_bitwise_mesh_none(runs):
    """A process group of one runs its collectives and changes no bit: rf,
    tomography (image and gradient) and prb (the shared generator)."""
    port, single, _, _ = runs
    for key in ("rf_img", "tomo_img", "tomo_grad", "prb_img"):
        want = single[f"single_{key}"]
        for r in range(WORLD):
            np.testing.assert_array_equal(port[r][f"{key}_w1"], want, err_msg=key)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_rf_tiled_sharded_bitmatches_single(runs, backend):
    """order_band=8, spp 2, jittered: the sharded frame is the single
    process's bit for bit. Without jitter it matches JAX's 4-device mesh:
    the fused route within the images' tolerance; the xla route, where
    XLA's FMA contraction and the cancelling q = c - b^2/a part the two
    packages' f32 frames (ROADMAP.md §D, the xla backend), by that route's rule
    (test_torch_rf_tiled_xla.hold_to_jax): the port in f64 within 1e-5 of
    JAX in f64 on the same shortlists, the f32 frame within 1e-5 of JAX's
    or within its bounds on the f64 yardstick."""
    port, single, jx, _ = runs
    img = _same_on_every_rank(port, f"band_{backend}")
    np.testing.assert_array_equal(img, single[f"single_band_{backend}"])
    got = _same_on_every_rank(port, f"band_{backend}_nojit")
    if backend == "fused":
        np.testing.assert_allclose(got, jx["band_fused_nojit"], **IMG_TOL)
    else:
        hold_to_jax(got, jx["band_xla_nojit"], _same_on_every_rank(port, "band_xla_nojit64"),
                    jx["band_xla_nojit64"], 1e-5, "sharded xla frame")


def test_rf_tiled_sharded_gradients_match(runs):
    """The opacity gradients of the mean squared frame (the xla route):
    within rtol 1e-3 of the single process; against JAX's 4-device mesh by
    the xla route's gradient rule (test_torch_rf_tiled_xla_grads.py),
    normalised by JAX's largest gradient: the port in f64 within 1e-4 of
    JAX in f64, the port in f32 within 1e-4 of JAX in f32 or within twice
    JAX's deviation from JAX in f64."""
    port, single, jx, _ = runs
    g = _same_on_every_rank(port, "tiled_grad")
    want = single["single_tiled_grad"]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-8)
    scale = np.abs(jx["tiled_grad"]).max()
    hold_to_jax(g / scale, jx["tiled_grad"] / scale,
                _same_on_every_rank(port, "tiled_grad64") / scale, jx["tiled_grad64"] / scale,
                1e-4, "sharded opacity gradient", max_factor=2.0)


def test_gradient_is_not_w_times(runs):
    """The collectives' backward gives each rank its own block's gradient
    (the tile gather) or passes the film's cotangent through (the film
    sum): summed over the ranks, the gradient is the single process's, not
    W = 4 times it, as torch.distributed.nn.functional's collectives would
    give under a loss that every rank computes on the whole image."""
    port, single, _, _ = runs
    for key in ("tiled_grad", "tomo_grad"):
        g, want = port[0][key].ravel(), single[f"single_{key}"].ravel()
        ratio = float(g @ want) / float(want @ want)
        assert abs(ratio - 1.0) < 1e-3, (key, ratio)


def test_prb_sharded_render_and_grad(runs):
    """Four ranks, each drawing from its own stream: the image mean within
    4 standard errors of the single process's (per-pixel differences), the
    gradients finite and equal on every rank."""
    port, single, _, _ = runs
    img = _same_on_every_rank(port, "prb_img")
    diff = (img - single["single_prb_img"]).mean(axis=-1).ravel()
    assert np.isfinite(img).all() and img.shape == (16, 16, 3)
    assert abs(diff.mean()) <= 4.0 * diff.std() / np.sqrt(diff.size)
    assert not np.array_equal(img, single["single_prb_img"])  # other streams
    g = _same_on_every_rank(port, "prb_grad")
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def test_rf_tiled_compact_and_classes_sharded(runs):
    port, single, jx, _ = runs
    np.testing.assert_array_equal(_same_on_every_rank(port, "compact"),
                                  single["single_compact"])
    np.testing.assert_allclose(_same_on_every_rank(port, "compact_nojit"),
                               jx["compact_nojit"], **IMG_TOL)
    i1, i4 = single["single_classes"], _same_on_every_rank(port, "classes")
    assert np.isfinite(i4).all()
    psnr = -10 * np.log10(max(float(np.mean((i1 - i4) ** 2)), 1e-12))
    assert psnr > 25.0, f"sharded classes PSNR {psnr:.1f}"
    # per-shard classes: the port's four ranks pick JAX's four shards' classes
    np.testing.assert_allclose(_same_on_every_rank(port, "classes_nojit"),
                               jx["classes_nojit"], **IMG_TOL)


def test_batch_sensor_step_matches_single(runs):
    """The dryrun's step: render_batch + rf.radiance -> L1 ->
    sharded_grad_step -> BoundedAdam, with replicated parameters."""
    port, single, _, _ = runs
    assert abs(float(port[0]["batch_loss"]) - float(single["single_batch_loss"])) <= 1e-5
    for k in ("opacities", "sh_coeffs", "centers"):
        g = _same_on_every_rank(port, f"batch_grad_{k}")
        want = single[f"single_batch_grad_{k}"]
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-7 * np.abs(want).max())
        _same_on_every_rank(port, f"batch_param_{k}")
    assert np.abs(port[0]["batch_param_opacities"]
                  - single["single_batch_param_opacities"]).max() <= 1e-6


def test_train_step_on_the_mesh(runs):
    """train.train_step(mesh=): the single process's loss and gradients, and
    parameters equal on every rank after the BoundedAdam step."""
    port, single, _, _ = runs
    assert float(port[0]["train_loss"]) == pytest.approx(float(single["single_train_loss"]),
                                                         rel=1e-6)
    for k in ("opacities", "sh_coeffs"):
        g = _same_on_every_rank(port, f"train_grad_{k}")
        want = single[f"single_train_grad_{k}"]
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-7 * np.abs(want).max())
        np.testing.assert_allclose(_same_on_every_rank(port, f"train_{k}"),
                                   single[f"single_train_{k}"], rtol=1e-6, atol=1e-6)


def test_init_multihost_single_process_fallback(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_multihost() is False
    m = parallel.data_mesh("cpu")
    assert (m.rank, m.size, m.group) == (0, 1, None)


def test_init_multihost_bad_coordinator_is_nonfatal(runs):
    """A coordinator nobody joins: False after about its 5 s timeout."""
    out = runs[3]["unreachable"]
    words = out.split("returned ")[1].split()
    assert words[0] == "False", out
    assert float(words[2]) < 20.0, out


def test_init_multihost_two_process_collective(runs):
    """Two processes join through torchrun's environment variables alone
    and sum over the mesh."""
    logs = runs[3]
    assert "rank0 OK" in logs["env0"] and "rank1 OK" in logs["env1"]
