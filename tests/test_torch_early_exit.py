"""The fused compositor's early-exit walk (``early_exit=True`` without
compaction) against the JAX package's while-loop walk
(volprim_tpu/pallas_kernels/composite3.py:728-747), on the CPU.

Before each segment a tile goes on while some ray of it is under its hit
cap and above log(beta_kill); the tile's beta is the product up to where it
stopped and column 4 of JAX's output counts the segments walked. The inputs
are ``synthetic_tiles`` with every live opacity raised to 0.99, so that
some tiles saturate before their last live segment and others do not. JAX
runs in Pallas interpret mode.

Tolerances are those of test_torch_composite3.py (L and beta within 2e-5 /
2e-4). JAX forms log beta from bf16 hi/lo prefix sums, the port with
torch.cumsum, so a tile whose deciding ray lies within 1e-6 of
log(beta_kill) may stop one segment apart in the two packages: such tiles
are counted (at most one per case) and left out of the comparison of that
case, never dropped silently. The backward walks the whole stream in both
packages, early exit or not (JAX's custom VJP does not pass the flag to its
kernel), and an emitter lights what the stopped tiles' beta leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_composite3 import _to_jax
import test_torch_composite3_bwd as bwd_test
from test_torch_composite3_bwd import _assert_gpf_close, _assert_gsh_close
from volprim_tpu import scene as jscene
from volprim_tpu.ops import envmap as jenv
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu.pallas_kernels import composite3 as jcomp
from volprim_tpu_torch.kernels import composite3 as tcomp
from volprim_tpu_torch.models import rf_tiled as trt
from volprim_tpu_torch.ops import envmap as tenv

T, R, S, SEG = 4, 64, 512, 128
KW = dict(seg=SEG, extent2=9.0, max_depth=128, beta_kill=0.01)
LOG_KILL = float(np.log(np.float32(KW["beta_kill"])))
NEAR_KILL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def saturating_tiles(sh_k, seed):
    """``synthetic_tiles`` with every live column's opacity raised to 0.99."""
    d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(T, R, S, SEG, sh_k, seed=seed)
    pf[:, 12] = torch.where(pf[:, 12] > 0.0, 0.99, 0.0)
    return d8, pf, sh3, n_seg_t


def jax_forward3(d8, pf, sh3, n_seg_t, sh_k, early_exit, compact=False, band=0,
                 max_depth=KW["max_depth"]):
    """JAX's _forward3 in interpret mode: (L, beta, walked, live) as numpy."""
    out = np.asarray(jcomp._forward3(
        *_to_jax(d8, pf, sh3, n_seg_t), SEG, KW["extent2"], max_depth,
        KW["beta_kill"], int(sh_k**0.5) - 1, sh_k, early_exit, True, True, 1, compact,
        False, band,
    ))
    return out[..., :3], out[..., 3], out[:, 0, 4].astype(np.int32), out[:, 0, 5].astype(np.int32)


def near_kill_tiles(*betas):
    """Tiles where, in either package, a ray's beta lies within NEAR_KILL of
    log(beta_kill) in log: the version that stopped there froze its deciding
    ray's beta at that boundary."""
    near = np.zeros(T, bool)
    for b in betas:
        with np.errstate(divide="ignore"):
            near |= (np.abs(np.log(np.asarray(b, np.float64)) - LOG_KILL) <= NEAR_KILL).any(axis=1)
    return near


@pytest.mark.parametrize("band", [0, 8])
@pytest.mark.parametrize("sh_k", [1, 4])  # SH degrees 0 and 1
def test_plain_forward_matches_jax_early_exit(sh_k, band):
    d8, pf, sh3, n_seg_t = saturating_tiles(sh_k, seed=sh_k)
    l_j, b_j, walked_j, live_j = jax_forward3(d8, pf, sh3, n_seg_t, sh_k, True, band=band)
    l_t, b_t, walked_t, live_t = tcomp.forward3(
        d8, pf, sh3, n_seg_t, sh_k=sh_k, order_band=band, early_exit=True, **KW)
    np.testing.assert_array_equal(live_t.numpy(), live_j)
    # some tiles stop before their last live segment, some walk them all
    assert (walked_j < live_j).any() and (walked_j == live_j).any()
    near = near_kill_tiles(b_t.numpy(), b_j)
    print(f"sh_k {sh_k} band {band}: walked {walked_j.tolist()} of {live_j.tolist()}, "
          f"tiles excused near the kill: {int(near.sum())}")
    assert near.sum() <= 1
    keep = ~near
    np.testing.assert_array_equal(walked_t.numpy()[keep], walked_j[keep])
    np.testing.assert_allclose(l_t.numpy()[keep], l_j[keep], atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(b_t.numpy()[keep], b_j[keep], atol=2e-5, rtol=2e-4)
    # beta is the product up to the stop: above the full capped product
    # where a tile stopped early, and L is the full walk's
    l_f, b_f, walked_f, _ = tcomp.forward3(d8, pf, sh3, n_seg_t, sh_k=sh_k, order_band=band,
                                           **KW)
    early = walked_t < live_t
    assert (b_t[early] > b_f[early]).any()
    assert torch.equal(b_t[~early], b_f[~early])
    np.testing.assert_allclose(l_t.numpy(), l_f.numpy(), atol=1e-6)
    assert (walked_f >= walked_t).all()


@pytest.mark.parametrize("sh_k", [1, 4])
def test_compaction_ignores_early_exit(sh_k):
    """With compaction both packages take their plain walk (JAX's compact
    branches come before its while loop): early_exit changes no output."""
    tiles = saturating_tiles(sh_k, seed=sh_k)
    for got, want in zip(jax_forward3(*tiles, sh_k, True, compact=True),
                         jax_forward3(*tiles, sh_k, False, compact=True)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
        tcomp.forward3(*tiles, sh_k=sh_k, compact=True, early_exit=True, **KW),
        tcomp.forward3(*tiles, sh_k=sh_k, compact=True, **KW),
    ):
        assert torch.equal(got, want)


@pytest.mark.parametrize("sh_k", [1, 4])
def test_backward_under_early_exit_matches_jax_vjp(sh_k):
    """A nonzero beta cotangent: JAX's custom VJP walks the whole stream, so
    g_beta reaches segments its forward did not walk; the port's backward
    does the same, and gives the gradients it gives without early exit. The
    inputs, cap and cotangents are test_torch_composite3_bwd.py's (its
    yardstick too); at its cap of 24 hits a tile stops early."""
    kw = dict(KW, max_depth=bwd_test.KW["max_depth"])
    d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(T, R, S, SEG, sh_k, seed=sh_k)
    _, _, walked_j, live_j = jax_forward3(d8, pf, sh3, n_seg_t, sh_k, True,
                                          max_depth=kw["max_depth"])
    assert (walked_j < live_j).any()
    g_l, g_beta = bwd_test._cotangents(sh_k)

    def fwd(pf_, sh_):
        return jcomp.composite_tiles3_ad(
            jnp.asarray(d8.numpy()), pf_, sh_, jnp.asarray(n_seg_t.numpy()), SEG,
            kw["extent2"], kw["max_depth"], kw["beta_kill"], int(sh_k**0.5) - 1, sh_k,
            True, True, True, 1, False,
        )

    _, vjp = jax.vjp(fwd, jnp.asarray(pf.numpy()),
                     jnp.asarray(sh3.float().numpy()).astype(jnp.bfloat16))
    gpf_j, gsh_j = (np.asarray(g, np.float32)
                    for g in vjp((jnp.asarray(g_l.numpy()), jnp.asarray(g_beta.numpy()))))

    def port_grads(early_exit):
        pf_leaf = pf.clone().requires_grad_(True)
        sh_leaf = sh3.clone().requires_grad_(True)
        l, b = tcomp.composite_tiles3(d8, pf_leaf, sh_leaf, n_seg_t, sh_k=sh_k,
                                      early_exit=early_exit, **kw)
        (torch.sum(l * g_l) + torch.sum(b * g_beta)).backward()
        return pf_leaf.grad, sh_leaf.grad

    gpf_t, gsh_t = port_grads(True)
    gpf_0, gsh_0 = port_grads(False)
    assert torch.equal(gpf_t, gpf_0) and torch.equal(gsh_t, gsh_0)
    gpf_64, _ = tcomp.composite_tiles3_bwd_reference(
        d8.double(), pf.double(), sh3, n_seg_t, g_l, g_beta, sh_k=sh_k, **kw)
    assert (np.abs(gpf_j[:, :13]).max(axis=(0, 2)) > 0).all()
    _assert_gpf_close(gpf_t.numpy(), gpf_j, gpf_64.numpy())
    _assert_gsh_close(gsh_t.float().numpy(), gsh_j)


def slab_scene(n=2000, seed=0):
    """An opaque slab of primitives over the left part of the film: whole
    tiles there saturate, the tiles beside it do not."""
    rng = np.random.default_rng(seed)
    f = jscene.EllipsoidsFactory()
    for _ in range(n):
        f.add(mean=rng.uniform([-1.6, -1.6, -0.2], [0.2, 1.6, 0.2]),
              scale=rng.uniform(0.05, 0.12, size=3), euler_deg=rng.uniform(-90, 90, size=3),
              opacities=rng.uniform(0.8, 0.95),
              sh_coeffs=rng.normal(size=3).astype(np.float32) * 0.4)
    return f.build()


def test_fused_frame_with_emitter_under_early_exit_matches_jax(monkeypatch):
    """The fused frame with early_exit and no compaction, lit by a
    ConstantEmitter: the emitter adds beta times its radiance, and beta is
    where each tile stopped, in both packages (within the 1e-5 of
    test_torch_rf_tiled_xla.py's fused frames). Without the early-exit walk
    the port's frame differs: the light behind the stopped tiles."""
    from test_torch_rf_tiled_xla import FRAME, _cameras, _port_scene

    s = slab_scene()
    cam_j, cam_t = _cameras(32, 32)
    emit = (0.3, 0.6, 0.9)
    kw = dict(FRAME, backend="fused", cluster_size=16, early_exit=True, tile_pixels=64,
              max_candidates=1024)
    img_j = np.asarray(jrt.render(
        s, cam_j, jrt.RFTiledConfig(**kw),
        jenv.ConstantEmitter(radiance=jnp.asarray(emit, jnp.float32)), spp=1, seed=0,
        jitter=False))
    walks = []
    orig = tcomp.forward3

    def counting(*a, **k):
        out = orig(*a, **k)
        walks.append((out[2], out[3]))
        return out

    monkeypatch.setattr(tcomp, "forward3", counting)
    ts = _port_scene(s)
    em_t = tenv.ConstantEmitter(radiance=torch.tensor(emit))
    img_t = trt.render(ts, cam_t, trt.RFTiledConfig(**kw), em_t, spp=1, seed=0,
                       jitter=False).numpy()
    [(walked, live)] = walks
    assert (walked < live).any() and (walked == live).any()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01
    assert np.abs(img_t - img_j).max() <= 1e-5
    full = trt.render(ts, cam_t, trt.RFTiledConfig(**dict(kw, early_exit=False)), em_t, spp=1,
                      seed=0, jitter=False).numpy()
    assert np.abs(full - img_j).max() > 1e-4


def test_chip_smoke_bound_counts_the_walked_segments():
    """chip_smoke.fwd_work, the forward's bound on the card: under early
    exit without compaction it counts the pairs and hits of the segments
    the plain version walks, and all the live ones otherwise."""
    import chip_smoke

    d8, pf, sh3, n_seg_t = saturating_tiles(4, seed=4)
    a = (d8, pf, sh3, n_seg_t, SEG, KW["extent2"], KW["max_depth"], KW["beta_kill"], 4, False,
         0, True)
    walked = tcomp._forward3_reference(*a)[2]
    live = n_seg_t.long()
    assert (walked < live).any()
    on, off = chip_smoke.fwd_work(tcomp, a), chip_smoke.fwd_work(tcomp, a[:11] + (False,))
    assert on["pairs"] == int(walked.sum()) * SEG * R
    assert off["pairs"] == int(live.sum()) * SEG * R
    assert on["hits"] < off["hits"] and on["fwd_bound_ms"] < off["fwd_bound_ms"]
    # compaction: the flag changes nothing
    c_on = chip_smoke.fwd_work(tcomp, a[:9] + (True, 0, True))
    c_off = chip_smoke.fwd_work(tcomp, a[:9] + (True, 0, False))
    assert c_on == c_off
