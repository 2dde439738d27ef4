"""The port's fused compositor (volprim_tpu_torch.kernels.composite3)
against volprim_tpu.pallas_kernels.composite3 on the same numpy-made
inputs; the JAX kernel runs in Pallas interpret mode on the CPU.

L and beta agree within atol 2e-5 / rtol 2e-4: the JAX kernel builds its
prefix sums from bf16 hi/lo parts with triangular matmuls and moves
compacted columns through a bf16x3 one-hot product (~2^-24 relative), while
the plain version sums with torch.cumsum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.pallas_kernels import composite3 as jcomp
from volprim_tpu.scene import EllipsoidScene as JScene
from volprim_tpu_torch import interop
from volprim_tpu_torch.kernels import composite3 as tcomp

T, R, S, SEG = 4, 64, 512, 128


def _to_jax(d8, pf, sh3, n_seg_t):
    return (
        jnp.asarray(d8.numpy()), jnp.asarray(pf.numpy()),
        jnp.asarray(sh3.float().numpy()).astype(sh3_jax_dtype(sh3)),
        jnp.asarray(n_seg_t.numpy()),
    )


def sh3_jax_dtype(sh3):
    return jnp.bfloat16 if sh3.dtype == torch.bfloat16 else jnp.float32


def test_pack_fused_features_matches_jax():
    rng = np.random.default_rng(0)
    n = 500
    arrays = dict(
        centers=rng.normal(0.0, 1.0, (n, 3)), scales=rng.uniform(0.01, 0.2, (n, 3)),
        quats=rng.normal(size=(n, 4)),
    )
    arrays["quats"] /= np.linalg.norm(arrays["quats"], axis=1, keepdims=True)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    opac = rng.uniform(0.1, 1.0, (n, 1)).astype(np.float32)
    origin = np.asarray([0.1, 0.4, -3.2], np.float32)
    js = JScene(
        centers=jnp.asarray(arrays["centers"]), scales=jnp.asarray(arrays["scales"]),
        quats=jnp.asarray(arrays["quats"]), attrs={"opacities": jnp.asarray(opac)},
    )
    ts = interop.scene_from_arrays(
        arrays["centers"], arrays["scales"], arrays["quats"], {"opacities": opac},
        3.0, device="cpu",
    )
    pj = np.asarray(jcomp.pack_fused_features(js, jnp.asarray(origin)))
    pt = tcomp.pack_fused_features(ts, torch.from_numpy(origin)).numpy()
    assert pt.shape == (16, n)
    # per-row absolute floor at 1e-6 of the row's scale: off-diagonal M
    # entries pass through zero
    floor = 1e-6 * np.max(np.abs(pj), axis=1, keepdims=True)
    assert np.all(np.abs(pt - pj) <= 1e-5 * np.abs(pj) + floor)
    np.testing.assert_array_equal(
        tcomp.neutral_fused_row().numpy(), np.asarray(jcomp.neutral_fused_row())
    )


@pytest.mark.parametrize("sh_k", [1, 4])  # SH degrees 0 and 1
@pytest.mark.parametrize("compact", [False, True])
def test_plain_compositor_matches_jax_kernel(compact, sh_k):
    d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(T, R, S, SEG, sh_k, seed=sh_k)
    assert (n_seg_t < S // SEG).any() and (n_seg_t == S // SEG).any()
    kw = dict(seg=SEG, extent2=9.0, max_depth=24, beta_kill=0.01)
    l_t, b_t = tcomp.composite_tiles3_reference(d8, pf, sh3, n_seg_t, sh_k=sh_k, **kw)
    # early_exit=False: the JAX while-loop walk stops once every ray of a
    # tile is below beta_kill and then returns a partial beta; the port (and
    # the JAX compacted walk) always returns the full capped product
    l_j, b_j = jcomp.composite_tiles3(
        *_to_jax(d8, pf, sh3, n_seg_t), degree=int(sh_k**0.5) - 1, sh_k=sh_k,
        early_exit=False, interpret=True, compact=compact, **kw,
    )
    l_j, b_j = np.asarray(l_j), np.asarray(b_j)
    # the inputs exercise hits, the kill and the hit cap
    assert (b_j < 0.01).any() and (b_j > 0.5).any()
    uncapped = tcomp.composite_tiles3_reference(
        d8, pf, sh3, n_seg_t, sh_k=sh_k, **{**kw, "max_depth": 10**6}
    )[1]
    assert not torch.allclose(uncapped, b_t)
    assert np.isfinite(l_t.numpy()).all()
    np.testing.assert_allclose(l_t.numpy(), l_j, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(b_t.numpy(), b_j, atol=2e-5, rtol=2e-4)


def test_wrapper_takes_plain_version_on_cpu_and_refuses_grad():
    """CPU tensors take the plain versions. The wrapper refuses a gradient
    to the ray directions d8 (the JAX custom VJP gives them zeros) and
    differentiates pf and sh3."""
    d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(2, 32, 256, 128, 4, seed=7)
    before = (tcomp.composite_tiles3.launches, tcomp.composite_tiles3_bwd.launches)
    got = tcomp.composite_tiles3(d8, pf, sh3, n_seg_t, seg=128, sh_k=4, compact=True)
    want = tcomp.composite_tiles3_reference(d8, pf, sh3, n_seg_t, seg=128, sh_k=4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    d8_leaf = d8.clone().requires_grad_(True)
    pf_leaf = pf.clone().requires_grad_(True)
    l, _ = tcomp.composite_tiles3(d8_leaf, pf_leaf, sh3, n_seg_t, seg=128, sh_k=4)
    l.sum().backward()
    assert d8_leaf.grad is None
    assert pf_leaf.grad is not None and pf_leaf.grad.abs().max() > 0
    # the counts are of kernel launches only
    assert (tcomp.composite_tiles3.launches, tcomp.composite_tiles3_bwd.launches) == before


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library is rebuilt when a csrc header its source includes changes,
    not only when the .cu file does."""
    from volprim_tpu_torch.kernels import _build

    for name in ("composite3_fwd.cu", "composite3_bwd.cu", "composite3_common.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert [p.name for p in _build._sources("composite3_bwd")] == [
        "composite3_bwd.cu", "composite3_common.cuh",
    ]
    before = {n: _build.library_path(n) for n in ("composite3_fwd", "composite3_bwd")}
    header = tmp_path / "composite3_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)


@pytest.mark.parametrize("launch", ["_launch", "_launch_bwd"])
def test_kernel_wrappers_refuse_more_than_1024_rays(launch):
    """One thread per ray: the kernels take R <= 1024, and their wrappers
    refuse more with a clear error before touching a library."""
    d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(1, 1056, 256, 128, 1, seed=3)
    extra = ()
    if launch == "_launch_bwd":
        extra = (torch.zeros((1, 1056, 3)), torch.zeros((1, 1056)))
    with pytest.raises(ValueError, match="R <= 1024"):
        getattr(tcomp, launch)(d8, pf, sh3, n_seg_t, *extra, 128, 9.0, 128, 0.01, 1, False)
