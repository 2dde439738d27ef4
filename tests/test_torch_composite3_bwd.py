"""The port's backward compositor against the JAX custom VJP.

The same numpy-made ``synthetic_tiles`` inputs and cotangents go through
(a) ``jax.vjp`` of ``volprim_tpu.pallas_kernels.composite3.
composite_tiles3_ad`` with the Pallas kernels in interpret mode, (b) the
port's plain backward ``composite_tiles3_bwd_reference`` and (c)
``loss.backward()`` through the port's autograd ``composite_tiles3`` on CPU
tensors, over compaction off and on, SH degrees 0 and 1, tiles with fewer
live segments than S / seg, the hit cap and the beta_kill cutoff, and a
nonzero beta cotangent.

Tolerances. gpf is ill-conditioned in f32, whatever computes it: g_u and
the t* parts of the M rows are adjoints whose exact value is 0 at the
closest approach (q is stationary in t*), so in f32 they are rounding
noise, and g_alpha divides by 1 - alpha (up to 100x here). So both f32
versions are held to the plain backward computed in f64: per row, the
port's largest deviation from it is at most twice the JAX kernel's own,
plus 1e-5 of the row's largest f64 value. gsh is within one bf16 ulp of
its largest value (both round each adjoint to bf16 once, from f32 sums
taken in different orders). The plain versions against torch.autograd are
compared in f64, where the two agree to 1e-9 of each tile's largest
adjoint. Last, the comparator chip_smoke.py holds the CUDA kernel with is
shown to pass the JAX kernel's gradients and to fail wrong ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.pallas_kernels import composite3 as jcomp
from volprim_tpu_torch.kernels import composite3 as tcomp

T, R, S, SEG = 4, 64, 512, 128
KW = dict(seg=SEG, extent2=9.0, max_depth=24, beta_kill=0.01)


def _cotangents(seed):
    rng = np.random.default_rng(seed)
    g_l = rng.normal(0.0, 1.0, (T, R, 3)).astype(np.float32)
    g_beta = rng.normal(0.0, 1.0, (T, R)).astype(np.float32)
    return torch.from_numpy(g_l), torch.from_numpy(g_beta)


def _jax_vjp(d8, pf, sh3, n_seg_t, g_l, g_beta, sh_k, compact):
    def fwd(pf_, sh_):
        return jcomp.composite_tiles3_ad(
            jnp.asarray(d8.numpy()), pf_, sh_, jnp.asarray(n_seg_t.numpy()),
            KW["seg"], KW["extent2"], KW["max_depth"], KW["beta_kill"],
            int(sh_k**0.5) - 1, sh_k, False, True, True, 1, compact,
        )

    _, vjp = jax.vjp(
        fwd, jnp.asarray(pf.numpy()),
        jnp.asarray(sh3.float().numpy()).astype(jnp.bfloat16),
    )
    gpf, gsh = vjp((jnp.asarray(g_l.numpy()), jnp.asarray(g_beta.numpy())))
    return np.asarray(gpf), np.asarray(gsh.astype(jnp.float32))


def _assert_gpf_close(got, want, yardstick):
    """Per row of gpf, ``got`` deviates from the f64 ``yardstick`` by at
    most twice what ``want`` (the JAX kernel) does, plus 1e-5 of the row's
    largest yardstick value."""
    err_got = np.max(np.abs(got - yardstick), axis=(0, 2))
    err_want = np.max(np.abs(want - yardstick), axis=(0, 2))
    scale = np.max(np.abs(yardstick), axis=(0, 2))
    print("gpf rows: port err", err_got, "JAX err", err_want, "scale", scale)
    assert np.all(err_got <= 2.0 * err_want + 1e-5 * scale)


def _assert_gsh_close(got, want):
    top = np.max(np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)  # one bf16 ulp of the largest
    diff = np.max(np.abs(got - want))
    assert diff <= ulp, f"gsh: max diff {diff:.3g} > one bf16 ulp {ulp:.3g}"


@pytest.mark.parametrize("sh_k", [1, 4])  # SH degrees 0 and 1
@pytest.mark.parametrize("compact", [False, True])
def test_backward_matches_jax_vjp(compact, sh_k):
    d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(T, R, S, SEG, sh_k, seed=sh_k)
    assert (n_seg_t < S // SEG).any() and (n_seg_t == S // SEG).any()
    g_l, g_beta = _cotangents(sh_k)
    # the inputs exercise the cap and the kill
    _, beta = tcomp.composite_tiles3_reference(d8, pf, sh3, n_seg_t, sh_k=sh_k, **KW)
    assert (beta < 0.01).any() and (beta > 0.5).any()

    gpf_j, gsh_j = _jax_vjp(d8, pf, sh3, n_seg_t, g_l, g_beta, sh_k, compact)
    gpf_b, gsh_b = tcomp.composite_tiles3_bwd_reference(
        d8, pf, sh3, n_seg_t, g_l, g_beta, sh_k=sh_k, **KW
    )
    assert gpf_b.dtype == torch.float32 and gsh_b.dtype == torch.bfloat16
    assert np.isfinite(gpf_b.numpy()).all()
    # every live row carries gradient; rows 13-15 (c0, radius, key) do not
    assert (np.abs(gpf_j[:, :13]).max(axis=(0, 2)) > 0).all()
    assert not gpf_b[:, 13:].any()
    gpf_64, _ = tcomp.composite_tiles3_bwd_reference(
        d8.double(), pf.double(), sh3, n_seg_t, g_l, g_beta, sh_k=sh_k, **KW
    )
    _assert_gpf_close(gpf_b.numpy(), gpf_j, gpf_64.numpy())
    _assert_gsh_close(gsh_b.float().numpy(), gsh_j)

    # (c) autograd through the wrapper: the same function on CPU tensors
    pf_leaf = pf.clone().requires_grad_(True)
    sh_leaf = sh3.clone().requires_grad_(True)
    l, b = tcomp.composite_tiles3(
        d8, pf_leaf, sh_leaf, n_seg_t, sh_k=sh_k, compact=compact, **KW
    )
    (torch.sum(l * g_l) + torch.sum(b * g_beta)).backward()
    gpf_c, gsh_c = tcomp.composite_tiles3_bwd_reference(
        d8, pf, sh3, n_seg_t, g_l, g_beta, sh_k=sh_k, compact=compact, **KW
    )
    assert torch.equal(pf_leaf.grad, gpf_c)
    assert torch.equal(sh_leaf.grad, gsh_c)


@pytest.mark.parametrize("sh_k", [1, 4])
def test_backward_matches_autograd_of_forward(sh_k):
    """The plain backward against torch.autograd through the plain forward,
    for gpf, both in f64: the same math, apart from the SH basis rounding,
    which only gsh sees."""
    d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(T, R, S, SEG, sh_k, seed=sh_k + 1)
    g_l, g_beta = _cotangents(100 + sh_k)
    f64 = torch.float64
    pf_leaf = pf.to(f64).requires_grad_(True)
    l, b = tcomp.composite_tiles3_reference(d8, pf_leaf, sh3, n_seg_t, sh_k=sh_k, **KW)
    (torch.sum(l * g_l) + torch.sum(b * g_beta)).backward()
    gpf_b, _ = tcomp.composite_tiles3_bwd_reference(
        d8.to(f64), pf.to(f64), sh3, n_seg_t, g_l, g_beta, sh_k=sh_k, **KW
    )
    want = pf_leaf.grad.numpy()
    # autograd also reaches rows 13-15 (c0, radius, key), which the pair
    # math does not read: zero there in both
    assert not want[:, 13:].any() and not gpf_b[:, 13:].any()
    scale = np.max(np.abs(want), axis=(1, 2), keepdims=True)  # per tile
    assert np.all(np.abs(gpf_b.numpy() - want) <= 1e-9 * scale)


def test_unused_beta_is_a_zero_cotangent():
    d8, pf, sh3, n_seg_t = tcomp.synthetic_tiles(2, 32, 256, 128, 4, seed=7)
    g_l, _ = _cotangents(3)
    g_l = g_l[:2, :32]
    pf_leaf = pf.clone().requires_grad_(True)
    l, _ = tcomp.composite_tiles3(d8, pf_leaf, sh3, n_seg_t, seg=128, sh_k=4)
    torch.sum(l * g_l).backward()
    want, _ = tcomp.composite_tiles3_bwd_reference(
        d8, pf, sh3, n_seg_t, g_l, torch.zeros((2, 32)), seg=128, sh_k=4
    )
    assert torch.equal(pf_leaf.grad, want)


@pytest.fixture(scope="module")
def comparator_case():
    """Inputs, cotangents and the plain backward in f32 and f64 for the
    chip_smoke.py comparator tests (k = 4, so the SH basis is not 1)."""
    inputs = tcomp.synthetic_tiles(T, R, S, SEG, 4, seed=11)
    cot = _cotangents(11)
    plain = tcomp.composite_tiles3_bwd_reference(*inputs, *cot, sh_k=4, **KW)
    d8, pf, sh3, n_seg_t = inputs
    yard, _ = tcomp.composite_tiles3_bwd_reference(
        d8.double(), pf.double(), sh3, n_seg_t, *cot, sh_k=4, **KW
    )
    return inputs, cot, plain, yard


def _one_ray_dropped(inputs, cot):
    g_l, g_beta = (c.clone() for c in cot)
    g_l[1, 7], g_beta[1, 7] = 0.0, 0.0
    return tcomp.composite_tiles3_bwd_reference(*inputs, g_l, g_beta, sh_k=4, **KW)


def _bf16_basis_in_sh_adjoint(inputs, cot, monkeypatch):
    ray_terms = tcomp._ray_terms

    def rounded(d8, sh_k, sh_dtype):
        d3, f6, _, basis = ray_terms(d8, sh_k, sh_dtype)
        return d3, f6, basis, basis

    monkeypatch.setattr(tcomp, "_ray_terms", rounded)
    return tcomp.composite_tiles3_bwd_reference(*inputs, *cot, sh_k=4, **KW)


@pytest.mark.parametrize(
    "kernel", ["jax_vjp", "one_ray_dropped", "relative_1e-4", "bf16_basis_in_sh"]
)
def test_chip_comparator_passes_jax_and_fails_a_wrong_kernel(
    kernel, comparator_case, monkeypatch
):
    """chip_smoke.compare_grads, which holds the CUDA backward kernel to
    its plain version on the card, accepts another correct f32
    implementation (the JAX kernel) and rejects a kernel that drops one
    ray of 256 in one tile, one off by 1e-4 relative, or one that takes
    the bf16 basis in the SH adjoint."""
    import chip_smoke

    inputs, cot, plain, yard = comparator_case
    if kernel == "jax_vjp":
        got = tuple(torch.from_numpy(np.array(g)) for g in _jax_vjp(*inputs, *cot, 4, True))
    elif kernel == "one_ray_dropped":
        got = _one_ray_dropped(inputs, cot)
    elif kernel == "relative_1e-4":
        got = (plain[0] * (1.0 + 1e-4), plain[1])
    else:
        got = _bf16_basis_in_sh_adjoint(inputs, cot, monkeypatch)
    result = chip_smoke.compare_grads(got, plain, yard)
    print(kernel, result["gpf"]["elements_outside_band"], result["gsh"])
    assert result["ok"] == (kernel == "jax_vjp")
