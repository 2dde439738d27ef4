"""The profiler's DMA-floor probe (``volprim_tpu_torch.kernels.clone``)
against the JAX probe of tools/profile_rf.py.

The JAX probe is a Pallas kernel defined inside the tool's ``main``; the
test runs a copy of its lines (tools/profile_rf.py:405-438) in Pallas
interpret mode and checks that the copy still stands verbatim in the tool,
so it cannot drift. The port's plain version must equal it exactly on
numpy-made tile blocks (f32 sums in the same order), at the profiler's
block shapes cut to test size. The wrapper's input checks run before any
library is loaded, so they are tested here too.
"""

import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu_torch.kernels import clone as tclone

# tools/profile_rf.py:405-438, verbatim but dedented (the probe's kernel and
# its call)
_JAX_CLONE = '''
def _ckern(ns_ref, d_ref, pf_ref, sh_ref, ut_ref, o_ref):
    v = (
        ns_ref[0, pl.program_id(0)].astype(jnp.float32)
        + d_ref[0, 0, 0]
        + pf_ref[0, 0, 0]
        + sh_ref[0, 0:1, 0:128].astype(jnp.float32)[0, 0]
        + ut_ref[0, 0]
    )
    o_ref[...] = jnp.zeros(o_ref.shape, jnp.float32) + v

def clone(seed, d8, pf_t, sh_t, n_seg_t):
    t = pf_t.shape[0]
    seg = cfg.segment
    y = pl.pallas_call(
        _ckern,
        grid=(t,),
        in_specs=[
            pl.BlockSpec((1, t), lambda i: (0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((1, 8, d8.shape[2]), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, 16, pf_t.shape[2]),
                         lambda i: (i, 0, 0)),
            pl.BlockSpec((1, sh_t.shape[1], sh_t.shape[2]),
                         lambda i: (i, 0, 0)),
            pl.BlockSpec((seg, seg), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec(
            (1, d8.shape[2], 8), lambda i: (i, 0, 0)
        ),
        out_shape=jax.ShapeDtypeStruct(
            (t, d8.shape[2], 8), jnp.float32
        ),
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=100 * 1024 * 1024,
        ),
'''


def _jax_clone():
    """The copied JAX probe, compiled for interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    class _Cfg:
        segment = 128

    ns = {"pl": pl, "pltpu": pltpu, "jnp": jnp, "jax": jax, "cfg": _Cfg}
    # run in interpret mode: the copy's pallas_call gets interpret=True
    exec(_JAX_CLONE + "        interpret=True,\n    )(\n"
         "        n_seg_t.astype(jnp.int32).reshape(1, t),\n"
         "        d8 + seed.astype(jnp.float32) * 1e-12, pf_t, sh_t,\n"
         "        jnp.triu(jnp.ones((seg, seg), jnp.float32)),\n    )\n"
         "    return y\n", ns)
    return ns["clone"]


def test_copy_of_the_jax_probe_is_verbatim():
    src = (Path(__file__).resolve().parent.parent / "tools" / "profile_rf.py").read_text()
    assert inspect.cleandoc(_JAX_CLONE) in inspect.cleandoc(
        "\n".join(line[8:] for line in src.splitlines())
    )


@pytest.mark.parametrize("t, r, s, k", [(6, 64, 256, 12), (3, 256, 512, 3)])
def test_clone_reference_matches_jax_probe(t, r, s, k):
    rng = np.random.default_rng(t)
    n_seg_t = rng.integers(0, 3, t).astype(np.int32)
    d8 = rng.normal(size=(t, 8, r)).astype(np.float32)
    pf = rng.normal(size=(t, 16, s)).astype(np.float32)
    sh = rng.normal(size=(t, k, s)).astype(np.float32)
    want = np.asarray(_jax_clone()(jnp.int32(0), jnp.asarray(d8), jnp.asarray(pf),
                                  jnp.asarray(sh).astype(jnp.bfloat16), jnp.asarray(n_seg_t)))
    ut = torch.triu(torch.ones((128, 128)))
    got = tclone.clone(torch.from_numpy(n_seg_t), torch.from_numpy(d8), torch.from_numpy(pf),
                       torch.from_numpy(sh).to(torch.bfloat16), ut)
    assert got.shape == (t, r, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tclone.clone.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("bad", ["S", "dtype", "rows"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The CUDA wrapper's checks (before any library is loaded): S a multiple
    of 8 (whole 16-byte copies), bf16 SH, d8 of 8 rows."""
    t, r, s = 2, 32, 256 if bad != "S" else 252
    args = [torch.zeros(t, dtype=torch.int32), torch.zeros((t, 8 if bad != "rows" else 7, r)),
            torch.zeros((t, 16, s)),
            torch.zeros((t, 12, s), dtype=torch.float32 if bad == "dtype" else torch.bfloat16),
            torch.ones((128, 128))]
    with pytest.raises((ValueError, TypeError)):
        tclone._launch(*args)
