"""The v1 / v2 forward compositors' contracts, seen from the CPU.

The forward kernels (csrc/composite12_fwd.cuh) walk only the columns of
opacity > 0, compacted in stream order: a column of opacity <= 0 gives
alpha <= 0 at every hit, so it touches neither the hit count, nor log beta,
nor L. Here, on the plain versions and the JAX kernels:

- the fact the skip rests on: the plain forward on the inputs with those
  columns removed (order kept, the tail refilled with neutral opacity-0
  rows to a segment multiple) equals the plain forward on the full inputs
  within 1e-6, v1 and v2, at max_depth 128 and 8, with such columns
  scattered among the others inside the capped region;
- the compacted inputs still match the JAX kernels in interpret mode, at
  tests/test_torch_composite.py's forward tolerance (atol 1e-4, rtol
  1e-3);
- ``chip_smoke.work12`` counts the forward's pairs on columns of opacity
  > 0 only, on a small hand-made tile with interleaved opacity-0 columns
  and a padding tail;
- ``chip_smoke.fwd12_cases``, the card's synthetic tile sets, cover every
  block size at k = 4, k = 1, 9 and 16, and (v1) blocks of one launch
  whose live SH counts differ;
- ``chip_smoke.ptxas_table`` reads the forward's instantiations
  (``fwd12_kernel<version, k, threads>``) and ``chip_smoke.spill_gated``
  gates v1's (one build per block size) and v2's k = 4 ones at 256 and
  512 threads; the ctypes argument types of ``composite_fwd`` and
  ``composite2_fwd`` follow their C declarations.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_composite import ORIGIN, kw, t_, tile_inputs, v1_args
from test_torch_composite2 import _jax, v2_args
from volprim_tpu.pallas_kernels import composite as jcomp
from volprim_tpu.pallas_kernels import composite2 as jcomp2
from volprim_tpu_torch.kernels import composite as tcomp
from volprim_tpu_torch.kernels import composite2 as tcomp2

SEG = kw(0)["seg"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: torch's thread pool only slows them under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zeroed(seed):
    """tile_inputs of 512 columns with 45% of the real ones at opacity 0,
    scattered among the others (before and after where max_depth 8 caps
    the rays)."""
    x = tile_inputs(seed, s=512)
    rng = np.random.default_rng(seed + 7)
    real = x["opac"] > 0.0
    x["opac"][real & (rng.uniform(size=x["opac"].shape) < 0.45)] = 0.0
    return x


def _compacted(args, opac, neutral):
    """The [T, S, ...] column tables of ``args`` with the columns of
    ``opac`` <= 0 removed per tile, in order, and the tail refilled with
    ``neutral`` (per table: its fill row) to a multiple of SEG."""
    keep = opac > 0.0  # [T, S]
    n = int(keep.sum(axis=1).max())
    s = -(-n // SEG) * SEG
    out = []
    for table, fill in zip(args, neutral):
        if table is None:
            out.append(None)
            continue
        col_axis = 2 if table.ndim == 3 and table.shape[1] in (1, 2) else 1
        t_major = np.moveaxis(table, col_axis, 1)  # [T, S, ...]
        new = np.broadcast_to(fill, (t_major.shape[0], s) + t_major.shape[2:]).copy()
        for t in range(t_major.shape[0]):
            kept = t_major[t][keep[t]]
            new[t, :len(kept)] = kept
        out.append(np.ascontiguousarray(np.moveaxis(new, 1, col_axis)))
    return out


def _v1_pair(seed):
    x = _zeroed(seed)
    full = v1_args(x)
    fa, fb, fc, basis, pf, opac, sh3 = full
    neutral_pf = np.zeros(16, np.float32)
    neutral_pf[:3] = 1.0
    pf_c, op_c, sh_c = _compacted([pf, opac, sh3], x["opac"],
                                  [neutral_pf, np.zeros(1, np.float32), np.zeros(48, np.float32)])
    return full, [fa, fb, fc, basis, pf_c, op_c, sh_c]


def _v2_pair(seed):
    x = _zeroed(seed)
    full = v2_args(x)
    d8, pf, aux, sh3 = full
    o = torch.tensor(ORIGIN, dtype=torch.float32)
    pf_c, aux_c, sh_c = _compacted(
        [pf, aux, sh3], x["opac"],
        [tcomp2.neutral_row(o).numpy(), np.array([0.0, float((o * o).sum())], np.float32),
         np.zeros(48, np.float32)])
    return full, [d8, pf_c, aux_c, sh_c]


@pytest.mark.parametrize("max_depth", [128, 8])
@pytest.mark.parametrize("version", [1, 2])
def test_dropping_opacity_zero_columns_keeps_the_plain_forward(version, max_depth):
    full, comp = (_v1_pair if version == 1 else _v2_pair)(40 + max_depth)
    k = dict(kw(max_depth), **({} if version == 1 else {"sh_k": 4}))
    ref = tcomp.composite_tiles_reference if version == 1 else tcomp2.composite_tiles2_reference
    l_f, b_f = ref(*map(t_, full), **k)
    l_c, b_c = ref(*map(t_, comp), **k)
    assert comp[-1].shape[1] < full[-1].shape[1]  # whole segments went
    if max_depth == 8:  # the cap decides
        l_u, _ = ref(*map(t_, full), **dict(k, max_depth=10**6))
        assert float((l_u - l_f).abs().max()) > 1e-3
    np.testing.assert_allclose(l_c.numpy(), l_f.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(b_c.numpy(), b_f.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("max_depth", [128, 8])
@pytest.mark.parametrize("version", [1, 2])
def test_compacted_inputs_match_jax(version, max_depth):
    _, comp = (_v1_pair if version == 1 else _v2_pair)(50 + max_depth)
    if version == 1:
        l_j, b_j = jcomp.composite_tiles(*map(jnp.asarray, comp), interpret=True,
                                         **kw(max_depth))
        l_t, b_t = tcomp.composite_tiles(*map(t_, comp), **kw(max_depth))
    else:
        l_j, b_j = jcomp2.composite_tiles2(*map(jnp.asarray, comp), *_jax(4, max_depth))
        l_t, b_t = tcomp2.composite_tiles2(*map(t_, comp), sh_k=4, **kw(max_depth))
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-4, rtol=1e-3)


def test_work12_counts_forward_pairs_on_opaque_columns_only():
    # one hand-made tile of 8 rays and 32 columns in segments of 16:
    # columns 2, 5, 6 and 11 at opacity 0 among the others, 24-31 padding
    x = tile_inputs(94, t=1, r=8, s=32)
    zero = [2, 5, 6, 11] + list(range(24, 32))
    x["opac"][:, zero] = 0.0
    x["pf"][:, 24:] = 0.0
    x["pf"][:, 24:, :3] = 1.0
    tensors = list(map(t_, v1_args(x)))
    k = dict(kw(3), seg=16)
    w = chip_smoke.work12(chip_smoke.V12Api("pallas"), tensors, k)
    fa, fb, fc, _, pf, opac, _ = tensors
    a, b, c = (tcomp.dot_in_order(f[:, :, None, :], pf[:, None, :, :], 10) for f in (fa, fb, fc))
    _, hit, _, _, alpha0 = (np.asarray(v) for v in tcomp.pair_terms(a, b, c, opac, k["extent2"]))
    op = opac[0, 0].numpy()
    pairs = pairs_fwd = hits_alpha = 0
    entered = [False, False]
    for r in range(8):
        count = 0
        for col in range(32):
            entered[col // 16] |= count <= k["max_depth"]
            pairs += 1
            pairs_fwd += op[col] > 0
            if hit[0, r, col] and alpha0[0, r, col] > 0:
                count += 1
                if count > k["max_depth"]:
                    break
                hits_alpha += 1
    opaque = sum(int((op[si * 16:(si + 1) * 16] > 0).sum()) for si in range(2) if entered[si])
    assert (w["pairs"], w["pairs_fwd"], w["hits_alpha"]) == (pairs, pairs_fwd, hits_alpha)
    assert pairs < 8 * 32 and 0 < pairs_fwd < pairs and hits_alpha  # the cap binds
    assert w["live_columns_opaque"] == opaque
    assert w["fwd_ops"] == pairs_fwd * chip_smoke.OPS_PAIR12["pallas"] + hits_alpha * (17 + 6 * 4)
    col_bytes = (10 + 1) * 4 + 3 * 4 * 4
    assert w["fwd_bytes"] == (8 * (30 + 4) * 4 + w["live_columns"] * 4
                              + opaque * (col_bytes - 4) + 8 * 4 * 4)


@pytest.mark.parametrize("backend", ["pallas", "pallas2"])
def test_fwd12_cases_cover_every_sh_width_and_blocks_of_differing_live_counts(backend):
    api = chip_smoke.V12Api(backend)
    cases = list(chip_smoke.fwd12_cases(backend, "cpu"))
    labels = [label for label, _, _ in cases]
    assert len(set(labels)) == len(labels)
    got = {(x[0].shape[1], api.sh_k(x, k), k["max_depth"]) for _, x, k in cases}
    assert got == ({(r, 4, md) for r in (256, 512, 1024) for md in (128, 8)}
                   | {(256, k, md) for k in (1, 9, 16) for md in (128, 8)})
    mixed = [x for label, x, _ in cases if "mixed" in label]
    assert len(mixed) == (2 if backend == "pallas" else 0)
    for x in mixed:
        # v1's blocks find one past their last live basis column: 16, 9, 4, 1
        nonzero = (x[3] != 0).any(dim=1)  # [T, 16]
        last = [int(torch.nonzero(row).max()) + 1 for row in nonzero]
        assert last == [(16, 9, 4, 1)[t % 4] for t in range(x[3].shape[0])]


def _entry(v, k, nt, spill):
    name = f"_ZN11composite1212fwd12_kernelILi{v}ELi{k}ELi{nt}EEEvNS_4ArgsE"
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used 80 registers, used 1 barriers\n")


def test_ptxas_table_reads_the_v12_forward_instantiations():
    cases = [(1, 16, 256, 0), (1, 16, 512, 0), (1, 16, 1024, 96), (2, 1, 256, 0),
             (2, 4, 256, 0), (2, 4, 512, 4), (2, 4, 1024, 0), (2, 16, 512, 0)]
    table = chip_smoke.ptxas_table("".join(_entry(*c) for c in cases))
    assert [(r["kernel"], r["args"], r["spill_stores"], r["registers"]) for r in table] == [
        ("fwd12_kernel", [v, k, nt], s, 80) for v, k, nt, s in cases]
    gated = [r["args"] for r in table
             if chip_smoke.spill_gated("composite_fwd" if r["args"][0] == 1 else "composite2_fwd", r)]
    assert gated == [[1, 16, 256], [1, 16, 512], [2, 4, 256], [2, 4, 512]]


CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}


@pytest.mark.parametrize("entry,args", [("composite_fwd", (9,)), ("composite2_fwd", (6, 5))])
def test_argtypes_follow_the_c_declarations(entry, args):
    src = (Path(tcomp.__file__).resolve().parent.parent / "csrc" / f"{entry}.cu").read_text()
    decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src).group(1)
    types = [re.sub(r"\s*\w+$", "", a.strip()).replace(" *", "*") for a in decl.split(",")]
    assert [CTYPE[t] for t in types] == tcomp.argtypes(*args)
