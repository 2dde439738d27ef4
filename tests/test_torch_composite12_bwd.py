"""The v1 / v2 backward compositors' contracts, seen from the CPU.

- The ctypes argument types of ``composite_bwd`` and ``composite2_bwd``
  follow their C declarations in csrc/, argument for argument.
- ``chip_smoke.ptxas_table`` reads the backward kernel's instantiations
  (``bwd12_kernel<version, k, threads>``) and ``chip_smoke.spill_gated``
  selects those that must not spill (k = 4 at 256 and 512 threads).
- The zero-opacity identity the kernels rest on, on the plain versions: a
  column of opacity 0 has alpha 0 for every ray, so its feature, SH and
  c0 adjoints are exactly 0, and its opacity adjoint is the sum of g_raw
  dens over its hits under the cap (held to autograd through the plain
  forward in f64); the whole result still matches ``jax.vjp`` of the JAX
  kernel in interpret mode within the tolerances of
  tests/test_torch_composite.py and test_torch_composite2.py.
- ``chip_smoke.work12`` counts pairs and hits under the cap (alpha > 0 and
  alpha = 0 apart) as a walk of ``composite.pair_terms`` ray by ray does.
- ``chip_smoke.band_check``'s KILL_FLIP allowance: a ray whose weight lies
  on log(beta_kill) in the plain version's run and is taken alive by the
  other version is excused and counted; a 1e-3 error or a zeroed tile in
  another tile still fails.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_composite import (
    assert_grads_close, jax_vjp, kw, rows, t_, tile_inputs, v1_args,
)
from test_torch_composite2 import jax_vjp as jax_vjp2
from test_torch_composite2 import rows as rows2
from test_torch_composite2 import v2_args
from volprim_tpu_torch.kernels import composite as tcomp
from volprim_tpu_torch.kernels import composite2 as tcomp2
from volprim_tpu_torch.kernels import composite_vjp as tvjp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: torch's thread pool only slows them under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}


@pytest.mark.parametrize("entry,module", [("composite_bwd", tvjp), ("composite2_bwd", tcomp2)])
def test_argtypes_follow_the_c_declarations(entry, module):
    src = (Path(tcomp.__file__).resolve().parent.parent / "csrc" / f"{entry}.cu").read_text()
    decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src).group(1)
    types = [re.sub(r"\s*\w+$", "", a.strip()).replace(" *", "*") for a in decl.split(",")]
    assert [CTYPE[t] for t in types] == module._BWD_ARGTYPES


def _entry(v, k, nt, spill):
    name = f"_ZN11composite1212bwd12_kernelILi{v}ELi{k}ELi{nt}EEEvNS_4ArgsE"
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used 128 registers, used 1 barriers\n")


def test_ptxas_table_reads_the_v12_backward_instantiations():
    cases = [(1, 4, 256, 0), (1, 4, 512, 8), (1, 4, 1024, 200), (1, 16, 256, 120),
             (2, 4, 256, 0), (2, 4, 512, 0), (2, 9, 512, 0)]
    table = chip_smoke.ptxas_table("".join(_entry(*c) for c in cases))
    assert [(r["kernel"], r["args"], r["spill_stores"]) for r in table] == [
        ("bwd12_kernel", [v, k, nt], s) for v, k, nt, s in cases]
    gated = [r["args"] for r in table
             if chip_smoke.spill_gated("composite_bwd" if r["args"][0] == 1 else "composite2_bwd", r)]
    assert gated == [[1, 4, 256], [1, 4, 512], [2, 4, 256], [2, 4, 512]]
    # the v3 gate is as before: unbanded k = 4 at 256 / 512 threads, path sources only
    v3 = chip_smoke.ptxas_table(
        "ptxas info    : Compiling entry function "
        "'_ZN10composite311fwd3_kernelILi4ELb0ELi512ELi0EEEvPKfS2_' for 'sm_90a'\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n")
    assert chip_smoke.spill_gated("composite3_fwd", v3[0])
    assert not chip_smoke.spill_gated("composite3_fwd_abl", v3[0])


ZERO_COLS = slice(3, 200, 7)  # real columns set to opacity 0 (before the neutral tail)


def test_zero_opacity_columns_v1():
    x = tile_inputs(90)
    x["opac"][:, ZERO_COLS] = 0.0
    args = v1_args(x)
    cot = (t_(x["g_l"]), t_(x["g_beta"]))
    gpf, gopac, gsh = tvjp.composite_tiles_bwd_reference(*map(t_, args), *cot, **kw(128))
    assert bool((gpf[:, ZERO_COLS] == 0).all()) and bool((gsh[:, ZERO_COLS] == 0).all())
    assert float(gopac[:, 0, ZERO_COLS].abs().max()) > 0  # hits under the cap carry it
    # the opacity adjoint is sum g_raw dens: autograd through the f64 forward
    a64 = [t_(a).double() for a in args]
    op = a64[5].clone().requires_grad_(True)
    l, b = tcomp.composite_tiles_reference(*a64[:5], op, a64[6], **kw(128))
    (torch.sum(l * cot[0]) + torch.sum(b * cot[1])).backward()
    g64 = tvjp.composite_tiles_bwd_reference(*a64, *cot, **kw(128))[1]
    want = op.grad[:, 0, ZERO_COLS]
    assert float((g64[:, 0, ZERO_COLS] - want).abs().max()) <= 1e-9 * float(want.abs().max())
    np.testing.assert_allclose(gopac[:, 0, ZERO_COLS].numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    # and the whole result against the JAX kernel, as test_torch_composite.py holds it
    want_j = jax_vjp(args, x["g_l"], x["g_beta"], 128)
    assert_grads_close(rows(gpf.numpy(), gopac.numpy(), gsh.numpy()), rows(*want_j), 2e-3)


def test_zero_opacity_columns_v2():
    x = tile_inputs(91)
    args = v2_args(x)
    args[2][:, 0, ZERO_COLS] = 0.0  # opacity row of aux; the geometry stays
    cot = (t_(x["g_l"]), t_(x["g_beta"]))
    k = dict(kw(128), sh_k=4)
    gpf, gaux, gsh = tcomp2.composite_tiles2_bwd_reference(*map(t_, args), *cot, **k)
    assert bool((gpf[:, ZERO_COLS] == 0).all()) and bool((gsh[:, ZERO_COLS] == 0).all())
    assert bool((gaux[:, 1, ZERO_COLS] == 0).all())  # c0
    assert float(gaux[:, 0, ZERO_COLS].abs().max()) > 0
    a64 = [t_(a).double() for a in args]
    aux = a64[2].clone().requires_grad_(True)
    l, b = tcomp2.composite_tiles2_reference(a64[0], a64[1], aux, a64[3], **k)
    (torch.sum(l * cot[0]) + torch.sum(b * cot[1])).backward()
    g64 = tcomp2.composite_tiles2_bwd_reference(*a64, *cot, **k)[1]
    want = aux.grad[:, 0, ZERO_COLS]
    assert float((g64[:, 0, ZERO_COLS] - want).abs().max()) <= 1e-9 * float(want.abs().max())
    want_j = jax_vjp2(args, x["g_l"], x["g_beta"], 4, 128)
    assert_grads_close(rows2(gpf.numpy(), gaux.numpy(), gsh.numpy()), rows2(*want_j), 8e-3)


def test_work12_counts_match_a_walk_of_pair_terms():
    x = tile_inputs(92)
    x["opac"][:, ZERO_COLS] = 0.0
    tensors = list(map(t_, v1_args(x)))
    k = kw(24)
    api = chip_smoke.V12Api("pallas")
    w = chip_smoke.work12(api, tensors, k)
    fa, fb, fc, _, pf, opac, _ = tensors
    a, b, c = (tcomp.dot_in_order(f[:, :, None, :], pf[:, None, :, :], 10) for f in (fa, fb, fc))
    _, hit, _, _, alpha0 = (np.asarray(v) for v in tcomp.pair_terms(a, b, c, opac, k["extent2"]))
    pairs = hits_alpha = hits_zero = 0
    for t in range(hit.shape[0]):
        for r in range(hit.shape[1]):
            count = 0
            for col in range(hit.shape[2]):
                pairs += 1
                if hit[t, r, col] and alpha0[t, r, col] > 0:
                    count += 1
                    if count > k["max_depth"]:
                        break
                    hits_alpha += 1
                elif hit[t, r, col]:
                    hits_zero += 1
    assert (w["pairs"], w["hits_alpha"], w["hits_zero"]) == (pairs, hits_alpha, hits_zero)
    assert hits_alpha and hits_zero and w["hits"] == hits_alpha + hits_zero
    ops = (pairs * chip_smoke.OPS_PAIR12["pallas"] + hits_alpha * chip_smoke.ops_hit12_bwd("pallas", 4)
           + hits_zero * chip_smoke.ops_hit12_zero_bwd(4))
    assert w["bwd_ops"] == ops and w["sh_k"] == 4


def _flip_case():
    """v1 tiles where one ray's weight lies exactly on log(beta_kill) in the
    plain version's run: beta_kill is chosen so that log(beta_kill) in f32
    equals that hit's log-weight lw (the plain version takes it dead), and
    the "kernel" is the plain version at the next smaller beta_kill (it
    takes that hit alive, as a kernel whose sum of log1p(-alpha) rounds the
    other way would)."""
    x = tile_inputs(93)
    tensors = list(map(t_, v1_args(x)))
    cot = [t_(x["g_l"]), t_(x["g_beta"])]
    k = kw(128)
    api = chip_smoke.V12Api("pallas")
    segments, _ = chip_smoke.walk12(api, tensors, k, torch.arange(tensors[0].shape[0]))
    best = None
    for lane0, lw, cand, _ in segments:
        score = torch.where(cand, (lw - np.log(0.08)).abs(), np.inf)
        i = int(score.argmin())
        if best is None or float(score.flatten()[i]) < best[0]:
            best = (float(score.flatten()[i]), float(lw.flatten()[i]), np.unravel_index(i, lw.shape))
    lw = np.float32(best[1])
    beta = np.float32(np.exp(np.float64(lw)))
    while np.log(beta) > lw:
        beta = np.nextafter(beta, np.float32(0))
    while np.log(beta) < lw:
        beta = np.nextafter(beta, np.float32(1))
    assert np.log(beta) == lw
    beta_k = beta  # the largest beta_kill below whose log lies under lw
    while np.log(beta_k) >= lw:
        beta_k = np.nextafter(beta_k, np.float32(0))
    k = dict(k, beta_kill=float(beta))
    plain = tvjp.composite_tiles_bwd_reference(*tensors, *cot, **k)
    got = tvjp.composite_tiles_bwd_reference(*tensors, *cot, **dict(k, beta_kill=float(beta_k)))
    yard = chip_smoke.yard12(api.bwd_ref, tensors, cot, k)
    flips = chip_smoke.kill_flips(lambda tiles: chip_smoke.walk12(api, tensors, k, tiles),
                                  tensors[0].shape[0], tensors[0].shape[1], tensors[4].shape[1],
                                  tcomp._log_kill(k["beta_kill"]))
    return got, plain, yard, flips, int(best[2][0])


@pytest.fixture(scope="module")
def flip_case():
    return _flip_case()


def test_kill_flip_is_excused_and_counted(flip_case):
    got, plain, yard, flips, tile = flip_case
    assert int(flips["near_per_tile"][tile]) >= 1 and bool(flips["excused"][tile].any())
    bare = chip_smoke.compare_grads12(got, plain, yard)
    assert not bare["ok"] and bare["elements_outside_band"] > 0  # the flip moves adjoints
    res = chip_smoke.compare_grads12(got, plain, yard, flips)
    print({k: res[k] for k in ("near_rays", "flipped_rays", "excused_columns", "elements_excused")})
    assert res["ok"] and res["elements_outside_band"] == 0
    assert res["flipped_rays"] >= 1 and res["elements_excused"] == bare["elements_outside_band"]


@pytest.mark.parametrize("plant", ["relative_1e-3", "tile_zeroed"])
def test_kill_flip_allowance_still_fails_another_tile(flip_case, plant):
    got, plain, yard, flips, tile = flip_case
    other = next(t for t in range(got[0].shape[0]) if not bool(flips["excused"][t].any()))
    scale = 1.0 + 1e-3 if plant == "relative_1e-3" else 0.0
    bad = tuple(torch.cat([g[:other], g[other:other + 1] * scale, g[other + 1:]]) for g in got)
    res = chip_smoke.compare_grads12(bad, plain, yard, flips)
    assert not res["ok"] and res["elements_outside_band"] > 0
