"""The v3 compositor's compile-time variants, seen from the CPU.

- The forward's timing ablations (``composite3.ABLATIONS``, built into
  csrc/composite3_fwd_abl.cu) are the eight that the JAX profiler sweeps
  (tools/profile_rf.py), in its order, and the port's profiler offers them
  as its ``abl_*`` stages. They time the CUDA kernel: the wrapper refuses
  CPU tensors and unknown names (there is no plain version of a result
  that is wrong by design).
- ``chip_smoke.ptxas_table`` reads nvcc's ``-Xptxas -v`` log into one row
  per kernel with the template arguments of the compositors'
  instantiations, which chip_smoke.py prints and holds to 0 spill stores
  for the path's unbanded k = 4 kernels at 256 and 512 threads.
- The ctypes argument types of each C entry point of the v3 compositors
  (forward, backward, the ablated forward) follow its declaration in
  csrc/, argument for argument.
"""

import ctypes
import re
from pathlib import Path

import pytest

import chip_smoke
from volprim_tpu_torch.kernels import composite3
from volprim_tpu_torch.tools import profile_rf


def test_ablations_are_the_jax_profilers_sweep():
    src = (Path(__file__).resolve().parent.parent / "tools" / "profile_rf.py").read_text()
    sweep = re.search(r'for abl in \(([^)]*)\):', src).group(1)
    jax_names = re.findall(r'"(\w+)"', sweep)
    assert list(composite3.ABLATIONS) == jax_names
    assert sorted(composite3.ABLATIONS.values()) == list(range(1, 9))
    assert profile_rf.ABL_STAGES == tuple(f"abl_{n}" for n in jax_names)


def test_ablated_kernel_refuses_cpu_and_unknown_names():
    d8, pf, sh3, n_seg_t = composite3.synthetic_tiles(1, 32, 64, 32, 4, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        composite3.forward3_ablated("noemis", d8, pf, sh3, n_seg_t, seg=32)
    with pytest.raises(ValueError, match="unknown ablation"):
        composite3.forward3_ablated("nowalk", d8, pf, sh3, n_seg_t, seg=32)
    assert composite3.forward3_ablated.launches == 0


LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN10composite311fwd3_kernelILi4ELb0ELi512ELi0EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN10composite311fwd3_kernelILi4ELb0ELi512ELi0EEEvPKfS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 80 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111bwd3_kernelILi4ELb1ELi256EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111bwd3_kernelILi4ELb1ELi256EEEvPKf
    5232 bytes stack frame, 32 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 5232 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z11walk_kernelPKf' for 'sm_90a'
ptxas info    : Function properties for _Z11walk_kernelPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""


def test_ptxas_table_reads_each_instantiation():
    rows = chip_smoke.ptxas_table(LOG)
    assert [(r["kernel"], r["args"]) for r in rows] == [
        ("fwd3_kernel", [4, 0, 512, 0]), ("bwd3_kernel", [4, 1, 256]), (None, None)]
    assert [(r["registers"], r["spill_stores"], r["spill_loads"], r["stack"]) for r in rows] == [
        (64, 0, 0, 0), (128, 32, 36, 5232), (40, 0, 0, 0)]
    assert rows[2]["function"] == "_Z11walk_kernelPKf"
    assert chip_smoke.ptxas_table("") == []


CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}


@pytest.mark.parametrize("entry", ["composite3_fwd", "composite3_fwd_abl", "composite3_bwd"])
def test_argtypes_follow_the_c_declarations(entry):
    src = (Path(composite3.__file__).resolve().parent.parent / "csrc" / f"{entry}.cu").read_text()
    decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src).group(1)
    types = [re.sub(r"\s*\w+$", "", a.strip()).replace(" *", "*") for a in decl.split(",")]
    assert [CTYPE[t] for t in types] == composite3._ARGTYPES[entry]
