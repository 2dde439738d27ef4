"""The forward compositor's timing ablations on the kernel before its
redesign, beside the ones compiled into this checkout: a one-off
measurement, kept for the provenance of PERF.md's "before" row.

The profiler's kernel stage (volprim_tpu_torch/tools/profile_rf.py) is
timed through another checkout's ``csrc/composite3_fwd.cu`` as it stood at
commit e0a83d3 (the v3 forward before its Hopper redesign; a ``git
archive`` of that commit holds it), unchanged and patched with each of the
eight ablations of ``composite3.ABLATIONS`` (text substitutions of that
file, PATCHES below, with the meaning of this tree's compiled-in variants,
csrc/composite3_fwd.cuh), then through this checkout's kernel and its
``abl_*`` stages, in turns, ``--rounds`` times. Prints one JSON line
{stage: [ms per round]}, ``before_*`` for the other checkout. On the card
only; it works on no other commit's forward.

Usage: python3 scripts/abl_before.py --other DIR [--rounds 2]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# each ablation as text substitutions of that commit's composite3_fwd.cu
# (its unbanded walk, which the kernel stage runs)
_CAP = "      if (!under_cap(alpha, count, max_depth)) break;"
_LOG1P = "      log_beta = log_beta + log1pf(-alpha);"
_EARLY_EXIT = ("    if (!__syncthreads_or(active)) {", "    if (!__syncthreads_or(1)) {")
PATCHES = {
    "nodepth": [(_CAP, "")],
    "noemis": [("        emission<K>(basis, s_sh + j * 3 * K, e0, e1, e2);",
                "        e0 = 1.0f; e1 = 1.01f; e2 = 1.02f;")],
    "notrans": [("          pair_alpha(s_pf[j * kFeat + kOpacRow], p.q, dens, raw);",
                 "          fminf(s_pf[j * kFeat + kOpacRow] * (1.0f - p.q), 0.9999f);"),
                ("const float w = expf(log_beta) * alpha;",
                 "const float w = (1.0f + log_beta) * alpha;"),
                (_LOG1P, "      log_beta = log_beta - alpha;")],
    "nocum": [(_LOG1P, "")],
    "noop": [("  int n_cols = nseg * seg;", "  int n_cols = 0;")],
    "noop2": [("  const bool ray_ok = tid < R;",
               "  if (tid < R) { const size_t o0 = static_cast<size_t>(t) * R + tid; "
               "out_l[3 * o0] = 0.0f; out_l[3 * o0 + 1] = 0.0f; out_l[3 * o0 + 2] = 0.0f; "
               "out_beta[o0] = 1.0f; } if (tid == 0) { out_walked[t] = 0; out_live[t] = 0; } "
               "if (R > 0) return;\n  const bool ray_ok = tid < R;")],
    "static": [("  const int nseg = max(0, min(n_seg_t[t], S / seg));",
                "  const int nseg = S / seg;"), _EARLY_EXIT],
    "fori": [_EARLY_EXIT],
}


def _build_other(other: Path) -> dict:
    """The other checkout's forward, unchanged and per ablation, each built
    by its own nvcc (all at once) and bound with ctypes."""
    from volprim_tpu_torch.kernels import _build

    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    src = (other / "volprim_tpu_torch" / "csrc").resolve()
    procs = []
    for name, patches in [("kernel", [])] + list(PATCHES.items()):
        d = _build.BUILD_DIR / "abl_before" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        text = (d / "composite3_fwd.cu").read_text()
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"ablation {name}: {other} is not the forward of commit "
                                 f"e0a83d3 ({old.strip()!r} not found)")
            text = text.replace(old, new)
        (d / "composite3_fwd.cu").write_text(text)
        so = d / "composite3_fwd.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / "composite3_fwd.cu")]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.composite3_fwd.argtypes = [vp] * 9 + [ci, ci, ci, ci, ci, cf, ci, cf, ci, ci, vp]
        lib.composite3_fwd.restype = ci
        lib.error_string = lib.composite3_fwd_error_string
        lib.error_string.argtypes, lib.error_string.restype = [ci], ctypes.c_char_p
        libs[name] = lib
    return libs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="checkout holding the earlier csrc/")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the ablations time the CUDA kernel")
    from volprim_tpu_torch.kernels import composite3
    from volprim_tpu_torch.tools import profile_rf

    libs = _build_other(Path(args.other))
    own = composite3._lib
    res: dict = {}
    stages = "kernel," + ",".join(profile_rf.ABL_STAGES)
    for _ in range(args.rounds):
        for name, lib in libs.items():
            composite3._lib = lambda entry="composite3_fwd", lib=lib: lib
            try:
                ms = profile_rf.main(["--reps", str(args.reps), "--stages", "kernel"])["kernel"]
            finally:
                composite3._lib = own
            key = "before_kernel" if name == "kernel" else f"before_abl_{name}"
            res.setdefault(key, []).append(ms)
        for st, ms in profile_rf.main(["--reps", str(args.reps), "--stages", stages]).items():
            res.setdefault(st, []).append(ms)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
