"""Where the v1 / v2 backward compositors spend their time, by phase.

Builds csrc/composite_bwd.cu and composite2_bwd.cu four times each, with
BWD12_ABL = 0 (the kernel as the path builds it), 1 (no column sums),
2 (also no phase B) and 3 (also no phase A: the carry pass, staging and
the chunk loop's barriers), and times each on the inputs of the v1 / v2
full-width train step of chip_smoke.py (phases 13 and 15), in turns,
``--rounds`` times. The differences of neighbouring builds are the column
sums, phase B and phase A; build 3 is the rest. The ablated results are
wrong by design and nothing checks them. Prints the card's name and power
limit, then one JSON line per backend {"backend", "ms": {build: [ms per
round]}}. On the card only.

Usage: python3 scripts/bwd12_phases.py [--rounds 2]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from volprim_tpu_torch import train  # noqa: E402
from volprim_tpu_torch.kernels import _build  # noqa: E402
from volprim_tpu_torch.models import rf_tiled  # noqa: E402
from volprim_tpu_torch.scene import CameraSpecs, look_at, synthetic  # noqa: E402

SOURCES = {"pallas": "composite_bwd", "pallas2": "composite2_bwd"}


def build_ablations(out_dir: Path) -> dict:
    """{(source, ablation): loaded library}, one nvcc per build, together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), []
    for src in SOURCES.values():
        for abl in range(4):
            so = out_dir / f"{src}_abl{abl}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, f"-DBWD12_ABL={abl}", "-o", str(so),
                   str(_build.CSRC_DIR / f"{src}.cu")]
            procs.append((src, abl, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, abl, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src} with BWD12_ABL={abl}:\n{log}")
        libs[(src, abl)] = ctypes.CDLL(str(so))
    return libs


def step_inputs(backend: str, dev) -> list:
    """The backward launch's recorded arguments of chip_smoke's train step."""
    api = cs.V12Api(backend)
    cfg = rf_tiled.RFTiledConfig(backend=backend, **cs.V12)
    camera = CameraSpecs(name="bench", width=cs.WIDTH, height=cs.WIDTH,
                         to_world=look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]), fov=50.0)
    base = synthetic.make_scene(cs.N_PRIMS, device=dev)
    params = {"centers": base.centers, "scales": base.scales, "quats": base.quats,
              "opacities": base.attrs["opacities"], "sh_coeffs": base.attrs["sh_coeffs"]}
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}

    def step():
        img = train.render_cameras(train.to_scene(params, base), [camera], cfg, spp=1, seed=0)
        torch.mean(torch.abs(img)).backward()

    _, _, rec = cs.record_launches(api.bwd_mod, "_launch_bwd", api.bwd_counter, step)
    return list(rec[0])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd12_phases: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    libs = build_ablations(_build.BUILD_DIR / "bwd12_phases")
    for backend, src in SOURCES.items():
        api = cs.V12Api(backend)
        a = step_inputs(backend, dev)
        argtypes = api.bwd_mod._BWD_ARGTYPES
        ms = {abl: [] for abl in range(4)}
        for _ in range(args.rounds):
            for abl in range(4):
                lib = libs[(src, abl)]
                fn = getattr(lib, src)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                err = getattr(lib, f"{src}_error_string")
                err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
                lib.error_string = err
                _build._LIBS[src] = lib  # the wrapper's launcher loads through this
                ms[abl].append(cs.cuda_ms(lambda: api.bwd_mod._launch_bwd(*a), 10))
        _build._LIBS.pop(src)
        print(json.dumps({"backend": backend, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
