"""chip_smoke.py's phases 24, 38 and 39 (emitters, the fused forward's
early-exit walk, the path tracer's stage profilers) alone, on one CUDA card.

    python3 scripts/ee_phases.py [--out DIR]

Builds the v3 forward (csrc/composite3_fwd.cu) and the walk
(csrc/ffwalk.cu), makes the 262,144-primitive headline scene and phase
21's cameras.json (synthetic.orbit_cameras: the headline camera and 7 more
on its orbit), then calls
chip_smoke.emitter_check, early_exit_phase and prb_profiler_phase, each
printing its phase lines; a phase that fails is reported and the next one
runs. ``--out`` writes the phases' details as JSON.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for the phases' details")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from volprim_tpu_torch.kernels import _build, composite3
    from volprim_tpu_torch.models import rf_tiled
    from volprim_tpu_torch.scene import JSONCameraSpecsIO, synthetic

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build("composite3_fwd", "ffwalk")
    dev = torch.device("cuda", 0)
    scene = synthetic.make_scene(cs.N_PRIMS, device=dev)
    camera = cs.headline_camera()
    os.makedirs(cs.ASSET_DIR, exist_ok=True)
    cams = os.path.join(cs.ASSET_DIR, "cameras.json")
    JSONCameraSpecsIO.write(synthetic.orbit_cameras(cs.WIDTH, 8), cams)
    details = {}
    failed = []
    for name, fn in (
        ("emitter", lambda: cs.emitter_check(composite3, rf_tiled, scene, camera, details)),
        ("early_exit", lambda: cs.early_exit_phase(composite3, rf_tiled, scene, cams, dev,
                                                   details)),
        ("prb_profiler", lambda: cs.prb_profiler_phase(details)),
    ):
        t1 = time.perf_counter()
        try:
            fn()
            print(json.dumps({"done": name, "seconds": time.perf_counter() - t1}), flush=True)
        except (SystemExit, KeyError):
            failed.append(name)
            print(json.dumps({"failed": name, "seconds": time.perf_counter() - t1}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ee_phases_details.json"), "w") as f:
            json.dump(details, f, default=str, indent=1)
    print(json.dumps({"total_seconds": time.perf_counter() - t0, "failed": failed}), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
