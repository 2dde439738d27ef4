"""chip_smoke.py's phase 37 (data parallelism) alone, on one CUDA card.

    python3 scripts/dp_phase.py [--out DIR]

Builds the v3 compositors (csrc/composite3_fwd.cu, composite3_bwd.cu),
makes the 262,144-primitive headline scene and calls
chip_smoke.data_parallel: two gloo ranks of chip_smoke.py on the card,
then one NCCL rank, each line a rank. ``--out`` writes the phase's details
as JSON.
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
    ap.add_argument("--out", help="directory for the phase's details")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from volprim_tpu_torch.kernels import _build
    from volprim_tpu_torch.scene import synthetic

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build("composite3_fwd", "composite3_bwd")
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    scene = synthetic.make_scene(cs.N_PRIMS, device=torch.device("cuda", 0))
    details = {}
    cs.data_parallel(scene, details)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "dp_phase_details.json"), "w") as f:
            json.dump(details, f, default=str, indent=1)
    print(json.dumps({"total_seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
