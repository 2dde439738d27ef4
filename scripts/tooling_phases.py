"""chip_smoke.py's phases 34-36 (the tooling) alone, on one CUDA card.

    python3 scripts/tooling_phases.py [--out DIR]

Builds the walk kernel (csrc/ffwalk.cu) and what the phases take from
earlier ones: the 262,144-primitive headline scene written as phase 21's
PLY, and phase 5's exact-order render of a fixed 4,096-pixel subsample of
the headline camera (its seconds size phase 36's cut). Then it calls
chip_smoke.radiosity_fit, sh_fit_visualizer and generate_dataset_cli, each
printing its phase lines; a phase that fails is reported and the next one
runs (phase 35 needs phase 34). ``--out`` writes the phases' details as
JSON and phase 34's torch.profiler tables.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for the phases' details")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from volprim_tpu_torch.kernels import _build, ffwalk
    from volprim_tpu_torch.models import rf
    from volprim_tpu_torch.scene import CameraSpecs, generate_rays, look_at, save_ply, synthetic

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build("ffwalk")
    dev = torch.device("cuda", 0)
    scene = synthetic.make_scene(cs.N_PRIMS, device=dev)
    os.makedirs(cs.ASSET_DIR, exist_ok=True)
    ply = os.path.join(cs.ASSET_DIR, "headline.ply")
    save_ply(scene, ply)
    # phase 5's exact-order render of 4,096 pixels of the headline camera
    camera = CameraSpecs(name="bench", width=cs.WIDTH, height=cs.WIDTH,
                         to_world=look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]), fov=50.0)
    o, d = generate_rays(camera, jitter=False, device=dev)
    sel = torch.from_numpy(
        np.random.default_rng(0).choice(cs.WIDTH * cs.WIDTH, size=4096, replace=False)).to(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rf.radiance(scene, None, o[sel], d[sel], rf.RFConfig(max_depth=128, srgb_primitives=True,
                                                         chunk_size=2048))
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t1
    print(json.dumps({"exact_s": exact_s}), flush=True)
    del scene, o, d
    details = {}
    rad = {}

    def radiosity():
        rad.update(cs.radiosity_fit(ffwalk, dev, details, args.out))

    for name, fn in (
        ("radiosity_fit", radiosity),
        ("sh_fit_visualizer", lambda: cs.sh_fit_visualizer(rad["cache"], rad["mesh"], dev,
                                                           details)),
        ("generate_dataset_cli", lambda: cs.generate_dataset_cli(ply, exact_s, dev, details)),
    ):
        t1 = time.perf_counter()
        try:
            fn()
            print(json.dumps({"done": name, "seconds": time.perf_counter() - t1}), flush=True)
        except (SystemExit, KeyError):
            print(json.dumps({"failed": name, "seconds": time.perf_counter() - t1}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "tooling_phases_details.json"), "w") as f:
            json.dump(details, f, default=str, indent=1)
    print(json.dumps({"total_seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
