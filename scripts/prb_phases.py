"""chip_smoke.py's phases 30-33 (the rest of the path tracer) alone, on one
CUDA card.

    python3 scripts/prb_phases.py [--xla_seq_width 256] [--out chiprun_out]

Builds what those phases take from phases 9-10 (the 4096-primitive plume,
its 512x512 camera and rays, the procedural sky, one pallas frame as the
jump frame), then calls chip_smoke.prb_xla_frame, prb_walk_paths,
prb_surfaces and render_volume_cli, each printing its phase lines; a phase
that fails is reported and the next one runs. ``--xla_seq_width`` sets
chip_smoke.XLA_SEQ_WIDTH, the film of phase 31's xla-walk sequential,
cluster and Epanechnikov frames (512 renders them at full width: 49-63 s
a frame on an H100 80GB HBM3 at 700 W). ``--out`` writes the phases' details as JSON.
The walk kernel builds at first use (csrc/ffwalk.cu).
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
    ap.add_argument("--xla_seq_width", type=int, default=cs.XLA_SEQ_WIDTH)
    ap.add_argument("--out", help="directory for the phases' details")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from volprim_tpu_torch.kernels import ffwalk
    from volprim_tpu_torch.models import prb, render
    from volprim_tpu_torch.ops import envmap
    from volprim_tpu_torch.scene import generate_rays, synthetic

    cs.XLA_SEQ_WIDTH = args.xla_seq_width
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    medium = synthetic.make_medium(cs.PRB_PRIMS, seed=0, device=dev)
    pcam = synthetic.medium_camera(cs.PRB_WIDTH, cs.PRB_WIDTH)
    po, pd = generate_rays(pcam, jitter=False, device=dev)
    sky = envmap.procedural_sky(device=dev)
    pimg = render(medium, pcam, prb.radiance, prb.PRBConfig(walk_backend="pallas"), sky, 1,
                  torch.Generator(device=dev).manual_seed(1))
    jump_stats = cs.frame_stats(pimg)
    details = {}
    for name, fn in (
        ("prb_xla_frame", lambda: cs.prb_xla_frame(medium, pcam, po, pd, sky, jump_stats, dev,
                                                   details)),
        ("prb_walk_paths", lambda: cs.prb_walk_paths(ffwalk, medium, pcam, po, pd, sky, dev,
                                                     details)),
        ("prb_surfaces", lambda: cs.prb_surfaces(ffwalk, medium, pcam, sky, dev, details)),
        ("render_volume_cli", lambda: cs.render_volume_cli(details)),
    ):
        t1 = time.perf_counter()
        try:
            fn()
            print(json.dumps({"done": name, "seconds": time.perf_counter() - t1}), flush=True)
        except SystemExit:
            print(json.dumps({"failed": name, "seconds": time.perf_counter() - t1}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "prb_phases_details.json"), "w") as f:
            json.dump(details, f, default=str, indent=1)
    print(json.dumps({"total_seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
