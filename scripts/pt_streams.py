"""The path tracer's per-ray random streams on one device: the uniforms'
bits against the CPU's, one frame under two ray chunks, and rays [a, b) of
a radiance call against rows [a, b) of the whole call, each frame compared
by the ``plume4096.pt`` cell's numbers (``portbench/drivers/path_trace``).

    python3 scripts/pt_streams.py [--res 64] [--seed 7] [--chunks 65536,64]
        [--cpu]

The plume of the cell (4,096 primitives, sigma_t x 10) under its sky and
camera at ``--res`` squared, 1 spp, with the cell's integrator (the CUDA
walk on the card). Prints one JSON line a check and a last one with all of
them; exits 1 when the bits differ from the CPU's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--chunks", default="65536,64")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from portbench import driving, plume
    from portbench.drivers.path_trace import compare
    from portbench.run import load_cell
    from volprim_tpu_torch.models import prb, render
    from volprim_tpu_torch.ops import streams
    from volprim_tpu_torch.ops.envmap import EnvironmentMap
    from volprim_tpu_torch.scene.ellipsoids import EllipsoidScene

    torch.set_num_threads(1)
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True)
        out["nvidia_smi"] = q.stdout.strip()

    # the bits: 64 bounces x 9 slots for 2^20 ray indices spread over 2^32
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    key = streams.draw_key(g, dev)
    idx = torch.randint(0, 1 << 32, (1 << 20,), generator=g, device=dev, dtype=torch.int64)
    table = streams.bounce_table(key, 64, prb.N_SLOTS)
    differ = 0
    for b in range(64):
        got = streams.uniforms(table, b, idx).cpu()
        want = streams.uniforms(table.cpu(), b, idx.cpu())
        differ += int((got != want).sum())
    out["uniform_bits_differing"] = differ
    print(json.dumps({"uniform_bits_differing": differ, "draws": 64 * (1 << 20) * prb.N_SLOTS}),
          flush=True)

    config = load_cell("plume4096.pt")[0]
    arrays = plume.plume(config["n_prims"], args.seed, config["sigmat_scale"])
    t = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    scene = EllipsoidScene(centers=t["centers"], scales=t["scales"], quats=t["quats"],
                           attrs={"sigma_t": t["sigma_t"], "albedo": t["albedo"]},
                           extent=float(config["extent"]))
    sky = EnvironmentMap.from_array(plume.sky(), device=dev)
    cam = driving.program_cameras([plume.camera(args.res, args.res)], "medium")[0]
    base = prb.PRBConfig(**config["integrator"])

    def frame(chunk):
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        with torch.no_grad():
            return render(scene, cam, prb.radiance, dataclasses.replace(base, ray_chunk=chunk),
                          sky, spp=1, generator=gen)

    def numbers(a, b):
        rms, flip, worst = compare(a.reshape(-1, 3), b.reshape(-1, 3))
        return dict(equal=bool(torch.equal(a, b)), frame_rms_gap=rms, flip_share=flip,
                    largest_relative_gap=worst)

    chunks = [int(c) for c in args.chunks.split(",")]
    frames = {c: frame(c) for c in chunks}
    for c in chunks[1:]:
        out[f"ray_chunk {chunks[0]} vs {c}"] = row = numbers(frames[chunks[0]], frames[c])
        print(json.dumps({"check": f"ray_chunk {chunks[0]} vs {c}", **row}), flush=True)

    # rays [a, b) of one call against rows [a, b) of the whole call
    from volprim_tpu_torch.scene.cameras import film_coords, rays_from_pixels

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    px, py = film_coords(cam, gen, device=dev)
    o, d = rays_from_pixels(cam, px, py)
    key = streams.draw_key(gen, dev)
    a, b = o.shape[0] // 3, 2 * o.shape[0] // 3
    with torch.no_grad():
        whole = prb.radiance_keyed(scene, sky, o, d, base, key)
        part = prb.radiance_keyed(scene, sky, o[a:b], d[a:b], base, key, first=a)
    out["rows [a, b) vs whole"] = row = numbers(whole[a:b], part)
    print(json.dumps({"check": "rows [a, b) vs whole", "a": a, "b": b, **row}), flush=True)
    print(json.dumps(out), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
