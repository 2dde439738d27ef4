"""The readings that the limits of ``portbench/limits`` are set from, many
seeds in one process:

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3
        --mode program|control|<fault> [--seconds 2]

``program``: the cell's compared numbers as a run computes them (the
training cells' first steps; the viewer's frames from a short window at
the cell's load). ``control``: the reference with its pair math in
bfloat16 put in the program's place. A fault (``portbench/faults/<fault>.py``):
the program with that fault planted. One JSON line per seed.
"""

from __future__ import annotations

import argparse
from contextlib import nullcontext
import json
import sys
import time

import torch

from portbench.run import driver, fault, load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--cpu_rehearsal", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device("cpu") if args.cpu_rehearsal else torch.device("cuda", 0)
    config, traffic, limits = load_cell(args.workload, args.cpu_rehearsal)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = driver(traffic["entry"])(config, traffic, seed, dev)
        if args.mode == "control":
            numbers = cell.control()
        else:
            planted = fault(args.mode)() if args.mode != "program" else nullcontext()
            with planted:
                cell.setup()
                if cell.unit == "frame":
                    cell.window(args.seconds)
                numbers = cell.check()
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "numbers": dict(numbers), "limits": limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
