"""The tiled cells' frames and refine steps of one checkout of the port,
saved so that another checkout's can be compared with them bit for bit.

    python3 scripts/frame_parity.py --save OUT.pt [--root DIR] [--seed N]
        [--frames F] [--cpu_rehearsal]
    python3 scripts/frame_parity.py --compare A.pt B.pt [C.pt ...]

``--save`` builds ``splat2m5.view`` and ``splat2m5.refine`` as
``portbench.run`` does (inputs from the seed, the same set-up), with the
``volprim_tpu_torch`` and ``portbench`` of ``--root`` (default: this
checkout), on the card (``--cpu_rehearsal``: on the CPU at the cells'
rehearsal sizes). It keeps the viewer's frames 0 .. F-1 along its
orbit and the refine cell's compared steps: the losses, the first gradient
as the optimizer took it (m / (1 - beta1)) and the parameters' change after
them. ``--compare`` prints one JSON line per file after the first: whether
every frame equals the first file's (``torch.equal``), the largest absolute
difference of the frames, of the losses and, leaf by leaf, of the gradients
and the changes. Two files of one checkout give the run-to-run spread of
the refine step, whose scatter-add backward sums in no fixed order.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def save(root: str, out: str, seed: int, frames: int, rehearsal: bool) -> None:
    sys.path.insert(0, root)
    import torch

    import volprim_tpu_torch
    from portbench import run

    torch.set_num_threads(1)
    dev = torch.device("cpu") if rehearsal else torch.device("cuda", 0)
    rec = {"package": os.path.dirname(volprim_tpu_torch.__file__), "seed": seed,
           "device": "cpu rehearsal" if rehearsal else torch.cuda.get_device_name(dev)}
    config, traffic, _ = run.load_cell("splat2m5.view", rehearsal)
    view = run.driver(traffic["entry"])(config, traffic, seed, dev)
    view.setup()
    with torch.no_grad():
        rec["frames"] = [view.frame(i).cpu() for i in range(frames)]
    del view
    config, traffic, _ = run.load_cell("splat2m5.refine", rehearsal)
    refine = run.driver(traffic["entry"])(config, traffic, seed, dev)
    refine.setup()
    rec["losses"] = torch.tensor(refine.prog_losses, dtype=torch.float64)
    rec["grads"] = {k: v.cpu() for k, v in refine.prog_grads.items()}
    rec["change"] = {k: v.cpu() for k, v in refine.prog_change.items()}
    torch.save(rec, out)
    print(json.dumps({"saved": out, "package": rec["package"], "seed": seed,
                      "device": rec["device"]}))


def compare(paths: list) -> None:
    import torch

    first = torch.load(paths[0])
    for path in paths[1:]:
        other = torch.load(path)
        frames = [(a.double() - b.double()).abs().max().item()
                  for a, b in zip(first["frames"], other["frames"])]
        line = {
            "a": paths[0], "b": path,
            "frames_equal": len(first["frames"]) == len(other["frames"]) and all(
                torch.equal(a, b) for a, b in zip(first["frames"], other["frames"])),
            "frame_max_abs": max(frames),
            "loss_max_abs": (first["losses"] - other["losses"]).abs().max().item(),
        }
        for part in ("grads", "change"):
            line[f"{part}_max_abs"] = {
                k: (first[part][k].double() - other[part][k].double()).abs().max().item()
                for k in first[part]}
        print(json.dumps(line))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--compare", nargs="+")
    ap.add_argument("--cpu_rehearsal", action="store_true")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.compare)
    elif args.save:
        save(os.path.abspath(args.root), args.save, args.seed, args.frames, args.cpu_rehearsal)
    else:
        ap.error("give --save or --compare")
    return 0


if __name__ == "__main__":
    sys.exit(main())
