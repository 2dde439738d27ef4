"""One benchmark cell's traced window, put down to the program's spans.

    python3 scripts/span_attrib.py --workload <config>.<traffic> --seed <n>
        [--out DIR] [--cpu_rehearsal]

Builds the cell as ``portbench.run`` does (inputs from the seed, the
warm-up), runs its traced window under ``torch.profiler`` and reads the
Chrome trace by the ranges of ``volprim_tpu_torch.utils.spans``
(``user_annotation`` events):

- each span's calls and host ms per step or frame;
- the root span's self time: the share of it that no other span covers;
- the pageable host-to-device copies (``Memcpy HtoD (Pageable -> Device)``),
  each put down to the innermost span around the ``cudaMemcpyAsync`` that
  issued it, with the host time that call took;
- the device launches by the innermost span around their runtime call;
- the host time in ``cudaStreamSynchronize`` / ``cudaDeviceSynchronize``
  calls (each blocking copy to or from the device makes one) by the
  innermost span around them;
- the window's device idle time, each gap between device activity put down
  to the innermost span (on any thread) covering the gap's midpoint;
- by span, the host operations that took most of its time (nested
  operations each count their own duration).

It prints one JSON line (also ``DIR/<cell>.json`` with ``--out``). It does
not compare the program with the reference; ``portbench.run`` does.

``--rounds N`` then measures what the spans cost while the profiler runs:
N more traced windows with the spans on and N with them off (the profiler
still on), in turns in this one process, each window's host wall time per
step or frame as ``portbench.run``'s ``host_wall_s`` takes it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ROOTS = {"step": ("train.step", "optimize_volume.step"), "frame": ("rf_tiled.render_state",)}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ranges, t, tid=None):
    """The name of the shortest range holding time ``t``: on thread ``tid``
    where one there does (a launch), else on any thread (the autograd
    engine's launches outside its own spans go to ``autograd.backward``)."""
    best = None
    for s, e, name, rt in ranges:
        if s <= t <= e and (best is None or (rt == tid, s - e) > best[1]):
            best = (name, (rt == tid, s - e))
    return best[0] if best else "outside any span"


def attribute(events: list, units: int, unit: str) -> dict:
    """The reduction described in the module docstring (times in ms)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"][0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid"))
              for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"] != WINDOW and w0 <= float(e["ts"]) < w1]
    spans = {}
    for s, e, name, _ in ranges:
        rec = spans.setdefault(name, {"calls": 0, "host_ms": 0.0})
        rec["calls"] += 1
        rec["host_ms"] += (e - s) * 1e-3
    per_unit = {k: {"calls": v["calls"] / units, "host_ms": v["host_ms"] / units}
                for k, v in sorted(spans.items(), key=lambda kv: -kv[1]["host_ms"])}

    roots = [r for r in ranges if r[2] in ROOTS[unit]]
    root_ms = sum(e - s for s, e, _, _ in roots) * 1e-3
    covered = 0.0
    for s, e, _, _ in roots:
        inner = [(max(a, s), min(b, e)) for a, b, name, _ in ranges
                 if name not in ROOTS[unit] and a < e and b > s]
        covered += sum(b - a for a, b in _merge(inner))
    self_share = 1.0 - covered * 1e-3 / root_ms if root_ms else None

    runtime = {e["args"]["correlation"]: e for e in events if e.get("ph") == "X"
               and e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1]
    copies, launches = {}, {}
    for e in dev:
        call = runtime.get(e.get("args", {}).get("correlation"))
        where = (_innermost(ranges, float(call["ts"]), call.get("tid")) if call
                 else "no runtime call")
        launches[where] = launches.get(where, 0) + 1
        if e["cat"] == "gpu_memcpy" and "Pageable" in e["name"] and "HtoD" in e["name"]:
            rec = copies.setdefault(where, {"copies": 0, "call_ms": 0.0, "bytes": 0})
            rec["copies"] += 1
            rec["call_ms"] += float(call["dur"]) * 1e-3 if call else 0.0
            rec["bytes"] += int(e.get("args", {}).get("bytes", 0))

    syncs = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and e["name"] in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
                and w0 <= float(e["ts"]) < w1):
            where = _innermost(ranges, float(e["ts"]), e.get("tid"))
            rec = syncs.setdefault(where, {"calls": 0, "ms": 0.0})
            rec["calls"] += 1 / units
            rec["ms"] += float(e["dur"]) * 1e-3 / units
    ops = {}  # host ops by the innermost span on their thread
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" and w0 <= float(e["ts"]) < w1:
            where = _innermost(ranges, float(e["ts"]), e.get("tid"))
            by = ops.setdefault(where, {})
            by[e["name"]] = by.get(e["name"], 0.0) + float(e["dur"]) * 1e-3 / units
    top_ops = {k: dict(sorted(v.items(), key=lambda kv: -kv[1])[:6]) for k, v in ops.items()}

    busy = _merge([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev])
    edges = [w0] + [x for span in busy for x in span] + [w1]
    idle = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            where = _innermost(ranges, 0.5 * (s + e))  # any thread
            idle[where] = idle.get(where, 0.0) + (e - s) * 1e-3
    window_ms = (w1 - w0) * 1e-3
    return {
        "units": units, "unit": unit, "window_ms": window_ms,
        "busy_ms": sum(e - s for s, e in busy) * 1e-3,
        "spans": per_unit, "root_ms_per_unit": root_ms / units, "root_self_share": self_share,
        "pageable_htod": {k: dict(v, copies=v["copies"] / units, call_ms=v["call_ms"] / units,
                                  bytes=v["bytes"] / units) for k, v in copies.items()},
        "sync_ms": dict(sorted(syncs.items(), key=lambda kv: -kv[1]["ms"])),
        "launches": {k: v / units for k, v in sorted(launches.items(), key=lambda kv: -kv[1])},
        "idle_ms": {k: v / units for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "top_ops_ms": top_ops,
    }


def cost(cell, rounds: int, acts, sync, spans) -> dict:
    """Host wall time per unit of traced windows with the spans on and off
    (``spans._enabled`` patched to False; the profiler on in both)."""
    from torch.profiler import profile, record_function

    def window(fn):
        sync()
        with profile(activities=acts):
            t0 = time.perf_counter()
            with record_function(WINDOW):
                units = fn()
                sync()
            wall = time.perf_counter() - t0
        return wall / units

    walls = {"on": [], "off": []}
    enabled = spans._enabled
    try:
        for i in range(2 * rounds):
            side = ("on", "off")[(i + i // 2) % 2]  # on, off, off, on, on, off, ...
            spans._enabled = enabled if side == "on" else (lambda: False)
            walls[side].append(cell.traced(window))
    finally:
        spans._enabled = enabled
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    ap.add_argument("--rounds", type=int, default=0,
                    help="then N traced windows each with the spans on and off, in turns")
    ap.add_argument("--cpu_rehearsal", action="store_true")
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import run as bench  # its import pins one host thread
    from volprim_tpu_torch.utils import spans

    torch.set_num_threads(1)
    dev = torch.device("cpu") if args.cpu_rehearsal else torch.device("cuda", 0)
    config, traffic, _ = bench.load_cell(args.workload, args.cpu_rehearsal)
    cell = bench.driver(traffic["entry"])(config, traffic, args.seed, dev)
    t0 = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def window(fn):
        sync()
        spans.reset()
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                units = fn()
                sync()
        return prof, units

    prof, units = cell.traced(window)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = attribute(events, units, cell.unit)
    record = spans.snapshot()
    out.update(workload=args.workload, seed=args.seed, setup_s=setup_s,
               counters={k: v / units for k, v in record["counters"].items()},
               kernel_launches=record["launches"],
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               power_limit=bench.power_limit() if dev.type == "cuda" else None)
    if args.rounds:
        out["spans_cost"] = cost(cell, args.rounds, acts, sync, spans)
    line = json.dumps(out)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{args.workload}.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
