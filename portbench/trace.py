"""The traced window: ``torch.profiler`` over a steady run of the cell's
own traffic, reduced to what the per-layer readers take.

The profiler's Chrome trace is read back: device activity ("kernel",
"gpu_memcpy", "gpu_memset" events) gives the busy time as the union of
their intervals, the launches, and the time by operation name; host
operations ("cpu_op") name the idle gaps, each by the innermost operation
that was running at the gap's middle. The window is the span of a
``portbench.window`` range, so busy and idle are measured over the same
interval of the trace.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list) -> dict:
    """The trace record of a Chrome trace's events (times in us)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1]
    spans = [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev]
    merged = _merge(spans)
    busy_us = sum(e - s for s, e in merged)
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    edges = [w0] + [x for span in merged for x in span] + [w1]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    top = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        covering = [h for h in host if h[0] <= mid <= h[1]]
        name = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "host, between ops"
        top.append((name, (e - s) * 1e-6))
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, launches=len(dev),
                by_name=by_name, gaps=top)


def profile(fn, dev) -> dict:
    """Run ``fn()`` (which returns how many steps or frames it ran) under
    torch.profiler and return the trace record, with the units, the peak
    memory of the window and the host wall time around it."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            units = fn()
            if cuda:
                torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    rec = reduce(events)
    rec.update(units=units, host_wall_s=wall,
               peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else 0)
    return rec


def breakdown(rec: dict) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each by name with its seconds."""
    ops = sorted(rec["by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in rec["gaps"]]}
