"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1> [--cpu_rehearsal]

Cell ``A.B`` is configuration ``portbench/configs/A.json`` under traffic
``portbench/traffic/B.json``. Each piece of code that a cell needs is a
file that the harness finds by name: the traffic's ``"entry"`` names its
driver ``portbench/drivers/<entry>.py``, each per-layer metric is the reader
``portbench/metrics/<metric>.py``, each fault that the traffic's
``"faults"`` lists is ``portbench/faults/<fault>.py``; the limits are
``portbench/limits/A.B.json``. So a new cell, entry, metric or fault is new
files and entries, and no file here changes.

A run makes its inputs from the seed, warms up the cell's shapes (set-up),
then with ``--trace 0`` measures the end-to-end metrics over ``--seconds``,
with ``--trace 1`` runs a profiled window, reads the program's peak memory,
counts the window's work from the reference, and reads the per-layer
metrics; in both it then compares what the program produced with the plain
reference. It needs one CUDA device and fails without it;
``--cpu_rehearsal`` runs the same control flow on the CPU at the tiny sizes
of the files' ``"rehearsal"`` keys and prints no device metric. The last
line of standard output is the result as JSON; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of the program at a fixed path in the
# checkout (the port's own nvcc builds go to build/kernels there)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
# one host thread: the program's CPU-side tensor ops (each frame's tile
# layout) are small, and on a shared host a pool of threads makes the
# host-paced cells' times swing from run to run (an H100 host's viewer
# frames: 23.4-35.9 ms over three runs with the pool, 25.6-30.6 ms over
# twelve with one thread)
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "volprim_tpu")


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, rehearsal: bool = False) -> tuple:
    """(configuration, traffic, limits) of cell ``name`` = ``A.B``."""
    if name.count(".") != 1:
        raise ValueError(f"a cell is <config>.<traffic>, got {name!r}")
    config_name, traffic_name = name.split(".")

    def read(*parts):
        with open(os.path.join(HERE, *parts)) as f:
            return json.load(f)

    config = read("configs", f"{config_name}.json")
    traffic = read("traffic", f"{traffic_name}.json")
    limits = read("limits", f"{name}.json")
    if rehearsal:
        config = _merge(config, config.get("rehearsal", {}))
        traffic = _merge(traffic, traffic.get("rehearsal", {}))
    return config, traffic, limits


def load_file(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py`` (a name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(rec)`` of ``portbench/metrics/<name>.py``."""
    return load_file("metrics", name).read


def driver(entry: str):
    """The class ``Driver`` of ``portbench/drivers/<entry>.py``."""
    return load_file("drivers", entry).Driver


def fault(name: str):
    """The context manager ``plant`` of ``portbench/faults/<name>.py``."""
    return load_file("faults", name).plant


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that ``cell``
    reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu_rehearsal", action="store_true",
                    help="the control flow on the CPU at tiny sizes; no device metric")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if args.cpu_rehearsal:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        dev = torch.device("cuda", 0)
    config, traffic, limits = load_cell(args.workload, args.cpu_rehearsal)

    from portbench import trace

    t_inputs = time.perf_counter()
    cell = driver(traffic["entry"])(config, traffic, args.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_warm = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - T_START
    print(f"set-up: {setup_s:.6f} s (start and imports {t_inputs - T_START:.3f}, inputs "
          f"{t_warm - t_inputs:.3f}, warm-up {setup_s - (t_warm - T_START):.3f})", flush=True)

    result_metrics, extra = {}, {}
    if args.trace:
        setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        rec = cell.traced(lambda fn: trace.profile(fn, dev))
        # the program's peak (set-up and the traced window), read before
        # the reference counts the window's work
        peak = max(setup_peak, rec["peak_bytes"])
        cell.count_work(rec)
        rec["unit"] = cell.unit
        attempted, failed = rec["units"], 0
        for m in cell_metrics(bench, args.workload, "per_layer"):
            value = metric_reader(m["name"])(rec)
            if value is not None and dev.type == "cuda":
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if dev.type == "cuda":
            extra["breakdown"] = trace.breakdown(rec)
        device_extra = {"busy_s": rec["busy_s"], "window_s": rec["window_s"]}
        print("trace: " + json.dumps({k: rec[k] for k in ("units", "busy_s", "window_s",
                                                          "launches", "host_wall_s")}
                                     | {"work": rec.get("work")}), flush=True)
    else:
        out = cell.window(args.seconds)
        attempted, failed = out["attempted"], out["failed"]
        values = dict(out["metrics"], setup_s=setup_s)
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            if dev.type == "cuda":
                result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        device_extra = {}
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    checks = cell.check()
    missing = [name for name, _ in checks if name not in limits]
    if missing:
        raise KeyError(f"no limit for {missing} in portbench/limits/{args.workload}.json")
    correct = all(value <= limits[name] for name, value in checks) and failed == 0

    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark's process must not hold: {found}", file=sys.stderr)
        return 4
    if dev.type == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                  "memory_peak_bytes": peak, "power_limit": power_limit(), **device_extra}
    else:
        device = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0,
                  "memory_peak_bytes": 0}
    for name, value in checks:
        print(f"{name} {value!r} limit {limits[name]!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": result_metrics, "device": device, **extra,
              "checks": {name: {"value": value, "limit": limits[name]} for name, value in checks}}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
