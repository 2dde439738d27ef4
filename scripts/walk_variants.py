"""The free-flight walk kernel's bits against another checkout's, and its
time by piece.

Builds csrc/ffwalk.cu with the timing ablations FFWALK_ABL = 1 (a found
ray skips the bisection, the snap and the solver) and 2 (also no window
depth, so no ray is found; both wrong by design, timed only), with
``--parent DIR`` also DIR's csrc/ffwalk.cu (a checkout of an earlier commit,
e.g. unpacked with ``git archive``), and with ``--build TAG=FILE`` any other
source of the same C entry point. Then, on chip_smoke.py's launch sets (the
eight ffwalk.WALK_VARIANTS on the tables of 65,536 plume camera rays, as in
its phase 9, the same tables at k = 96 and 4,096 rays' tables at K' = k =
1024 (the kernel's shared-memory slots, past the 48 KB opt-in), and every
walk launch of one 512x512 plume frame, recorded and replayed as in its
phase 10):

- the path's build (the repo's kernel as the wrapper launches it) against
  the parent's and each other build's, all five outputs bit for bit
  (NaN-aware), with the first ray that differs;
- the path's build against the plain version (chip_smoke.compare_walk);
- the time of each build on each set, the sum over its launches of
  chip_smoke.launch_ms of ffwalk._launch (phase 10's yardstick), in turns,
  ``--rounds`` times, the order reversed every other round (on the frame
  also each launch's, from the last round), and the kernel's own device
  time over one pass (torch.profiler);
- on the frame's launches, the walk by piece: the launch floor (the same
  launches with every ray inactive), the selection (ablation 2 less the
  floor; its rays walk until resolved, so more windows than the path's),
  the windows' depth (1 less 2) and the found rays' bisection, snap and
  solve (the path less 1).

Prints the card's name and power limit, ptxas's rows of each build, then
one JSON line per launch set. On the card only.

Usage: python3 scripts/walk_variants.py [--parent DIR] [--build TAG=FILE]... [--rounds 2]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from volprim_tpu_torch.kernels import _build, ffwalk  # noqa: E402
from volprim_tpu_torch.models import prb, render  # noqa: E402
from volprim_tpu_torch.ops import envmap  # noqa: E402
from volprim_tpu_torch.scene import generate_rays, synthetic  # noqa: E402

ABLATIONS = {"abl_nobisect": 1, "abl_select": 2}


def build_all(out_dir: Path, sources: dict) -> dict:
    """{tag: loaded library} for {tag: (source, extra nvcc flags)}, one
    nvcc per build, all started together; prints ptxas's rows."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), []
    for tag, (src, flags) in sources.items():
        so = out_dir / f"ffwalk_{tag}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(so), str(src)]
        procs.append((tag, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on ffwalk ({tag}):\n{log}")
        libs[tag] = ctypes.CDLL(str(so))
        for row in cs.ptxas_table(log):
            print(json.dumps({"ptxas": "ffwalk", "build": tag, **{k: row.get(k) for k in (
                "function", "kernel", "args", "registers", "spill_stores", "stack")}}),
                flush=True)
    return libs


def use(lib) -> None:
    """Make ffwalk._launch launch ``lib`` (it loads the library through
    _build's cache, bound once)."""
    lib.ffwalk.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ffwalk.restype = ctypes.c_int
    err = lib.ffwalk_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    lib.error_string = err
    _build._LIBS["ffwalk"] = lib


def launch_sets(dev) -> dict:
    """{set: [(args, keywords)]}: the variants (one launch each) and the
    frame's walk launches."""
    medium = synthetic.make_medium(cs.PRB_PRIMS, seed=0, device=dev)
    pcam = synthetic.medium_camera(cs.PRB_WIDTH, cs.PRB_WIDTH)
    po, pd = generate_rays(pcam, jitter=False, device=dev)
    w, q = cs.PRB_WIDTH, cs.PRB_WIDTH // 4
    center = (slice(q, 3 * q), slice(q, 3 * q))
    oc = po.reshape(w, w, 3)[center].reshape(-1, 3).contiguous()
    dc = pd.reshape(w, w, 3)[center].reshape(-1, 3).contiguous()
    tables = ffwalk.synthetic_tables(medium, oc, dc, 256, seed=9)
    sets = {}
    for name in ffwalk.WALK_VARIANTS:
        tb, kw = ffwalk.walk_variant(tables, name, seed=9)
        sets[name] = [(list(tb.values()), cs.walk_kwargs(kw))]
    # the other size class, slots in shared memory (k > 64), and K' = k =
    # 1024, whose shared memory needs the opt-in past 48 KB
    sets["k96_w3"] = [(sets["kp256_k32_w4"][0][0], cs.walk_kwargs(dict(k=96, n_windows=3)))]
    del tables
    big = ffwalk.synthetic_tables(medium, oc[:4096], dc[:4096], 1024, seed=9)
    sets["kp1024_k1024_w1"] = [(list(big.values()),
                                cs.walk_kwargs(dict(k=1024, n_windows=1)))]

    recorded, launch = [], ffwalk._launch

    def hook(*a, **k):
        recorded.append((a, k))
        return launch(*a, **k)

    sky = envmap.procedural_sky(device=dev)
    pcfg = prb.PRBConfig(max_depth=-1, walk_backend="pallas")
    ffwalk._launch = hook
    try:
        render(medium, pcam, prb.radiance, pcfg, sky, 1,
               torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
    finally:
        ffwalk._launch = launch
    sets["frame"] = recorded
    return sets


def first_diff(got, want):
    """The first ray where any of the five outputs differs in its bits, or
    None."""
    d = torch.zeros_like(got[0])
    for g, w in zip(got[:4], want[:4]):
        d |= g != w
    d |= got[4].view(torch.int32) != want[4].view(torch.int32)
    if not bool(d.any()):
        return None
    i = int(torch.nonzero(d)[0, 0])
    return dict(ray=i, rays=int(d.sum()), got=[float(x[i]) for x in got],
                other=[float(x[i]) for x in want])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="checkout whose walk kernel to compare")
    ap.add_argument("--build", action="append", default=[], metavar="TAG=FILE",
                    help="another ffwalk.cu to compare and time")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("walk_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    src = _build.CSRC_DIR / "ffwalk.cu"
    sources = {tag: (src, [f"-DFFWALK_ABL={a}"]) for tag, a in ABLATIONS.items()}
    if args.parent:
        sources["parent"] = (args.parent / "volprim_tpu_torch" / "csrc" / "ffwalk.cu", [])
    for spec in args.build:
        tag, path = spec.split("=", 1)
        sources[tag] = (Path(path), [])
    libs = build_all(_build.BUILD_DIR / "walk_variants", sources)
    libs["path"] = ffwalk._lib()
    for row in cs.ptxas_table(_build.build_log("ffwalk")):
        print(json.dumps({"ptxas": "ffwalk", "build": "path", **{k: row.get(k) for k in (
            "function", "kernel", "args", "registers", "spill_stores", "stack")}}), flush=True)
    compared = [t for t in libs if t != "path" and t not in ABLATIONS]
    timed = ["path", *compared, *ABLATIONS]

    for name, launches in launch_sets(dev).items():
        row = dict(set=name, launches=len(launches),
                   rays=sum(int(a[0].shape[0]) for a, _ in launches),
                   ms={t: [] for t in timed})
        with torch.no_grad():
            use(libs["path"])
            path = [ffwalk._launch(*a, **k) for a, k in launches]
            torch.cuda.synchronize()
            rows = []
            for p, (a, k) in zip(path, launches):
                got = (*p[:4], torch.where(p[0], p[4], torch.inf))
                rows.append(cs.compare_walk(got, ffwalk.walk_reference(*a, **k),
                                            int(a[8].sum())))
            row["path_rays_differ_plain"] = sum(r["decisions_differ"] + r["t_outside_tol"]
                                                for r in rows)
            row["path_ok"] = all(r["ok"] for r in rows)
            row["found"] = sum(r["found"] for r in rows)
            for tag in compared:
                use(libs[tag])
                diffs = [first_diff(p, ffwalk._launch(*a, **k))
                         for p, (a, k) in zip(path, launches)]
                row[f"equal_to_{tag}"] = all(d is None for d in diffs)
                row[f"diff_to_{tag}"] = next((d for d in diffs if d), None)
            del path
            for rnd in range(args.rounds):
                for tag in (timed if rnd % 2 == 0 else timed[::-1]):
                    use(libs[tag])
                    per = [cs.launch_ms(lambda: ffwalk._launch(*a, **k),
                                        5 if name == "frame" else 10) for a, k in launches]
                    row["ms"][tag].append(sum(per))
                    if name == "frame":
                        row.setdefault("launch_ms", {})[tag] = per
            row["kernel_ms"] = {}
            for tag in timed:
                use(libs[tag])
                row["kernel_ms"][tag] = cs.kernel_device_ms(
                    lambda: [ffwalk._launch(*a, **k) for a, k in launches], "ffwalk_kernel")
            if name == "frame":
                use(libs["path"])
                idle = [([*a[:8], torch.zeros_like(a[8]), a[9]], k) for a, k in launches]
                floor = [sum(cs.launch_ms(lambda: ffwalk._launch(*a, **k), 5) for a, k in idle)
                         for _ in range(args.rounds)]
                mean = {t: sum(v) / len(v) for t, v in row["ms"].items()}
                f = sum(floor) / len(floor)
                row["floor_ms"] = floor
                row["pieces_ms"] = dict(
                    floor=f, selection=mean["abl_select"] - f,
                    depth=mean["abl_nobisect"] - mean["abl_select"],
                    bisect_snap_solve=mean["path"] - mean["abl_nobisect"])
        use(libs["path"])
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
