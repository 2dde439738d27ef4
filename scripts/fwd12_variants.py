"""The v1 / v2 forward compositors' bits against another checkout's
kernels, and their timing ablations.

Builds csrc/composite_fwd.cu and composite2_fwd.cu with the timing
ablations FWD12_ABL = 1 (no emission at hits) and 2 (the pairs past the
early miss counted, not taken; both wrong by design, timed only), and
with ``--parent DIR`` also DIR's composite_fwd.cu and composite2_fwd.cu (a
checkout of an earlier commit, e.g. unpacked with ``git archive``). Then,
on the inputs of chip_smoke.py's v1 / v2 frames (phases 12 and 14: every
forward launch of one 2-spp frame) and train steps (phases 13 and 15: the
forward launch), on every chip_smoke.fwd12_cases tile set, and on one
such set (R = 256, k = 4) with NaN, -inf, -0.0 and negative opacities put
among the columns of opacity > 0 at the front of each tile (the kernel
skips a finite opacity <= 0 and walks NaN and -inf):

- the path's build (the repo's kernel as the wrapper launches it) against
  the parent's, bit for bit (NaN-aware), with the first ray that differs
  (tile, ray, L, beta of both); on the special set also how many rays the
  special opacities moved (against the set without them);
- the path's build against the plain version (chip_smoke.compare; not on
  the special set, whose NaN the plain version takes differently);
- the time of each build on each launch set (the sum over its launches of
  chip_smoke.cuda_ms, 10 launches each), in turns, ``--rounds`` times,
  the order reversed every other round.

Prints the card's name and power limit, then one JSON line per launch set.
On the card only.

Usage: python3 scripts/fwd12_variants.py [--parent DIR] [--rounds 2]
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
from volprim_tpu_torch import train  # noqa: E402
from volprim_tpu_torch.kernels import _build, composite  # noqa: E402
from volprim_tpu_torch.models import rf_tiled  # noqa: E402
from volprim_tpu_torch.scene import CameraSpecs, look_at, synthetic  # noqa: E402

SOURCES = {"pallas": "composite_fwd", "pallas2": "composite2_fwd"}
# timing ablations (FWD12_ABL 1, 2)
ABLATIONS = {"abl_noemis": 1, "abl_nohit": 2}
SPECIAL = (float("nan"), float("-inf"), -0.0, -0.3)


def build_all(out_dir: Path, parent: Path = None) -> dict:
    """{(source, build): loaded library}, one nvcc per build, together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), []
    for src in SOURCES.values():
        jobs = [(tag, [f"-DFWD12_ABL={a}"], _build.CSRC_DIR) for tag, a in ABLATIONS.items()]
        if parent is not None:
            jobs.append(("parent", [], parent / "volprim_tpu_torch" / "csrc"))
        for tag, flags, csrc in jobs:
            so = out_dir / f"{src}_{tag}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(so), str(csrc / f"{src}.cu")]
            procs.append((src, tag, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, tag, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src} ({tag}):\n{log}")
        libs[(src, tag)] = ctypes.CDLL(str(so))
        for row in cs.ptxas_table(log):
            if row["kernel"]:
                print(json.dumps({"ptxas": src, "build": tag, **{k: row.get(k) for k in (
                    "kernel", "args", "registers", "spill_stores", "stack")}}), flush=True)
    return libs


def argtypes(src: str) -> list:
    return composite.argtypes(9) if src == "composite_fwd" else composite.argtypes(6, 5)


def use(src, lib) -> None:
    """Make the wrapper's launcher (``_launch``) launch ``lib``: it loads
    csrc/<src>.cu's library through _build's cache."""
    fn = getattr(lib, src)
    fn.argtypes, fn.restype = argtypes(src), ctypes.c_int
    err = getattr(lib, f"{src}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    lib.error_string = err
    _build._LIBS[src] = lib


def recorded_sets(backend: str, dev) -> dict:
    """{launch set: [(tensors, keywords)]}: the frame's and the train
    step's forward launches, as chip_smoke records them."""
    api = cs.V12Api(backend)
    cfg = rf_tiled.RFTiledConfig(backend=backend, **cs.V12)
    camera = CameraSpecs(name="bench", width=cs.WIDTH, height=cs.WIDTH,
                         to_world=look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]), fov=50.0)
    base = synthetic.make_scene(cs.N_PRIMS, device=dev)
    state = rf_tiled.build_state(base, cfg)
    _, _, frame = cs.record_launches(
        api.fwd_mod, "_launch", api.fwd_counter,
        lambda: rf_tiled.render_state(state, camera, cfg, None, spp=cs.SPP, seed=1))
    params = {"centers": base.centers, "scales": base.scales, "quats": base.quats,
              "opacities": base.attrs["opacities"], "sh_coeffs": base.attrs["sh_coeffs"]}
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}

    def step():
        img = train.render_cameras(train.to_scene(params, base), [camera], cfg, spp=1, seed=0)
        torch.mean(torch.abs(img)).backward()

    _, _, stp = cs.record_launches(api.fwd_mod, "_launch", api.fwd_counter, step)
    sets = {"frame": [api.split(a) for a in frame], "train_step": [api.split(a) for a in stp]}
    for label, tensors, kw in cs.fwd12_cases(backend, dev):
        sets[f"synthetic_{label}"] = [(tensors, kw)]
    return sets


def special_set(backend, dev):
    """(plain launches, launches with special opacities): one
    fwd12_cases tile set, R = 256, k = 4, max_depth 128, with SPECIAL's
    values in turn on every fifth of the first 40 columns of opacity > 0
    of each tile (the front of its depth order, under the cap)."""
    tensors, _, kw = cs.synthetic12(backend, 16, 256, 2048, seed=256, dev=dev)
    special = [x.clone() for x in tensors]
    opac = special[5][:, 0] if backend == "pallas" else special[2][:, 0]
    for t in range(opac.shape[0]):
        cols = torch.nonzero(opac[t] > 0).flatten()[:40:5].tolist()
        for i, c in enumerate(cols):
            opac[t, c] = SPECIAL[i % len(SPECIAL)]
    return [(tensors, kw)], [(special, kw)]


def first_diff(got, want):
    """The first ray whose L or beta differs in its bits, or None."""
    bits = lambda x: x.view(torch.int32)  # noqa: E731
    d = (bits(got[0]) != bits(want[0])).any(dim=-1) | (bits(got[1]) != bits(want[1]))
    if not bool(d.any()):
        return None
    t, r = (int(x) for x in torch.nonzero(d)[0])
    return dict(tile=t, ray=r, L=got[0][t, r].tolist(), L_other=want[0][t, r].tolist(),
                beta=float(got[1][t, r]), beta_other=float(want[1][t, r]),
                rays=int(d.sum()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="checkout whose forward kernels to compare")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fwd12_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    libs = build_all(_build.BUILD_DIR / "fwd12_variants", args.parent)
    timed = ["path"] + (["parent"] if args.parent else []) + list(ABLATIONS)
    for backend, src in SOURCES.items():
        api = cs.V12Api(backend)
        libs[(src, "path")] = _build.bind(src, argtypes(src))
        sets = recorded_sets(backend, dev)
        plain_special, sets["special_opacities"] = special_set(backend, dev)
        for name, launches in sets.items():
            with torch.no_grad():
                use(src, libs[(src, "path")])
                path = [api.fwd(*x, **kw) for x, kw in launches]
                row = dict(backend=backend, set=name, launches=len(launches),
                           ms={t: [] for t in timed})
                if name == "special_opacities":
                    moved = [first_diff(p, api.fwd(*x, **kw))
                             for p, (x, kw) in zip(path, plain_special)]
                    row["rays_moved_by_special"] = sum(d["rays"] for d in moved if d)
                else:
                    plain = [api.fwd_ref(*x, **kw) for x, kw in launches]
                    nr = [x[0].shape[0] * x[0].shape[1] for x, _ in launches]
                    row["path_rays_outside_tol"] = sum(
                        cs.compare(g[i], p[i], n)["rays_outside_tol"]
                        for g, p, n in zip(path, plain, nr) for i in (0, 1))
                    del plain
                if args.parent:
                    use(src, libs[(src, "parent")])
                    diffs = [first_diff(p, api.fwd(*x, **kw))
                             for p, (x, kw) in zip(path, launches)]
                    row["equal_to_parent"] = all(d is None for d in diffs)
                    row["diff_to_parent"] = next((d for d in diffs if d), None)
                del path
                for rnd in range(args.rounds):
                    for tag in (timed if rnd % 2 == 0 else timed[::-1]):
                        use(src, libs[(src, tag)])
                        row["ms"][tag].append(sum(
                            cs.cuda_ms(lambda: api.fwd(*x, **kw), 10) for x, kw in launches))
            use(src, libs[(src, "path")])
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
