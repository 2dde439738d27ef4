"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Drives volprim_tpu_torch's render path (synthetic 262,144-primitive surface
scene -> build_state -> render_state, 512x512 film, 2 spp, the headline
configuration of bench.py) and checks the hand-written CUDA compositor on
the way, in phases that each print one line:

1. probe: the card, its power limit, TF32 off;
2. build: nvcc builds csrc/composite3_fwd.cu from this checkout;
3. kernel: the kernel against its plain PyTorch version at the headline
   shapes (T=64 tiles, R=512 rays, S=2048 and 8192 columns, seg 256,
   k=4, bf16 SH, compaction on and off), with CUDA-event timings;
4. main path: the frame through the kernel (launch counts, frame time,
   Mrays/s, peak memory, mean radiance), then the kernel against its plain
   version on the inputs that frame gave it;
5. quality: a 1-spp unjittered frame against the exact-order integrator on
   a fixed 4096-pixel subsample (PSNR).

Then a JSON line with each kernel's numbers, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. There
is no CPU mode: without a CUDA card it exits with an error. ``--out DIR``
also writes the details and a torch.profiler table of two frames there.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerance of a kernel against its plain version on the card: native
# expf/log1pf and another summation order than torch's cumsum/matmul.
ATOL, RTOL = 1e-4, 1e-3
# ...except where a ray's log-transmittance lands within rounding of
# log(beta_kill): the two versions then disagree on one emission weight
# (at most beta_kill times the emission). Allowed on at most this share of
# the rays; every such ray is counted and printed.
KILL_FLIP_SHARE = 1e-4
KILL_FLIP_ATOL = 0.05

HEADLINE = dict(
    max_depth=128, tile_pixels=256, max_candidates=2048, segment=256,
    cluster_size=16, backend="fused", early_exit=True, coarse_group=4,
    coarse_factor=8, super_group=4,
    budget_classes=((0.35, 128), (0.3, 192), (0.2, 288), (0.1, 384), (0.05, 512)),
    kernel_compact=True, cluster_sort=True,
)
N_PRIMS, WIDTH, SPP = 262144, 512, 2


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_times(fn, reps: int, warmup: int = 2) -> list:
    """Device times of fn() in ms, sorted, over reps runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events)."""
    return float(np.median(cuda_times(fn, reps, warmup)))


def compare(got, want, n_rays: int) -> dict:
    """Max abs / rel difference and the rays outside the tolerance."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bad = diff > ATOL + RTOL * want.abs()
    bad_rays = int(bad.reshape(n_rays, -1).any(dim=1).sum())
    return {
        "max_abs": float(diff.max()),
        "max_rel": float((diff / want.abs().clamp(min=1e-6)).max()),
        "rays_outside_tol": bad_rays,
        "max_abs_outside_tol": float(diff[bad].max()) if bad_rays else 0.0,
        "ok": bad_rays <= KILL_FLIP_SHARE * n_rays
        and (not bad_rays or float(diff[bad].max()) <= KILL_FLIP_ATOL),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for details and a profiler table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is False); the port's "
             "kernels have no CPU mode here")

    from volprim_tpu_torch.kernels import _build, composite3
    from volprim_tpu_torch.models import rf, rf_tiled
    from volprim_tpu_torch.scene import CameraSpecs, generate_rays, look_at, synthetic

    dev = torch.device("cuda", 0)
    details = {}

    # ---- 1. probe -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unavailable"
    print(smi_line, flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on; the quadric math must stay full f32")
    phase(
        "probe", device=torch.cuda.get_device_name(0),
        capability=list(torch.cuda.get_device_capability(0)),
        count=torch.cuda.device_count(), nvidia_smi=smi_line,
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
    )

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    composite3._lib()
    info = _build.build_info.get("composite3_fwd", {})
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines() if "registers" in ln]
    phase("build", kernel="composite3_fwd", seconds=round(time.perf_counter() - t0, 2),
          nvcc_seconds=round(info.get("seconds", 0.0), 2), ptxas=ptxas)

    # ---- 3. kernel vs plain version at the headline shapes ---------------
    checks = []
    kw = dict(seg=256, extent2=9.0, max_depth=128, beta_kill=0.01, sh_k=4)
    for s in (2048, 8192):
        inputs = composite3.synthetic_tiles(64, 512, s, 256, 4, seed=s, device=dev)
        want = composite3.composite_tiles3_reference(*inputs, **kw)
        plain_ms = cuda_ms(lambda: composite3.composite_tiles3_reference(*inputs, **kw), 20)
        for compact in (False, True):
            got = composite3.composite_tiles3(*inputs, compact=compact, **kw)
            torch.cuda.synchronize()
            cl = compare(got[0], want[0], 64 * 512)
            cb = compare(got[1], want[1], 64 * 512)
            ms = cuda_ms(lambda: composite3.composite_tiles3(*inputs, compact=compact, **kw), 20)
            row = dict(S=s, compact=compact, L=cl, beta=cb, ms=ms, plain_ms=plain_ms)
            checks.append(row)
            phase("kernel", **row)
            if not (cl["ok"] and cb["ok"]):
                fail(f"kernel disagrees with its plain version at S={s} compact={compact}")
    details["kernel_checks"] = checks

    # ---- 4. main path ---------------------------------------------------
    t0 = time.perf_counter()
    scene = synthetic.make_scene(N_PRIMS, device=dev)
    cfg = rf_tiled.RFTiledConfig(**HEADLINE)
    camera = CameraSpecs(
        name="bench", width=WIDTH, height=WIDTH,
        to_world=look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]), fov=50.0,
    )
    state = rf_tiled.build_state(scene, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    build_ms = cuda_ms(lambda: rf_tiled.build_state(scene, cfg), 3, warmup=1)

    def frame(seed=0):
        return rf_tiled.render_state(state, camera, cfg, None, spp=SPP, seed=seed)

    # the counted run: launch counts reset just before, read just after;
    # the launch arguments are recorded on the way (the recorder wraps the
    # launch helper, so the count stays on composite_tiles3)
    recorded = []
    launch = composite3._launch

    def recording(*a):
        recorded.append(a)
        return launch(*a)

    composite3._launch = recording
    composite3.composite_tiles3.launches = 0
    try:
        img = frame(seed=1)
        torch.cuda.synchronize()
    finally:
        launches = composite3.composite_tiles3.launches
        composite3._launch = launch
    n_classes = len(cfg.budget_classes)
    fold = max(1, min(SPP, 512 // cfg.tile_pixels))
    while SPP % fold:
        fold -= 1
    if launches != n_classes * (SPP // fold) or launches != len(recorded):
        fail(f"composite_tiles3 launched {launches} times, expected "
             f"{n_classes * (SPP // fold)} (one per budget class and sample group)")
    if tuple(img.shape) != (WIDTH, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        fail("the frame is not a finite [512, 512, 3] image")
    torch.cuda.reset_peak_memory_stats()
    seeds = iter(range(100, 200))
    frame_times = cuda_times(lambda: frame(next(seeds)), 10)
    frame_ms = float(np.median(frame_times))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    mrays = WIDTH * WIDTH * SPP / (frame_ms / 1e3) / 1e6
    phase(
        "main_path", launches=launches, frame_ms=frame_ms,
        frame_ms_min=frame_times[0], frame_ms_max=frame_times[-1], mrays_per_s=mrays,
        peak_mem_gib=peak_gib, mean_radiance=float(img.mean()),
        build_state_ms=build_ms, setup_s=round(setup_s, 2),
        class_tiles=[int(a[0].shape[0]) for a in recorded],
        class_columns=[int(a[1].shape[2]) for a in recorded],
    )

    # the kernel against its plain version on the frame's own inputs
    path_checks, path_ms, path_plain_ms = [], 0.0, 0.0
    for d8, pf, sh3, n_seg_t, seg, extent2, max_depth, beta_kill, sh_k, compact in recorded:
        inputs = (d8, pf, sh3, n_seg_t)
        kw = dict(seg=seg, extent2=extent2, max_depth=max_depth,
                  beta_kill=beta_kill, sh_k=sh_k)
        want = composite3.composite_tiles3_reference(*inputs, **kw)
        got = composite3.composite_tiles3(*inputs, compact=compact, **kw)
        torch.cuda.synchronize()
        n_rays = d8.shape[0] * d8.shape[2]
        cl, cb = compare(got[0], want[0], n_rays), compare(got[1], want[1], n_rays)
        ms = cuda_ms(lambda: composite3.composite_tiles3(*inputs, compact=compact, **kw), 10)
        # the same launch with compaction flipped: what compaction buys
        ms_flipped = cuda_ms(
            lambda: composite3.composite_tiles3(*inputs, compact=not compact, **kw), 10
        )
        plain_ms = cuda_ms(
            lambda: composite3.composite_tiles3_reference(*inputs, **kw), 3, warmup=1
        )
        path_ms += ms
        path_plain_ms += plain_ms
        row = dict(tiles=int(d8.shape[0]), rays=int(d8.shape[2]), S=int(pf.shape[2]),
                   compact=compact, L=cl, beta=cb, ms=ms, ms_compact_flipped=ms_flipped,
                   plain_ms=plain_ms)
        path_checks.append(row)
        phase("kernel_on_frame_inputs", **row)
        if not (cl["ok"] and cb["ok"]):
            fail("kernel disagrees with its plain version on the frame's inputs")
    details["frame_kernel_checks"] = path_checks

    # ---- 5. quality vs the exact-order integrator ------------------------
    img1 = rf_tiled.render_state(state, camera, cfg, None, spp=1, seed=0, jitter=False)
    o, d = generate_rays(camera, jitter=False, device=dev)
    sel = torch.from_numpy(
        np.random.default_rng(0).choice(WIDTH * WIDTH, size=4096, replace=False)
    ).to(dev)
    t0 = time.perf_counter()
    exact = rf.radiance(scene, None, o[sel], d[sel], rf.RFConfig(
        max_depth=128, srgb_primitives=True, chunk_size=2048))
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    tiled = img1.reshape(-1, 3)[sel]
    if not bool(torch.isfinite(exact).all()):
        fail("the exact-order reference is not finite")
    mse = float(torch.mean((tiled - exact) ** 2))
    psnr = -10.0 * math.log10(max(mse, 1e-12))
    phase("quality", psnr_vs_exact_db=psnr, pixels=4096, exact_s=round(exact_s, 2),
          mean_tiled=float(tiled.mean()), mean_exact=float(exact.mean()))
    if not psnr > 20.0:
        fail(f"PSNR vs the exact-order integrator is {psnr:.2f} dB")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        from torch.profiler import ProfilerActivity, profile

        n_prof = 2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n_prof):
                frame(seed=300 + i)
            torch.cuda.synchronize()
        events = prof.key_averages()
        # device-side rows only (kernels, copies); CPU-op rows repeat them
        busy_us = sum(
            e.self_device_time_total for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
        )
        busy_ms = busy_us / 1e3 / n_prof
        details["device_busy_ms_per_frame"] = busy_ms
        details["device_idle_share"] = 1.0 - busy_ms / frame_ms
        phase("profile", device_busy_ms_per_frame=busy_ms,
              device_idle_share=details["device_idle_share"])
        with open(os.path.join(args.out, "chip_smoke_profile.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
        with open(os.path.join(args.out, "chip_smoke_details.json"), "w") as f:
            json.dump(details, f, indent=1)

    worst = max(
        [c[x]["max_abs"] for c in checks + path_checks for x in ("L", "beta")]
    )
    print(json.dumps({"kernels": [{
        "name": "composite3_fwd",
        "route": "cuda",
        "source": "volprim_tpu_torch/csrc/composite3_fwd.cu",
        "replaces": "volprim_tpu/pallas_kernels/composite3.py:496",
        "launches": launches,
        "max_abs_err": worst,
        "ms": path_ms,
        "plain_ms": path_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
