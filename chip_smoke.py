"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Drives volprim_tpu_torch's render path (synthetic 262,144-primitive surface
scene -> build_state -> render_state, 512x512 film, 2 spp, the headline
configuration of bench.py) and its training step (the same scene, 1 spp,
bench.py's train configuration, L1 loss, backward, BoundedAdam), and checks
the hand-written CUDA compositor kernels on the way, in phases that each
print one line:

1. probe: the card, its power limit, TF32 off;
2. build: nvcc builds csrc/composite3_fwd.cu and csrc/composite3_bwd.cu
   from this checkout, one process each, started together;
3. kernel: the forward kernel against its plain PyTorch version at the
   headline shapes (T=64 tiles, R=512 rays, S=2048 and 8192 columns, seg
   256, k=4, bf16 SH, compaction on and off), with CUDA-event timings;
4. main path: the frame through the kernel (launch counts, frame time,
   Mrays/s, peak memory, mean radiance), then the kernel against its plain
   version on the inputs that frame gave it;
5. quality: a 1-spp unjittered frame against the exact-order integrator on
   a fixed 4096-pixel subsample (PSNR);
6. bwd_kernel: the backward kernel against its plain version on synthetic
   inputs (T=64, R=256 and 512, S=2048, seg 256, k=4, compaction on and
   off) with numpy-made cotangents;
7. train_step: the full-width train step (launch counts, finite nonzero
   gradients of all five parameters, step time, peak memory), then the
   forward and the backward kernel against their plain versions on that
   step's own inputs;
8. train_loop: eight steps of the refine protocol through train.train_step
   (perturbed opacities and SH against a 4-spp render of the scene).

Then a JSON line with each kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero. There is no CPU mode: without a CUDA card it exits with an
error. ``--out DIR`` also writes the details and a torch.profiler table of
two frames there.
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
# bench.py's train step (bench.py:1060-1071): one budget, no cluster sort
TRAIN = dict(
    max_depth=128, tile_pixels=256, max_candidates=2048, segment=256,
    cluster_size=16, backend="fused", early_exit=True, coarse_group=4,
    coarse_factor=8, super_group=4, kernel_compact=True, refine_fraction=0.0,
)

# The backward kernel against its plain version. Its adjoints are
# ill-conditioned in f32 whatever computes them (g_u and the t* parts of
# the M rows are exactly 0 at the closest approach, so in f32 they are
# rounding noise; g_alpha divides by 1 - alpha), and its shared-memory
# atomics sum each column in a varying order. So the plain version also
# runs in f64 as a yardstick, and every element of gpf is held to it:
# - per tile and row, the kernel's deviation from f64 is at most
#   GRAD_BAND times the plain f32 version's largest deviation in that tile
#   row, plus GRAD_FLOOR of the tile row's largest f64 value;
# - per row, over the elements that carry gradient, the kernel's median
#   deviation is at most GRAD_MEDIAN times the plain version's (plus
#   GRAD_FLOOR of the row's median |g|): a kernel that is a little off in
#   many columns, as one that drops some rays' contributions, fails here.
# gsh (bf16) is compared with the plain version's: each element within one
# bf16 ulp of its own value plus GSH_FLOOR of its tile row's largest (for
# sums that cancel), and at most GSH_DIFF_SHARE of the nonzero elements
# rounded differently at all (taking the bf16 basis for the f32 one moves
# most of them by an ulp).
GRAD_BAND = 4.0
GRAD_MEDIAN = 2.0
GRAD_FLOOR = 1e-6
GSH_FLOOR = 1e-5
GSH_DIFF_SHARE = 0.01

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# f32 operations per (ray, surviving column) pair: the pair math every
# pair runs (a 11, b 5, t* 1, p 6, q 14, clamp 1, hit test 2); per hit the
# forward adds alpha 3, the cap 1, w 2, emission 6k + 9 and log1p 2, and
# the backward adds alpha 3, emission 6k + 3, g_w and w 7, the carries 4,
# g_alpha, g_raw and g_q 9, the p, t*, a, b adjoints 31, the 13 rows 28,
# SH 3 + 3k, the sum over rays 13 + 3k and log1p 2
OPS_PAIR = 40


def ops_hit_fwd(k):
    return 17 + 6 * k


def ops_hit_bwd(k):
    return 103 + 12 * k


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


def column_keep(d8, pf):
    """[T, S] columns whose bounding sphere meets the tile's ray cone: the
    kernels' compaction mask, for counting the work they must do."""
    ax0, ax1, ax2, ch, sh_ = (d8[:, i, 0:1] for i in range(3, 8))
    vx, vy, vz, r = -pf[:, 9], -pf[:, 10], -pf[:, 11], pf[:, 14]
    dist2 = vx * vx + vy * vy + vz * vz
    a = vx * ax0 + vy * ax1 + vz * ax2
    b2 = torch.clamp(dist2 - a * a, min=0.0)
    ch2 = ch * ch
    inside = (a > 0.0) & (b2 * ch2 <= (a * a) * (sh_ * sh_))
    rhs = r + a * sh_
    near = (rhs >= 0.0) & (b2 * ch2 <= rhs * rhs)
    keep = (((inside | near) & (a + r > 1e-4)) | (dist2 <= r * r)) & (r >= 0.0)
    return keep


def device_profile(fn, out_dir: str, name: str, n: int = 2) -> float:
    """Device busy ms per call of fn(i) over n calls (torch.profiler's
    device-side rows: kernels and copies; the CPU-op rows repeat them),
    with the table written to out_dir/name."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    return busy_us / 1e3 / n


@torch.no_grad()
def work(composite3, d8, pf, sh3, n_seg_t, seg, extent2, max_depth, sh_k, compact):
    """What one compositor call on these inputs must do: live columns,
    (ray, surviving column) pairs, hits under the cap, and the least time
    of the forward and the backward on this card (ms, and what bounds it).
    Input bytes count the live segments' columns once; outputs are
    written whole."""
    t, _, r = d8.shape
    s = pf.shape[2]
    seg_id = torch.arange(s, device=d8.device) // seg
    live = seg_id[None, :] < n_seg_t.clamp(max=s // seg)[:, None].long()  # [T, S]
    keep = live & column_keep(d8, pf) if compact else live
    pairs = int(keep.sum()) * r
    d3, f6, _, _ = composite3._ray_terms(d8, sh_k, sh3.dtype)
    count = torch.zeros((t, r, 1), device=d8.device)
    hits = 0
    for si in range(s // seg):
        cols = pf[:, :, si * seg:(si + 1) * seg]
        pr = composite3._segment_pairs(
            cols, d3, f6, extent2 * 0.5, (si < n_seg_t.long())[:, None, None]
        )
        depth_ok, count = composite3._capped(pr[7], count, max_depth)
        hits += int((pr[8] & depth_ok).sum())
    n_live = int(live.sum())
    rays_in = t * 8 * r * 4 + t * 4
    cols_in = n_live * (16 * 4 + 3 * sh_k * 2)
    fwd_bytes = rays_in + cols_in + t * r * 4 * 4
    bwd_bytes = rays_in + cols_in + t * r * 4 * 4 + t * s * (16 * 4 + 3 * sh_k * 2)
    out = dict(live_columns=n_live, pairs=pairs, hits=hits)
    for name, nbytes, ops in (
        ("fwd", fwd_bytes, pairs * OPS_PAIR + hits * ops_hit_fwd(sh_k)),
        ("bwd", bwd_bytes, pairs * OPS_PAIR + hits * ops_hit_bwd(sh_k)),
    ):
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        out[f"{name}_bound_ms"] = max(t_bytes, t_ops)
        out[f"{name}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        out[f"{name}_bytes"], out[f"{name}_ops"] = nbytes, ops
    return out


def bf16_ulp(x):
    """One bf16 ulp of each element of |x| (0 where x is 0)."""
    _, e = torch.frexp(x.abs())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x), e - 8), 0.0)


def compare_grads(got, plain, yard) -> dict:
    """The backward kernel's (gpf, gsh) against the plain version's, with
    the plain version's gpf in f64 as the yardstick (see GRAD_BAND). Per
    row of gpf it reports the median band beside the median |g|, so a
    reader can see the check is tight enough to fail a wrong kernel."""
    gk, sk = got
    gp, sp = plain
    gy = yard.double()
    e_k, e_p = (gk.double() - gy).abs(), (gp.double() - gy).abs()
    tile_row = gy.abs().amax(dim=2, keepdim=True)  # [T, 16, 1]
    band = GRAD_BAND * e_p.amax(dim=2, keepdim=True) + GRAD_FLOOR * tile_row
    outside = e_k > band
    carry = gy != 0
    rows, medians_ok = [], True
    for i in range(16):
        m = carry[:, i]
        if not bool(m.any()):
            rows.append(None)
            continue
        med = lambda x: float(x[:, i][m].median())  # noqa: E731
        g_med, k_med, p_med = med(gy.abs()), med(e_k), med(e_p)
        ok = k_med <= GRAD_MEDIAN * p_med + GRAD_FLOOR * g_med
        medians_ok &= ok
        rows.append({
            "median_g": g_med, "median_band": med(band.expand_as(gy)),
            "median_dev": k_med, "median_dev_plain": p_med,
            "outside": int(outside[:, i].sum()), "median_ok": ok,
        })
    sk, sp = sk.float(), sp.float()
    sdiff = (sk - sp).abs()
    s_band = bf16_ulp(torch.maximum(sk.abs(), sp.abs())) + GSH_FLOOR * sp.abs().amax(
        dim=2, keepdim=True
    )
    s_out = int((sdiff > s_band).sum())
    s_nz = (sk != 0) | (sp != 0)
    s_share = float((sdiff[s_nz] > 0).float().mean()) if bool(s_nz.any()) else 0.0
    tile_row_p = gp.abs().amax(dim=2, keepdim=True).clamp(min=1e-30)
    tile_row_s = sp.abs().amax(dim=2, keepdim=True).clamp(min=1e-30)
    return {
        "gpf": {
            "max_abs": float((gk - gp).abs().max()),
            "max_rel_tile_row": float(((gk - gp).abs() / tile_row_p).max()),
            "elements_outside_band": int(outside.sum()), "rows": rows,
        },
        "gsh": {
            "max_abs": float(sdiff.max()),
            "max_rel_tile_row": float((sdiff / tile_row_s).max()),
            "elements_outside_ulp": s_out,
            "share_differing": s_share,
        },
        "ok": not bool(outside.any()) and medians_ok and s_out == 0
        and s_share <= GSH_DIFF_SHARE,
    }


@torch.no_grad()
def check_bwd(composite3, args, kw, compact, reps=10):
    """The backward kernel on ``args`` = (d8, pf, sh3, n_seg_t, g_l,
    g_beta) against its plain version (f32, and f64 as the yardstick),
    with CUDA-event times of both."""
    d8, pf, sh3, n_seg_t, g_l, g_beta = args
    got = composite3.composite_tiles3_bwd(*args, compact=compact, **kw)
    plain = composite3.composite_tiles3_bwd_reference(*args, **kw)
    yard, _ = composite3.composite_tiles3_bwd_reference(
        d8.double(), pf.double(), sh3, n_seg_t, g_l, g_beta, **kw
    )
    torch.cuda.synchronize()
    cmp_ = compare_grads(got, plain, yard)
    del yard
    ms = cuda_ms(lambda: composite3.composite_tiles3_bwd(*args, compact=compact, **kw), reps)
    plain_ms = cuda_ms(
        lambda: composite3.composite_tiles3_bwd_reference(*args, **kw), 3, warmup=1
    )
    return cmp_, ms, plain_ms


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

    # ---- 2. build: one nvcc per source, all started together ------------
    t0 = time.perf_counter()
    names = ("composite3_fwd", "composite3_bwd")
    _build.build(*names)
    for name in names:
        composite3._lib(name)
    seconds = round(time.perf_counter() - t0, 2)
    for name in names:
        info = _build.build_info.get(name, {})
        ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", kernel=name, seconds=seconds,
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
    fwd_work = [work(composite3, *a[:4], a[4], a[5], a[6], a[8], a[9]) for a in recorded]
    phase("frame_kernel_work", classes=fwd_work)
    details["frame_kernel_work"] = fwd_work

    # ---- 6. backward kernel vs plain version, synthetic inputs ------------
    bwd_checks = []
    kw = dict(seg=256, extent2=9.0, max_depth=128, beta_kill=0.01, sh_k=4)
    for r in (256, 512):
        inputs = composite3.synthetic_tiles(64, r, 2048, 256, 4, seed=r, device=dev)
        rng = np.random.default_rng(r)
        cot = [torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(np.float32)).to(dev)
               for shape in ((64, r, 3), (64, r))]
        for compact in (False, True):
            cmp_, ms, plain_ms = check_bwd(composite3, (*inputs, *cot), kw, compact, 20)
            row = dict(T=64, R=r, S=2048, compact=compact, **cmp_, ms=ms, plain_ms=plain_ms)
            bwd_checks.append(row)
            phase("bwd_kernel", **row)
            if not cmp_["ok"]:
                fail(f"backward kernel disagrees with its plain version at R={r} "
                     f"compact={compact}")
    details["bwd_kernel_checks"] = bwd_checks

    # ---- 7. the train step at full width ---------------------------------
    from volprim_tpu_torch import interop, train

    tcfg = rf_tiled.RFTiledConfig(**TRAIN)
    base = synthetic.make_scene(N_PRIMS, device=dev)
    params = {
        "centers": base.centers, "scales": base.scales, "quats": base.quats,
        "opacities": base.attrs["opacities"], "sh_coeffs": base.attrs["sh_coeffs"],
    }
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}

    def bench_step(seed):
        for p in params.values():
            p.grad = None
        img = train.render_cameras(train.to_scene(params, base), [camera], tcfg,
                                   spp=1, seed=seed)
        loss = torch.mean(torch.abs(img))  # L1 against a zero image (bench.py)
        loss.backward()
        return loss.detach()

    recorded_bwd = []
    launch_bwd = composite3._launch_bwd

    def recording_bwd(*a):
        recorded_bwd.append(a)
        return launch_bwd(*a)

    composite3._launch_bwd = recording_bwd
    composite3.composite_tiles3.launches = 0
    composite3.composite_tiles3_bwd.launches = 0
    try:
        loss0 = bench_step(0)
        torch.cuda.synchronize()
    finally:
        step_launches = (composite3.composite_tiles3.launches,
                         composite3.composite_tiles3_bwd.launches)
        composite3._launch_bwd = launch_bwd
    if step_launches != (1, 1) or len(recorded_bwd) != 1:
        fail(f"the train step launched (forward, backward) {step_launches} times, "
             "expected (1, 1)")
    grad_stats = {}
    for k in interop.TRAIN_KEYS:
        g = params[k].grad
        if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            fail(f"the gradient of {k} is missing, not finite or all zero")
        grad_stats[k] = float(g.abs().max())
    torch.cuda.reset_peak_memory_stats()
    step_times = cuda_times(lambda: bench_step(1), 5, warmup=1)
    step_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    d8, pf, sh3, n_seg_t, g_l, g_beta, seg, extent2, max_depth, beta_kill, sh_k, compact = (
        x.detach() if torch.is_tensor(x) else x for x in recorded_bwd[0]
    )
    bkw = dict(seg=seg, extent2=extent2, max_depth=max_depth, beta_kill=beta_kill,
               sh_k=sh_k)
    train_work = work(composite3, d8, pf, sh3, n_seg_t, seg, extent2, max_depth, sh_k,
                      compact)
    # the forward kernel against its plain version on the step's inputs
    # (256-ray tiles: its only check at this block size)
    fwd_inputs = (d8, pf, sh3, n_seg_t)
    want = composite3.composite_tiles3_reference(*fwd_inputs, **bkw)
    got = composite3.composite_tiles3(*fwd_inputs, compact=compact, **bkw)
    torch.cuda.synchronize()
    n_rays = d8.shape[0] * d8.shape[2]
    cl, cb = compare(got[0], want[0], n_rays), compare(got[1], want[1], n_rays)
    del want, got
    fwd_train_ms = cuda_ms(
        lambda: composite3.composite_tiles3(*fwd_inputs, compact=compact, **bkw), 10
    )
    fwd_train_plain_ms = cuda_ms(
        lambda: composite3.composite_tiles3_reference(*fwd_inputs, **bkw), 3, warmup=1
    )
    fwd_step_row = dict(L=cl, beta=cb, ms=fwd_train_ms, plain_ms=fwd_train_plain_ms)
    phase("fwd_kernel_on_step_inputs", **fwd_step_row)
    details["train_step_fwd"] = fwd_step_row
    if not (cl["ok"] and cb["ok"]):
        fail("forward kernel disagrees with its plain version on the step's inputs")
    step_ms = float(np.median(step_times))
    if args.out:
        busy_ms = device_profile(lambda i: bench_step(10 + i), args.out,
                                 "chip_smoke_train_profile.txt")
        details["train_device_busy_ms_per_step"] = busy_ms
        details["train_device_idle_share"] = 1.0 - busy_ms / step_ms
    phase(
        "train_step", launches_fwd=step_launches[0], launches_bwd=step_launches[1],
        loss=float(loss0), step_ms=step_ms,
        step_ms_min=step_times[0], step_ms_max=step_times[-1],
        peak_mem_gib=step_peak_gib, grad_max_abs=grad_stats,
        tiles=int(d8.shape[0]), rays=int(d8.shape[2]), S=int(pf.shape[2]),
        fwd_kernel_ms=fwd_train_ms,
        device_busy_ms=details.get("train_device_busy_ms_per_step"),
        device_idle_share=details.get("train_device_idle_share"), **train_work,
    )
    cmp_, bwd_ms, bwd_plain_ms = check_bwd(
        composite3, (d8, pf, sh3, n_seg_t, g_l, g_beta), bkw, compact
    )
    row = dict(**cmp_, ms=bwd_ms, plain_ms=bwd_plain_ms,
               step_share=(bwd_ms + fwd_train_ms) / step_ms)
    phase("bwd_kernel_on_step_inputs", **row)
    details["train_step"] = dict(step_times=step_times, bwd=row, work=train_work)
    if not cmp_["ok"]:
        fail("backward kernel disagrees with its plain version on the step's inputs")
    del recorded_bwd, d8, pf, sh3, g_l, g_beta, params

    # ---- 8. the refine loop through train.train_step ---------------------
    cameras = [camera, CameraSpecs(
        name="side", width=WIDTH, height=WIDTH,
        to_world=look_at([1.6, 0.6, -2.8], [0, 0, 0], [0, 1, 0]), fov=50.0,
    )]
    with torch.no_grad():
        ref = train.render_cameras(base, cameras, tcfg, spp=4, seed=999)
    rng = np.random.default_rng(8)
    start = {
        "opacities": base.attrs["opacities"].cpu().numpy() * 0.5,
        "sh_coeffs": base.attrs["sh_coeffs"].cpu().numpy()
        + rng.normal(0.0, 0.05, tuple(base.attrs["sh_coeffs"].shape)).astype(np.float32),
        "centers": base.centers.cpu().numpy(),
    }
    lparams = interop.params_from_jax(start, device=dev)
    opt = train.make_optimizer()
    losses = []
    for it in range(8):
        t0 = time.perf_counter()
        loss, psnr_t, _ = train.train_step(lparams, opt, ref, cameras, tcfg, spp=1,
                                           seed=it, base=base)
        loss, psnr_t = float(loss), float(psnr_t)  # synchronises
        losses.append(loss)
        phase("train_loop", step=it + 1, loss=loss, psnr_db=psnr_t,
              ms=(time.perf_counter() - t0) * 1e3)
    o = lparams["opacities"].detach()
    lo, hi = train.OPACITY_BOUNDS
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"the refine loop's loss did not fall: {losses}")
    if not (float(o.min()) >= lo and float(o.max()) <= hi):
        fail("the opacities left their bounds")
    details["train_loop_losses"] = losses

    if args.out:
        busy_ms = device_profile(lambda i: frame(seed=300 + i), args.out,
                                 "chip_smoke_profile.txt")
        details["device_busy_ms_per_frame"] = busy_ms
        details["device_idle_share"] = 1.0 - busy_ms / frame_ms
        phase("profile", device_busy_ms_per_frame=busy_ms,
              device_idle_share=details["device_idle_share"])
        with open(os.path.join(args.out, "chip_smoke_details.json"), "w") as f:
            json.dump(details, f, indent=1)

    worst = max(
        c[x]["max_abs"] for c in checks + path_checks + [fwd_step_row]
        for x in ("L", "beta")
    )
    worst_bwd = max(
        c[x]["max_abs"] for c in bwd_checks + [details["train_step"]["bwd"]]
        for x in ("gpf", "gsh")
    )
    fwd_bound = sum(w["fwd_bound_ms"] for w in fwd_work)
    print(json.dumps({"kernels": [{
        "name": "composite3_fwd",
        "route": "cuda",
        "source": "volprim_tpu_torch/csrc/composite3_fwd.cu",
        "replaces": "volprim_tpu/pallas_kernels/composite3.py:496",
        "launches": launches,
        "max_abs_err": worst,
        "ms": path_ms,
        "plain_ms": path_plain_ms,
        "bound_ms": fwd_bound,
        "bound_by": max(fwd_work, key=lambda w: w["fwd_bound_ms"])["fwd_bound_by"],
        "library_ms": None,
        "launches_train_step": step_launches[0],
        "ms_train_step": fwd_train_ms,
        "plain_ms_train_step": fwd_train_plain_ms,
        "bound_ms_train_step": train_work["fwd_bound_ms"],
    }, {
        "name": "composite3_bwd",
        "route": "cuda",
        "source": "volprim_tpu_torch/csrc/composite3_bwd.cu",
        "replaces": "volprim_tpu/pallas_kernels/composite3.py:830",
        "launches": step_launches[1],
        "max_abs_err": worst_bwd,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": train_work["bwd_bound_ms"],
        "bound_by": train_work["bwd_bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
