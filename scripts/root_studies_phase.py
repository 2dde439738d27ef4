"""chip_smoke.py's phase 41 (the root studies: refine_truck, truck_bound,
band262k) alone, on one CUDA card, and measurements of refine_truck's parts
at its full width.

    python3 scripts/root_studies_phase.py [--skip_phase] [--exact_view PRIMS]
        [--replay_step PRIMS] [--cli_steps PRIMS [--images DIR]
        [--iterations N]] [--out DIR]

Builds the v3 forward and backward (csrc/composite3_fwd.cu,
composite3_bwd.cu) and calls chip_smoke.root_studies_phase, which prints
its phase lines. ``--exact_view PRIMS`` then times one of refine_truck's
held-out views at its defaults (256^2, 4 spp: 262,144 rays) through the
exact integrator (``studies.exact_image``) on the bench scene of PRIMS
primitives, and prints the seconds and the ray-primitive pairs a second.
``--replay_step PRIMS`` drives one step of refine_truck's training at its
defaults (the refine CLI's tiled configuration on 8 ring cameras at 256^2,
1 spp, the strong perturbation of the bench scene of PRIMS primitives, L1
against a zero image) with the compositor launches recorded, and replays
every forward and backward launch of that step against the plain versions
at phase 7's tolerances, with the kernels' and the plain versions' times
and the bounds. ``--exact_view`` and ``--replay_step`` were one-off
measurements (their numbers are in PERF.md, PR 17): phase 41 replays the
CLI's own steps at a smaller depth, and ``--cli_steps`` times them at full
width.

``--cli_steps PRIMS`` runs the refine CLI (``refine_3dg_dataset.main``) as
refine_truck calls it at its defaults (8 ring cameras at 256^2, 1 spp,
``--renderer tiled``, the strong perturbation of the bench scene of PRIMS
primitives) for ``--iterations`` steps on the ground truth in ``--images``
(refine_truck's ``<workdir>/images``; made there by the exact renderer
where missing), with the compositor's kernels built at first use, as in
refine_truck. It prints every step's seconds (the first apart, with the
nvcc seconds inside it), the peak of allocated memory that the CLI reads
after its steps, and a torch.profiler window of PROFILE_STEPS steps in the
middle of the run: the device's busy ms a step, its idle share against the
unprofiled steps' median, the CPU ops a step and the largest device and
host rows. The CLI's final exact preview is replaced by a blank image (it
would take minutes at 1M; refine_truck times it). ``--out`` writes the
details as JSON and the profiler's tables.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PROFILE_STEPS = 6


def replay_step(prims: int, dev: torch.device, res: int = 256) -> dict:
    """One refine step at ``prims`` primitives on 8 ring cameras of
    ``res``^2 on ``dev``, its launches recorded and replayed (module
    docstring)."""
    from volprim_tpu_torch import train
    from volprim_tpu_torch.examples import refine_3dg_dataset as refine
    from volprim_tpu_torch.kernels import composite3
    from volprim_tpu_torch.optim import l1
    from volprim_tpu_torch.scene import synthetic
    from volprim_tpu_torch.tools import refine_truck, studies

    scene = synthetic.make_scene(prims, device=dev)
    op, sh = refine_truck.perturb(scene.attrs["opacities"].cpu().numpy(),
                                  scene.attrs["sh_coeffs"].cpu().numpy(), "strong")
    params = {"opacities": torch.from_numpy(op).to(dev).requires_grad_(True),
              "sh_coeffs": torch.from_numpy(sh).to(dev).requires_grad_(True),
              "centers": scene.centers.clone().requires_grad_(True)}
    cams = refine_truck.cameras(res, 8, 2)[0]
    cfg = refine.tiled_config(cams[0], 128, "gaussian")
    ref = torch.zeros((res, len(cams) * res, 3), device=dev)

    def step():
        img = train.render_cameras(train.to_scene(params, scene), cams, cfg, spp=1, seed=0)
        l1(ref, img).backward()

    t0 = studies.clock(dev)
    fwd, bwd = composite3.composite_tiles3, composite3.composite_tiles3_bwd
    (_, n_b, rec_b), n_f, rec_f = cs.record_launches(
        composite3, "_launch", fwd,
        lambda: cs.record_launches(composite3, "_launch_bwd", bwd, step))
    step_s = studies.clock(dev) - t0
    rows_f = [cs.check_fwd3(composite3, a, reps=3) for a in rec_f]
    rows_b = [cs.replay_bwd(composite3, a) for a in rec_b]
    work_f = [cs.fwd_work(composite3, a) for a in rec_f]
    work_b = [cs.bwd_work(composite3, a) for a in rec_b]
    res_ = dict(prims=prims, res=res, cameras=len(cams), launches_fwd=n_f, launches_bwd=n_b,
                step_s_first=step_s, fwd=cs.replay_summary(rows_f, "fwd"),
                bwd=cs.replay_summary(rows_b, "bwd"),
                fwd_bound_ms=sum(w["fwd_bound_ms"] for w in work_f),
                fwd_bound_by=max(work_f, key=lambda w: w["fwd_bound_ms"])["fwd_bound_by"],
                bwd_bound_ms=sum(w["bwd_bound_ms"] for w in work_b),
                bwd_bound_by=max(work_b, key=lambda w: w["bwd_bound_ms"])["bwd_bound_by"],
                segments_walked=sum(r_["walked"] for r_ in rows_f),
                segments_live=sum(r_["live"] for r_ in rows_f))
    if not (n_f == n_b == len(cams) and res_["fwd"]["ok"] and res_["bwd"]["ok"]):
        cs.fail(f"replay_step: {n_f} / {n_b} launches, or a kernel disagrees: {res_}")
    return res_


def cli_steps(prims: int, images: str, iters: int, dev: torch.device, out: str = None,
              res: int = 256) -> dict:
    """The refine CLI's steps at ``prims`` primitives, timed and profiled
    (module docstring)."""
    import statistics

    from torch.profiler import ProfilerActivity, profile, schedule

    from volprim_tpu_torch.examples import refine_3dg_dataset as refine
    from volprim_tpu_torch.kernels import _build
    from volprim_tpu_torch.scene import EllipsoidScene, JSONCameraSpecsIO, save_ply, synthetic
    from volprim_tpu_torch.tools import refine_truck, studies

    work_dir = os.path.join("build", "cli_steps")
    os.makedirs(images, exist_ok=True)
    os.makedirs(work_dir, exist_ok=True)
    scene = synthetic.make_scene(prims, device=dev)
    cams = refine_truck.cameras(res, 8, 2)[0]
    gt_s = refine_truck.ground_truth(
        cams, images, lambda cam, i: studies.exact_image(scene, cam, 4, i,
                                                         refine_truck.exact_config()))[1]
    op, sh = refine_truck.perturb(scene.attrs["opacities"].cpu().numpy(),
                                  scene.attrs["sh_coeffs"].cpu().numpy(), "strong")
    init = EllipsoidScene(scene.centers, scene.scales, scene.quats,
                          {**scene.attrs, "opacities": torch.from_numpy(op).to(dev),
                           "sh_coeffs": torch.from_numpy(sh).to(dev)}, scene.extent)
    ply, cam_json = os.path.join(work_dir, "init.ply"), os.path.join(work_dir, "cameras.json")
    save_ply(init, ply)
    JSONCameraSpecsIO.write(cams, cam_json)
    del scene, init

    wait = max(2, (iters - PROFILE_STEPS) // 2 - 1)
    on_card = dev.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * on_card,
                   schedule=schedule(wait=wait, warmup=1, active=PROFILE_STEPS, repeat=1))
    l1, batch = refine.l1, refine._batch

    def l1_stepping(*a):
        prof.step()  # once a step, at its loss
        return l1(*a)

    def blank(scene_, cameras, *a):
        return torch.zeros((cameras[0].height, cameras[0].width * len(cameras), 3), device=dev)

    built = set(_build.build_info)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        refine.l1, refine._batch = l1_stepping, blank
        prof.start()
        cli = refine.main([
            "--ply", ply, "--cameras", cam_json, "--images", images,
            "--output", os.path.join(work_dir, "out"), "--cam_count", "8", "--cam_scale", "1.0",
            "--kernel", "gaussian", "--renderer", "tiled", "--iterations", str(iters),
            "--opt_spp", "1", "--ref_spp", "4", "--max_depth", "128",
            "--write_image_every", "1000000", "--device", str(dev)])
    finally:
        prof.stop()
        refine.l1, refine._batch = l1, batch
    steps = cli["step_seconds"]
    # the profiler warms up from the loss of step wait - 1 and records from
    # that of step wait to that of step wait + PROFILE_STEPS: the steps it
    # touched are left out of the clean ones
    clean = steps[1:wait - 1] + steps[wait + PROFILE_STEPS + 1:]
    events = prof.key_averages()
    # the profiler's step ranges also appear on the device as annotation
    # spans, which cover idle time: kernels and copies alone are busy time
    rows = [e for e in events if not e.key.startswith("ProfilerStep")]
    cuda = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in cuda) / 1e3 / PROFILE_STEPS
    top_dev = sorted(cuda, key=lambda e: -e.self_device_time_total)[:12]
    top_cpu = sorted(rows, key=lambda e: -e.self_cpu_time_total)[:12]
    median_ms = 1e3 * statistics.median(clean)
    res_ = dict(
        prims=prims, res=res, cameras=len(cams), iterations=iters,
        gt_views_s={k: v for k, v in gt_s.items()},
        step0_s=steps[0],
        kernel_build_s={k: v["seconds"] for k, v in _build.build_info.items() if k not in built},
        clean_steps=len(clean), step_ms_median=median_ms,
        step_ms_mean=1e3 * statistics.fmean(clean), step_ms_min=1e3 * min(clean),
        step_ms_max=1e3 * max(clean), step_seconds=steps,
        train_peak_gib=cli["train_peak_bytes"] / 2**30 if on_card else None,
        loss_first=cli["losses"][0], loss_last=cli["losses"][-1],
        profiled_steps=PROFILE_STEPS, profiled_step_ms=1e3 * statistics.fmean(
            steps[wait + 1:wait + PROFILE_STEPS]),
        device_busy_ms_per_step=busy_ms, device_idle_share=1.0 - busy_ms / median_ms,
        cpu_events_per_step=sum(e.count for e in rows
                                if e.device_type == torch.autograd.DeviceType.CPU) / PROFILE_STEPS,
        top_device_ms_per_step={e.key: e.self_device_time_total / 1e3 / PROFILE_STEPS
                                for e in top_dev},
        top_host_ms_per_step={e.key: e.self_cpu_time_total / 1e3 / PROFILE_STEPS
                              for e in top_cpu})
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "cli_steps_profile.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
            f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    return res_


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip_phase", action="store_true", help="run no phase 41")
    ap.add_argument("--exact_view", type=int, help="time one exact view at this many primitives")
    ap.add_argument("--replay_step", type=int,
                    help="replay one refine step's launches at this many primitives")
    ap.add_argument("--cli_steps", type=int,
                    help="time and profile the refine CLI's steps at this many primitives")
    ap.add_argument("--images", default=os.path.join("build", "cli_steps", "images"),
                    help="--cli_steps' ground truth (refine_truck's <workdir>/images)")
    ap.add_argument("--iterations", type=int, default=64, help="--cli_steps' steps")
    ap.add_argument("--out", help="directory for the phase's details")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from volprim_tpu_torch.kernels import _build, composite3
    from volprim_tpu_torch.scene import synthetic
    from volprim_tpu_torch.tools import refine_truck, studies

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    details, failed = {}, []
    if not args.skip_phase or args.replay_step:
        _build.build("composite3_fwd", "composite3_bwd")
    if not args.skip_phase:
        try:
            cs.root_studies_phase(composite3, details)
            print(json.dumps({"done": "root_studies", "seconds": time.perf_counter() - t0}),
                  flush=True)
        except (SystemExit, KeyError):
            failed.append("root_studies")
            print(json.dumps({"failed": "root_studies", "seconds": time.perf_counter() - t0}),
                  flush=True)
    if args.exact_view:
        dev = torch.device("cuda", 0)
        scene = synthetic.make_scene(args.exact_view, device=dev)
        cam = refine_truck.cameras(256, 8, 1)[1][0]
        spp = 4
        t1 = studies.clock(dev)
        img = studies.exact_image(scene, cam, spp, 1000, refine_truck.exact_config())
        secs = studies.clock(dev) - t1
        rays = cam.width * cam.height * spp
        row = dict(prims=args.exact_view, rays=rays, seconds=secs,
                   pairs_per_s=rays * args.exact_view / secs, mean=float(img.mean()),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                   card=smi.stdout.strip())
        details["exact_view"] = row
        print(json.dumps({"exact_view": row}), flush=True)
    if args.replay_step:
        t1 = time.perf_counter()
        try:
            details["replay_step"] = replay_step(args.replay_step, torch.device("cuda", 0))
            print(json.dumps({"replay_step": details["replay_step"],
                              "seconds": time.perf_counter() - t1}), flush=True)
        except (SystemExit, KeyError):
            failed.append("replay_step")
    if args.cli_steps:
        t1 = time.perf_counter()
        details["cli_steps"] = cli_steps(args.cli_steps, args.images, args.iterations,
                                         torch.device("cuda", 0), args.out)
        print(json.dumps({"cli_steps": details["cli_steps"],
                          "seconds": time.perf_counter() - t1}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "root_studies_details.json"), "w") as f:
            json.dump(details, f, default=str, indent=1)
    print(json.dumps({"total_seconds": time.perf_counter() - t0, "failed": failed}), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
