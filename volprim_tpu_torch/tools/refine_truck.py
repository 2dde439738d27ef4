"""Truck-scale training parity: a 1M-splat asset refined through the tiled
renderer by the refine CLI, scored on held-out views by the exact renderer.

The port of tools/refine_truck.py, with its flags, defaults and protocol:

1. Ground truth: the bench scene of ``--n_splats`` splats
   (``scene.synthetic.make_scene``, bit-equal to bench.make_scene) rendered
   by the exact-order integrator (models/rf, max_depth 128, Gaussian) at
   ``--spp`` through ``--train_cams`` ring cameras (elevation 0.35) and
   ``--test_cams`` held-out ones (half a step further on, elevation 0.6),
   each view in blocks of 16,384 rays (``studies.exact_image``; view i
   seeded i). The views are kept in ``<workdir>/images`` and a cached view
   is used if its shape is the run's: the cache checks nothing else.
2. The initial asset: the scene's opacities and SH scrambled by a numpy
   generator seeded 42 (``--perturb mild`` or ``strong``, bit-equal to the
   root script's), geometry kept; written as ``init.ply`` with the
   training cameras' ``cameras.json``.
3. Training: the refine CLI (``examples.refine_3dg_dataset.main``)
   in-process with ``--renderer tiled`` (for Gaussians the fused
   compositor with early exit), ``--iterations``, 1 spp, on the ground
   truth images; skipped if ``<workdir>/out/refined_asset`` already holds
   an asset of ``--n_splats`` splats (the splat count is all this checks,
   and the JSON then says ``train_resumed``). So a run with another
   ``--perturb``, ``--spp``, camera count or scene size needs a
   ``--workdir`` of its own.
4. Scores: the held-out PSNR by the exact renderer at ``--spp`` (view i
   seeded 1000 + i) of the initial and the refined asset and of the true
   scene (the evaluation's own noise floor), and by the tiled renderer
   (fused, 2,048 candidates, early exit) of the initial, the refined and
   the true scene (the tiled renderer's bound on these views).

Each stage is timed (ground truth and exact evaluation per view, training:
every step, the first apart, as it loads and on the card builds the
compositor's kernels, whose nvcc seconds are recorded; the tiled
evaluations) beside the card's name and power limit; training's peak memory
(read by the CLI after its steps, before its final exact preview) and the
fused kernels' launches in training and in each tiled evaluation are
recorded. The results are written,
keyed by ``--perturb``, to ``<workdir>/REFINE_TRUCK.json`` (never the
repo's REFINE_TRUCK.json, which holds the JAX package's TPU records), and
printed as the last line. The generators' draws are torch's, not
jax.random's: images agree with the root script's in distribution.

Usage: python -m volprim_tpu_torch.tools.refine_truck [--n_splats 1048576]
       [--res 256] [--train_cams 8] [--test_cams 2] [--spp 4]
       [--iterations 256] [--workdir $TMPDIR/refine_truck]
       [--perturb mild|strong] [--tiny] [--cpu]
(the card unless --cpu; --tiny is the root's CPU smoke: 4,096 splats, 64^2,
8 steps, 3 + 1 cameras, 2 spp, on the CPU; the workdir defaults to
refine_truck in the system's temporary directory, /tmp/refine_truck where
TMPDIR is unset, as in the root script).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from . import studies

TRAIN_ELEV, TEST_ELEV = 0.35, 0.6
PERTURB_SEED = 42
# the tiled evaluation's and the CLI's configurations (tools/refine_truck.py:101, :212-217)
EXACT = dict(max_depth=128, kernel_type="gaussian", chunk_size=2048)
TILED = dict(max_depth=128, kernel_type="gaussian", tile_pixels=256, max_candidates=2048,
             segment=256, cluster_size=16, backend="fused", early_exit=True, coarse_group=4,
             coarse_factor=8, super_group=4)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_splats", type=int, default=1 << 20)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--train_cams", type=int, default=8)
    ap.add_argument("--test_cams", type=int, default=2)
    ap.add_argument("--spp", type=int, default=4, help="GT + eval spp")
    ap.add_argument("--iterations", type=int, default=256)
    ap.add_argument("--workdir", type=str, default=None,
                    help="default: refine_truck in the system's temporary directory")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU smoke: 4096 splats, 64^2, 8 iters")
    ap.add_argument("--perturb", choices=("mild", "strong"), default="mild",
                    help="initial-asset corruption severity ('strong' scrambles appearance "
                         "hard enough that recovery dominates the approximation bound)")
    return ap


def cameras(res: int, train_cams: int, test_cams: int) -> tuple:
    """(training cameras, held-out cameras) on the ring
    (tools/refine_truck.py:91-99)."""
    train = [studies.ring_cam(f"train_{i:02d}", i, train_cams, TRAIN_ELEV, res)
             for i in range(train_cams)]
    test = [studies.ring_cam(f"test_{i:02d}", i + 0.5, train_cams, TEST_ELEV, res)
            for i in range(test_cams)]
    return train, test


def exact_config():
    from ..models import rf

    return rf.RFConfig(**EXACT)


def tiled_config():
    """The tiled evaluation's configuration (tools/refine_truck.py:212-217;
    the TPU's ``kernel_batch`` has no counterpart, ROADMAP.md §D)."""
    from ..models import rf_tiled

    return rf_tiled.RFTiledConfig(**TILED)


def perturb(op: np.ndarray, sh: np.ndarray, kind: str, seed: int = PERTURB_SEED) -> tuple:
    """The initial asset's (opacities, SH coefficients): ``op`` and ``sh``
    scrambled by a numpy generator seeded ``seed`` as the root script does
    (tools/refine_truck.py:164-179), bit for bit."""
    rng = np.random.default_rng(seed)
    if kind == "strong":
        op_p = np.clip(op * rng.uniform(0.05, 0.5, op.shape).astype(np.float32), 1e-4, 0.995)
        sh_p = sh * rng.uniform(0.0, 0.6, sh.shape).astype(np.float32) \
            + rng.normal(0, 0.6, sh.shape).astype(np.float32)
    else:
        op_p = np.clip(op * rng.uniform(0.15, 0.9, op.shape).astype(np.float32), 1e-4, 0.995)
        sh_p = sh * rng.uniform(0.2, 1.0, sh.shape).astype(np.float32) \
            + rng.normal(0, 0.25, sh.shape).astype(np.float32)
    return op_p, sh_p


def ground_truth(cams, img_dir: str, render, card: str = "cpu") -> tuple:
    """({camera name: image [res, res, 3] numpy}, {name: seconds or None if
    cached}): ``<img_dir>/<name>.npy`` where its shape is the camera's,
    else ``render(camera, view index)`` saved there."""
    gt, secs = {}, {}
    for i, cam in enumerate(cams):
        path = os.path.join(img_dir, f"{cam.name}.npy")
        if os.path.exists(path):
            cached = np.load(path)
            if cached.shape == (cam.height, cam.width, 3):
                gt[cam.name], secs[cam.name] = cached, None
                print(f"  GT {cam.name}: cached", flush=True)
                continue
        t0 = time.perf_counter()
        img = render(cam, i).cpu().numpy()
        secs[cam.name] = time.perf_counter() - t0
        gt[cam.name] = img
        np.save(path, img)
        print(f"  GT {cam.name}: {secs[cam.name]:.1f}s mean={img.mean():.4f} ({card})",
              flush=True)
    return gt, secs


def _heldout(images, gt, cams) -> float:
    """The held-out PSNR: the mean over the views of each view's PSNR."""
    return float(np.mean([studies.psnr(images[i], gt[c.name]) for i, c in enumerate(cams)]))


def _resumable(asset_dir: str, n_splats: int, dev) -> bool:
    """An asset of ``n_splats`` splats is in ``asset_dir``."""
    from ..scene import load_asset

    if not os.path.exists(os.path.join(asset_dir, "primitives.ply")):
        return False
    try:
        return load_asset(asset_dir, device=dev)["primitives"].num_prims == n_splats
    except (OSError, ValueError, KeyError):
        return False


def default_workdir() -> str:
    """refine_truck in the system's temporary directory (the root
    script's /tmp/refine_truck where TMPDIR is unset)."""
    return os.path.join(tempfile.gettempdir(), "refine_truck")


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, with ``--tiny``'s sizes and the default workdir put in
    place."""
    args = _parser().parse_args(argv)
    args.workdir = args.workdir or default_workdir()
    if args.tiny:
        args.n_splats, args.res, args.iterations = 4096, 64, 8
        args.train_cams, args.test_cams, args.spp = 3, 1, 2
        args.cpu = True
    return args


def step_seconds(steps: list) -> dict:
    """The CLI's step times: the first (loading, and on the card the
    kernels' build) apart, the median and mean of the rest."""
    rest = steps[1:]
    return dict(train_steps=sum(steps), train_step0=steps[0] if steps else None,
                train_ms_per_step=1e3 * statistics.median(rest) if rest else None,
                train_ms_per_step_mean=1e3 * statistics.fmean(rest) if rest else None,
                train_step_seconds=steps)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = studies.device_of(args.cpu)
    card = studies.card_line(dev)
    from ..examples import refine_3dg_dataset
    from ..kernels import _build, composite3
    from ..models import rf_tiled
    from ..scene import EllipsoidScene, JSONCameraSpecsIO, load_asset, save_ply, synthetic

    t_all = time.perf_counter()
    img_dir = os.path.join(args.workdir, "images")
    os.makedirs(img_dir, exist_ok=True)
    scene_true = synthetic.make_scene(args.n_splats, device=dev)
    cams_train, cams_test = cameras(args.res, args.train_cams, args.test_cams)
    ecfg = exact_config()

    def exact(scene, cam, seed):
        return studies.exact_image(scene, cam, args.spp, seed, ecfg)

    print(f"[refine_truck] GT: {args.n_splats} splats, {args.train_cams}+{args.test_cams} "
          f"cams at {args.res}^2, spp {args.spp} ({card})", flush=True)
    gt, gt_s = ground_truth(cams_train + cams_test, img_dir,
                            lambda cam, i: exact(scene_true, cam, i), card)
    gt_dev = {k: torch.from_numpy(v).to(dev) for k, v in gt.items()}

    op_p, sh_p = perturb(scene_true.attrs["opacities"].cpu().numpy(),
                         scene_true.attrs["sh_coeffs"].cpu().numpy(), args.perturb)
    scene_init = EllipsoidScene(
        centers=scene_true.centers, scales=scene_true.scales, quats=scene_true.quats,
        attrs={**scene_true.attrs, "opacities": torch.from_numpy(op_p).to(dev),
               "sh_coeffs": torch.from_numpy(sh_p).to(dev)},
        extent=scene_true.extent)
    ply_path = os.path.join(args.workdir, "init.ply")
    save_ply(scene_init, ply_path)
    cam_path = os.path.join(args.workdir, "cameras.json")
    JSONCameraSpecsIO.write(cams_train, cam_path)

    exact_s = []

    def heldout_psnr(scene_eval, tag):
        images = []
        for i, cam in enumerate(cams_test):
            t0 = studies.clock(dev)
            images.append(exact(scene_eval, cam, 1000 + i))
            exact_s.append(studies.clock(dev) - t0)
        p = _heldout(images, gt_dev, cams_test)
        print(f"[refine_truck] held-out PSNR ({tag}): {p:.2f} dB ({exact_s[-1]:.1f} s a view, "
              f"{card})", flush=True)
        return p

    tcfg = tiled_config()
    tiled = {}

    @torch.no_grad()
    def heldout_psnr_tiled(scene_eval, tag, key):
        before = composite3.composite_tiles3.launches
        t0 = studies.clock(dev)
        st = rf_tiled.build_state(scene_eval, tcfg)
        images = [rf_tiled.render_state(st, cam, tcfg, None, spp=args.spp, seed=1000 + i)
                  for i, cam in enumerate(cams_test)]
        secs = studies.clock(dev) - t0
        p = _heldout(images, gt_dev, cams_test)
        tiled[key] = dict(seconds=secs, launches=composite3.composite_tiles3.launches - before)
        print(f"[refine_truck] held-out PSNR tiled ({tag}): {p:.2f} dB ({secs:.2f} s, {card})",
              flush=True)
        return p

    psnr_init = heldout_psnr(scene_init, "initial")

    out_dir = os.path.join(args.workdir, "out")
    asset_dir = os.path.join(out_dir, "refined_asset")
    resume = _resumable(asset_dir, args.n_splats, dev)
    if resume:
        print("[refine_truck] refined asset found on disk — skipping training", flush=True)
    cli = {}
    launches = dict(train_fwd=0, train_bwd=0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_train = studies.clock(dev)
    prebuilt = set(_build.build_info)
    if not resume:
        before = (composite3.composite_tiles3.launches, composite3.composite_tiles3_bwd.launches)
        cli = refine_3dg_dataset.main([
            "--ply", ply_path, "--cameras", cam_path, "--images", img_dir,
            "--output", out_dir, "--cam_count", str(args.train_cams), "--cam_scale", "1.0",
            "--kernel", "gaussian", "--renderer", "tiled",
            "--iterations", str(args.iterations), "--opt_spp", "1",
            "--ref_spp", str(args.spp), "--max_depth", "128",
            "--write_image_every", "1000000", "--device", str(dev),
        ])
        launches = dict(train_fwd=composite3.composite_tiles3.launches - before[0],
                        train_bwd=composite3.composite_tiles3_bwd.launches - before[1])
    train_s = studies.clock(dev) - t_train
    peak = cli.get("train_peak_bytes")

    refined = load_asset(asset_dir, device=dev)["primitives"]
    psnr_final = heldout_psnr(refined, "refined")
    psnr_noise = heldout_psnr(scene_true, "gt-reseeded noise floor")
    psnr_init_t = heldout_psnr_tiled(scene_init, "initial", "init")
    psnr_final_t = heldout_psnr_tiled(refined, "refined", "refined")
    psnr_true_t = heldout_psnr_tiled(scene_true, "true scene (approx bound)", "true")

    block = {
        "n_splats": int(args.n_splats),
        "res": int(args.res),
        "train_cams": args.train_cams,
        "test_cams": args.test_cams,
        "spp": args.spp,
        "iterations": args.iterations,
        "renderer": "tiled",
        "perturb": args.perturb,
        "heldout_psnr_init_db": round(psnr_init, 2),
        "heldout_psnr_refined_db": round(psnr_final, 2),
        "heldout_psnr_noise_floor_db": round(psnr_noise, 2),
        "heldout_psnr_init_tiled_db": round(psnr_init_t, 2),
        "heldout_psnr_refined_tiled_db": round(psnr_final_t, 2),
        "heldout_psnr_true_tiled_db": round(psnr_true_t, 2),
        "train_wall_s": round(train_s, 1),
        "total_wall_s": round(time.perf_counter() - t_all, 1),
        # a resumed run evaluates an asset trained before (train_wall_s is
        # then not the training cost)
        **({"train_resumed": True} if resume else {}),
        "device": dev.type,
        "card": card,
        "psnr_db": dict(init=psnr_init, refined=psnr_final, noise_floor=psnr_noise,
                        init_tiled=psnr_init_t, refined_tiled=psnr_final_t,
                        true_tiled=psnr_true_t),
        "seconds": dict(gt_views=gt_s, exact_eval_views=exact_s,
                        **step_seconds(cli.get("step_seconds", [])),
                        kernel_build={k: v["seconds"] for k, v in _build.build_info.items()
                                      if k not in prebuilt},
                        cli_final_render=cli.get("final_seconds"),
                        tiled_eval={k: v["seconds"] for k, v in tiled.items()}),
        "train_peak_gib": peak / 2**30 if peak is not None else None,
        "loss_first": cli["losses"][0] if cli else None,
        "loss_last": cli["losses"][-1] if cli else None,
        "launches": dict(launches, tiled_eval_fwd={k: v["launches"] for k, v in tiled.items()}),
    }
    # keyed by perturb severity so both experiments stay on record
    out_json = os.path.join(args.workdir, "REFINE_TRUCK.json")
    data = {}
    if os.path.exists(out_json):
        try:
            with open(out_json) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
    data[args.perturb] = block
    with open(out_json, "w") as f:
        json.dump(data, f, indent=1)
    return studies.emit(dict(tool="refine_truck", **block))


if __name__ == "__main__":
    main()
