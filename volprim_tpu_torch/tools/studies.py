"""What the port's tools share: the device they run on (all of them); and
for the quality studies (convergence_eval, analyze_rf, diag2m, band262k,
refine_truck, truck_bound) the card's line printed beside every time, a
synchronised clock, the fixed pixel subsample and the permuted scene of
their exact references, PSNR and the JSON line each prints last; for
refine_truck and truck_bound the camera ring and the block-streamed exact
image."""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

# pixels of the fixed subsample an exact reference is rendered on
SUBSAMPLE = 4096
# the camera ring of refine_truck and truck_bound (tools/refine_truck.py:82-88)
RING_RADIUS, RING_FOV = 3.3, 50.0
# rays a call of the exact integrator in exact_image (tools/refine_truck.py:109)
EXACT_BLOCK = 16384


def device_of(cpu: bool) -> torch.device:
    """The card unless ``cpu``; exits when there is no card."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card (torch.cuda.is_available() is False); "
                         "pass --cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them ("cpu" on the
    CPU)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60,
        )
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(dev)}, power limit unavailable"


def clock(dev: torch.device) -> float:
    """Host seconds, after the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def subsample(n_pixels: int, seed: int) -> np.ndarray:
    """SUBSAMPLE pixel indices drawn without replacement by a numpy
    generator seeded ``seed`` (every pixel of a smaller film)."""
    return np.random.default_rng(seed).choice(n_pixels, size=min(SUBSAMPLE, n_pixels),
                                              replace=False)


def permuted(scene, seed: int = 7):
    """The scene with its primitives in a numpy-seeded random order (the
    exact reference's noise floor)."""
    perm = np.random.default_rng(seed).permutation(scene.num_prims)
    return scene.select(torch.from_numpy(perm).to(scene.centers.device))


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR in dB at peak 1 of two images, the MSE floored at 1e-12 as the
    JAX package's tools floor it."""
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return -10.0 * math.log10(max(mse, 1e-12))


def emit(results: dict) -> dict:
    """Print ``results`` as one JSON line (the tool's last) and return it."""
    print(json.dumps(results), flush=True)
    return results


def ring_cam(name: str, idx: float, count: int, elev: float, res: int):
    """A camera on the ring at angle 2 pi idx / count about the y axis,
    RING_RADIUS from it at height ``elev``, looking at the origin, fov
    RING_FOV, a square film of ``res`` (tools/refine_truck.py:82-88)."""
    from ..scene import CameraSpecs, look_at

    ang = 2.0 * np.pi * idx / count
    pos = [RING_RADIUS * np.sin(ang), elev, -RING_RADIUS * np.cos(ang)]
    return CameraSpecs(name=name, width=res, height=res,
                       to_world=look_at(pos, [0, 0, 0], [0, 1, 0]), fov=RING_FOV)


def sample_seed(seed: int, sample: int) -> int:
    """The generator seed of ``sample`` of a view seeded ``seed``."""
    return seed * 65536 + sample


@torch.no_grad()
def exact_image(scene, cam, spp: int, seed: int, cfg, block: int = EXACT_BLOCK) -> torch.Tensor:
    """The exact-order integrator's image of ``cam`` [H, W, 3] on the
    scene's device: per sample, one jittered ray per pixel (the in-pixel
    offsets drawn by a ``torch.Generator`` seeded ``sample_seed(seed,
    sample)``), the rays through ``rf.radiance`` under ``cfg`` in blocks of
    ``block``, the samples averaged. Each sample lands in its own pixel
    (box filter), so this is the estimator of ``models.render`` at ``spp``;
    its draws are not jax.random's, so images agree in distribution."""
    from ..models import rf
    from ..scene.cameras import film_coords, rays_from_pixels

    dev = scene.device
    n = cam.height * cam.width
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        gen = torch.Generator(device=dev)
        gen.manual_seed(sample_seed(seed, s))
        o, d = rays_from_pixels(cam, *film_coords(cam, gen, jitter=True, device=dev))
        for b0 in range(0, n, block):
            sl = slice(b0, min(b0 + block, n))
            acc[sl] += rf.radiance(scene, None, o[sl], d[sl], cfg, gen)
    return (acc / spp).reshape(cam.height, cam.width, 3)
