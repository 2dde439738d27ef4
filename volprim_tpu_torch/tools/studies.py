"""What the port's tools share: the device they run on (all of them); and
for the quality studies (convergence_eval, analyze_rf, diag2m) the card's
line printed beside every time, a synchronised clock, the fixed pixel
subsample and the permuted scene of their exact references, PSNR and the
JSON line each prints last."""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

# pixels of the fixed subsample an exact reference is rendered on
SUBSAMPLE = 4096


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
