"""The xla backend's memory and time on the card (CUDA only).

    python3 scripts/xla_memory.py

At chip_smoke's V12 configuration (the 262,144-primitive headline scene,
512 x 512, the shortlist backends' culls, max_candidates 2048) it prints,
one JSON line each:

- the 2-spp frame's median time and peak memory at several step sizes
  (``rf_tiled._GROUP_PAIRS``: pairs per vectorised step);
- the 1-spp train step (L1 against a zero image, gradients of all five
  parameters) as rf_tiled runs it (the saved intermediates of every step
  kept) and with each step recomputed in the backward pass
  (torch.utils.checkpoint around ``rf_tiled._composite_group_xla``): its
  time and peak memory, or the out-of-memory error.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.utils.checkpoint

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from volprim_tpu_torch import interop, train  # noqa: E402
from volprim_tpu_torch.models import rf_tiled  # noqa: E402
from volprim_tpu_torch.scene import CameraSpecs, look_at, synthetic  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("xla_memory.py measures the card; no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    scene = synthetic.make_scene(cs.N_PRIMS, device=dev)
    camera = CameraSpecs(name="bench", width=cs.WIDTH, height=cs.WIDTH,
                         to_world=look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]), fov=50.0)
    cfg = rf_tiled.RFTiledConfig(backend="xla", **cs.V12)
    state = rf_tiled.build_state(scene, cfg)
    default = rf_tiled._GROUP_PAIRS
    seeds = iter(range(1000))
    for pairs in (1 << 24, 1 << 26, 1 << 28):
        rf_tiled._GROUP_PAIRS = pairs
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            t = cs.cuda_times(lambda: rf_tiled.render_state(state, camera, cfg, None, spp=cs.SPP,
                                                            seed=next(seeds)), 5, warmup=1)
        print(json.dumps(dict(what="frame", group_pairs=pairs, frame_ms=float(np.median(t)),
                              peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)),
              flush=True)
    rf_tiled._GROUP_PAIRS = default
    del state
    group = rf_tiled._composite_group_xla
    for recompute in (False, True):
        if recompute:
            rf_tiled._composite_group_xla = lambda *a: torch.utils.checkpoint.checkpoint(
                group, *a, use_reentrant=False)
        params = {k: v.clone().requires_grad_(True) for k, v in cs.scene_arrays(scene).items()
                  if k in interop.TRAIN_KEYS}

        def step():
            for p in params.values():
                p.grad = None
            img = train.render_cameras(train.to_scene(params, scene), [camera], cfg, spp=1,
                                       seed=next(seeds))
            torch.mean(torch.abs(img)).backward()

        row = dict(what="train_step", recompute=recompute)
        try:
            torch.cuda.reset_peak_memory_stats()
            t = cs.cuda_times(step, 3, warmup=1)
            row.update(step_ms=float(np.median(t)),
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        except torch.cuda.OutOfMemoryError as e:
            row.update(out_of_memory=str(e).splitlines()[0],
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        rf_tiled._composite_group_xla = group
        del params
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
