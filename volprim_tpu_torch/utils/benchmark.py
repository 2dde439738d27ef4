"""Timing of the port's entry points (volprim_tpu.utils.benchmark).

``measure`` splits a first call from the timed ones, as the JAX package
splits its trace-and-compile step from execution. The port has no such
step: ``compile_ms`` is the first call, which pays for the lazy nvcc build
of the kernels it reaches, their first launch and the allocator's warm-up.
Then come ``nb_dry_runs`` untimed calls and ``nb_runs`` timed ones. Each
timed call is host wall time; where a card is present the device is
synchronised before the clock starts and before it stops, so a run counts
the device's work too. ``single_run`` times one block as the example CLIs
print it.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch


@dataclass
class BenchResult:
    label: str
    compile_ms: float
    execute_ms_mean: float
    execute_ms_std: float
    runs: list = field(default_factory=list)

    def mrays_per_sec(self, num_rays: int) -> float:
        return num_rays / (self.execute_ms_mean * 1e-3) / 1e6

    def __repr__(self):
        return (
            f"BenchResult[{self.label}: compile {self.compile_ms:.1f} ms, "
            f"execute {self.execute_ms_mean:.2f} +/- {self.execute_ms_std:.2f} ms]"
        )


def measure(
    fn: Callable,
    *args,
    label: str = "",
    nb_runs: int = 4,
    nb_dry_runs: int = 1,
    static_argnums=(),
    log: bool = True,
    **kwargs,
) -> BenchResult:
    """Benchmark ``fn(*args, **kwargs)``: the first call, then the timed
    runs. ``static_argnums`` is accepted so the JAX package's callers port
    unchanged; every argument is passed through as given."""
    del static_argnums
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def timed() -> float:
        sync()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        sync()
        return (time.perf_counter() - t0) * 1e3

    compile_ms = timed()
    for _ in range(nb_dry_runs):
        fn(*args, **kwargs)
    runs = [timed() for _ in range(nb_runs)]

    result = BenchResult(
        label=label,
        compile_ms=compile_ms,
        execute_ms_mean=float(np.mean(runs)),
        execute_ms_std=float(np.std(runs)),
        runs=runs,
    )
    if log:
        print(result)
    return result


@contextmanager
def single_run(label: str = "", device=None):
    """Print ``<label>: <ms> ms`` for one run of the block. ``device`` (a
    CUDA device, or None for the current one when a card is present) is
    synchronised before the clock stops; a CPU device is not."""
    dev = torch.device(device) if device is not None else None
    sync = torch.cuda.is_available() and (dev is None or dev.type == "cuda")
    t0 = time.perf_counter()
    yield
    if sync:
        torch.cuda.synchronize(dev)
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
