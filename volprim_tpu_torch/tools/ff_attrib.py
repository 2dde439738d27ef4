"""Free-flight stage attribution through prb._FF_STOP.

The port of tools/ff_attrib.py. It times models.prb.free_flight on the
camera rays of tools/profile_prb.py's frame (the plume with sigma_t x 10,
JAX's camera and base configuration, ``--res`` square) truncated after
each stage, so that the differences between rows give each stage's cost:

  collect         the jump path's decision pass (optical depth) alone
  escape          and the closed-form escape decision
  sort            and the needy-ray compaction
  full_allescape  the whole free_flight, every ray escaping (xi = 1e-30)
  full_xi_rand    the whole free_flight with xi uniform in [1e-7, 1) from a
                  seeded torch.Generator

The first four take xi = 1e-30. Then a ``summary:`` line. ``_FF_STOP`` is
read at each call, so nothing is recompiled between rows; it is reset to
None at the end, also on an error. Each row runs once to warm up, then
``--reps`` times with a new seed each time, ``torch.cuda.synchronize()``
around each rep and a host read of its scalar; the minimum is reported.
Runs on the card, or with ``--cpu`` on the CPU.

Usage: python -m volprim_tpu_torch.tools.ff_attrib [--reps 3] [--res 256] [--cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from . import studies
from .profile_prb import BASE, camera, plume, uniform_xi
from .profile_rf import _timeit

STOPS = ("collect", "escape", "sort", None, "full_xi_rand")


def row_name(stop) -> str:
    return "full_allescape" if stop is None else stop


@torch.no_grad()
def main(argv=None) -> dict:
    """Time each stop; returns {row: ms} and the reps of each under "reps"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--res", type=int, default=256, help="film side")
    args = ap.parse_args(argv)
    dev = studies.device_of(args.cpu)
    from ..models import prb
    from ..scene import generate_rays

    medium = plume(dev)
    o, d = generate_rays(camera(args.res), jitter=False, device=dev)
    r = o.shape[0]
    cfg = prb.PRBConfig(**BASE)
    active = torch.ones((r,), dtype=torch.bool, device=dev)
    xi_escape = torch.full((r,), 1e-30, device=dev)
    xi_rand = uniform_xi(r, dev)

    def make_ff(xi):
        def ff(s):
            out = prb.free_flight(medium, o + s * 1e-12, d, xi, cfg, active)
            return sum(torch.sum(torch.where(torch.isfinite(x.float()), x.float(), 0.0))
                       for x in out)
        return ff

    results, reps = {}, {}
    try:
        for stop in STOPS:
            prb._FF_STOP = None if stop == "full_xi_rand" else stop
            fn = make_ff(xi_rand if stop == "full_xi_rand" else xi_escape)
            t0 = time.perf_counter()
            float(fn(0))
            first = time.perf_counter() - t0
            sec, ts = _timeit(fn, 1, args.reps, dev)
            name = row_name(stop)
            results[name], reps[name] = sec * 1e3, [t * 1e3 for t in ts]
            print(f"{name:16s} {sec * 1e3:8.1f} ms  (first {first:.1f} s; reps: "
                  + ", ".join(f"{t * 1e3:.1f}" for t in ts) + ")", flush=True)
    finally:
        prb._FF_STOP = None
    print("summary:", {k: round(v, 1) for k, v in results.items()}, flush=True)
    return dict(results, reps=reps)


if __name__ == "__main__":
    main()
