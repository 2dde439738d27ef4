"""Gradients of the path tracer's score factors (volprim_tpu_torch.models.
prb.free_flight) against ``jax.grad`` and a float64 run of the port, on the
cases of tests/test_torch_prb_walks.py (its inputs, rounding band and
tolerances, described there)."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_ffwalk import one_torch_thread  # noqa: F401
from test_torch_prb_walks import (
    GEOM_TOL_F64, GRAD_TOL, case_inputs, jax_run, port_run, rounding_band,
)


# the xla walk through the sequential path with caps, re-collection rounds
# and the Epanechnikov kernel (the fused walk keeps one round and sends that
# kernel down the xla walk); the fused walk on the jump path, where JAX's
# geometry gradients are finite
GRAD_CASES = [("jump", "pallas"), ("chain_rounds24", "xla"), ("epanechnikov", "xla"),
              ("caps_sequential", "xla")]


@pytest.mark.parametrize("case,backend", GRAD_CASES)
def test_score_gradients_match_jax(case, backend):
    """Gradients of the score sum over the rays outside the band whose
    sampled distance is well conditioned (f32 and f64 runs of the port, and
    JAX, within 1e-5 (1 + t) of each other: in the thin chain 4 bisection
    steps leave t_samp 0.04 apart between f32 and f64, and the density at
    it moves with it). sigma_t always against ``jax.grad``; centers and
    scales against ``jax.grad`` where JAX's are finite, and always against
    a float64 run of the port. JAX's geometry gradients are NaN through its
    xla walk (it evaluates q at t = +inf for rays a window leaves
    unresolved, and its fused walk's post-pass integrates from +inf where
    nothing is open: 0 * inf enters the chain rule; ROADMAP.md §D)."""
    a, cfg, o, d, xi, t_max = case_inputs(case)
    cfg = dataclasses.replace(cfg, walk_backend=backend)
    out, _ = port_run(a, cfg, o, d, xi, t_max)
    want = jax_run(case, backend)
    band = rounding_band(a, cfg, o, d, xi, t_max, out)
    out64, _ = port_run(a, cfg, o, d, xi, t_max, dtype=torch.float64)
    same = [(x[0] == out[0]) & (x[1] == out[1]) for x in (want, out64)]
    t_s = np.where(out[0], out[2], 0.0)
    t_ok = [np.abs(t_s - np.where(out[0], x[2], 0.0)) <= 1e-5 * (1.0 + np.abs(t_s))
            for x in (want, out64)]
    mask = ~band & same[0] & same[1] & t_ok[0] & t_ok[1]
    assert mask.sum() >= 0.5 * len(mask)
    _, g_t = port_run(a, cfg, o, d, xi, t_max, grads=True, mask=mask)
    _, g_j = jax_run(case, backend, mask.tobytes())
    _, g_64 = port_run(a, cfg, o, d, xi, t_max, grads=True, mask=mask, dtype=torch.float64)
    for i, name in enumerate(("sigma_t", "centers", "scales")):
        gt, gj = g_t[i], g_j[i]
        assert np.isfinite(gt).all(), name
        scale = np.abs(g_64[i]).max()
        assert scale > 0.0, name
        err64 = np.abs(gt - g_64[i]).max() / scale
        msg = f"{case}/{backend} ({mask.sum()} rays) d/d{name}: vs f64 {err64:.3g}"
        tol = GRAD_TOL
        if np.isfinite(gj).all():
            jax64 = np.abs(gj - g_64[i]).max() / scale
            tol = max(GRAD_TOL, 2.0 * jax64)
            err = np.abs(gt - gj).max() / scale
            msg += f", vs JAX {err:.3g} (JAX vs f64 {jax64:.3g})"
            assert err <= tol, msg
        else:
            assert name != "sigma_t", msg
            msg += f", JAX NaN on {int(np.isnan(gj).sum())} of {gj.size}"
            tol = GEOM_TOL_F64
        print(msg)
        assert err64 <= tol, msg
