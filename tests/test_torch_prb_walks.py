"""The path tracer's walks (volprim_tpu_torch.models.prb) against the JAX
package per ray, on the same numpy-made primitives, rays and xi: the xla
window walk (``_free_flight_window`` in both branches, ``_run_windows``),
the fused walk (``walk_backend="pallas"``; JAX runs its Pallas kernel in
interpret mode), the jump path, the sequential walk with and without
re-collection rounds, cluster collection, ``coeff_gemm``, the Epanechnikov
kernel and surface caps; ``count_intervals`` and ``suggest_budgets``.

Tolerances:
- decisions (found, dead) equal on every ray outside the rounding band,
  and t_samp within atol 5e-3 + rtol 1e-3 (tests/test_ffwalk.py:43-72,
  the solver's resolution) there. The band is the rays whose port
  decisions change when xi is moved by a relative 1e-3 either way (a
  depth difference of 1e-3: the two packages sum the window depths in
  another order, and q = c - b^2/a rounds differently); at most 3% of the
  rays may lie in it, and each case prints its count;
- albedo within 1e-3 (tests/test_ffwalk.py), the score factors 1 within
  1e-5;
- the gradients of sum(score_found + score_escape) over the rays outside
  the band with respect to sigma_t, centers and scales, against
  ``jax.grad`` where JAX's are finite, and against a float64 run of the
  port always, within 2e-3 of each gradient's largest magnitude or twice
  JAX's own deviation from the float64 run, whichever is larger (f32 on
  both sides; through the 240-interval chain and its re-collection rounds
  both packages lie ~4e-3 from float64, on opposite sides); where JAX's
  geometry gradient is NaN, 1e-2 of it against float64 (the chain's scale
  gradient lies 6.2e-3 from float64 in f32, with the rounds and with one
  collection large enough to need none alike, and those two are equal:
  test_rounds_gradients_equal_one_collection). See
  tests/test_torch_prb_walk_grads.py for the rays it takes;
- count_intervals equal per ray, suggest_budgets the equal config.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ffwalk import DENSE, both_scenes, cloud_arrays, one_torch_thread, rays  # noqa: F401
from volprim_tpu.models import prb as jprb
from volprim_tpu.ops import kernels as jkernels
from volprim_tpu.ops import quadric as jquadric
from volprim_tpu_torch.models import prb
from volprim_tpu_torch.ops import quadric

T_ATOL, T_RTOL = 5e-3, 1e-3
XI_BAND = 1e-3  # relative move of xi that defines the rounding band
BAND_SHARE = 0.03
GRAD_TOL = 2e-3  # of each gradient's largest magnitude
GEOM_TOL_F64 = 1e-2  # where JAX's geometry gradient is NaN: against f64 only
N_RAYS = 256


def chain_arrays(n=240, sigma_t=0.003, albedo=0.0):
    """tests/test_prb_extra.py's chain_scene: Gaussians of scale 0.25 every
    0.3 along +z (about 5 open at once, n intervals in all)."""
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(
        centers=f32([[0.0, 0.0, 0.3 * i] for i in range(n)]),
        scales=f32(np.full((n, 3), 0.25)),
        quats=f32(np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))),
        sigma_t=f32(np.full((n, 1), sigma_t)),
        albedo=f32(np.full((n, 3), albedo)),
    )


def chain_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.2, 0.2, (n, 2)), np.full((n, 1), -3.0)], axis=1)
    d = np.tile([0.0, 0.0, 1.0], (n, 1))
    xi = rng.uniform(1e-7, 1.0, n)
    return o.astype(np.float32), d.astype(np.float32), xi.astype(np.float32)


CLOUD = cloud_arrays(24, 3, 0.4, 0.15, 0.5)
CHAIN = chain_arrays()
SCENES = {"cloud": CLOUD, "dense": DENSE, "chain": CHAIN}
BASE = prb.PRBConfig(max_overlaps=8, max_windows=6, chunk_size=64)
CHAIN_CFG = prb.PRBConfig(max_overlaps=8, max_windows=4, collect_budget=24, chunk_size=128,
                          jump=False)
CAPS = "caps"  # t_max = 5 on half the rays

# case: (scene, config, rays, caps)
CASES = {
    "jump": ("cloud", BASE, "cloud", None),
    "jump_dense": ("dense", dataclasses.replace(BASE, max_overlaps=32), "cloud", None),
    "sequential": ("cloud", dataclasses.replace(BASE, jump=False), "cloud", None),
    "chain_rounds1": ("chain", dataclasses.replace(CHAIN_CFG, collect_rounds=1), "chain", None),
    "chain_rounds24": ("chain", dataclasses.replace(CHAIN_CFG, collect_rounds=24), "chain", None),
    "clusters_rounds": ("chain", dataclasses.replace(CHAIN_CFG, collect_rounds=24,
                                                     use_clusters=True, cluster_size=32),
                        "chain", None),
    "clusters": ("dense", dataclasses.replace(BASE, max_overlaps=32, use_clusters=True,
                                              cluster_size=16), "cloud", None),
    "coeff_gemm": ("cloud", dataclasses.replace(BASE, coeff_gemm=True), "cloud", None),
    "coeff_gemm_seq": ("cloud", dataclasses.replace(BASE, coeff_gemm=True, jump=False), "cloud",
                       None),
    "epanechnikov": ("cloud", dataclasses.replace(BASE, kernel_type="epanechnikov"), "cloud",
                     None),
    "caps_jump": ("dense", dataclasses.replace(BASE, max_overlaps=32), "cloud", CAPS),
    "caps_sequential": ("dense", dataclasses.replace(BASE, max_overlaps=32, jump=False),
                        "cloud", CAPS),
}


def case_inputs(case):
    scene, cfg, ray_kind, caps = CASES[case]
    if ray_kind == "chain":
        o, d, xi = chain_rays(N_RAYS, 7)
    else:
        o, d, xi = rays(N_RAYS, 0)
    t_max = None
    if caps:
        rng = np.random.default_rng(7)
        t_max = np.where(rng.uniform(size=N_RAYS) < 0.5, 5.0, np.inf).astype(np.float32)
    return SCENES[scene], cfg, o, d, xi, t_max


def jcfg_of(cfg):
    j = jprb.PRBConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    return dataclasses.replace(j, ff_chunk=0)


def jax_scalar(js, o, d, xi, jcfg, act, t_max, mask):
    """JAX's free flight, and sum(score_found + score_escape) over ``mask``
    with its gradient in sigma_t, centers and scales."""

    def f(sig, ctr, scl):
        s2 = dataclasses.replace(js, centers=ctr, scales=scl,
                                 attrs={**js.attrs, "sigma_t": sig})
        out = jprb.free_flight(s2, o, d, xi, jcfg, act, t_max=t_max)
        return jnp.sum(jnp.where(mask, out[4] + out[5], 0.0)), out

    (_, out), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        js.attrs["sigma_t"], js.centers, js.scales)
    return [np.asarray(x) for x in out], [np.asarray(x) for x in g]


@functools.lru_cache(maxsize=None)
def jax_run(case, backend, mask_key=None):
    a, cfg, o, d, xi, t_max = case_inputs(case)
    _, js = both_scenes(a)
    jcfg = jcfg_of(dataclasses.replace(cfg, walk_backend=backend))
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(xi), jcfg, jnp.ones(len(o), bool),
            None if t_max is None else jnp.asarray(t_max))
    if mask_key is None:
        return [np.asarray(x) for x in jprb.free_flight(js, *args[:5], t_max=args[5])]
    return jax_scalar(js, *args, jnp.asarray(np.frombuffer(mask_key, bool)))


def port_run(a, cfg, o, d, xi, t_max, grads=False, mask=None, dtype=torch.float32):
    """The port's free flight (and, with ``grads``, the gradient of the
    masked score sum in sigma_t, centers and scales), in ``dtype``."""
    ts, _ = both_scenes(a)
    if dtype != torch.float32:
        ts = dataclasses.replace(ts, centers=ts.centers.to(dtype), scales=ts.scales.to(dtype),
                                 quats=ts.quats.to(dtype),
                                 attrs={k: v.to(dtype) for k, v in ts.attrs.items()})
    leaves = None
    if grads:
        leaves = [ts.attrs["sigma_t"].requires_grad_(True), ts.centers.requires_grad_(True),
                  ts.scales.requires_grad_(True)]
    t = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    out = prb.free_flight(ts, t(o), t(d), t(xi), cfg, torch.ones(len(o), dtype=torch.bool),
                          t_max=None if t_max is None else t(t_max))
    g = None
    if grads:
        m = torch.from_numpy(mask)
        torch.sum(torch.where(m, out[4] + out[5], 0.0)).backward()
        g = [x.grad.double().numpy() for x in leaves]
    return [x.detach().numpy() for x in out], g


def rounding_band(a, cfg, o, d, xi, t_max, out):
    """Rays whose port decisions (found, dead) change when xi moves by a
    relative XI_BAND either way."""
    band = np.zeros(len(o), bool)
    for s in (1.0 - XI_BAND, 1.0 + XI_BAND):
        alt, _ = port_run(a, cfg, o, d, np.clip(xi * s, 1e-7, 1.0).astype(np.float32), t_max)
        band |= (alt[0] != out[0]) | (alt[1] != out[1])
    return band


def check_per_ray(got, want, band, label):
    n = len(band)
    outside = ~band
    assert band.sum() <= BAND_SHARE * n, f"{label}: {band.sum()} of {n} rays in the band"
    for i, name in ((0, "found"), (1, "dead")):
        bad = outside & (got[i] != want[i])
        assert not bad.any(), f"{label}: {name} differs on {bad.sum()} rays outside the band"
    both = outside & got[0]
    dt = np.abs(got[2][both] - want[2][both])
    assert np.all(dt <= T_ATOL + T_RTOL * np.abs(want[2][both])), (label, dt.max())
    np.testing.assert_allclose(got[3][both], want[3][both], atol=1e-3)
    for i in (4, 5):
        np.testing.assert_allclose(got[i], 1.0, atol=1e-5)
    print(f"{label}: found {got[0].mean():.3f} dead {got[1].mean():.3f}, band {band.sum()}, "
          f"max |dt| {dt.max() if dt.size else 0.0:.3g}")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_free_flight_matches_jax(case, backend):
    a, cfg, o, d, xi, t_max = case_inputs(case)
    cfg = dataclasses.replace(cfg, walk_backend=backend)
    got, _ = port_run(a, cfg, o, d, xi, t_max)
    want = jax_run(case, backend)
    band = rounding_band(a, cfg, o, d, xi, t_max, got)
    check_per_ray(got, want, band, f"{case}/{backend}")
    # the case exercises what it names
    if case.startswith("caps"):
        assert (np.isfinite(t_max) & ~got[0] & ~got[1]).any()  # rays resolved at the cap
    if case == "chain_rounds1":
        assert got[1].mean() > 0.5  # the one-shot collection budget-kills
    if case in ("chain_rounds24", "clusters_rounds"):
        # the rounds rescue the xla walk; the fused walk keeps one round,
        # as in the JAX package
        assert (got[1].mean() < 0.02) == (backend == "xla")


def test_rounds_gradients_equal_one_collection():
    """On the chain, the xla walk with 24 re-collection rounds of 24
    intervals and the walk over one collection of all 256 (48 windows)
    decide the same and give the same score gradients: the rounds resume
    exactly where a round stopped."""
    a, cfg, o, d, xi, t_max = case_inputs("chain_rounds24")
    one = dataclasses.replace(cfg, collect_budget=256, max_windows=48, collect_rounds=1)
    r24, _ = port_run(a, cfg, o, d, xi, t_max)
    r1, _ = port_run(a, one, o, d, xi, t_max)
    live = ~r24[1] & ~r1[1]
    assert live.sum() > 100 and r24[1].sum() == 0
    assert np.array_equal(r24[0][live], r1[0][live])
    f = live & r24[0]
    np.testing.assert_allclose(r24[2][f], r1[2][f], rtol=1e-6)
    _, g24 = port_run(a, cfg, o, d, xi, t_max, grads=True, mask=live)
    _, g1 = port_run(a, one, o, d, xi, t_max, grads=True, mask=live)
    for x, y in zip(g24, g1):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6 * np.abs(y).max())


@pytest.mark.parametrize("fast", [True, False])
def test_free_flight_window_matches_jax(fast):
    """One window, both branches (the Gaussian antiderivative, the general
    [R, 2K - 1, K] broadcast), on the same table, coefficients and xi."""
    ts, _ = both_scenes(DENSE)
    o, d, xi = rays(N_RAYS, 3)
    k = 16
    ot, dt_ = torch.from_numpy(o), torch.from_numpy(d)
    entry_all, exit_all, ids_all, _, _ = prb._gather_intervals(
        ts, ot, dt_, torch.zeros(N_RAYS), 64, 64)
    t_min = torch.full((N_RAYS,), 4.7)  # mid-cloud
    entry, exit_t, sel, valid, t_limit, _ = prb._window_from_collected(entry_all, exit_all,
                                                                      t_min, k)
    ids = torch.gather(ids_all, 1, sel)
    co = quadric.pair_coeffs_gathered(ot, dt_, ts.centers, ts.scales, ts.quats, ids)
    sig = torch.where(valid, ts.attrs["sigma_t"][:, 0][ids], 0.0)
    sp = ts.scale_prod()[ids]
    trans = torch.from_numpy(np.random.default_rng(4).uniform(0.5, 1.0, N_RAYS).astype(np.float32))
    kern_name = "gaussian" if fast else "epanechnikov"
    tk = prb.PRBConfig(kernel_type=kern_name).kernel
    jk = jkernels.Kernel(kern_name, normalized=False, full_range=False)
    act = np.random.default_rng(5).uniform(size=N_RAYS) < 0.9
    args = [entry, exit_t, co, sig, sp, t_limit, trans, torch.from_numpy(xi),
            torch.from_numpy(act)]
    got = [x.numpy() for x in prb._free_flight_window(tk, *args, 4, "bisection")]
    jargs = [jnp.asarray(x.numpy()) if torch.is_tensor(x) else
             jquadric.QuadricCoeffs(*(jnp.asarray(c.numpy()) for c in x)) for x in args]
    want = [np.asarray(x) for x in jprb._free_flight_window(jk, *jargs, 4, "bisection")]
    assert 0.1 < got[1].mean() < 0.9 and np.isfinite(t_limit.numpy()).any()
    assert np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7)  # trans_out
    f = got[1]
    np.testing.assert_allclose(got[2][f], want[2][f], atol=T_ATOL, rtol=T_RTOL)
    assert np.all(np.isinf(got[2][~f])) and np.all(np.isinf(want[2][~f]))
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-7)  # trans at sample
    print(f"{kern_name}: found {f.mean():.3f}, max |dt| {np.abs(got[2][f] - want[2][f]).max():.3g}")


def test_segment_taus_match_jax():
    ts, js = both_scenes(DENSE)
    o, d, _ = rays(64, 9)
    entry, exit_t, ids, _, _ = prb._gather_intervals(ts, torch.from_numpy(o),
                                                     torch.from_numpy(d), torch.zeros(64), 16, 64)
    co = quadric.pair_coeffs_gathered(torch.from_numpy(o), torch.from_numpy(d), ts.centers,
                                      ts.scales, ts.quats, ids)
    sig = ts.attrs["sigma_t"][:, 0][ids]
    sp = ts.scale_prod()[ids]
    events = torch.sort(torch.cat([entry, exit_t], 1), 1).values
    from volprim_tpu_torch.ops import kernels as tkernels

    got = tkernels.gaussian_segment_taus(co, sp, sig, entry, exit_t, events).numpy()
    want = np.asarray(jkernels.gaussian_segment_taus(
        jquadric.QuadricCoeffs(*(jnp.asarray(c.numpy()) for c in co)), jnp.asarray(sp.numpy()),
        jnp.asarray(sig.numpy()), jnp.asarray(entry.numpy()), jnp.asarray(exit_t.numpy()),
        jnp.asarray(events.numpy())))
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("case", ["jump_dense", "chain_rounds1", "clusters", "caps_jump"])
def test_xla_and_pallas_walks_agree(case):
    """The port's two backends on the same rays and xi (the fused walk's
    decisions against the xla windows', one collection round: the fused
    walk has no others), outside the rounding band. On the chain, where no
    more than k intervals overlap, their score gradients agree too (beyond
    k overlaps the fused walk's post-pass keeps the whole depth of the
    intervals the windows drop, in both packages)."""
    a, cfg, o, d, xi, t_max = case_inputs(case)
    cfg = dataclasses.replace(cfg, collect_rounds=1)
    xla_cfg = dataclasses.replace(cfg, walk_backend="xla")
    fused_cfg = dataclasses.replace(cfg, walk_backend="pallas")
    xla, _ = port_run(a, xla_cfg, o, d, xi, t_max)
    fused, _ = port_run(a, fused_cfg, o, d, xi, t_max)
    band = rounding_band(a, xla_cfg, o, d, xi, t_max, xla)
    check_per_ray(fused, xla, band, f"{case}: pallas vs xla")
    if case == "chain_rounds1":
        mask = ~band & (fused[0] == xla[0]) & (fused[1] == xla[1])
        _, g_x = port_run(a, xla_cfg, o, d, xi, t_max, grads=True, mask=mask)
        _, g_f = port_run(a, fused_cfg, o, d, xi, t_max, grads=True, mask=mask)
        for name, gx, gf in zip(("sigma_t", "centers", "scales"), g_x, g_f):
            err = np.abs(gx - gf).max() / np.abs(gf).max()
            print(f"{case} d/d{name}: xla vs fused {err:.3g}")
            assert err <= GRAD_TOL, name


@pytest.mark.parametrize("gemm", [False, True])
def test_count_intervals_and_suggest_budgets_match_jax(gemm):
    """count_intervals per ray: equal, except on rays that graze an extent
    ellipsoid (float64 q_min within 1e-4 of extent^2, or t_far within 1e-4
    of the origin), where the two packages' roundings of q = c - b^2/a may
    count the primitive differently (as tests/test_torch_tomography.py
    excuses them); at most 0.1% of the rays. suggest_budgets: the equal
    config (the same subsample, drawn by numpy)."""
    ts, js = both_scenes(DENSE)
    o, d, _ = rays(5000, 2)
    got = prb.count_intervals(ts, torch.from_numpy(o), torch.from_numpy(d), 128,
                              coeff_gemm=gemm).numpy()
    want = np.asarray(jprb.count_intervals(js, jnp.asarray(o), jnp.asarray(d), 128,
                                           coeff_gemm=gemm))
    assert got.max() > 50
    co = quadric.ray_prim_coeffs(torch.from_numpy(o).double(), torch.from_numpy(d).double(),
                                 ts.centers.double(), ts.scales.double(), ts.quats.double())
    qmin = co.c - co.b * co.b / co.a
    t_far = -co.b / co.a + torch.sqrt(torch.clamp((9.0 - qmin) / co.a, min=0.0))
    graze = ((torch.abs(qmin - 9.0) < 1e-4) | (torch.abs(t_far) < 1e-4)).any(1).numpy()
    differ = got != want
    print(f"count_intervals: {differ.sum()} rays differ, {graze.sum()} graze")
    assert not (differ & ~graze).any() and differ.sum() <= 0.001 * len(o)
    cfg = dataclasses.replace(BASE, coeff_gemm=gemm)
    jcfg = jprb.PRBConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    for pct in (99.9, 50.0):
        c_t = prb.suggest_budgets(ts, torch.from_numpy(o), torch.from_numpy(d), cfg, pct)
        c_j = jprb.suggest_budgets(js, jnp.asarray(o), jnp.asarray(d), jcfg, pct)
        assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j)
        assert c_t.collect_budget != cfg.collect_budget


def test_collection_counts_what_count_intervals_counts():
    """tests/test_prb.py::test_suggest_budgets_covers_need on the port: an
    uncapped collection holds exactly the counted intervals, with clusters
    too, and a budget of the need's maximum kills no ray."""
    ts, _ = both_scenes(DENSE)
    o, d, _ = rays(512, 4)
    ot, dt_ = torch.from_numpy(o), torch.from_numpy(d)
    need = prb.count_intervals(ts, ot, dt_, 128)
    for clusters in (False, True):
        cfg = dataclasses.replace(BASE, collect_budget=512, use_clusters=clusters,
                                  cluster_size=16, cluster_candidates=64)
        index = prb.build_ff_index(ts, cfg) if clusters else None
        entry, _, _, t_budget, _ = prb._collect_intervals(ts, index, ot, dt_, cfg)
        assert torch.equal(torch.isfinite(entry).sum(1).to(torch.int32), need)
        assert torch.isinf(t_budget).all()
    cfg2 = prb.suggest_budgets(ts, ot, dt_, BASE, percentile=100.0)
    assert cfg2.collect_budget >= int(need.max()) and cfg2.collect_budget % 16 == 0
    assert cfg2.max_windows * cfg2.max_overlaps >= cfg2.collect_budget
