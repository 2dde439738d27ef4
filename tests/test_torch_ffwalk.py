"""The port's free-flight walk (volprim_tpu_torch.kernels.ffwalk) and the
free-flight stages around it (models/prb: _gather_intervals, free_flight)
against the JAX package on the same numpy-made inputs. The JAX walk runs as
prb runs it on the CPU: the Pallas kernel in interpret mode, with lax.erf.

Tolerances, from tests/test_ffwalk.py:43-72: sampling decisions may flip
only at f32 rounding boundaries (at most 1% of rays; the window depth is a
sum taken in another order), sampled distances agree within atol 5e-3 +
rtol 1e-3 (the solver's resolution), albedo within 1e-3. The walk itself
on identical tables is held tighter: decisions identical on at least 99%
of rays, and each test prints the largest t_samp difference it saw, in
each of ffwalk.WALK_VARIANTS (among them the walk started at the jump
boundary and long intervals open across windows). chip_smoke.py's reader
of ptxas's rows and its spill gate for the walk's instantiations, and the
ctypes argument types against the C declaration, are checked here too."""

import ctypes
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu.models import prb as jprb
from volprim_tpu.pallas_kernels import ffwalk as jffwalk
from volprim_tpu.scene import EllipsoidScene as JScene
from volprim_tpu_torch import interop
from volprim_tpu_torch.kernels import ffwalk
from volprim_tpu_torch.models import prb

T_ATOL, T_RTOL = 5e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The path tracer runs thousands of small eager ops. With several test
    processes sharing the cores, torch's intra-op threads wait on each other
    far longer than the ops take, so these tests use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cloud_arrays(n_prims, seed, spread, smin, smax, sig=(1.0, 5.0)):
    """A _cloud-style medium (tests/test_ffwalk.py:18): isotropic Gaussians
    around the origin, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(
        centers=f32(rng.normal(size=(n_prims, 3)) * spread),
        scales=f32(np.repeat(rng.uniform(smin, smax, (n_prims, 1)), 3, axis=1)),
        quats=f32(np.tile([0.0, 0.0, 0.0, 1.0], (n_prims, 1))),
        sigma_t=f32(rng.uniform(*sig, (n_prims, 1))),
        albedo=f32(np.repeat(rng.uniform(0.2, 0.9, (n_prims, 1)), 3, axis=1)),
    )


def both_scenes(a):
    attrs = {"sigma_t": a["sigma_t"], "albedo": a["albedo"]}
    ts = interop.scene_from_arrays(a["centers"], a["scales"], a["quats"], attrs, 3.0,
                                   device="cpu")
    js = JScene(
        centers=jnp.asarray(a["centers"]), scales=jnp.asarray(a["scales"]),
        quats=jnp.asarray(a["quats"]), attrs={k: jnp.asarray(v) for k, v in attrs.items()},
        extent=3.0,
    )
    return ts, js


def rays(n, seed, jitter=0.3, z0=-5.0):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = z0
    o[:, :2] = rng.normal(size=(n, 2)) * jitter
    d = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (n, 1))
    xi = rng.uniform(1e-6, 1.0, n).astype(np.float32)
    return o, d, xi


# a dense cloud: up to ~300 intervals per ray, ~30 open at once in its core
DENSE = cloud_arrays(400, 3, 0.4, 0.06, 0.2, sig=(0.02, 0.1))

def variant_tables(name, r=256, seed=0):
    """Walk inputs collected by the port for one variant (numpy-seeded)."""
    ts, _ = both_scenes(DENSE)
    o, d, _ = rays(r, seed)
    tb = ffwalk.synthetic_tables(ts, torch.from_numpy(o), torch.from_numpy(d), 256, seed=seed)
    return ffwalk.walk_variant(tb, name, seed=seed + 1)


@pytest.mark.parametrize("name", list(ffwalk.WALK_VARIANTS))
def test_walk_reference_matches_jax_kernel(name):
    tb, kw = variant_tables(name)
    got = ffwalk.walk(*tb.values(), **kw)
    want = jffwalk.walk(*(jnp.asarray(v.numpy()) for v in tb.values()), **kw, interpret=True)
    r = tb["entry"].shape[0]
    flips = 0
    for g, w in zip(got[:4], want[:4]):
        flips = max(flips, int((g.numpy() != np.asarray(w)).sum()))
    assert flips <= 0.01 * r, f"{flips} of {r} rays decide differently"
    fg, fw = got[0].numpy(), np.asarray(want[0])
    both = fg & fw
    tg, tw = got[4].numpy()[both], np.asarray(want[4])[both]
    diff = np.abs(tg - tw)
    print(f"{name}: {int(both.sum())} found by both, max |dt| {diff.max():.3g}, "
          f"flips {flips}")
    assert np.all(diff <= T_ATOL + T_RTOL * np.abs(tw))
    # the variant exercises what it names
    if name == "t_cap_half":
        assert got[3].any()
    if name == "t_budget":
        assert got[2].any()
    if name == "jump_start":  # some rays start past the first block
        t0 = tb["t_min0"]
        assert (t0 > 0).any() and (t0 == 0).any()
    if name == "long_open":  # intervals 0 and 37 end at the row's last exit
        ex = tb["exit_t"]
        last = torch.amax(torch.where(torch.isfinite(ex), ex, -torch.inf), 1)
        fin = torch.isfinite(tb["entry"][:, 37])
        assert fin.any() and torch.equal(ex[fin, 37], last[fin])
        assert torch.equal(ex[:, 0], last)


def test_walk_work_counts_what_the_rays_walk():
    tb, kw = variant_tables("kp256_k32_w4")
    work = {}
    found, resolved, bdead, _, _ = ffwalk.walk_reference(*tb.values(), **kw, work=work)
    # a ray walks windows until it is found, resolved or dead
    done = int((found | resolved | bdead).sum())
    assert done <= work["windows"] <= 4 * tb["entry"].shape[0]
    assert 0 < work["selected_found"] <= 32 * int(found.sum())
    assert work["selected_found"] <= work["selected"] <= 32 * work["windows"]
    assert work["windows"] <= work["scanned"] <= 256 * work["windows"]
    assert work["selected_union"] <= work["selected"]
    assert work["selected_union"] <= work["scanned_max"] <= work["scanned"]
    r = tb["entry"].shape[0]
    assert 128 * r <= work["group_entries"] <= 256 * r  # K' = 256: one or two groups a row
    # one ray, five intervals open from 0, padding after them: a window reads
    # up to its (k+1)-th open interval, or up to the first padding entry
    inf = torch.inf
    row = dict(
        entry=torch.tensor([[0.0, 1.0, 2.0, 3.0, 4.0, inf, inf, inf]]),
        exit_t=torch.tensor([[9.0] * 5 + [inf] * 3]),
        cp=torch.zeros(1, 8), alpha=torch.ones(1, 8), beta=torch.zeros(1, 8),
        chi=torch.ones(1), t_budget=torch.full((1,), inf), t_cap=torch.full((1,), inf),
        active=torch.ones(1, dtype=torch.bool), t_min0=torch.zeros(1),
    )
    for k, scanned in ((2, 3), (8, 6)):
        work = {}
        ffwalk.walk_reference(*row.values(), k=k, n_windows=1, work=work)
        assert (work["scanned"], work["scanned_max"]) == (scanned, scanned)
        assert work["group_entries"] == 8  # one group, cut to the row's 8 entries
        assert work["selected_union"] == min(k, 5)


@pytest.mark.parametrize("fault", ["none", "t_samp_not_inf", "decision_flipped", "t_off"])
def test_chip_smoke_compare_walk(fault):
    """chip_smoke.compare_walk, which holds ffwalk.walk on the card to
    walk_reference, passes the wrapper's own output and counts a t_samp left
    at BIG where not found, a flipped decision and a t_samp out of
    tolerance."""
    import chip_smoke

    tb, kw = variant_tables("kp256_k32_w4", r=64)
    got = list(ffwalk.walk(*tb.values(), **kw))
    want = ffwalk.walk_reference(*tb.values(), **kw)
    found = got[0]
    assert found.any() and not found.all()
    i = int(torch.nonzero(found)[0, 0])
    if fault == "t_samp_not_inf":
        got[4] = torch.where(found, got[4], ffwalk.BIG)
    elif fault == "decision_flipped":
        got[2] = got[2].clone()
        got[2][i] = ~got[2][i]
    elif fault == "t_off":
        got[4] = got[4].clone()
        got[4][i] += 0.1
    res = chip_smoke.compare_walk(tuple(got), want, 64)
    n_bad = res["decisions_differ"] + res["t_outside_tol"]
    want_bad = {"none": 0, "t_samp_not_inf": int((~found).sum()), "decision_flipped": 1,
                "t_off": 1}[fault]
    assert n_bad == want_bad
    assert res["ok"] == (fault == "none")


def test_walk_wrapper_routes_by_device():
    tb, kw = variant_tables("kp128_k8_w4", r=32)
    before = ffwalk.walk.launches
    found, _, _, _, t = ffwalk.walk(*tb.values(), **kw)
    assert ffwalk.walk.launches == before  # the CPU takes the plain version
    assert torch.all(torch.isfinite(t) == found)  # +inf where not found
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ffwalk.walk(*(v.to("meta") for v in tb.values()), **kw)
    big = {key: torch.zeros((4, 1056)) if v.dim() == 2 else v[:4] for key, v in tb.items()}
    with pytest.raises(ValueError, match="K' <= 1024"):
        ffwalk._launch(*big.values(), 8, 4, 22, 4, False)


def test_ptxas_table_reads_the_walk_instantiations():
    """chip_smoke.py prints ptxas's row of each walk instantiation (slots
    per lane: 1, 2, or 0 for shared memory) and fails if the path's, one
    slot per lane (k <= 32), spills."""
    import chip_smoke

    fn = "_ZN12_GLOBAL__N_113ffwalk_kernelILi{}EEEvPKfS2_"
    log = "".join(
        f"ptxas info    : Compiling entry function '{fn.format(s)}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {fn.format(s)}\n"
        f"    0 bytes stack frame, {sp} bytes spill stores, {sp} bytes spill loads\n"
        f"ptxas info    : Used {reg} registers\n"
        for s, sp, reg in ((1, 0, 56), (2, 8, 72), (0, 0, 40)))
    table = chip_smoke.ptxas_table(log)
    assert [(r["kernel"], r["args"], r["registers"], r["spill_stores"]) for r in table] == [
        ("ffwalk_kernel", [1], 56, 0), ("ffwalk_kernel", [2], 72, 8),
        ("ffwalk_kernel", [0], 40, 0)]
    assert [chip_smoke.spill_gated("ffwalk", r) for r in table] == [True, False, False]


def test_walk_argtypes_follow_the_c_declaration(monkeypatch):
    src = (Path(ffwalk.__file__).resolve().parent.parent / "csrc" / "ffwalk.cu").read_text()
    decl = re.search(r'extern "C" int ffwalk\(([^)]*)\)', src).group(1)
    types = [re.sub(r"\s*\w+$", "", a.strip()).replace(" *", "*") for a in decl.split(",")]
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}
    argtypes = []
    monkeypatch.setattr(ffwalk._build, "bind",
                        lambda name, types_, entry=None: argtypes.extend(types_))
    ffwalk._lib()
    assert [ctype[t] for t in types] == argtypes


def test_walk_detaches_its_inputs():
    tb, kw = variant_tables("kp128_k8_w4", r=16)
    cp = tb["cp"].clone().requires_grad_(True)
    tb["cp"] = cp
    out = ffwalk.walk(*tb.values(), **kw)
    assert not out[4].requires_grad


def tie_scene():
    """The cloud plus 12 co-located Gaussians at the origin: rays that
    start inside them see many entries clamped to t_min = 0 (ties)."""
    a = cloud_arrays(60, 5, 0.4, 0.1, 0.3)
    rng = np.random.default_rng(11)
    b = cloud_arrays(12, 6, 0.0, 0.3, 0.5, sig=(2.0, 2.0))
    b["centers"] = (rng.normal(size=(12, 3)) * 0.05).astype(np.float32)
    return {key: np.concatenate([a[key], b[key]]) for key in a}


@pytest.mark.parametrize("inside", [False, True])
def test_gather_intervals_matches_jax(inside):
    a = tie_scene()
    ts, js = both_scenes(a)
    o, d, _ = rays(192, 7)
    if inside:  # start at the co-located cluster: entries tie at 0
        o[:, 2] = 0.0
        o[:, :2] *= 0.1
    k, chunk = 48, 64
    kern = prb.PRBConfig().kernel
    t_min = np.zeros(len(o), np.float32)
    got = prb._gather_intervals(ts, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(t_min), k, chunk, kern=kern)
    want = jprb._gather_intervals(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min), k,
                                  chunk, kern=jprb.PRBConfig().kernel)
    e_t, e_j = got[0].numpy(), np.asarray(want[0])
    fin = np.isfinite(e_j)
    assert np.array_equal(np.isfinite(e_t), fin)
    # t = t_peak -/+ sqrt((e^2 - q_min) / a) inherits q_min = c - b^2/a's
    # cancellation: XLA's and torch's roundings differ by up to ~2e-5
    # relative near tangent rays
    np.testing.assert_allclose(e_t[fin], e_j[fin], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy()[fin], np.asarray(want[1])[fin], atol=1e-4,
                               rtol=1e-4)
    ids_t, ids_j = got[2].numpy(), np.asarray(want[2])
    # the tie order is exact (entries clamped to exactly 0 on both sides);
    # elsewhere only entries within rounding of each other may swap
    ties = fin & (e_j == 0.0)
    if inside:
        assert ties.sum() > 5 * len(o)
    assert np.array_equal(ids_t[ties], ids_j[ties])
    assert (ids_t[fin] == ids_j[fin]).mean() >= 0.995
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    # whole-interval depths: erf(u1) - erf(u0) at those entries and exits,
    # so within 1e-4 of the largest depth (tangent rays) and 2e-4 relative
    same = fin & (ids_t == ids_j)
    tau_j = np.asarray(want[4])[same]
    np.testing.assert_allclose(got[4].numpy()[same], tau_j,
                               atol=1e-4 * np.abs(tau_j).max(), rtol=2e-4)


BASE = prb.PRBConfig(max_overlaps=8, max_windows=6, chunk_size=64, walk_backend="pallas")


def compare_free_flight(a, cfg, n=512, seed=0, t_max=None):
    """free_flight in both packages on the same o, d, xi (and caps)."""
    ts, js = both_scenes(a)
    o, d, xi = rays(n, seed)
    act = np.ones(n, bool)
    jcfg = jprb.PRBConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jcfg = dataclasses.replace(jcfg, ff_chunk=0)
    want = jprb.free_flight(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(xi), jcfg,
                            jnp.asarray(act),
                            t_max=None if t_max is None else jnp.asarray(t_max))
    got = prb.free_flight(ts, *(torch.from_numpy(x) for x in (o, d, xi)), cfg,
                          torch.from_numpy(act),
                          t_max=None if t_max is None else torch.from_numpy(t_max))
    fx, fp = [np.asarray(w) for w in want], [g.detach().numpy() for g in got]
    assert (fx[0] != fp[0]).mean() < 0.01
    assert (fx[1] != fp[1]).mean() < 0.01
    both = fx[0] & fp[0]
    assert both.sum() > n // 10
    diff = np.abs(fp[2][both] - fx[2][both])
    print(f"found {fp[0].mean():.3f} dead {fp[1].mean():.3f}, max |dt| {diff.max():.3g}")
    np.testing.assert_allclose(fp[2][both], fx[2][both], atol=T_ATOL, rtol=T_RTOL)
    np.testing.assert_allclose(fp[3][both], fx[3][both], atol=1e-3)
    for i in (4, 5):  # score factors: numerically 1
        np.testing.assert_allclose(fp[i], 1.0, atol=1e-5)
    return fx, fp


def test_free_flight_matches_jax_jump():
    compare_free_flight(cloud_arrays(24, 3, 0.4, 0.15, 0.5), BASE)


def test_free_flight_matches_jax_with_surface_cap():
    n = 512
    rng = np.random.default_rng(7)
    t_max = np.where(rng.uniform(size=n) < 0.5, 5.0, np.inf).astype(np.float32)
    _, fp = compare_free_flight(DENSE, dataclasses.replace(BASE, max_overlaps=32), n=n,
                                t_max=t_max)
    assert fp[1].any()  # the dense cloud exercises window exhaustion too
