"""The path tracer's stage stops (``models.prb._FF_STOP``) against the JAX
package's, and the two stage profilers built on them
(``volprim_tpu_torch.tools.profile_prb`` and ``tools.ff_attrib``, ports of
the root tools/profile_prb.py and tools/ff_attrib.py).

A stop returns free_flight's six outputs with checksums of the stage's
results (``_ff_stop_out``): the first score is 1 plus the checksum in both
packages, held within 1e-5 relative. The sequential walk's "collect" sums
the collected intervals, and a ray that grazes an extent ellipsoid may
collect the primitive in one package and not the other (ROADMAP.md §D,
recorded mismatches): such rays, whose collected ids differ, are counted (at most 2 of
the 1024) and their own sums taken out of both checksums. The scene is the profilers' plume
(sigma_t x 10) at 1024 primitives, seen by their camera at 32 x 32 (1024
rays: JAX's needy-ray sort runs from 1024 rays up). At "sort" the port
compacts with ``torch.nonzero`` where JAX stable-sorts every ray, so only
the structure and the transmittance part of the checksum are compared. The
tools run on the CPU at 16 x 16 and must print every row name of JAX's
tools, read from their sources.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ffwalk import both_scenes, one_torch_thread  # noqa: F401
from volprim_tpu.models import prb as jprb
from volprim_tpu_torch.models import prb
from volprim_tpu_torch.scene import generate_rays, synthetic
from volprim_tpu_torch.tools import ff_attrib, profile_prb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool_rows():
    """The row names JAX's tools print: the sweep (run_cfg's first
    argument), the stages (the *_65k names) and the ff_attrib stops."""
    src = open(os.path.join(ROOT, "tools", "profile_prb.py")).read()
    sweep = re.findall(r'run_cfg\(\s*"([^"]+)"', src)
    stages = list(dict.fromkeys(re.findall(r'"(\w+_65k)"', src)))
    src = open(os.path.join(ROOT, "tools", "ff_attrib.py")).read()
    stops = re.search(r"stops = \(([^)]*)\)", src).group(1)
    attrib = [s_ if s_ != "None" else "full_allescape"
              for s_ in re.findall(r'"?(\w+)"?', stops)]
    return sweep, stages, attrib


@pytest.fixture(scope="module")
def flight_setup():
    a = synthetic.make_medium_arrays(1024, seed=0)
    a["sigma_t"] = a["sigma_t"] * 10.0
    ts, js = both_scenes(a)
    o, d = generate_rays(profile_prb.camera(32), jitter=False, device="cpu")
    return ts, js, o, d


def _flights(setup, stop, xi_val, monkeypatch, **cfg_kw):
    """(port, JAX) free_flight outputs as numpy under the stop ``stop``."""
    ts, js, o, d = setup
    r = o.shape[0]
    xi = np.full((r,), xi_val, np.float32)
    monkeypatch.setattr(prb, "_FF_STOP", stop)
    monkeypatch.setattr(jprb, "_FF_STOP", stop)
    cfg = dict(profile_prb.BASE, **cfg_kw)
    got = prb.free_flight(ts, o, d, torch.from_numpy(xi), prb.PRBConfig(**cfg),
                          torch.ones((r,), dtype=torch.bool))
    # a new function per stop: JAX reads _FF_STOP when it traces
    want = jax.jit(lambda oo, dd, xx: jprb.free_flight(
        js, oo, dd, xx, jprb.PRBConfig(**cfg), jnp.ones((r,), bool)))(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(xi))
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


def _grazing_sums(setup):
    """The sequential walk's collections in both packages: the rays whose
    collected ids differ, and (port, JAX) sums of those rays' finite entries,
    exits and budgets, as the "collect" checksum sums them."""
    ts, js, o, d = setup
    cfg = dict(profile_prb.BASE, jump=False)
    port = [x.numpy() for x in prb._collect_intervals(ts, None, o, d,
                                                      prb.PRBConfig(**cfg))[:4]]
    jx = [np.asarray(x) for x in jax.jit(lambda oo, dd: jprb._collect_intervals(
        js, None, oo, dd, jprb.PRBConfig(**cfg)))(jnp.asarray(o.numpy()),
                                                  jnp.asarray(d.numpy()))[:4]]
    differ = [i for i in range(o.shape[0])
              if set(port[2][i][np.isfinite(port[0][i])])
              != set(jx[2][i][np.isfinite(jx[0][i])])]

    def sums(tables):
        e, x, _, tb = (v[differ] for v in tables)
        return float(sum(np.sum(np.where(np.isfinite(v), v, 0.0), dtype=np.float64)
                         for v in (e, x, tb)))

    return sums(port), sums(jx), len(differ)


def _same_structure(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("stop, xi_val, cfg_kw", [
    ("collect", 0.5, {}),
    ("collect", 0.5, dict(jump=False)),
    ("escape", 1e-30, {}),
    (None, 1e-30, {}),
], ids=["collect_jump", "collect_sequential", "escape", "none"])
def test_ff_stop_matches_jax(flight_setup, monkeypatch, stop, xi_val, cfg_kw):
    got, want = _flights(flight_setup, stop, xi_val, monkeypatch, **cfg_kw)
    _same_structure(got, want)
    found, dead, t_samp, albedo, s_found, s_escape = got
    if stop is not None:
        assert not found.any() and not dead.any() and not np.isfinite(t_samp).any()
        assert not albedo.any() and (s_escape == 1.0).all()
        chk_t, chk_j = float(s_found[0]) - 1.0, float(want[4][0]) - 1.0
        if cfg_kw.get("jump") is False:
            off_t, off_j, n_graze = _grazing_sums(flight_setup)
            print(f"rays collecting other ids: {n_graze}")
            assert n_graze <= 2
            chk_t, chk_j = chk_t - off_t, chk_j - off_j
        print(f"{stop} {cfg_kw}: checksum port {chk_t} JAX {chk_j}")
        assert abs(chk_j) > 1.0  # the stage's results are in it
        assert abs(chk_t - chk_j) <= 1e-5 * abs(chk_j)
        assert (s_found == s_found[0]).all()
    else:  # every ray escapes in closed form: nothing found, nothing dead
        assert not found.any() and not dead.any()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_ff_stop_sort(flight_setup, monkeypatch):
    """Every ray escapes (xi = 1e-30): no needy ray, so the port's index sum
    is 0 and JAX's sort order sums to R (R - 1) / 2; less those, both
    checksums are the sum of the closed-form transmittances (JAX's within
    two f32 ulps of its whole checksum, where it was rounded)."""
    got, want = _flights(flight_setup, "sort", 1e-30, monkeypatch)
    _same_structure(got, want)
    r = got[0].shape[0]
    assert not got[0].any() and not got[1].any() and not np.isfinite(got[2]).any()
    chk_j = np.float32(want[4][0]) - np.float32(1.0)
    part_j = float(chk_j) - r * (r - 1) / 2
    part_t = float(got[4][0]) - 1.0
    assert part_t > 1.0
    print(f"sort: transmittance part port {part_t} JAX {part_j}")
    assert abs(part_t - part_j) <= 1e-5 * part_j + 2 * float(np.spacing(chk_j))
    # the port's stop really compacts: with xi near 1 every ray is needy
    ts, _, o, d = flight_setup
    got, _ = _flights(flight_setup, "sort", 1.0 - 1e-7, monkeypatch)
    f = prb.optical_depth(ts, o, d, prb.PRBConfig(**profile_prb.BASE))
    needy = f > -torch.log(torch.tensor(1.0 - 1e-7))
    assert 0 < int(needy.sum()) < r
    want = float(torch.nonzero(needy)[:, 0].double().sum()) + float(torch.exp(-f).sum())
    np.testing.assert_allclose(float(got[4][0]) - 1.0, want, rtol=1e-5)


def test_ff_stop_none_is_the_path(flight_setup, monkeypatch):
    """_FF_STOP None after a stop gives free_flight's own result, bit for
    bit, on a random xi."""
    ts, _, o, d = flight_setup
    r = o.shape[0]
    xi = torch.from_numpy(np.random.default_rng(7).uniform(1e-7, 1.0, r).astype(np.float32))
    cfg = prb.PRBConfig(**profile_prb.BASE)
    act = torch.ones((r,), dtype=torch.bool)
    base = prb.free_flight(ts, o, d, xi, cfg, act)
    monkeypatch.setattr(prb, "_FF_STOP", "escape")
    prb.free_flight(ts, o, d, xi, cfg, act)
    monkeypatch.setattr(prb, "_FF_STOP", None)
    for a, b in zip(base, prb.free_flight(ts, o, d, xi, cfg, act)):
        assert torch.equal(a, b)


def _tool(module, *argv):
    """``python -m volprim_tpu_torch.tools.<module> --cpu ...`` on one
    thread: its stdout (it must exit 0)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", f"volprim_tpu_torch.tools.{module}", "--cpu",
                           *argv], capture_output=True, text=True, timeout=600, env=env,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_profile_prb_prints_jax_rows():
    sweep, stages, _ = jax_tool_rows()
    assert len(sweep) == 13 and len(stages) == 5
    assert [name for name, _ in profile_prb.SWEEP] == sweep
    assert list(profile_prb.STAGES) == stages
    out = _tool("profile_prb", "--quick", "--res", "16", "--reps", "1")
    lines = out.splitlines()
    for name in [sweep[0]] + stages:
        assert any(line.startswith(f"{name} ") for line in lines), name
    assert not any(line.startswith(sweep[1] + " ") for line in lines)  # --quick
    assert any(line.startswith("window stats bounce 0: {") for line in lines)
    assert lines[-1].startswith("summary: {")


def test_profile_prb_sweep_in_process(capsys):
    """Every row of the sweep, in-process at 8 x 8: the walk=pallas rows
    count the walk's launches (its plain version on the CPU counts none)."""
    sweep, stages, _ = jax_tool_rows()
    res = profile_prb.main(["--cpu", "--res", "8", "--reps", "1"])
    out = capsys.readouterr().out
    for name in sweep + stages:
        assert any(line.startswith(f"{name} ") for line in out.splitlines()), name
        assert res[name] > 0.0
    assert set(res["walk_launches"]) == {"walk=pallas", "walk=pallas exact"}
    stats = res["window_stats"]
    assert len(stats["active_entering_window"]) == profile_prb.BASE["max_windows"]
    assert stats["active_entering_window"][0] == 64
    assert 0.0 <= stats["found_frac"] <= 1.0


def test_ff_attrib_prints_jax_rows(monkeypatch):
    _, _, attrib = jax_tool_rows()
    assert attrib == ["collect", "escape", "sort", "full_allescape", "full_xi_rand"]
    out = _tool("ff_attrib", "--res", "16", "--reps", "1")
    lines = out.splitlines()
    for name in attrib:
        assert any(line.startswith(f"{name} ") for line in lines), name
    assert lines[-1].startswith("summary: {")
    # the stop is reset on an error too
    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(prb, "optical_depth", broken)
    with pytest.raises(RuntimeError, match="planted"):
        ff_attrib.main(["--cpu", "--res", "4", "--reps", "1"])
    assert prb._FF_STOP is None


def test_profile_prb_rows_select_the_sweep(capsys):
    """--rows runs the first sweep row and the named ones (chip_smoke's
    phase 39 asks for the walk=pallas rows); an unknown row exits."""
    res = profile_prb.main(["--cpu", "--res", "4", "--reps", "1", "--rows", "walk=pallas"])
    out = capsys.readouterr().out
    assert "full (bench cfg)" in res and "walk=pallas" in res
    assert "walk=pallas exact" not in res and "no_nee" not in res
    assert res["walk_launches"] == {"walk=pallas": 0}  # the plain walk on the CPU
    assert out.splitlines()[-1].startswith("summary: {")
    with pytest.raises(SystemExit, match="unknown rows"):
        profile_prb.main(["--cpu", "--res", "4", "--rows", "walk=cuda"])
