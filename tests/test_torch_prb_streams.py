"""The path tracer's counter-based random streams (``ops/streams``,
``prb.radiance_keyed``), its spans and counters, and its frame against the
benchmark's plain reference (``portbench/reference/pt.py``) at a small
size, all on the CPU with one torch thread.

On the CPU the program and the reference run the same float32 operations
in the same order (256 primitives fit one of the program's 1,024-wide
chunks, and the CPU walk is the kernel's plain version), so their frames
agree to the bit; the tolerances below admit rounding alone."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import plume
from portbench.drivers import path_trace
from portbench.run import load_cell
from volprim_tpu_torch.models import prb, render
from volprim_tpu_torch.ops import bsdf, streams
from volprim_tpu_torch.ops.envmap import EnvironmentMap
from volprim_tpu_torch.scene.cameras import film_coords, rays_from_pixels
from volprim_tpu_torch.utils import spans

M32 = 0xFFFFFFFF
KEY = 0x0123456789ABCDEF
IDX = [0, 1, 2, 65535, 2 ** 31 + 5]
# the top 24 bits of bounce 3's nine words for rays IDX under KEY
WORDS = [
    [2648719, 16104335, 16528042, 10414298, 11782579, 8778045, 1528508, 9480575, 14061105],
    [16348572, 898565, 3954471, 841279, 2253194, 12634359, 6836825, 13023217, 14802936],
    [10150281, 13444557, 10958003, 226679, 425848, 4610009, 11398162, 14550625, 8156869],
    [15052334, 11366779, 6481669, 4110102, 12503519, 2821709, 5251255, 15402893, 11438563],
    [7347237, 13003634, 612585, 14240618, 4882961, 14668236, 3845608, 6911948, 992486],
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcg(v: int) -> int:
    s = (v * 747796405 + 2891336453) & M32
    w = (((s >> ((s >> 28) + 4)) ^ s) * 277803737) & M32
    return (w >> 22) ^ w


def _word(key: int, i: int, b: int, s: int) -> int:
    """ops/streams in plain Python integers."""
    def row(j):
        return _pcg(_pcg(_pcg(b * streams.SLOT_STRIDE + j) ^ (key & M32)) ^ (key >> 32))
    return _pcg(_pcg(i ^ row(0)) ^ row(1 + s)) >> 8


@pytest.fixture(scope="module")
def small():
    """The cell's configuration at 256 primitives, 16 x 16, spp 2."""
    config, traffic, _ = load_cell("plume4096.pt")
    config = dict(config, n_prims=256, film={"width": 16, "height": 16}, spp=2)
    traffic = dict(traffic, warm_frames=0, compared_frames=1, check={"center": 16, "random": 0})
    return config, traffic


def _driver(small, seed=3):
    return path_trace.Driver(*small, seed, torch.device("cpu"))


def test_stream_words_are_a_fixed_function():
    table = streams.bounce_table(torch.tensor([KEY]), 8, prb.N_SLOTS)
    u = streams.uniforms(table, 3, torch.tensor(IDX))
    assert u.dtype == torch.float32 and u.shape == (5, 9)
    assert torch.equal((u * 2 ** 24).to(torch.int64), torch.tensor(WORDS))
    rng = np.random.default_rng(0)
    keys = [int(k) for k in rng.integers(0, 2 ** 62, 3, dtype=np.int64)]
    for key in keys:
        table = streams.bounce_table(torch.tensor([key]), 64, prb.N_SLOTS)
        idx = [int(i) for i in rng.integers(0, 2 ** 32, 40, dtype=np.int64)]
        for b in (0, 17, 63):
            got = (streams.uniforms(table, b, torch.tensor(idx)) * 2 ** 24).to(torch.int64)
            want = [[_word(key, i, b, s) for s in range(prb.N_SLOTS)] for i in idx]
            assert got.tolist() == want
    g = torch.Generator().manual_seed(1)
    k = streams.draw_key(g, "cpu")
    assert k.dtype == torch.int64 and k.shape == (1,) and 0 <= int(k) < streams.KEY_RANGE


def test_uniforms_are_uniform_and_uncorrelated():
    """2^18 rays at one bounce: each slot's mean and variance within 5
    standard errors of U[0, 1)'s, every pair of slots uncorrelated within 5
    standard errors, and no two rays of a slot with one word."""
    n = 1 << 18
    table = streams.bounce_table(torch.tensor([KEY]), 2, prb.N_SLOTS)
    u = streams.uniforms(table, 1, torch.arange(n)).double()
    se = 5.0 / np.sqrt(n)
    assert (u.mean(0) - 0.5).abs().max() < se * np.sqrt(1 / 12)
    assert (u.var(0) - 1 / 12).abs().max() < se * np.sqrt(1 / 180)
    corr = torch.corrcoef(u.T) - torch.eye(prb.N_SLOTS, dtype=torch.float64)
    assert corr.abs().max() < se
    words = streams.pcg(streams.pcg(torch.arange(n) ^ table[1, 0])[:, None] ^ table[1, 1:])
    assert all(torch.unique(words[:, s]).numel() == n for s in range(prb.N_SLOTS))


def _frame(d, chunk, seed=5):
    cfg = dataclasses.replace(d.cfg, ray_chunk=chunk)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return render(d.scene, d.camera, prb.radiance, cfg, d.emitter, spp=2, generator=g)


def test_frame_is_identical_under_any_ray_chunk(small):
    d = _driver(small)
    whole = _frame(d, 65536)
    assert torch.isfinite(whole).all() and whole.mean() > 0
    for chunk in (64, 100):
        assert torch.equal(_frame(d, chunk), whole), chunk


def test_rows_of_a_call_are_a_call_on_those_rows(small):
    """Rays [a, b) traced alone, given the key and a, equal rows [a, b) of
    the whole call, bit for bit: no ray's draws depend on which others are
    live. ``radiance`` draws its key as ``streams.draw_key`` does."""
    d = _driver(small)
    g = torch.Generator().manual_seed(11)
    px, py = film_coords(d.camera, g, device="cpu")
    o, dirs = rays_from_pixels(d.camera, px, py)
    state = g.get_state()
    key = streams.draw_key(g, "cpu")
    with torch.no_grad():
        whole = prb.radiance_keyed(d.scene, d.emitter, o, dirs, d.cfg, key)
        for a, b in ((0, 40), (77, 256), (130, 131)):
            part = prb.radiance_keyed(d.scene, d.emitter, o[a:b], dirs[a:b], d.cfg, key, first=a)
            assert torch.equal(part, whole[a:b]), (a, b)
        g.set_state(state)
        assert torch.equal(prb.radiance(d.scene, d.emitter, o, dirs, d.cfg, g), whole)


def test_program_frame_matches_the_reference(small):
    """Every pixel of a 16 x 16, 2-spp frame against the reference, which
    replays the frame's jitter and keys from the generator's state: no
    pixel parts (``flip_share`` 0) and the RMS gap within 1e-6, rounding
    (both are bit-identical on the CPU today). Two seeds."""
    for seed in (3, 2 ** 31 + 11):
        d = _driver(small, seed)
        state = d.gen.get_state()
        with torch.no_grad():
            img = d.frame()
        d._keep("f", state, img)
        numbers = dict(d.check())
        assert numbers["flip_share"] == 0.0 and numbers["frame_rms_gap"] <= 1e-6, numbers


def test_spans_and_counters_against_the_reference_counts(small):
    """Traced, the frame records every span of the path tracer once or
    more, and its counters equal what the reference counts on the same
    paths: live rays entering each bounce, rays handed to the walk, and
    rows x primitives of the optical depth (each live ray's escape test and
    each shadow ray). Untraced, nothing is recorded."""
    d = _driver(small, 7)
    state = d.gen.get_state()
    spans.reset()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        d.frame()
    rec = spans.snapshot()
    spans.reset()
    for name in ("prb.radiance", "prb.bounce", "prb.free_flight", "prb.optical_depth",
                 "prb.collect", "prb.walk", "prb.nee"):
        assert rec["spans"][name]["calls"] >= 1, name
    assert rec["spans"]["prb.radiance"]["calls"] == 2  # one a pass
    counts = {}
    with torch.no_grad():
        passes = d._replay(state)
        d._trace(d._ref_parts(), passes, [torch.arange(256)] * 2, counts)
    b = counts["bounces"]
    assert rec["counters"]["prb.ray_bounces"] == sum(x["live"] for x in b)
    assert rec["counters"]["prb.walked_rays"] == sum(x["walked"] for x in b)
    assert rec["counters"]["prb.depth_pairs"] == 256 * sum(x["live"] + x["shadow"] for x in b)
    assert rec["counters"]["prb.ray_bounces"] > 512  # the dense plume scatters
    with torch.no_grad():
        d.frame()
    assert spans.snapshot()["spans"] == {}


@pytest.mark.parametrize("model", ["diffuse", "principled"])
def test_bsdf_sample_on_stream_uniforms_matches_the_old_draws(model):
    """``bsdf.sample`` on the streams' slots 6-8 against the generator draws
    it took before (s1, then s2): the mean weight and direction of 2^17
    samples each within 5 standard errors of their difference."""
    n = 1 << 17
    wi = torch.nn.functional.normalize(torch.tensor([[0.4, -0.2, 0.8]]), dim=-1).expand(n, 3)
    if model == "diffuse":
        b, attrs = bsdf.Diffuse(), {"base_color": torch.full((n, 3), 0.7)}
    else:
        b = bsdf.Principled()
        attrs = {"base_color": torch.full((n, 3), 0.6), "roughness": torch.full((n,), 0.3),
                 "metallic": torch.full((n,), 0.5)}
    g = torch.Generator().manual_seed(4)
    s1 = torch.rand((n,), generator=g)
    old = b.sample(attrs, wi, s1, torch.rand((n, 2), generator=g))
    u = streams.uniforms(streams.bounce_table(torch.tensor([KEY]), 1, prb.N_SLOTS), 0,
                         torch.arange(n))
    new = b.sample(attrs, wi, u[:, prb._BSDF1], u[:, prb._BSDF2:prb._BSDF2 + 2])
    for x_old, x_new in ((old[0], new[0]), (old[2], new[2])):
        a, c = x_old.double(), x_new.double()
        se = torch.sqrt((a.var(0) + c.var(0)) / n)
        assert ((a.mean(0) - c.mean(0)).abs() <= 5 * se + 1e-12).all(), (a.mean(0), c.mean(0))
    assert abs(float((old[1] > 0).double().mean() - (new[1] > 0).double().mean())) < 0.01


def test_plume_inputs_are_the_ports_plume():
    """The benchmark's frozen plume, sky and camera equal the port's."""
    from volprim_tpu_torch.ops.envmap import procedural_sky
    from volprim_tpu_torch.scene import synthetic

    a = plume.plume(1024, 5, 10.0)
    b = synthetic.make_medium_arrays(1024, 5)
    for k in b:
        want = b[k] * np.float32(10.0) if k == "sigma_t" else b[k]
        np.testing.assert_array_equal(a[k], want, err_msg=k)
    sky = EnvironmentMap.from_array(plume.sky(), device="cpu")
    assert torch.equal(sky.data, procedural_sky(device="cpu").data)
    cam = synthetic.medium_camera(512, 512)
    ours = plume.camera(512, 512)
    np.testing.assert_array_equal(ours["to_world"], cam.to_world)
    assert ours["fov"] == cam.fov
