"""The port's spans and counters (volprim_tpu_torch.utils.spans) on the CPU:
nothing recorded and no ``record_function`` entered without a profiler;
under ``torch.profiler`` a tiny refine step's stages as nested
``user_annotation`` ranges of its Chrome trace, their call counts, the
compositor's segment counters and the tomography integrator's pair count;
results bit-identical with tracing on and off; and the benchmark's readers
of the record (``portbench/metrics``)."""

import importlib.util
import json
import os
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volprim_tpu_torch import train
from volprim_tpu_torch.examples import optimize_volume
from volprim_tpu_torch.models import rf_tiled, tomography
from volprim_tpu_torch.ops.envmap import ConstantEmitter
from volprim_tpu_torch.optim import BoundedAdam
from volprim_tpu_torch.scene import lattice_init, synthetic
from volprim_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the refine cell's renderer at test size: 16 tiles of 64 rays a camera
REFINE = rf_tiled.RFTiledConfig(
    max_depth=128, tile_pixels=64, max_candidates=256, segment=128, cluster_size=16,
    backend="fused", early_exit=True, coarse_group=4, coarse_factor=8, super_group=4,
)
CAMS = synthetic.orbit_cameras(32, 2)
STAGES = ("rf_tiled.layout", "rf_tiled.cull", "rf_tiled.pack", "rf_tiled.gather",
          "rf_tiled.composite")
FIT_RAYS, FIT_PRIMS, FIT_CHUNK = 2 * 8 * 8, 2 ** 3, 16  # 2 cameras at 8^2; 8 primitives


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def refine_step():
    """(loss, image, parameters after the step) of one refine step from a
    fixed start."""
    scene = synthetic.make_scene(2048, seed=5, device="cpu")
    params = {k: scene.attrs[k].clone().requires_grad_(True)
              for k in ("opacities", "sh_coeffs")}
    params["centers"] = scene.centers.clone().requires_grad_(True)
    target = torch.full((32, 64, 3), 0.5)
    loss, _, img = train.train_step(params, train.make_optimizer(), target, CAMS, REFINE,
                                    seed=3, base=scene)
    return loss, img, {k: v.detach() for k, v in params.items()}


def fit_step():
    """(loss, image, parameters after the step) of one tomography fit step."""
    prims = lattice_init(2, device="cpu")
    params = optimize_volume.volume_params(prims)
    opt = BoundedAdam()
    opt.set_learning_rate(1e-3)
    cams = optimize_volume.ring_cameras(2, 8)
    cfg = tomography.TomographyConfig(max_depth=-1, chunk_size=FIT_CHUNK)
    args = types.SimpleNamespace(opt_spp=1, grad_spp=0)
    loss, _, img = optimize_volume.train_step(
        params, opt, cams, cfg, ConstantEmitter(radiance=torch.ones(3)),
        torch.zeros((8, 16, 3)), args, 7, 3.0)
    return loss, img, {k: v.detach() for k, v in params.items()}


def traced(step, tmp_path):
    """``step()`` under torch.profiler: (its result, the record, the Chrome
    trace's events)."""
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step()
    record = spans.snapshot()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans.reset()
    return out, record, events


@pytest.fixture(scope="module")
def refine_runs(tmp_path_factory):
    return refine_step(), *traced(refine_step, tmp_path_factory.mktemp("refine"))


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    return fit_step(), *traced(fit_step, tmp_path_factory.mktemp("fit"))


def test_off_enters_no_range_and_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    spans.reset()

    @spans.spanned("test.fn")
    def fn():
        return 3

    with spans.span("test.span"):
        assert fn() == 3
    spans.count("test.ints", 5)
    spans.count("test.tensor", torch.ones(4, dtype=torch.int32))
    refine_step()
    fit_step()
    record = spans.snapshot()
    assert record["spans"] == {} and record["counters"] == {}


@pytest.mark.parametrize("run", ["refine", "fit"])
def test_results_bit_identical_with_tracing_on_and_off(run, request):
    (loss0, img0, p0), (loss1, img1, p1), _, _ = request.getfixturevalue(f"{run}_runs")
    assert torch.equal(torch.as_tensor(loss0), torch.as_tensor(loss1))
    assert torch.equal(img0, img1)
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)


def _ranges(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") == name]


def _inside(inner, outer):
    return any(o[2] == inner[2] and o[0] <= inner[0] and inner[1] <= o[1] for o in outer)


def test_refine_stages_nest_in_the_trace(refine_runs):
    _, _, _, events = refine_runs
    step = _ranges(events, "train.step")
    frames = _ranges(events, "rf_tiled.render_state")
    assert len(step) == 1 and len(frames) == len(CAMS)
    assert all(_inside(f, step) for f in frames)
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    for name in STAGES:
        rs = _ranges(events, name)
        assert rs, name
        assert all(_inside(r, frames) for r in rs), name
        # each range holds aten ops of its stage, on the same clock
        assert all(any(_inside(op, [r]) for op in ops) for r in rs), name
    for name, outer in (("rf_tiled.build_state", "train.step"), ("optim.step", "train.step"),
                        ("autograd.backward", "train.step"),
                        ("composite3.fwd", "rf_tiled.composite"),
                        ("composite3.bwd", "autograd.backward")):
        rs = _ranges(events, name)
        assert rs and all(_inside(r, _ranges(events, outer)) for r in rs), name


def test_refine_record_counts(refine_runs):
    _, _, record, _ = refine_runs
    n = len(CAMS)
    calls = {k: v["calls"] for k, v in record["spans"].items()}
    assert calls == {"train.step": 1, "rf_tiled.build_state": 1, "rf_tiled.render_state": n,
                     "rf_tiled.layout": n, "rf_tiled.cull": n, "rf_tiled.pack": n,
                     "rf_tiled.gather": n, "rf_tiled.composite": n, "composite3.fwd": n,
                     "autograd.backward": 1, "composite3.bwd": n, "optim.step": 1}
    assert all(v["host_s"] > 0 for v in record["spans"].values())
    c = record["counters"]
    assert 0 < c["composite3.segments_walked"] <= c["composite3.segments_live"]
    assert set(record["launches"]) >= {"composite3.fwd", "composite3.bwd", "ffwalk.walk"}


def test_fit_counts_every_pair_twice(fit_runs):
    """The forward and the checkpoint's recompute each evaluate every ray
    against every padded primitive."""
    _, _, record, events = fit_runs
    assert record["counters"] == {"tomography.pair_evals": 2 * FIT_RAYS * FIT_CHUNK}
    assert FIT_CHUNK > FIT_PRIMS
    for name in ("optimize_volume.step", "tomography.radiance", "tomography.chunk",
                 "autograd.backward", "optim.step"):
        assert _ranges(events, name), name
    # the checkpoint's recompute runs inside the backward
    backward = _ranges(events, "autograd.backward")
    assert any(_inside(r, backward) for r in _ranges(events, "tomography.chunk"))


# reader, what it reads (span or counter), the unit it takes, the run
READERS = [
    ("build_state_ms.step", ("spans", "rf_tiled.build_state"), "step", "refine"),
    ("layout_ms.step", ("spans", "rf_tiled.layout"), "step", "refine"),
    ("cull_ms.step", ("spans", "rf_tiled.cull"), "step", "refine"),
    ("backward_ms.step", ("spans", "autograd.backward"), "step", "refine"),
    ("optim_ms.step", ("spans", "optim.step"), "step", "refine"),
    ("fwd3_segments_walked.step", ("counters", "composite3.segments_walked"), "step", "refine"),
    ("layout_ms.frame", ("spans", "rf_tiled.layout"), "frame", "refine"),
    ("cull_ms.frame", ("spans", "rf_tiled.cull"), "frame", "refine"),
    ("fwd3_segments_walked.frame", ("counters", "composite3.segments_walked"), "frame",
     "refine"),
    ("tomo_pair_evals.fit", ("counters", "tomography.pair_evals"), "step", "fit"),
]


def reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name,source,unit,run", READERS, ids=[r[0] for r in READERS])
def test_reader_on_the_record(name, source, unit, run, request, monkeypatch):
    record = request.getfixturevalue(f"{run}_runs")[2]
    monkeypatch.setattr(spans, "snapshot", lambda: record)
    read = reader(name)
    kind, key = source
    want = (record["spans"][key]["host_s"] * 1e3 if kind == "spans"
            else record["counters"][key]) / 2
    assert read({"unit": unit, "units": 2}) == pytest.approx(want, rel=1e-12) and want > 0
    other = "frame" if unit == "step" else "step"
    assert read({"unit": other, "units": 2}) is None
    # nothing recorded in the window reads 0; a program without spans, None
    monkeypatch.setattr(spans, "snapshot",
                        lambda: {"spans": {}, "counters": {}, "launches": {}})
    assert read({"unit": unit, "units": 2}) == 0.0
    monkeypatch.setitem(sys.modules, "volprim_tpu_torch.utils.spans", None)
    monkeypatch.delattr(sys.modules["volprim_tpu_torch.utils"], "spans")
    assert read({"unit": unit, "units": 2}) is None


def test_span_attrib_puts_a_trace_down_to_spans():
    """scripts/span_attrib.py's reduction on a hand-made Chrome trace: a
    step (0-100 us) whose layout range (10-40) uploads and syncs and whose
    cull range (40-85) launches one kernel."""
    spec = importlib.util.spec_from_file_location(
        "span_attrib", os.path.join(ROOT, "scripts", "span_attrib.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    x = dict(ph="X", tid=1)
    ann = dict(x, cat="user_annotation")
    events = [
        dict(ann, name="portbench.window", ts=0.0, dur=100.0),
        dict(ann, name="train.step", ts=0.0, dur=100.0),
        dict(ann, name="rf_tiled.layout", ts=10.0, dur=30.0),
        dict(ann, name="rf_tiled.cull", ts=40.0, dur=45.0),
        dict(x, cat="cpu_op", name="aten::copy_", ts=12.0, dur=20.0),
        dict(x, cat="cuda_runtime", name="cudaMemcpyAsync", ts=15.0, dur=2.0,
             args={"correlation": 7}),
        dict(x, cat="cuda_runtime", name="cudaStreamSynchronize", ts=17.0, dur=5.0),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", ts=50.0, dur=1.0,
             args={"correlation": 8}),
        dict(ph="X", tid=9, cat="gpu_memcpy", name="Memcpy HtoD (Pageable -> Device)",
             ts=20.0, dur=4.0, args={"correlation": 7, "bytes": 64}),
        dict(ph="X", tid=9, cat="kernel", name="k", ts=60.0, dur=20.0,
             args={"correlation": 8}),
    ]
    out = mod.attribute(events, 2, "step")
    assert out["spans"]["rf_tiled.layout"] == {"calls": 0.5, "host_ms": 0.015}
    assert out["root_self_share"] == pytest.approx(0.25)
    assert out["pageable_htod"] == {"rf_tiled.layout": {"copies": 0.5, "call_ms": 0.001,
                                                        "bytes": 32.0}}
    assert out["sync_ms"] == {"rf_tiled.layout": {"calls": 0.5, "ms": 0.0025}}
    assert out["launches"] == {"rf_tiled.layout": 0.5, "rf_tiled.cull": 0.5}
    # idle 0-20 (mid 10: layout), 24-60 (mid 42: cull), 80-100 (mid 90: the step)
    idle = {k: round(v * 2e3) for k, v in out["idle_ms"].items()}
    assert idle == {"rf_tiled.layout": 20, "rf_tiled.cull": 36, "train.step": 20}
    assert out["top_ops_ms"]["rf_tiled.layout"] == {"aten::copy_": 0.01}
