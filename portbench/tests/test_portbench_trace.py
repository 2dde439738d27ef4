"""The trace reduction on a hand-made Chrome trace, and the per-layer
readers on its record."""

import json
import os

from portbench import run, trace


def events():
    x = dict(ph="X")
    return [
        dict(x, name=trace.WINDOW, cat="user_annotation", ts=1000.0, dur=100.0),
        dict(x, name=trace.WINDOW, cat="gpu_user_annotation", ts=990.0, dur=130.0),
        dict(x, name="aten::mul", cat="cpu_op", ts=1000.0, dur=50.0),
        dict(x, name="aten::index", cat="cpu_op", ts=1005.0, dur=10.0),
        dict(x, name="fwd3_kernel<4>", cat="kernel", ts=1002.0, dur=20.0),
        dict(x, name="mul_kernel", cat="kernel", ts=1015.0, dur=10.0),  # overlaps
        dict(x, name="Memcpy HtoD", cat="gpu_memcpy", ts=1060.0, dur=20.0),
        dict(x, name="bwd3_kernel<4>", cat="kernel", ts=1095.0, dur=20.0),  # past the end
        dict(x, name="before", cat="kernel", ts=900.0, dur=20.0),  # outside
    ]


def test_reduce_unions_device_time_and_names_gaps():
    rec = trace.reduce(events())
    assert abs(rec["window_s"] - 100e-6) < 1e-12
    # [1002, 1025] + [1060, 1080] + [1095, 1100 (cut at the window's end)]
    assert abs(rec["busy_s"] - (23 + 20 + 5) * 1e-6) < 1e-12
    assert rec["launches"] == 4
    gaps = dict((round(s * 1e6), n) for n, s in rec["gaps"])
    assert gaps[35] == "aten::mul"  # 1025-1060, mid 1042.5 inside aten::mul only
    assert gaps[15] == "host, between ops"  # 1080-1095
    assert gaps[2] == "aten::mul"  # 1000-1002
    b = trace.breakdown(rec)
    assert b["device_ops"][0][0] == "fwd3_kernel<4>" and len(b["idle_gaps"]) == 3


def test_readers_on_the_record():
    rec = dict(trace.reduce(events()), unit="step", units=2, peak_bytes=2 ** 31,
               work={"fwd3": {"seconds": 10e-6}, "bwd3": {"seconds": 5e-6},
                     "tomo_step": {"seconds": 4.8e-6}})
    assert run.metric_reader("launches_per_step")(rec) == 2.0
    assert run.metric_reader("launches_per_step.fit")(rec) == 2.0
    assert run.metric_reader("device_idle_pct.frame")(rec) is None
    assert run.metric_reader("peak_mem_gib.fit")(rec) == 2.0
    assert run.metric_reader("launches_per_frame")(rec) is None
    assert abs(run.metric_reader("device_idle_pct.step")(rec) - 52.0) < 1e-9
    assert abs(run.metric_reader("fwd3_roofline_pct.step")(rec) - 50.0) < 1e-9
    assert abs(run.metric_reader("bwd3_roofline_pct")(rec) - 25.0) < 1e-9
    assert abs(run.metric_reader("mfu.step")(rec) - 31.25) < 1e-9
    assert abs(run.metric_reader("tomo_roofline_pct")(rec) - 10.0) < 1e-9
    assert run.metric_reader("peak_mem_gib.step")(rec) == 2.0
    rec["work"] = {}
    assert run.metric_reader("fwd3_roofline_pct.step")(rec) is None


def test_every_cell_reads_each_of_its_per_layer_metrics():
    """A traced record of each cell's kind gives a number for every
    per-layer metric that BENCHMARK.json lists for the cell."""
    bench = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    work = {"fwd3": {"seconds": 1e-6}, "bwd3": {"seconds": 1e-6}, "tomo_step": {"seconds": 1e-6}}
    for w in bench["workloads"]:
        unit = "frame" if w["traffic"] == "view" else "step"
        rec = dict(trace.reduce(events()), unit=unit, units=2, peak_bytes=1, work=work)
        for m in run.cell_metrics(bench, w["name"], "per_layer"):
            assert run.metric_reader(m["name"])(rec) is not None, (w["name"], m["name"])
