"""The path-traced cell at its rehearsal sizes on the CPU (512 primitives,
16 x 16, spp 1, one compared frame): its run, its faults and its control
against the limits, the metrics it reports, and its work counts."""

import json

import numpy as np
import pytest
import torch

from portbench import run
from portbench.drivers import path_trace
from portbench.reference import pt as ref_pt
from portbench.tests.test_portbench_runs import rehearse
from portbench.work import pt as work_pt

CELL = "plume4096.pt"


def test_rehearsal_sizes():
    config, traffic, _ = run.load_cell(CELL, rehearsal=True)
    assert (config["n_prims"], config["film"], config["spp"]) == (
        512, {"width": 16, "height": 16}, 1)
    assert traffic["compared_frames"] == 1


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_run_is_correct_with_its_two_numbers(trace):
    res = rehearse(CELL, trace, seed=2 ** 31 + 101)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["checks"]) == {"frame_rms_gap", "flip_share"}
    assert res["checks"]["flip_share"]["value"] == 0.0


@pytest.mark.parametrize("mode", ["altered_pt_frame", "denser_medium", "control"])
def test_faults_and_control_read_above_the_limits(mode):
    config, traffic, limits = run.load_cell(CELL, rehearsal=True)
    over = []
    for seed in (3, 4):
        cell = run.driver(traffic["entry"])(config, traffic, seed, torch.device("cpu"))
        if mode == "control":
            numbers = cell.control()
        else:
            with run.fault(mode)():
                cell.setup()
                cell.window(0.1)
                numbers = cell.check()
        over.append(any(v > limits[k] for k, v in numbers))
    assert all(over), mode


def test_cell_reports_setup_frame_ms_and_its_ten_readers():
    bench = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
    e2e = {m["name"] for m in run.cell_metrics(bench, CELL, "end_to_end")}
    per_layer = {m["name"] for m in run.cell_metrics(bench, CELL, "per_layer")}
    assert e2e == {"setup_s", "frame_ms"}
    assert per_layer == {"device_idle_pct.pt", "launches_per_frame.pt", "free_flight_ms.pt",
                         "optical_depth_ms.pt", "nee_ms.pt", "ray_bounces.pt", "depth_pairs.pt",
                         "ffwalk_roofline_pct.pt", "mfu.pt", "peak_mem_gib.pt"}


def test_readers_on_a_card_like_record():
    """The ten readers on a record shaped as a traced card run makes it:
    shares of the walk's and the frame's least times, idle, launches, peak;
    a record of another unit reads nothing."""
    rec = {"unit": "frame", "units": 1, "busy_s": 2.0, "window_s": 5.0, "launches": 1000,
           "peak_bytes": 2 ** 31, "by_name": {"void ffwalk_kernel<1>(float const*)": 0.01},
           "work": {"pt_frame": {"seconds": 0.1}, "ffwalk": {"seconds": 0.0005}}}
    read = {name: run.metric_reader(name)(rec) for name in (
        "device_idle_pct.pt", "launches_per_frame.pt", "ffwalk_roofline_pct.pt", "mfu.pt",
        "peak_mem_gib.pt")}
    assert read == {"device_idle_pct.pt": 60.0, "launches_per_frame.pt": 1000.0,
                    "ffwalk_roofline_pct.pt": pytest.approx(5.0), "mfu.pt": pytest.approx(5.0),
                    "peak_mem_gib.pt": 2.0}
    rec["unit"] = "step"
    assert all(run.metric_reader(n)(rec) is None for n in read)


def test_walk_work_against_a_hand_count():
    """One ray, one window of two selected intervals scanned to the third,
    found: 3 scans, 2 + 28 erf terms a selected interval."""
    work = {"scanned": 3, "selected": 2, "selected_found": 2, "scanned_max": 3,
            "selected_union": 2}
    b = work_pt.walk_bound(work, 1, 4, 1.0)
    assert b["ops"] == 3 * 3 + (2 * 2 + 28 * 2) * 28
    assert b["bytes"] == 3 * 8 + 2 * 12 + 17 + 8
    assert work_pt.OPS_PT_PAIR == 90 + 49 and work_pt.OPS_PT_TEST == 79
    counts = {"bounces": [dict(live=10, shadow=4, walked=1, live_hits=30, shadow_hits=8,
                               walked_hits=5, **work)]}
    f = work_pt.frame_work(counts, 2.0, 100, {"solver_max_iterations": 4})
    assert f["pt_frame"]["pairs"] == 2.0 * (10 + 4 + 1) * 100
    assert f["pt_frame"]["hits"] == 2.0 * (30 + 8 + 5)
    assert f["pt_frame"]["ops"] == (2.0 * 1500 * 79 + 2.0 * 43 * 60
                                    + 2.0 * (3 * 3 + (2 * 2 + 28 * 2) * 28))
    assert f["pt_frame"]["ray_bounces"] == 20.0


def test_flip_and_rms_of_compare():
    """The RMS gap takes every compared pixel, the one that parted too; a
    pixel flips past FLIP, and a NaN flips and fails the RMS gap."""
    want = torch.ones((4, 3))
    prog = want.clone()
    prog[0] *= 1.0 + 1e-6
    prog[1] = 0.0
    rms, flip, worst = path_trace.compare(prog, want)
    assert flip == 0.25 and worst == 1.0
    d = float(torch.tensor(1.0 + 1e-6)) - 1.0  # one pixel off by d, one zeroed
    assert rms == pytest.approx(((d * d + 1.0) / 4) ** 0.5, rel=1e-9)
    prog[1] = 1.0 + 0.5 * path_trace.FLIP  # within the flip line: in the RMS alone
    rms, flip, _ = path_trace.compare(prog, want)
    assert flip == 0.0 and rms > 0.2 * path_trace.FLIP
    prog[2, 0] = float("nan")
    rms, flip, _ = path_trace.compare(prog, want)
    assert flip == 0.25 and not rms <= 1.0


def test_reference_refuses_another_integrator():
    with pytest.raises(ValueError, match="jump"):
        ref_pt.supported(dict(ref_pt.SUPPORTED, jump=False))
    ref_pt.supported(dict(ref_pt.SUPPORTED))
    assert np.isclose(ref_pt.KILL, 0.005)


def test_reference_traces_with_tf32_off():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        seen = ref_pt._full_f32(
            lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))()
        assert seen == (False, False)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert ref_pt.trace.__wrapped__ is not None
