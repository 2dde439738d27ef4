"""Each cell run end to end at the rehearsal sizes on the CPU, the faults
that each cell's comparison must catch, the control at the cells' sizes
on the card, and the frozen work counts against a hand count."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import scene as ref_scene
from portbench.reference import tiled as ref_tiled
from portbench.work import tiled as work_tiled
from portbench.work import tomo as work_tomo

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def rehearse(cell, trace=0, seed=2147483659, seconds=0.5):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace), "--cpu_rehearsal"])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


CELLS = [w["name"] for w in json.load(open(f"{run.ROOT}/BENCHMARK.json"))["workloads"]]
FAULTS = [(cell, f) for cell in CELLS for f in run.load_cell(cell)[1]["faults"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_contract_line(cell, trace):
    res = rehearse(cell, trace)
    assert set(res) >= KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["metrics"] == {}  # no device metric from a CPU run
    assert res["device"]["platform"] == "cpu"
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_makes_correct_false(cell, fault):
    with run.fault(fault)():
        res = rehearse(cell, seed=12345)
    assert res["correct"] is False, res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    """The reference with its pair math in bfloat16 put in the program's
    place, at the cell's own size on the card: at least one number beyond
    its limit."""
    config, traffic, limits = run.load_cell(cell)
    numbers = run.driver(traffic["entry"])(config, traffic, 20240611, card).control()
    assert any(v > limits[k] for k, v in numbers), numbers


def test_tiled_work_counts_match_a_hand_count():
    """Two rays from the origin, one along +z, one along +x; four columns:
    two splats on the +z axis, one far off inside the tile's cone, one
    neutral (outside every cone). Three columns meet the cone: 6 pairs;
    the +z ray hits the two splats, the other nothing: 2 hits."""
    f32 = torch.float32
    prims = ref_scene.Scene(
        centers=torch.tensor([[0, 0, 2], [0, 0, 3], [5, 5, 5]], dtype=f32),
        scales=torch.full((3, 3), 0.1), quats=torch.tensor([[0, 0, 0, 1.0]] * 3),
        attrs={"opacities": torch.full((3, 1), 0.5)})
    pf = torch.cat([ref_tiled.pack_features(prims, torch.zeros(3)),
                    ref_tiled.neutral_row("cpu")[:, None]], dim=1)[None]
    d = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    d8 = ref_tiled.direction_rows(d[None, :, 0], d[None, :, 1], d[None, :, 2])
    sh3 = torch.zeros((1, 3, 4), dtype=torch.bfloat16)
    kw = dict(seg=4, sh_k=1, max_depth=128, compact=False, early_exit=False, extent2=9.0,
              beta_kill=0.01)
    call = dict(t=1, r=2, s=4, sh_k=1, fwd_live=0, fwd_stream=0, fwd_hits=0, bwd_live=0,
                bwd_stream=0, bwd_hits=0)
    ref_tiled.forward_plain(d8, pf, sh3, torch.tensor([1], dtype=torch.int32), kw, call)
    assert (call["fwd_stream"], call["fwd_hits"], call["bwd_hits"]) == (3, 2, 2)
    b = work_tiled.launch_bounds(call)
    # rays 8 f32 + one int32, 4 columns of 16 f32 and 3 bf16, L and beta out
    assert b["fwd"]["bytes"] == 2 * 8 * 4 + 4 + 4 * (64 + 6) + 2 * 16
    assert b["fwd"]["ops"] == 6 * 40 + 2 * (17 + 6)
    assert b["bwd"]["ops"] == 6 * 40 + 2 * (103 + 12)
    assert b["bwd"]["bytes"] == b["fwd"]["bytes"] + 4 * (64 + 6)
    assert b["fwd"]["bound_by"] == "bytes" or b["fwd"]["seconds"] == b["fwd"]["ops"] / 67e12


def test_early_exit_counts_only_the_walked_segments():
    """A tile whose rays are all killed in the first segment walks one of
    its two segments forward; the backward walks both."""
    f32 = torch.float32
    n = 8
    prims = ref_scene.Scene(
        centers=torch.tensor([[0, 0, 2.0 + 0.01 * i] for i in range(n)], dtype=f32),
        scales=torch.full((n, 3), 0.2), quats=torch.tensor([[0, 0, 0, 1.0]] * n),
        attrs={"opacities": torch.full((n, 1), 0.99)})
    pf = ref_tiled.pack_features(prims, torch.zeros(3))[None]
    d = torch.tensor([[0.0, 0.0, 1.0]])
    d8 = ref_tiled.direction_rows(d[None, :, 0], d[None, :, 1], d[None, :, 2])
    sh3 = torch.zeros((1, 3, n), dtype=torch.bfloat16)
    kw = dict(seg=4, sh_k=1, max_depth=128, compact=False, early_exit=True, extent2=9.0,
              beta_kill=0.01)
    call = dict(fwd_live=0, fwd_stream=0, fwd_hits=0, bwd_live=0, bwd_stream=0, bwd_hits=0)
    ref_tiled.forward_plain(d8, pf, sh3, torch.tensor([2], dtype=torch.int32), kw, call)
    assert (call["fwd_stream"], call["fwd_hits"]) == (4, 4)
    assert (call["bwd_stream"], call["bwd_hits"], call["bwd_live"]) == (8, 8, 8)
    assert call["fwd_live"] == 4


def test_tomo_work_is_rays_times_primitives():
    b = work_tomo.step_bound(rays=8 * 256 * 256, prims=16 ** 3)
    assert b["pairs"] == 2_147_483_648
    assert b["ops"] == b["pairs"] * (90 + 198) and b["bound_by"] == "operations"
    assert np.isclose(b["seconds"], b["ops"] / 67e12)
