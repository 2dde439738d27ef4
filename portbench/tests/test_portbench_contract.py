"""BENCHMARK.json against the contract's characters and shapes, the cells
resolving to their files, and the rules on what may be imported."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(kind):
    b = bench()
    names = [e["name"] for e in b[kind]]
    assert len(names) == len(set(names))
    for e in b[kind]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if kind == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
            assert os.path.exists(os.path.join(ROOT, e["file"]))
        if kind == "workloads":
            assert e["chips"] == 1 and NAME.match(e["config"]) and NAME.match(e["traffic"])


def test_bounds_and_per_layer_links():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        mv = e2e[m["moves"]]
        assert "workloads" not in mv or set(m["workloads"]) <= set(mv["workloads"])
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(layers) >= 3


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves_to_its_files(cell):
    """Each piece of a cell is a file found by name: its driver, its
    faults, its metric readers and its limits."""
    config, traffic, limits = run.load_cell(cell)
    driver = run.driver(traffic["entry"])
    for method in ("setup", "window", "traced", "count_work", "check", "control"):
        assert callable(getattr(driver, method)), method
    assert traffic["faults"] and all(callable(run.fault(f)) for f in traffic["faults"])
    assert limits and all(v > 0 for v in limits.values())
    b = bench()
    per_layer = run.cell_metrics(b, cell, "per_layer")
    e2e = run.cell_metrics(b, cell, "end_to_end")
    assert per_layer and {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
    for m in per_layer:
        assert callable(run.metric_reader(m["name"]))


def test_a_missing_piece_is_named():
    with pytest.raises(FileNotFoundError, match="no driver 'no_such_entry'"):
        run.driver("no_such_entry")


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "volprim_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "volprim_tpu.probe", object())
    assert run.forbidden_modules() == ["volprim_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(ROOT, "portbench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & {"volprim_tpu_torch", "volprim_tpu", "jax", "jaxlib", "flax"}, name
    code = ("import sys, portbench.reference.tiled, portbench.reference.tomo;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'volprim_tpu_torch', 'volprim_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_harness_imports_no_jax_anywhere():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for name in files:
            if name.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(dirpath, name))}
                assert not tops & {"volprim_tpu", "jax", "jaxlib", "flax"}, name


def test_run_refuses_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "tomo16.fit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
