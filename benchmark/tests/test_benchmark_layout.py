"""BENCHMARK.json against the contract's form, and the harness finding
every configuration, traffic mix and metric by name."""

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.conftest import small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.bench_file()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("workload", CELLS)
def test_harness_finds_each_piece_by_name(workload):
    cell, config, traffic = run.cell_inputs(BENCH, workload)
    assert config["name"] == cell["config"]
    assert traffic["name"] == cell["traffic"]
    importlib.import_module(f"benchmark.reference.{config['reference']}")
    run.kcycle_config(config)
    per_layer = run.metrics_for(BENCH, "per_layer", cell)
    assert per_layer
    for m in per_layer:
        assert callable(importlib.import_module(
            f"benchmark.metrics.{run.base_name(m['name'])}").read)
    assert sorted(run.base_name(m["name"]) for m in run.metrics_for(
        BENCH, "end_to_end", cell)) == ["ms_per_rhs", "setup_s"]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    bench, cell, config, traffic = small_cell("n13-2048-rhs8", 16)
    result = run.run_cell(bench, cell, config, traffic, 2**31 + 7, 0.2,
                          bool(trace), device="cpu")
    assert list(result)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        result)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] % 8 == 0 and result["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in run.metrics_for(bench, kind, cell)}
    if trace:   # no device trace on the CPU: the trace's readers find none
        names = {n for n in names if run.base_name(n) in (
            "hierarchy_build_s", "outer_iters_per_rhs",
            "kcycle_iters_per_outer")}
    assert set(result["metrics"]) == names and names
    for value in result["metrics"].values():
        assert value["value"] > 0 and UNIT.match(value["unit"])
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, num in result["check"].items():
        assert NAME.match(name) and set(num) == {"value", "limit"}
    json.dumps(result)


def test_same_seed_same_inputs():
    from benchmark.inputs import make_inputs
    _, _, config, traffic = small_cell("n19-2048-rhs8", 16, "gauss-rhs1")
    a = make_inputs(config, traffic, 2**33 + 1, "cpu")
    b = make_inputs(config, traffic, 2**33 + 1, "cpu")
    c = make_inputs(config, traffic, 2**33 + 2, "cpu")
    assert all(bool((a[k] == b[k]).all()) for k in ("gauge", "pool"))
    assert not bool((a["pool"] == c["pool"]).all())


def test_setup_seed_fixes_gauge_and_null_vector_seeds():
    from benchmark.inputs import make_inputs
    _, _, config, traffic = small_cell("n13-2048-rhs8", 16, "gauss-rhs1")
    assert config["setup_seed"] is not None
    a = make_inputs(config, traffic, 2**33 + 1, "cpu")
    c = make_inputs(config, traffic, 2**33 + 2, "cpu")
    assert bool((a["gauge"] == c["gauge"]).all())
    assert all(bool((x == y).all()) for x, y in zip(a["seeds"], c["seeds"]))
    assert not bool((a["pool"] == c["pool"]).all())


def test_loads_no_jax_package():
    code = ("import sys, benchmark.run, benchmark.control, benchmark.ranks; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=run.ROOT).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "qmg_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.wilson, benchmark.control; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('qmg_tpu_torch', 'qmg_tpu', 'jax')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=run.ROOT).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_fails_without_the_program(tmp_path):
    import shutil
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""
