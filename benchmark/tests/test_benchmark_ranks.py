"""A cell on several chips, run on the CPU: one gloo rank a block of the
configuration's ``mesh``, launched by ``ranks.launch`` as ``run.main``
launches NCCL ranks on the cards. Each case runs a 32^2 n13 configuration
with one refinement, and each launch has its own timeout: the parent's
deadline, ``CASE_TIMEOUT_S`` past the window, after which it kills every
rank."""

import json
import os
import sys
import time

import pytest

from benchmark import ranks, run
from benchmark.tests.conftest import small_cell

SEED = 2**31 + 17
SECONDS = 0.05
CASE_TIMEOUT_S = 60.0
# What a launch ends within when a rank fails in set-up.
FAIL_FAST_S = 30.0


@pytest.fixture(autouse=True)
def case_timeout(monkeypatch):
    monkeypatch.setattr(ranks, "SETUP_ALLOWANCE_S", CASE_TIMEOUT_S)


def mesh_cell(shape, mix=None):
    """(bench, cell, config, traffic) of n13 at 32^2 on a ``shape`` mesh,
    one chip a block. A batched solve on a mesh, and a mesh cut along x,
    take the plain sharded apply, as the program asks."""
    bench, cell, config, traffic = small_cell("n13-2048-rhs8", 32, mix)
    config["mesh"] = {"ny": shape[0], "nx": shape[1]}
    if traffic["nrhs"] > 1 or shape[1] > 1:
        config["solve"]["fine_kernel"] = None
    cell = dict(cell, chips=shape[0] * shape[1])
    return bench, cell, config, traffic


def launch(bench, cell, config, traffic, trace=False, command=None):
    """The result line of a run on ``cell["chips"]`` gloo ranks and its
    notes (from standard error)."""
    job = {"bench": bench, "cell": cell, "config": config,
           "traffic": traffic, "seed": SEED, "seconds": SECONDS,
           "trace": trace, "device": "cpu", "t_start": time.perf_counter()}
    out, err = ranks.launch(job, **({} if command is None
                                    else {"command": command}))
    (notes,) = [json.loads(line[len("notes "):])
                for line in err.splitlines() if line.startswith("notes ")]
    assert err.rstrip().splitlines()[-1].startswith("check ")
    return json.loads(out.strip().splitlines()[-1]), notes


def faulty(fault):
    return (sys.executable, "-m", "benchmark.tests.rank_faults", fault)


@pytest.fixture(scope="module")
def one_card():
    """Outer counts of each solve of the unsharded runs, by traffic mix."""
    counts = {}
    for mix in ("gauss-rhs1", "gauss-rhs8"):
        bench, cell, config, traffic = mesh_cell((2, 1), mix)
        del config["mesh"]
        cell = dict(cell, chips=1)
        result = run.run_cell(bench, cell, config, traffic, SEED, SECONDS,
                              False, device="cpu")
        assert result["correct"] is True
        counts[mix] = result["notes"]["solve_outer"]
    return counts


@pytest.mark.parametrize("shape,mix,trace", [
    ((2, 1), "gauss-rhs1", True), ((2, 1), "gauss-rhs8", False),
    ((2, 2), "gauss-rhs1", False), ((2, 2), "gauss-rhs8", False)],
    ids=["2x1-rhs1-traced", "2x1-rhs8", "2x2-rhs1", "2x2-rhs8"])
def test_mesh_run_is_correct(shape, mix, trace, one_card):
    """Correct on every rank's blocks, with the outer counts of the
    unsharded solve of the same batches, within one."""
    result, notes = launch(*mesh_cell(shape, mix), trace=trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["count"] == shape[0] * shape[1]
    assert len(notes["rank_memory_peak_bytes"]) == shape[0] * shape[1]
    assert notes["sent_bytes_per_rhs"]["sum"] > 0
    assert notes["sent_bytes_per_rhs"]["halo"] > 0
    expect = one_card[mix]
    n = min(len(expect), len(notes["solve_outer"]))
    assert n and all(abs(a - b) <= 1 for a, b in zip(
        notes["solve_outer"][:n], expect[:n])), (notes, expect)
    if trace:
        # The per-layer metrics that a CPU trace holds, from rank 0.
        assert set(result["metrics"]) == {
            "hierarchy_build_s", "outer_iters_per_rhs.host_paced",
            "kcycle_iters_per_outer.host_paced"}
        assert result["metrics"]["outer_iters_per_rhs.host_paced"][
            "value"] > 0
        assert result["device"]["busy_s"] == 0.0   # no device on the CPU
        assert result["device"]["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["answer_altered", "exchange_dropped"])
def test_fault_on_one_rank_is_not_correct(fault):
    """An answer altered on rank 1's block, or the halos rank 1 receives
    left out: the run comes out not correct."""
    result, _ = launch(*mesh_cell((2, 1), "gauss-rhs1"),
                       command=faulty(fault))
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.parametrize("fault,within", [
    ("setup_raises", FAIL_FAST_S), ("setup_hangs", CASE_TIMEOUT_S + 15)])
def test_failing_rank_ends_the_run(fault, within, monkeypatch):
    """A rank that raises ends the run at once, one that hangs at the
    deadline: every rank is killed, the failing one named with its error,
    and no process is left."""
    if fault == "setup_hangs":
        monkeypatch.setattr(ranks, "SETUP_ALLOWANCE_S", 10.0)
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailed) as failure:
        launch(*mesh_cell((2, 1), "gauss-rhs1"), command=faulty(fault))
    assert time.monotonic() - t0 < within
    message = str(failure.value)
    if fault == "setup_raises":
        assert "rank 1 of 2 failed first" in message
        assert "planted: set-up fails" in message
    else:
        assert "still running" in message and "1]" in message
    for pid in failure.value.pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("shape,chips", [((2, 1), 4), ((2, 2), 2),
                                         (None, 2)])
def test_mesh_and_chips_that_do_not_pair_are_refused(shape, chips):
    bench, cell, config, traffic = small_cell("n13-2048-rhs8", 32)
    if shape is not None:
        config["mesh"] = {"ny": shape[0], "nx": shape[1]}
    cell = dict(cell, chips=chips)
    with pytest.raises(SystemExit, match=repr(cell["name"])):
        run.mesh_shape(cell, config)


@pytest.mark.parametrize("shape", [None, (2, 1)], ids=["no-mesh", "2x1"])
def test_one_card_cell_starts_no_process_group(shape, monkeypatch):
    """A cell on one chip, with no mesh or with a mesh held in process,
    runs in this process alone."""
    import torch.distributed as dist

    def refuse(*args, **kw):
        raise AssertionError("a one-card cell started a process group")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(ranks.subprocess, "Popen", refuse)
    bench, cell, config, traffic = small_cell("n13-2048-rhs8", 32,
                                              "gauss-rhs1")
    if shape is not None:
        config["mesh"] = {"ny": shape[0], "nx": shape[1]}
    result = run.run_cell(bench, cell, config, traffic, SEED, SECONDS,
                          False, device="cpu")
    assert result["correct"] is True and result["device"]["count"] == 1
    assert not dist.is_initialized()
    assert ("mesh" in result["notes"]) == (shape is not None)
