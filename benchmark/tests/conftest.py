"""Shared fixtures of the benchmark's tests: the cells shrunk to sizes the
CPU runs in seconds, and the card for the tests that need one."""

import copy
import os

import pytest
import torch

from benchmark import run


def small_cell(workload: str, size: int = 32, traffic: str | None = None):
    """(bench, cell, config, traffic) of ``workload`` at ``size``^2 with one
    refinement and a pool of two batches; ``traffic`` names another mix
    of ``benchmark/traffic/`` to drive the cell's configuration with."""
    bench = run.bench_file()
    cell, config, mix = run.cell_inputs(bench, workload)
    if traffic is not None:
        mix = run.load_json(os.path.join(run.BENCH_DIR, "traffic",
                                         traffic + ".json"))
    traffic = mix
    config = copy.deepcopy(config)
    config["lattice"].update(x=size, y=size)
    config["kcycle"]["n_refine"] = 1
    traffic = dict(traffic, pool=2 * traffic["nrhs"])
    return bench, cell, config, traffic


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); this machine has none")
    return "cuda"
