"""The four-card cell ``n13-4096-mesh4`` and its readers: each reader on
synthetic ``facts`` (a number where it finds its spans or kernels, None
where it finds nothing), and the cell itself shrunk to 32^2 on four gloo
ranks, as ``run.main`` launches its NCCL ranks on the cards."""

import json
import time

import pytest

from benchmark import ranks
from benchmark.metrics import (collectives_per_rhs, mesh_ms_per_rhs,
                               slab_apply_roofline)
from benchmark.metrics.fine_apply_roofline import wilson_apply_bytes
from benchmark.tests.conftest import small_cell

CELL = "n13-4096-mesh4"
HBM = 3.35e12
# One profiled batch of 4 fields: spans (name, start s, end s), device
# operations (name, start, end, correlation) and their launches.
SPANS = [("qmg.solve", 0.0, 10.0), ("qmg.mesh.halo", 1.0, 2.0),
         ("qmg.mesh.sum", 3.0, 4.0), ("qmg.mesh.halo", 5.0, 6.0),
         ("qmg.apply.L0.original", 7.0, 8.0)]
DEVICE = [("ncclDevKernel_SendRecv", 1.1, 1.5, 1),
          ("ncclDevKernel_AllReduce", 3.1, 3.2, 2),
          ("copy", 5.1, 5.2, 3), ("apply", 7.1, 7.9, 4)]
LAUNCHES = {1: 1.05, 2: 3.05, 3: 5.05, 4: 7.05}


def facts(**over):
    """Facts of one profiled batch of 4 on one card of a (4, 1) mesh of a
    4096^2 lattice; ``over`` replaces keys."""
    base = {
        "nrhs": 4, "mesh": (4, 1), "chips": 4, "sites": 4096 * 4096 // 4,
        "config": {"lattice": {"x": 4096, "y": 4096, "nc": 2}},
        "peaks": {"hbm_bytes_per_s": HBM},
        "profile": {"kernel_s": {
            "(anonymous namespace)::wilson_r1_halo_kernel(float2 const*)":
                0.5, "(anonymous namespace)::wilson_r1_kernel<false>": 9.0}},
        "solves": [{"profiled": False, "level0_applies": [99] * 4},
                   {"profiled": True, "level0_applies": [40, 40, 36, 40]}],
        "spans": {"spans": SPANS, "device": DEVICE, "launches": LAUNCHES},
    }
    base.update(over)
    return base


def test_slab_apply_roofline():
    """Bytes: the links once a launch, x and out of each field's apply,
    and each field's two halo rows (2 x 2 parities x 2048 sites x 16 B);
    time: K7's kernels alone."""
    sites = 4096 * 4096 // 4
    nbytes = (40 * wilson_apply_bytes(sites, 0)
              + 156 * (wilson_apply_bytes(sites, 1)
                       - wilson_apply_bytes(sites, 0) + 4 * 2048 * 16))
    assert slab_apply_roofline.read(facts()) == pytest.approx(
        100 * nbytes / HBM / 0.5)
    assert slab_apply_roofline.halo_bytes(2048) == 131072


@pytest.mark.parametrize("reader,expect", [
    (mesh_ms_per_rhs, 1e3 * (0.4 + 0.1 + 0.1) / 4),
    (collectives_per_rhs, 3 / 4)], ids=["mesh_ms", "collectives"])
def test_mesh_readers(reader, expect):
    """Device time and count of the ``qmg.mesh.*`` spans of the profiled
    batch, a field; the apply outside them is not counted."""
    assert reader.read(facts()) == pytest.approx(expect)
    assert collectives_per_rhs.by_kind(facts()["spans"]) == {"halo": 2,
                                                             "sum": 1}


NOTHING = {
    "no_trace": dict(profile=None, spans=None),
    "no_mesh_spans": dict(spans={"spans": SPANS[:1] + SPANS[4:],
                                 "device": DEVICE, "launches": LAUNCHES}),
    "no_slab_kernel": dict(profile={"kernel_s": {"wilson_r1_kernel": 1.0}}),
    "no_mesh": dict(mesh=None),
    "no_device": dict(spans={"spans": SPANS, "device": [], "launches": {}},
                      profile={"kernel_s": {}}),
}


@pytest.mark.parametrize("case", list(NOTHING))
@pytest.mark.parametrize("reader", [slab_apply_roofline, mesh_ms_per_rhs,
                                    collectives_per_rhs],
                         ids=["roofline", "mesh_ms", "collectives"])
def test_readers_find_nothing(reader, case):
    """None where the reader finds nothing to read: a parent program
    without the mesh's spans, an untraced run, no slab kernel."""
    found = reader.read(facts(**NOTHING[case]))
    unrelated = {
        slab_apply_roofline: ("no_mesh_spans",),
        mesh_ms_per_rhs: ("no_slab_kernel", "no_mesh"),
        collectives_per_rhs: ("no_slab_kernel", "no_mesh", "no_device")}
    if case in unrelated[reader]:
        assert found is not None and found > 0
    else:
        assert found is None


def test_cell_on_four_gloo_ranks(monkeypatch):
    """The cell at 32^2 (one refinement) on four gloo ranks, traced: the
    batched solve on the (4, 1) mesh with the slab kernel's rhs entry,
    correct, and rank 0's spans give the collectives a field."""
    monkeypatch.setattr(ranks, "SETUP_ALLOWANCE_S", 90.0)
    bench, cell, config, traffic = small_cell(CELL, 32)
    assert config["mesh"] == {"ny": 4, "nx": 1} and cell["chips"] == 4
    assert config["solve"]["fine_kernel"] == "wilson-r1"
    job = {"bench": bench, "cell": cell, "config": config,
           "traffic": traffic, "seed": 2**31 + 41, "seconds": 0.05,
           "trace": True, "device": "cpu", "t_start": time.perf_counter()}
    out, err = ranks.launch(job)
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] % 4 == 0 and result["device"]["count"] == 4
    metrics = result["metrics"]
    # No device on the CPU: the roofline and the device time find nothing.
    assert set(metrics) == {
        "hierarchy_build_s", "outer_iters_per_rhs.host_paced",
        "kcycle_iters_per_outer.host_paced", "collectives_per_rhs"}
    assert metrics["collectives_per_rhs"]["value"] > 0
    (notes,) = [json.loads(line[len("notes "):])
                for line in err.splitlines() if line.startswith("notes ")]
    assert notes["sent_bytes_per_rhs"]["halo"] > 0
