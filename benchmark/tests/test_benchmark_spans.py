"""The reduction of a profiled solve by the program's spans
(``benchmark/spans.py``) on synthetic events, and ``span_table`` on a
small cell on the CPU."""

import pytest
import torch
from torch.profiler import profile, ProfilerActivity

from benchmark import run, span_table, spans
from benchmark.tests.conftest import small_cell
from qmg_tpu_torch.spans import span

SPANS = [("qmg.solve", 0.0, 10.0),
         ("qmg.apply.L0.original", 1.0, 2.0),
         ("qmg.kcycle.L0", 3.0, 9.0),
         ("qmg.coarse_solve.L1", 4.0, 8.0),
         ("qmg.apply.L1.original", 5.0, 6.0),
         ("qmg.readback", 6.5, 7.5)]
# Launched in the order they run, one stream; correlation 5 outside every
# span, 6 with no launch event.
LAUNCHES = {1: 1.5, 2: 3.5, 4: 4.5, 3: 5.5, 5: 11.0}
DEVICE = [("k1", 2.0, 2.5, 1), ("k2", 3.6, 4.0, 2), ("k4", 4.6, 5.0, 4),
          ("k3", 5.6, 6.2, 3), ("k5", 11.1, 11.2, 5), ("k6", 12.0, 12.5, 6)]
CONFIG = {"lattice": {"x": 8, "y": 8, "nc": 2},
          "kcycle": {"x_block": 2, "y_block": 2, "coarse_dof": 4}}
PEAKS = {"hbm_bytes_per_s": 1e6}


def test_table_by_span():
    tab = spans.table(SPANS, DEVICE, LAUNCHES)
    rows = tab["rows"]
    assert tab["busy_s"] == pytest.approx(2.5)
    # gaps 1.1 (kcycle), 0.6 (coarse), 0.6 (apply L1), 4.9 (kcycle), 0.8
    assert tab["idle_s"] == pytest.approx(8.0)
    assert tab["outside_s"] == pytest.approx(0.6)
    assert (tab["unlinked"], tab["n_device_ops"]) == (1, 6)
    expect = {  # device self / inclusive, idle self / inclusive, host self
        "qmg.solve": (0.0, 1.9, 0.0, 7.2, 3.0),
        "qmg.apply.L0.original": (0.5, 0.5, 0.0, 0.0, 1.0),
        "qmg.kcycle.L0": (0.4, 1.4, 6.0, 7.2, 2.0),
        "qmg.coarse_solve.L1": (0.4, 1.0, 0.6, 1.2, 2.0),
        "qmg.apply.L1.original": (0.6, 0.6, 0.6, 0.6, 1.0),
        "qmg.readback": (0.0, 0.0, 0.0, 0.0, 1.0)}
    for name, numbers in expect.items():
        r = rows[name]
        assert r["count"] == 1
        assert (r["device_self_s"], r["device_s"], r["idle_self_s"],
                r["idle_s"], r["host_self_s"]) == pytest.approx(numbers)


def test_metrics_by_span():
    tab = spans.table(SPANS, DEVICE, LAUNCHES)
    got = spans.metrics(tab, CONFIG, 2, PEAKS)
    nbytes = spans.coarse_apply_bytes(16, 4, 2)
    assert nbytes == 16 * (5 * 16 * 8 + 2 * 2 * 4 * 8)
    assert got == pytest.approx({
        "coarse_levels_ms_per_rhs": 1.0 * 1e3 / 2,
        "coarse_levels_idle_pct": 100 * 1.2 / 8.0,
        "coarse_apply_roofline": 100 * nbytes / 1e6 / 0.6})


def test_schur_roofline_counts_every_span():
    schur = [("qmg.solve", 0.0, 10.0), ("qmg.apply.L0.right_schur", 1.0, 2.0),
             ("qmg.apply.L0.right_schur", 3.0, 4.0)]
    device = [("a", 1.2, 1.4, 1), ("b", 3.2, 3.3, 2)]
    got = spans.metrics(spans.table(schur, device, {1: 1.1, 2: 3.1}),
                        CONFIG, 2, PEAKS)
    assert spans.schur_apply_bytes(64, 2) == 64 * 16 + 2 * 32 * 16 * 2
    assert got == pytest.approx(
        {"schur_apply_roofline": 100 * 2 * spans.schur_apply_bytes(64, 2)
         / 1e6 / 0.3})


def test_nothing_to_read_without_spans():
    """A program without spans (the parent of the change that added them):
    every device second is outside, and no per-layer number comes out."""
    tab = spans.table([], DEVICE, LAUNCHES)
    assert tab["rows"] == {}
    assert tab["outside_s"] == pytest.approx(tab["busy_s"])
    assert spans.metrics(tab, CONFIG, 2, PEAKS) == {}
    # nor from a trace with no device at all (the CPU)
    assert spans.metrics(spans.table(SPANS, [], {}), CONFIG, 2, PEAKS) == {}


def test_collect_takes_the_program_spans():
    x = torch.ones(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("qmg.solve"):
            with span("qmg.apply.L0.original"):
                x = x * 2
    events = spans.collect(prof)
    assert [name for name, _, _ in sorted(events["spans"],
                                          key=lambda s: s[1])] == [
        "qmg.solve", "qmg.apply.L0.original"]
    assert events["device"] == [] and events["launches"] == {}
    assert events["kinds"]["spans"] == 2 and events["kinds"]["other"] >= 1


def test_span_table_on_a_small_cell():
    _, _, config, traffic = small_cell("n13-2048-rhs8", 32, "gauss-rhs1")
    report = span_table.span_table(config, traffic, 4100000003, 1, "cpu")
    assert [label for label, _ in report["setup_stages"]] == [
        "operator", "L1 nullvec", "L1 transfer", "L1 coarse", "cdinv"]
    (plain,) = report["plain"]
    assert plain["derived_builds"] == 0 and plain["readbacks"]["gcr"] > 0
    assert report["readbacks_per_rhs"] == sum(plain["readbacks"].values())
    prof = report["profiled"]
    assert prof["readback_spans"] == prof["readbacks"] > 0
    assert report["rows"]["qmg.solve"]["count"] == 1
    assert report["metrics"] == {}      # no device on the CPU
    assert "sync_debug" not in report


def coarse_device_s(facts: dict):
    """A reader of the kind a later metric adds: the device seconds
    launched under the coarse solve's span in the profiled solve."""
    events = facts["spans"]
    rows = spans.table(events["spans"], events["device"],
                       events["launches"])["rows"]
    return rows[spans.COARSE]["device_s"] if spans.COARSE in rows else None


def test_facts_hold_the_spans_and_the_counters(monkeypatch):
    """A traced run's ``facts`` hold the profiled solve's spans, device
    operations and launches and each window solve's counter deltas, from
    which a reader takes a span's device time and a count."""
    seen = {}

    def capture(bench, cell, facts):
        seen.update(facts)
        return per_layer(bench, cell, facts)

    per_layer = run.per_layer_metrics
    monkeypatch.setattr(run, "per_layer_metrics", capture)
    bench, cell, config, traffic = small_cell("n13-2048-rhs8", 32,
                                              "gauss-rhs1")
    run.run_cell(bench, cell, config, traffic, 2**31 + 23, 0.05, True,
                 device="cpu")
    events = seen["spans"]
    assert events["kinds"]["spans"] == len(events["spans"]) > 0
    assert coarse_device_s(seen) == 0.0         # no device on the CPU
    assert coarse_device_s({"spans": {"spans": SPANS, "device": DEVICE,
                                      "launches": LAUNCHES}}) == \
        pytest.approx(1.0)
    tab = spans.table(events["spans"], events["device"], events["launches"])
    (profiled,) = [s for s in seen["solves"] if s["profiled"]]
    assert sum(profiled["readbacks"].values()) == \
        tab["rows"]["qmg.readback"]["count"] > 0
    for solve in seen["solves"]:
        assert solve["readbacks"]["gcr"] > 0
        assert sum(solve["contractions"].values()) > 0
