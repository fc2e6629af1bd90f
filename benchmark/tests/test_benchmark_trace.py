"""The trace reduction and the readers that take the trace, on a
synthetic trace (the CPU has no device operations to profile)."""

import pytest

from benchmark import trace
from benchmark.metrics import (device_idle_pct, fine_apply_roofline,
                               kernels_per_rhs)

DEVICE = [("wilson_r1_kernel<false>", 0.0, 0.2),
          ("reduce_kernel", 0.1, 0.3),        # overlaps: busy is a union
          ("Memcpy DtoH", 0.5, 0.6),
          ("wilson_r1_kernel<false>", 0.9, 1.0)]
HOST = [("aten::item", 0.25, 0.55), ("aten::mul", 0.6, 0.95),
        ("aten::empty", 0.7, 0.8), ("Activity Buffer Request", 0.0, 2.0)]


def test_summarize():
    s = trace.summarize(DEVICE, HOST)
    assert s["busy_s"] == pytest.approx(0.3 + 0.1 + 0.1)
    assert s["n_kernels"] == 3
    assert s["kernel_s"]["wilson_r1_kernel<false>"] == pytest.approx(0.3)
    assert "Memcpy DtoH" not in s["kernel_s"]
    gaps = s["breakdown"]["idle_gaps"]
    assert [g[0] for g in gaps] == ["aten::empty", "aten::item"]
    assert [g[1] for g in gaps] == pytest.approx([0.3, 0.2])
    assert s["breakdown"]["device_ops"][0][0] == "wilson_r1_kernel<false>"


def _facts(applies):
    prof = trace.summarize(DEVICE, HOST)
    return {"profile": prof, "nrhs": len(applies), "sites": 10 ** 9,
            "peaks": {"hbm_bytes_per_s": 3.35e12},
            "solves": [{"wall_s": 1.0, "profiled": False,
                        "level0_applies": applies},
                       {"wall_s": 2.0, "profiled": False,
                        "level0_applies": applies},
                       {"wall_s": 9.0, "profiled": True,
                        "level0_applies": applies}]}


def test_trace_readers():
    facts = _facts([3, 2])
    assert kernels_per_rhs.read(facts) == 1.5
    # busy 0.5 s against the unprofiled median 1.5 s
    assert device_idle_pct.read(facts) == pytest.approx(100 * (1 - 0.5 / 1.5))
    # 3 launches read the links, 5 field-applies move x and y
    nbytes = 3 * 16 * 10 ** 9 + 5 * 32 * 10 ** 9
    assert fine_apply_roofline.read(facts) == pytest.approx(
        100 * nbytes / 3.35e12 / 0.3)


def test_readers_silent_without_a_trace():
    facts = dict(_facts([1]), profile=None)
    for reader in (kernels_per_rhs, device_idle_pct, fine_apply_roofline):
        assert reader.read(facts) is None
