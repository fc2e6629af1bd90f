"""Share of the time the device is idle: 100 (1 - busy / wall), busy the
union of the device operations of the profiled solves, wall the median
wall time of the same run's unprofiled solves times the number profiled
(the profiler's own host cost inflates the profiled solves' wall)."""

import statistics


def read(facts: dict):
    prof = facts["profile"]
    plain = [s["wall_s"] for s in facts["solves"] if not s["profiled"]]
    n_prof = sum(s["profiled"] for s in facts["solves"])
    if not prof or not prof["busy_s"] or not plain or not n_prof:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / (statistics.median(plain)
                                            * n_prof))
