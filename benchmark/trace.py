"""The traced part of a run: whole solves under ``torch.profiler``, the
trace kept in memory and reduced here to device busy time, kernel times
by name, kernel counts and the longest idle gaps with the host operation
running in each."""

from __future__ import annotations

TOP = 10
NAME_CHARS = 160
# Device operations that are copies or fills, not kernels.
NOT_KERNELS = ("Memcpy", "Memset")
# The profiler's own host events, which name no work of the program.
PROFILER_EVENTS = ("Activity Buffer Request",)


def profiled(fn, sync):
    """Runs ``fn()`` under the profiler; returns (fn's result, (device
    ops, host ops), the finished profiler), each op (name, start s, end s)
    on one clock. ``spans.collect`` takes the program's spans from the
    profiler, out of the solve's time."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        op = (e.name(), start, start + e.duration_ns() * 1e-9)
        (device if e.device_type() == DeviceType.CUDA else host).append(op)
    return out, (device, host), prof


def busy_intervals(device_ops) -> list:
    """The union of the device ops' intervals, sorted, as (start, end)."""
    merged = []
    for _, start, end in sorted(device_ops, key=lambda op: op[1]):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _host_label(host_ops, t: float) -> str:
    """The innermost host operation running at time ``t``."""
    best = None
    for name, start, end in host_ops:
        if name in PROFILER_EVENTS:
            continue
        if start <= t <= end and (best is None
                                  or end - start < best[2] - best[1]):
            best = (name, start, end)
    return best[0] if best else "host outside any profiled operation"


def summarize(device_ops, host_ops) -> dict:
    """busy_s (union of device op intervals), kernel_s by name,
    n_kernels, and the
    breakdown: the device operations with the most time and the longest
    idle gaps between them, each named by the host operation running in
    its middle."""
    busy = busy_intervals(device_ops)
    by_name = {}
    n_kernels = 0
    for name, start, end in device_ops:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        n_kernels += not name.startswith(NOT_KERNELS)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:TOP]
    return {
        "busy_s": sum(end - start for start, end in busy),
        "kernel_s": {name: s for name, s in by_name.items()
                     if not name.startswith(NOT_KERNELS)},
        "n_kernels": n_kernels,
        "breakdown": {
            "device_ops": [[name[:NAME_CHARS], s] for name, s in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[_host_label(host_ops, (g0 + g1) / 2)[:NAME_CHARS],
                           length] for length, g0, g1 in gaps],
        },
    }
