"""Device time and idle time of a profiled solve by the program's spans.

The port opens host ranges named ``qmg.*`` at each layer of its solve
(``qmg_tpu_torch/spans.py``: the solve, each apply by level and operator
type, each K-cycle visit, smoothing, transfers, coarse solves, read-backs)
while a profiler runs. Here a trace of kineto's events is reduced to a
table by span name:

  * each device operation goes to the innermost ``qmg.`` span that
    encloses its launch: the host runtime event (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...) with its correlation id;
  * each idle gap between the device's busy intervals goes to the
    innermost ``qmg.`` span at its midpoint on the host, the rule of
    ``trace._host_label``.

Events are plain tuples, so the reduction runs on synthetic lists: spans
(name, start s, end s), device operations (name, start, end, correlation:
kernels, copies and fills), launches {correlation: start}. A span's
"self" numbers are what lies in it and in no span nested in it; its
inclusive numbers add its nested spans'.
"""

from __future__ import annotations

from benchmark.trace import busy_intervals

PREFIX = "qmg."
# The span of the coarse solve below level 0: everything at levels >= 1.
COARSE = "qmg.coarse_solve.L1"
# The prefix of the CUDA API's calls (``cudaLaunchKernel``,
# ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...) among the host events.
LAUNCH_PREFIX = "cu"
# Bytes of one complex64 number.
C64 = 8


def collect(prof) -> dict:
    """spans, device operations and launches of a finished
    ``torch.profiler`` session, and how many events of each of those kinds,
    of user annotations on the device and of other host events it held
    (``kinds``). The device's user annotations (the ranges that
    ``torch.profiler.record_function`` draws over its kernels, named as
    their host ranges) are no device work and are left out."""
    from torch.autograd import DeviceType
    spans, device, launches = [], [], {}
    kinds = dict.fromkeys(("spans", "device", "launches", "annotations",
                           "other"), 0)
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            annotation = getattr(e, "is_user_annotation", None)
            if name.startswith(PREFIX) or (annotation and annotation()):
                kinds["annotations"] += 1
                continue
            device.append((name, start, end, e.correlation_id()))
            kinds["device"] += 1
        elif name.startswith(PREFIX):
            spans.append((name, start, end))
            kinds["spans"] += 1
        elif name.startswith(LAUNCH_PREFIX):
            launches[e.correlation_id()] = start
            kinds["launches"] += 1
        else:
            kinds["other"] += 1
    return {"spans": spans, "device": device, "launches": launches,
            "kinds": kinds}


def _nest(spans) -> tuple:
    """The spans sorted by start (the outer of two with one start first)
    and each one's parent index (-1 at the top). The program's spans are
    context managers on one thread, so they nest."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    parent, stack = [], []
    for i, (_, start, end) in enumerate(spans):
        while stack and spans[stack[-1]][2] < start:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return spans, parent


def _innermost(spans, times) -> list:
    """For each time, the index in ``spans`` (sorted by ``_nest``) of the
    innermost span that holds it, or -1."""
    out = [-1] * len(times)
    stack, i = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][1] <= t:
            while stack and spans[stack[-1]][2] < spans[i][1]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def _chains(parent) -> list:
    """Each span's own index and its ancestors' indices."""
    chains = []
    for i, p in enumerate(parent):
        chains.append([i] + (chains[p] if p >= 0 else []))
    return chains


def table(spans, device, launches) -> dict:
    """``rows``: span name -> count, host_self_s (its duration less its
    nested spans'), device_self_s and device_s (device time launched in it
    alone and with its nested spans), idle_self_s and idle_s (device idle
    gaps by midpoint, the same two ways). Totals: ``busy_s`` (union of the
    device operations), ``idle_s`` (the gaps between them), ``outside_s``
    (device time launched outside every span, or with no launch event
    found), ``unlinked`` (operations with no launch event),
    ``n_device_ops``."""
    spans, parent = _nest(spans)
    chains = _chains(parent)
    rows = {}

    def row(name):
        return rows.setdefault(name, {
            "count": 0, "host_self_s": 0.0, "device_self_s": 0.0,
            "device_s": 0.0, "idle_self_s": 0.0, "idle_s": 0.0})

    for i, (name, start, end) in enumerate(spans):
        r = row(name)
        r["count"] += 1
        r["host_self_s"] += end - start
        if parent[i] >= 0:
            row(spans[parent[i]][0])["host_self_s"] -= end - start

    def charge(index, seconds, key):
        if index < 0:
            return
        rows[spans[index][0]][key + "_self_s"] += seconds
        for name in {spans[j][0] for j in chains[index]}:
            rows[name][key + "_s"] += seconds

    linked = [op for op in device if op[3] in launches]
    owners = _innermost(spans, [launches[op[3]] for op in linked])
    outside = sum(op[2] - op[1] for op in device if op[3] not in launches)
    for op, owner in zip(linked, owners):
        if owner < 0:
            outside += op[2] - op[1]
        charge(owner, op[2] - op[1], "device")
    busy = busy_intervals([op[:3] for op in device])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    for (g0, g1), owner in zip(gaps, _innermost(
            spans, [(g0 + g1) / 2 for g0, g1 in gaps])):
        charge(owner, g1 - g0, "idle")
    return {"rows": rows, "busy_s": sum(e - s for s, e in busy),
            "idle_s": sum(g1 - g0 for g0, g1 in gaps),
            "outside_s": outside, "unlinked": len(device) - len(linked),
            "n_device_ops": len(device)}


def coarse_apply_bytes(sites: int, nc: int, nrhs: int) -> int:
    """Compulsory bytes of one plain apply of a coarse level (``sites``
    sites of ``nc`` components) to ``nrhs`` fields at once: the clover
    and the four hops, nc x nc each a site, read once, and each field read
    and written once."""
    return sites * (5 * nc * nc * C64 + nrhs * 2 * nc * C64)


def schur_apply_bytes(sites: int, nrhs: int) -> int:
    """Compulsory bytes of one Schur apply of the fine Wilson level
    (``sites`` sites, two spin components) to ``nrhs`` even halves at
    once, whatever implements it: the U(1) links U_x and U_y of every
    site read once, and each field's even half read and written once."""
    return sites * 2 * C64 + nrhs * (sites // 2) * 2 * C64 * 2


def metrics(tab: dict, config: dict, nrhs: int, peaks: dict | None) -> dict:
    """The per-layer numbers of one profiled solve of ``nrhs`` fields on
    ``config``'s lattice: ``coarse_levels_ms_per_rhs`` (device time of
    everything launched under ``COARSE``), ``coarse_levels_idle_pct``
    (the share of the device's idle gaps that fall in ``COARSE``), and
    the HBM roofline shares of the applies by span, ``coarse_apply``
    (level 1's plain apply) and ``schur_apply`` (level 0's Schur apply),
    each left out where the solve has no such span."""
    rows, out = tab["rows"], {}
    coarse = rows.get(COARSE)
    if coarse and tab["busy_s"]:
        out["coarse_levels_ms_per_rhs"] = coarse["device_s"] * 1e3 / nrhs
        if tab["idle_s"]:
            out["coarse_levels_idle_pct"] = (100.0 * coarse["idle_s"]
                                             / tab["idle_s"])
    lat, kc = config["lattice"], config["kcycle"]
    sites0 = lat["x"] * lat["y"]
    sites1 = sites0 // (kc["x_block"] * kc["y_block"])
    for key, name, nbytes in (
            ("coarse_apply_roofline", "qmg.apply.L1.original",
             coarse_apply_bytes(sites1, kc["coarse_dof"], nrhs)),
            ("schur_apply_roofline", "qmg.apply.L0.right_schur",
             schur_apply_bytes(sites0, nrhs))):
        r = rows.get(name)
        if r and r["device_s"] and peaks:
            out[key] = (100.0 * r["count"] * nbytes
                        / peaks["hbm_bytes_per_s"] / r["device_s"])
    return out
