"""Where one cell's solve spends its device and idle time, by the
program's spans, with the program's counters around it.

    python -m benchmark.span_table --workload <cell> --seed <n> \
        [--solves 2] [--device cuda] [--out <file>]

Builds the cell's inputs, hierarchy and solver as ``run.run_cell`` does
and warms up with one solve; then, on the next batches of the pool:

  1. ``--solves`` plain solves: each one's wall, its host read-backs
     (``solvers.READBACKS``) and the derived sets it built
     (``stencil.DERIVED_BUILDS``; 0 once warm);
  2. on the card, one solve under ``torch.cuda.set_sync_debug_mode``:
     the synchronising operations torch reports, by the lines of Python
     that made each, those made from the program against that solve's
     read-backs;
  3. one solve under ``torch.profiler``: the span table (``spans.table``)
     with its ``qmg.readback`` spans against that solve's read-backs, and
     the per-layer numbers of ``spans.metrics``.

Prints one JSON object (and writes it to ``--out``), with the setup's
stages (``setup_fn.stages``) and the device's name. No answer is checked
here: ``run.py`` does that.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import sysconfig
import time
import traceback
import warnings

import numpy as np
# First: ``run`` sets the kernel caches' paths before torch loads.
from benchmark import run

import torch

from qmg_tpu_torch import solvers, stencil
from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.setup_planes import make_kcycle_setup_planes
from qmg_tpu_torch.solve import make_solver, make_batched_solver
from qmg_tpu_torch.stencil import StencilType

from benchmark import spans
from benchmark.inputs import make_inputs

SYNC_WARNING = "synchroniz"
STDLIB = sysconfig.get_paths()["stdlib"]


def _total(counter) -> int:
    return sum(counter.values())


def _counted(fn):
    """fn()'s result and the read-backs and derived builds it made."""
    rb, built = dict(solvers.READBACKS), _total(stencil.DERIVED_BUILDS)
    out = fn()
    return out, {k: v - rb.get(k, 0) for k, v in solvers.READBACKS.items()
                 if v != rb.get(k, 0)}, _total(stencil.DERIVED_BUILDS) - built


def _syncs(fn, sync) -> tuple:
    """fn()'s result and the synchronising operations that torch's sync
    debug mode reports while it runs, by the lines of Python that made
    each (the innermost frames of the program or the benchmark, and the
    one that made the call)."""
    sites = collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.startswith(STDLIB)]
            ours = [f for f in frames if "-packages" not in f.filename]
            where = ours[-2:]
            if frames[-1] not in ours:
                where = where + frames[-1:]
            sites[" < ".join(f"{os.path.relpath(f.filename)}:{f.lineno}"
                             for f in reversed(where))] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    return out, dict(sites)


def span_table(config: dict, traffic: dict, seed: int, solves: int,
               device="cuda", peaks: dict | None = None) -> dict:
    """The report of the module's docstring for one configuration and
    traffic mix."""
    from torch.profiler import profile, ProfilerActivity
    on_card = torch.device(device).type == "cuda"
    if on_card:
        solvers.GCR_STORE_LIMIT_BYTES = max(
            solvers.GCR_STORE_LIMIT_BYTES,
            torch.cuda.get_device_properties(device).total_memory // 2)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    nrhs, sol, op = traffic["nrhs"], config["solve"], config["operator"]
    data = make_inputs(config, traffic, seed, device)
    lat = config["lattice"]
    setup_fn = make_kcycle_setup_planes(
        Lattice2D(lat["x"], lat["y"], lat["nc"]), run.kcycle_config(config),
        op["mass"], op["wilson_coeff"], dtype=getattr(torch, op["dtype"]),
        device=device)
    mg = setup_fn(data["gauge"], *data["seeds"])
    kw = dict(tol=sol["tol"], max_iter=sol["max_iter"],
              restart_freq=sol["restart_freq"],
              fine_kernel=sol["fine_kernel"],
              coarse_apply=sol["coarse_apply"],
              outer_type=StencilType[sol["outer_type"]])
    solve = (make_solver(mg, **kw) if nrhs == 1
             else make_batched_solver(mg, **kw))
    pool, n_batches = data["pool"], traffic["pool"] // nrhs

    def batch(i):
        k = i % n_batches
        return pool[k] if nrhs == 1 else pool[k * nrhs:(k + 1) * nrhs]

    def solved(i):
        """The solve of the pool's batch i, the device synchronized."""
        res, _ = solve(batch(i))
        sync()
        return res

    solved(0)
    report = {"setup_stages": [[label, s] for label, s in setup_fn.stages],
              "hierarchy_build_s": setup_fn.seconds, "plain": []}
    for i in range(1, solves + 1):
        t0 = time.perf_counter()
        res, readbacks, built = _counted(lambda: solved(i))
        report["plain"].append({"wall_s": time.perf_counter() - t0,
                                "readbacks": readbacks,
                                "derived_builds": built,
                                "outer_iters": int(np.max(res.iters))})
    if report["plain"]:
        report["readbacks_per_rhs"] = sum(
            _total(s["readbacks"]) for s in report["plain"]) / (
                len(report["plain"]) * nrhs)
    if on_card:
        # The device is synchronized outside the debug mode's reach.
        (_, readbacks, _), sites = _syncs(
            lambda: _counted(lambda: solve(batch(solves + 1))), sync)
        # The mode's own switch back, with the solve's work still queued,
        # reports one more, from this file alone.
        report["sync_debug"] = {
            "syncs": _total(sites), "sites": sites,
            "program_syncs": sum(n for site, n in sites.items()
                                 if "qmg_tpu_torch" in site),
            "readbacks": _total(readbacks)}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        _, readbacks, _ = _counted(lambda: solved(solves + 2))
    wall = time.perf_counter() - t0
    events = spans.collect(prof)
    tab = spans.table(events["spans"], events["device"], events["launches"])
    report["metrics"] = spans.metrics(tab, config, nrhs, peaks)
    rows = tab.pop("rows")
    report["profiled"] = dict(
        tab, wall_s=wall, readbacks=_total(readbacks),
        readback_spans=rows.get("qmg.readback", {}).get("count", 0),
        kinds=events["kinds"],
        outside_pct=(100.0 * tab["outside_s"] / tab["busy_s"]
                     if tab["busy_s"] else None))
    report["rows"] = dict(sorted(rows.items(),
                                 key=lambda kv: -kv[1]["device_s"]))
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--solves", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = run.bench_file()
    cell, config, traffic = run.cell_inputs(bench, args.workload)
    kind = (torch.cuda.get_device_name(args.device)
            if torch.device(args.device).type == "cuda" else "cpu")
    peaks = run.load_json(os.path.join(run.BENCH_DIR, "peaks.json")).get(
        kind)
    report = dict(workload=args.workload, seed=args.seed, device=kind,
                  **span_table(config, traffic, args.seed, args.solves,
                               args.device, peaks))
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
