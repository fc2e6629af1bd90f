"""One run of one cell of the benchmark of ``qmg_tpu_torch``.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the package. The cell is an entry
of ``workloads`` in ``BENCHMARK.json``; it names a configuration
(``benchmark/configs/<name>.json``, found through ``configs``' ``file``)
and a traffic mix (``benchmark/traffic/<name>.json``). Per-layer metrics
are readers ``benchmark/metrics/<name>.py``, each with ``read(facts)``
returning a number or None. Adding a configuration, a traffic mix or a
metric is adding its file and an entry in ``BENCHMARK.json``.

Set-up (``setup_s``, from the start of this process): the inputs on the
device from ``--seed`` (``inputs.py``; a configuration's ``setup_seed``
fixes the gauge field and the null-vector seeds), the hierarchy by
``setup_planes.make_kcycle_setup_planes``, the solver bound
(``solve.make_solver`` for one right-hand side, ``make_batched_solver``
for more) and one warm-up solve. The window: a closed loop of whole
solves over the pool of right-hand sides, taken in turn, until
``--seconds`` have passed; it ends at the end of the last whole solve.
``ms_per_rhs`` is its wall time over the right-hand sides solved in it.
With ``--trace 1`` the window's last solve runs under ``torch.profiler``
and the per-layer metrics are reported instead. ``memory_peak_bytes`` is
the largest device memory of a solve, set-up's with the first, less the
answers kept for the check.

Then, with the program's state freed, the plain reference
(``reference/<config["reference"]>.py``) judges the answers: every
checked field's true relative residual ||b - M x|| / ||b|| in
complex128 from the gauge field the benchmark made, against the
configuration's limit. The last line of standard output is the result
object; the numbers compared close standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Kernel caches at fixed paths inside the checkout: only a cell's first
# run there builds. The port builds its own kernels into
# qmg_tpu_torch/_build/, also inside the checkout.
CACHE_DIR = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE_DIR, _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qmg_tpu_torch import solvers  # noqa: E402
from qmg_tpu_torch.lattice import Lattice2D  # noqa: E402
from qmg_tpu_torch.operators.coarse import CoarseOperator2D  # noqa: E402
from qmg_tpu_torch.setup import KCycleConfig  # noqa: E402
from qmg_tpu_torch.setup_planes import make_kcycle_setup_planes  # noqa: E402
from qmg_tpu_torch.solve import make_solver, make_batched_solver  # noqa: E402
from qmg_tpu_torch.stateful import (DSLASH_PRESMOOTH,  # noqa: E402
                                    DSLASH_POSTSMOOTH)
from qmg_tpu_torch.stencil import StencilType  # noqa: E402
from qmg_tpu_torch.wilson_kernel import (wilson_r1_apply,  # noqa: E402
                                         wilson_r1_rhs_apply)

from benchmark.inputs import make_inputs  # noqa: E402
from benchmark import trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "qmg_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_file() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_inputs(bench: dict, workload: str):
    """(cell, configuration, traffic) of ``workload`` by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    (cfg_entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, config, traffic


def kcycle_config(config: dict) -> KCycleConfig:
    """The configuration's ``kcycle`` block as the port's KCycleConfig:
    stencil types by name, ``build_extra`` by CoarseOperator2D's name."""
    fields = {}
    for key, value in config["kcycle"].items():
        if key.endswith("_stencil_app") or key == "nullvec_stype":
            value = StencilType[value]
        elif key == "build_extra" and isinstance(value, str):
            value = getattr(CoarseOperator2D, value)
        fields[key] = value
    return KCycleConfig(**fields)


def base_name(metric: str) -> str:
    """What a metric measures: its name up to the first dot. A quantity
    split by the end-to-end metric it moves (``device_idle_pct.batched``)
    is read by one reader, ``metrics/<base>.py``."""
    return metric.split(".")[0]


def metrics_for(bench: dict, kind: str, cell: dict) -> list:
    """The ``kind`` metrics ("end_to_end" or "per_layer") that ``cell``
    reports: those that list it, or, without a list, every one whose
    end-to-end metric the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and (kind == "end_to_end" or m["moves"] in e2e)]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _lanes(value, nrhs: int) -> list:
    """A per-lane array or tensor, or a scalar of one field, as a list."""
    if torch.is_tensor(value):
        value = value.cpu()
    return np.asarray(value).reshape(nrhs).tolist()


class Reservoir:
    """A uniform sample of at most ``size`` of the fields solved, drawn
    from the seed as they come. ``offer(make)`` calls ``make()`` only for
    a field it keeps, so a kept answer can be copied out of its batch."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = random.Random(seed)

    def offer(self, make):
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(make())
            return
        k = self.rng.randrange(self.seen)
        if k < self.size:
            self.kept[k] = make()

    def nbytes(self) -> int:
        """Bytes of the kept answers."""
        return sum(x.numel() * x.element_size() for _, x, _ in self.kept)


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict,
             seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, solver=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result object: the
    keys the result line prints, ``notes`` for standard error (the count
    check of level 0's applies against K1's launches, each solve's
    seconds) and, last, ``check``, the numbers compared with their
    limits. ``t_start`` is when set-up began (this process's start).
    ``solver(data, config, nrhs)``, when given, makes the solve that
    takes the program's place (the control, ``control.py``): no
    hierarchy is built."""
    t_start = T_START if t_start is None else t_start
    if torch.device(device).type == "cuda":
        # The outer GCR's direction stores of 8 fields at 2048^2 with the
        # configurations' restart length 32 are 32 GiB, over the port's
        # 8 GiB guard against unrestarted stores; a restarted store may
        # take half of the card.
        solvers.GCR_STORE_LIMIT_BYTES = max(
            solvers.GCR_STORE_LIMIT_BYTES,
            torch.cuda.get_device_properties(device).total_memory // 2)
    sync = lambda: _sync(device)  # noqa: E731
    nrhs, sol = traffic["nrhs"], config["solve"]
    op_cfg = config["operator"]
    data = make_inputs(config, traffic, seed, device)
    pool = data["pool"]
    lat = config["lattice"]
    if solver is None:
        lat0 = Lattice2D(lat["x"], lat["y"], lat["nc"])
        setup_fn = make_kcycle_setup_planes(
            lat0, kcycle_config(config), op_cfg["mass"],
            op_cfg["wilson_coeff"], dtype=getattr(torch, op_cfg["dtype"]),
            device=device)
        mg = setup_fn(data["gauge"], *data["seeds"])
        hierarchy_build_s = setup_fn.seconds
        kw = dict(tol=sol["tol"], max_iter=sol["max_iter"],
                  restart_freq=sol["restart_freq"],
                  fine_kernel=sol["fine_kernel"],
                  coarse_apply=sol["coarse_apply"],
                  outer_type=StencilType[sol["outer_type"]])
        solve = (make_solver(mg, **kw) if nrhs == 1
                 else make_batched_solver(mg, **kw))
    else:
        mg = setup_fn = hierarchy_build_s = None
        solve = solver(data, config, nrhs)
    del data["seeds"]
    n_batches = traffic["pool"] // nrhs

    def batch(i):
        k = i % n_batches
        return k, (pool[k] if nrhs == 1 else pool[k * nrhs:(k + 1) * nrhs])

    solve(batch(0)[1])      # warm-up: binds and builds every kernel
    sync()
    setup_s = time.perf_counter() - t_start

    on_card = torch.device(device).type == "cuda"
    kept = Reservoir(traffic["checked_fields"], seed)
    k1_before = wilson_r1_apply.launches + wilson_r1_rhs_apply.launches
    solves, profile = [], None
    memory_peak = 0
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    while not i or t_end - t0 < seconds or (trace and profile is None):
        k, b = batch(i)
        # A traced run profiles its last solve, once the window's time is
        # up: the profiler's after-effects then touch no unprofiled solve.
        traced = trace and t_end - t0 >= seconds
        if on_card and i:
            # The peak of each solve, less the answers the check keeps,
            # which a deployment would not hold; the first solve's peak
            # is the run's since its start, set-up's with it.
            torch.cuda.reset_peak_memory_stats(device)
        held = kept.nbytes()
        cpu_a, t_a = time.thread_time(), time.perf_counter()
        if traced:
            (res, carry), profile = tracing.profiled(lambda: solve(b), sync)
        else:
            res, carry = solve(b)
            sync()
        t_end = time.perf_counter()
        cpu_s = time.thread_time() - cpu_a
        if on_card:
            memory_peak = max(memory_peak,
                              torch.cuda.max_memory_allocated(device) - held)
        iters = carry["iters"].reshape(nrhs, -1)
        counts = carry["counts"].reshape(nrhs, iters.shape[1], -1)
        solves.append({
            "wall_s": t_end - t_a,
            "cpu_s": cpu_s,
            "profiled": traced,
            "outer_iters": _lanes(res.iters, nrhs),
            "converged": _lanes(res.converged, nrhs),
            "coarse_iters": iters[:, 1:].sum(axis=1).tolist(),
            "level0_applies": (counts[:, 0, DSLASH_PRESMOOTH]
                               + counts[:, 0, DSLASH_POSTSMOOTH]).tolist(),
        })
        xs = res.x.reshape((nrhs,) + tuple(pool.shape[1:]))
        for lane in range(nrhs):
            # A copy, so that a kept lane holds no other lane's memory.
            kept.offer(lambda lane=lane: (k * nrhs + lane, xs[lane].clone(),
                                          solves[-1]["converged"][lane]))
        i += 1
    window_s = t_end - t0
    k1_launches = (wilson_r1_apply.launches + wilson_r1_rhs_apply.launches
                   - k1_before)

    # The program's state goes before the reference runs.
    del solve, mg, setup_fn, res, carry, xs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference = importlib.import_module(
        f"benchmark.reference.{config['reference']}")
    limit = config["check"]["true_residual_limit"]
    residuals = [reference.true_residual(data["gauge"], pool[j], x,
                                         op_cfg["mass"],
                                         op_cfg["wilson_coeff"])
                 for j, x, _ in kept.kept]
    attempted = nrhs * len(solves)
    # A field fails when its solve did not converge, or when its answer,
    # checked, lies above the limit.
    failed = (sum(not c for s in solves for c in s["converged"])
              + sum(conv and not (r <= limit)
                    for (_, _, conv), r in zip(kept.kept, residuals)))
    worst = max(residuals) if residuals else float("nan")
    correct = bool(residuals) and failed == 0 and worst <= limit

    facts = {
        "config": config, "traffic": traffic, "cell": cell["name"],
        "sites": lat["x"] * lat["y"], "nrhs": nrhs,
        "hierarchy_build_s": hierarchy_build_s, "setup_s": setup_s,
        "window_s": window_s, "solves": solves, "profile": None,
    }
    dev_info = {"platform": "gpu" if torch.device(device).type == "cuda"
                else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if torch.device(device).type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    facts["peaks"] = load_json(os.path.join(BENCH_DIR, "peaks.json")).get(
        dev_info["kind"])
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        summary = facts["profile"] = tracing.summarize(*profile)
        profiled_wall = solves[-1]["wall_s"]
        metrics = {}
        for m in metrics_for(bench, "per_layer", cell):
            reader = importlib.import_module(
                f"benchmark.metrics.{base_name(m['name'])}")
            value = reader.read(facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = profiled_wall
        result["metrics"] = metrics
        result["device"] = dev_info
        result["breakdown"] = summary["breakdown"]
    else:
        e2e = {"ms_per_rhs": window_s * 1e3 / attempted, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[base_name(m["name"])],
                                         "unit": m["unit"]}
                             for m in metrics_for(bench, "end_to_end", cell)}
        result["device"] = dev_info
    result["notes"] = {
        "k1_launches": k1_launches,
        "level0_batch_applies": sum(max(s["level0_applies"])
                                    for s in solves),
        "solves": len(solves),
        "solve_s": [round(s["wall_s"], 4) for s in solves],
        "solve_cpu_s": [round(s["cpu_s"], 4) for s in solves],
        "solve_outer": [max(s["outer_iters"]) for s in solves],
        "solve_coarse_iters": [sum(s["coarse_iters"]) for s in solves],
    }
    result["check"] = {
        "true_res_worst": {"value": worst, "limit": limit},
        "failed": {"value": failed, "limit": 0},
        "fields_checked": {"value": len(residuals), "limit": 1},
    }
    return result


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = bench_file()
    cell, config, traffic = cell_inputs(bench, args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark may not load: {found}",
              file=sys.stderr)
        return 3
    print(f"notes {json.dumps(result.pop('notes'))}", file=sys.stderr)
    for name, num in result["check"].items():
        print(f"check {name} {num['value']!r} limit {num['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
