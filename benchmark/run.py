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

A configuration may name a ``mesh``, {"ny": .., "nx": ..}: level 0 cut
into ny x nx blocks by the program's ``parallel.Mesh``. A cell on one
chip runs that mesh in this process; a cell on ``chips`` = ny * nx chips
runs one ``torch.distributed`` rank a chip (``ranks.py``), every rank
solving its blocks of the same batches in lockstep. Any other pairing of
``chips`` and ``mesh`` is refused at load. ``setup_options`` (such as
``deflate_low``, ``deflate_high``) go to ``make_kcycle_setup_planes`` as
they are.

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
and the per-layer metrics are reported instead: the readers get
``facts``, which hold each window solve's counts (``solves``, with the
deltas of ``solvers.READBACKS`` and ``linalg.CONTRACTIONS``), the trace's
reduction (``profile``) and the profiled solve's spans, device
operations and launches (``spans``, of ``spans.collect``).
``memory_peak_bytes`` is the largest device memory of a solve, set-up's
with the first, less the answers kept for the check.

On several chips every rank draws the whole inputs from the seed, keeps
its blocks of the pool and solves them; rank 0's clock ends the window,
and ``ms_per_rhs`` is rank 0's window. ``setup_s`` runs from the
launching process's start until every rank has ended its warm-up.
On a mesh the program gets the whole gauge field and null-vector seeds
from the host, and moves to the card only what it holds. On several
chips ``memory_peak_bytes`` is the largest over the ranks, counted from
the freeing of the whole pool, set-up's with the first solve's as on one
chip; the traced solve runs under the profiler on
every rank, the per-layer metrics come from rank 0's trace, and
``busy_s`` is the mean over the ranks.

Then, with the program's state freed, the plain reference
(``reference/<config["reference"]>.py``) judges the answers: every
checked field's true relative residual ||b - M x|| / ||b|| in
complex128 from the gauge field the benchmark made, against the
configuration's limit (on several chips, rank 0 judges the whole fields
gathered from every rank's blocks; a field not converged on any rank
fails). The last line of standard output is the result
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

from qmg_tpu_torch import linalg, solvers  # noqa: E402
from qmg_tpu_torch.lattice import Lattice2D  # noqa: E402
from qmg_tpu_torch.operators.coarse import CoarseOperator2D  # noqa: E402
from qmg_tpu_torch.parallel import Mesh  # noqa: E402
from qmg_tpu_torch.setup import KCycleConfig  # noqa: E402
from qmg_tpu_torch.setup_planes import make_kcycle_setup_planes  # noqa: E402
from qmg_tpu_torch.solve import make_solver, make_batched_solver  # noqa: E402
from qmg_tpu_torch.stateful import (DSLASH_PRESMOOTH,  # noqa: E402
                                    DSLASH_POSTSMOOTH)
from qmg_tpu_torch.stencil import StencilType  # noqa: E402
from qmg_tpu_torch.wilson_kernel import (wilson_r1_apply,  # noqa: E402
                                         wilson_r1_rhs_apply)

from benchmark.inputs import make_inputs  # noqa: E402
from benchmark import spans, trace as tracing  # noqa: E402

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
    mesh_shape(cell, config)
    return cell, config, traffic


def mesh_shape(cell: dict, config: dict):
    """(ny, nx) of the configuration's ``mesh``, or None without one. A
    cell on one chip runs any mesh in one process; a cell on more chips
    runs one rank a chip and needs a mesh of as many blocks. Any other
    pairing is refused, naming the cell."""
    mesh, chips = config.get("mesh"), cell["chips"]
    shape = None if mesh is None else (int(mesh["ny"]), int(mesh["nx"]))
    if shape is not None and min(shape) < 1:
        raise SystemExit(f"cell {cell['name']!r}: mesh {mesh} needs at "
                         "least one block along each axis")
    if chips != 1 and (shape is None or shape[0] * shape[1] != chips):
        raise SystemExit(
            f"cell {cell['name']!r} asks for {chips} chips, but its "
            f"configuration's mesh {mesh} does not hold one block a chip: "
            "a cell on several chips needs a mesh of ny * nx = chips")
    return shape


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


def _delta(counter, before: dict) -> dict:
    """A counter's counts since ``before`` (a copy of it), those that moved."""
    return {k: v - before.get(k, 0) for k, v in counter.items()
            if v != before.get(k, 0)}


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
             t_start: float | None = None, solver=None,
             ranks=None) -> dict | None:
    """One run of ``cell`` on ``device``; returns the result object: the
    keys the result line prints, ``notes`` for standard error (the count
    check of level 0's applies against K1's launches, each solve's
    seconds) and, last, ``check``, the numbers compared with their
    limits. ``t_start`` is when set-up began (this process's start, or
    the launching parent's on the same clock). ``solver(data, config,
    nrhs)``, when given, makes the solve that takes the program's place
    (the control, ``control.py``): no hierarchy is built.

    ``ranks`` (a ``ranks.Ranks``) makes this process one rank of a cell on
    several chips: it solves its blocks of every batch, in the window
    that rank 0's clock ends, and rank 0 judges the whole fields gathered
    from the blocks; the result comes back on rank 0, None on the
    others."""
    t_start = T_START if t_start is None else t_start
    if ranks is not None and solver is not None:
        raise ValueError("the control runs in one process")
    on_card = torch.device(device).type == "cuda"
    if on_card:
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
    shape = mesh_shape(cell, config)
    mesh = (None if shape is None
            else Mesh(*shape, group=None if ranks is None else ranks.group))
    data = make_inputs(config, traffic, seed, device)
    pool = data["pool"]
    if mesh is not None:
        # On a mesh the program takes the whole gauge field and seeds from
        # the host, as a deployment's rank holds them, and moves to the
        # card only the blocks it holds and the replicated levels' seeds.
        data["gauge"] = data["gauge"].cpu()
        data["seeds"] = [s.cpu() for s in data["seeds"]]
    if ranks is not None:
        # Each rank solves its blocks of the pool; the whole pool goes
        # before set-up, and the peak counts from here.
        pool = ranks.block(pool, 2).clone()
        del data["pool"]
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
    lat = config["lattice"]
    if solver is None:
        lat0 = Lattice2D(lat["x"], lat["y"], lat["nc"])
        setup_fn = make_kcycle_setup_planes(
            lat0, kcycle_config(config), op_cfg["mass"],
            op_cfg["wilson_coeff"], dtype=getattr(torch, op_cfg["dtype"]),
            device=device, mesh=mesh, **config.get("setup_options", {}))
        mg = setup_fn(data["gauge"], *data["seeds"])
        hierarchy_build_s = setup_fn.seconds
        kw = dict(tol=sol["tol"], max_iter=sol["max_iter"],
                  restart_freq=sol["restart_freq"],
                  fine_kernel=sol["fine_kernel"],
                  coarse_apply=sol["coarse_apply"], mesh=mesh,
                  outer_type=StencilType[sol["outer_type"]])
        solve = (make_solver(mg, **kw) if nrhs == 1
                 else make_batched_solver(mg, **kw))
    else:
        mg = setup_fn = hierarchy_build_s = None
        solve = solver(data, config, nrhs)
    del data["seeds"]
    if ranks is not None and not ranks.root:
        del data["gauge"]   # only rank 0 judges
    n_batches = traffic["pool"] // nrhs

    def batch(i):
        k = i % n_batches
        return k, (pool[k] if nrhs == 1 else pool[k * nrhs:(k + 1) * nrhs])

    solve(batch(0)[1])      # warm-up: binds and builds every kernel
    sync()
    if ranks is not None:
        ranks.gather(0.0)   # set-up ends when every rank is ready
    setup_s = time.perf_counter() - t_start

    kept = Reservoir(traffic["checked_fields"], seed)
    k1_before = wilson_r1_apply.launches + wilson_r1_rhs_apply.launches
    sent_before = dict(mesh.sent) if mesh is not None else None
    solves, profile, events = [], None, None
    memory_peak = 0
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    while True:
        go = not i or t_end - t0 < seconds or (trace and profile is None)
        # A traced run profiles its last solve, once the window's time is
        # up: the profiler's after-effects then touch no unprofiled solve.
        traced = trace and t_end - t0 >= seconds
        if ranks is not None:
            go, traced = ranks.share(go, traced)   # rank 0's clock decides
        if not go:
            break
        k, b = batch(i)
        if on_card and i:
            # The peak of each solve, less the answers the check keeps,
            # which a deployment would not hold; the first solve's peak
            # is the run's since its start, set-up's with it.
            torch.cuda.reset_peak_memory_stats(device)
        held = kept.nbytes()
        readbacks, contractions = (dict(solvers.READBACKS),
                                   dict(linalg.CONTRACTIONS))
        cpu_a, t_a = time.thread_time(), time.perf_counter()
        if traced:
            (res, carry), profile, prof = tracing.profiled(
                lambda: solve(b), sync)
        else:
            res, carry = solve(b)
            sync()
        t_end = time.perf_counter()
        cpu_s = time.thread_time() - cpu_a
        if traced:
            events = spans.collect(prof)
            del prof
        if on_card:
            memory_peak = max(memory_peak,
                              torch.cuda.max_memory_allocated(device) - held)
        iters = carry["iters"].reshape(nrhs, -1)
        counts = carry["counts"].reshape(nrhs, iters.shape[1], -1)
        converged = _lanes(res.converged, nrhs)
        if ranks is not None:
            converged = ranks.all_true(converged)
        solves.append({
            "wall_s": t_end - t_a,
            "cpu_s": cpu_s,
            "profiled": traced,
            "outer_iters": _lanes(res.iters, nrhs),
            "converged": converged,
            "coarse_iters": iters[:, 1:].sum(axis=1).tolist(),
            "level0_applies": (counts[:, 0, DSLASH_PRESMOOTH]
                               + counts[:, 0, DSLASH_POSTSMOOTH]).tolist(),
            "readbacks": _delta(solvers.READBACKS, readbacks),
            "contractions": _delta(linalg.CONTRACTIONS, contractions),
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
    attempted = nrhs * len(solves)
    sent = (None if mesh is None else
            {kind: (n - sent_before[kind]) / attempted
             for kind, n in mesh.sent.items()})
    summary = tracing.summarize(*profile) if trace else None
    rank_peaks = busy = None
    if ranks is not None:
        rank_peaks = [int(p) for p in ranks.gather(memory_peak)]
        memory_peak = max(rank_peaks)
        if trace:
            busy = ranks.gather(summary["busy_s"])

    # The program's state goes before the reference runs.
    del solve, mg, setup_fn, res, carry, xs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference = importlib.import_module(
        f"benchmark.reference.{config['reference']}")
    limit = config["check"]["true_residual_limit"]
    if ranks is None:
        gauge = data["gauge"].to(device)
        residuals = [reference.true_residual(gauge, pool[j], x,
                                             op_cfg["mass"],
                                             op_cfg["wilson_coeff"])
                     for j, x, _ in kept.kept]
    else:
        # Every rank gives its blocks of each kept answer and its
        # right-hand side; rank 0 judges the whole fields.
        gauge = data["gauge"].to(device) if ranks.root else None
        residuals = []
        for j, x, _ in kept.kept:
            x, b = ranks.whole(x, 1), ranks.whole(pool[j], 1)
            if ranks.root:
                residuals.append(reference.true_residual(
                    gauge, b, x, op_cfg["mass"], op_cfg["wilson_coeff"]))
            del x, b
        if not ranks.root:
            return None
    # A field fails when its solve did not converge, or when its answer,
    # checked, lies above the limit.
    failed = (sum(not c for s in solves for c in s["converged"])
              + sum(conv and not (r <= limit)
                    for (_, _, conv), r in zip(kept.kept, residuals)))
    worst = max(residuals) if residuals else float("nan")
    correct = bool(residuals) and failed == 0 and worst <= limit

    chips = 1 if ranks is None else ranks.world
    facts = {
        "config": config, "traffic": traffic, "cell": cell["name"],
        # Sites of the lattice that one card holds.
        "sites": lat["x"] * lat["y"] // chips, "nrhs": nrhs,
        "mesh": shape, "chips": chips, "sent_bytes_per_rhs": sent,
        "hierarchy_build_s": hierarchy_build_s, "setup_s": setup_s,
        "window_s": window_s, "solves": solves, "profile": None,
        "spans": events,
    }
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if on_card else "cpu"),
                "count": chips, "memory_peak_bytes": int(memory_peak)}
    facts["peaks"] = load_json(os.path.join(BENCH_DIR, "peaks.json")).get(
        dev_info["kind"])
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        facts["profile"] = summary
        profiled_wall = solves[-1]["wall_s"]
        result["metrics"] = per_layer_metrics(bench, cell, facts)
        # Busy seconds of the traced solve, the mean over the chips.
        dev_info["busy_s"] = (summary["busy_s"] if busy is None
                              else sum(busy) / len(busy))
        dev_info["window_s"] = profiled_wall
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
    if mesh is not None:
        result["notes"]["mesh"] = repr(mesh)
        result["notes"]["sent_bytes_per_rhs"] = sent
    if rank_peaks is not None:
        result["notes"]["rank_memory_peak_bytes"] = rank_peaks
    result["check"] = {
        "true_res_worst": {"value": worst, "limit": limit},
        "failed": {"value": failed, "limit": 0},
        "fields_checked": {"value": len(residuals), "limit": 1},
    }
    return result


def per_layer_metrics(bench: dict, cell: dict, facts: dict) -> dict:
    """The cell's per-layer metrics that their readers find in ``facts``."""
    metrics = {}
    for m in metrics_for(bench, "per_layer", cell):
        reader = importlib.import_module(
            f"benchmark.metrics.{base_name(m['name'])}")
        value = reader.read(facts)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def emit(result: dict):
    """Prints a run's result: its notes and the numbers compared beside
    their limits, last, on standard error, then the result line."""
    print(f"notes {json.dumps(result.pop('notes'))}", file=sys.stderr)
    for name, num in result["check"].items():
        print(f"check {name} {num['value']!r} limit {num['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


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
    if cell["chips"] > 1:
        return _main_ranks(bench, cell, config, traffic, args)
    result = run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark may not load: {found}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def _main_ranks(bench, cell, config, traffic, args) -> int:
    """``main`` for a cell on several chips: one rank a chip
    (``ranks.launch``), whose rank 0 prints the result."""
    from benchmark import ranks
    job = {"bench": bench, "cell": cell, "config": config,
           "traffic": traffic, "seed": args.seed, "seconds": args.seconds,
           "trace": bool(args.trace), "device": "cuda", "t_start": T_START}
    try:
        out, err = ranks.launch(job)
    except ranks.RankFailed as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark may not load: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.write(err)
    sys.stderr.flush()
    sys.stdout.write(out)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
