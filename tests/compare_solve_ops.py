"""One solve of the port in two trees, side by side in one process: the
device operations it dispatches, its host read-backs, its device kernels
and its wall time. Compares a change with its parent (or any other
checkout) where a change must not add work to a solve.

    python tests/compare_solve_ops.py --other <another checkout> \
        [--size 512] [--outer original|schur] [--rounds 14] [--device cuda]

The other tree's package is copied under another name into a temporary
directory and imported beside this tree's, so both run in one process on
one card: timings taken in separate processes differ by tens of percent
on a shared host. Each tree builds ``kcycle.build_problem(size)`` (the
original formulation solves through K1, the Schur one through plain
applies), makes a solver with ``make_solver`` and makes two warm-up
solves. Then, for each tree, the aten operations of one solve on the
device (views excluded; a scalar read-back counts as one operation and as
one read-back: the counter of ``chip_smoke.count_device_ops``) and on the
card the device kernels of one solve under torch.profiler
(``kcycle.profile_solve``), and the Python calls of one solve; then ``--rounds`` rounds of one timed solve
each, the order of the two trees alternating from round to round. Prints
one JSON line per tree and a summary: operations, read-backs, kernels,
Python calls, outer iterations, median and fastest solve ms, the ratios of this
tree's to the other's, and in how many rounds this tree's solve was the
faster, by the wall clock and by the process's CPU time (which a
preempted process does not accrue), and the mean log of the rounds'
ratios with its standard error.
"""

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIAS = "qmg_tpu_torch_other"


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True,
                   help="the other checkout's root (e.g. the parent's)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--outer", default="original",
                   choices=["original", "schur"])
    p.add_argument("--rounds", type=int, default=14)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    tmp = tempfile.mkdtemp()
    try:
        shutil.copytree(os.path.join(args.other, "qmg_tpu_torch"),
                        os.path.join(tmp, ALIAS),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        sys.path[:0] = [HERE, tmp]
        compare(args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compare(args):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    on_card = torch.device(args.device).type == "cuda"
    item = torch.ops.aten._local_scalar_dense.default

    class Counter(TorchDispatchMode):
        ops = reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is item:
                Counter.ops += 1
                Counter.reads += 1
            elif not func.is_view and any(
                    isinstance(t, torch.Tensor) and t.is_cuda == on_card
                    for t in tree_leaves(out)):
                Counter.ops += 1
            return out

    def sync():
        if on_card:
            torch.cuda.synchronize()

    trees = {}
    for label, pkg in (("other", ALIAS), ("this", "qmg_tpu_torch")):
        kcycle = importlib.import_module(f"{pkg}.kcycle")
        solve_mod = importlib.import_module(f"{pkg}.solve")
        problem = kcycle.build_problem(args.size, args.device,
                                       outer=args.outer)
        solve = solve_mod.make_solver(
            problem["mg"], tol=kcycle.TOL, max_iter=kcycle.MAX_ITER,
            restart_freq=problem["restart"],
            fine_kernel="wilson-r1" if args.outer == "original" else None,
            outer_type=kcycle.OUTERS[args.outer])
        for _ in range(2):
            solve(problem["b"])
        sync()
        Counter.ops = Counter.reads = 0
        with Counter():
            res, _ = solve(problem["b"])
        sync()
        calls = python_calls(lambda: solve(problem["b"]))
        kernels = (kcycle.profile_solve(solve, problem["b"], 1.0)[1]
                   if on_card else None)
        trees[label] = {"solve": solve, "b": problem["b"], "times": [],
                        "cpu": [], "line": {"tree": label, "ops": Counter.ops,
                                 "reads": Counter.reads, "kernels": kernels,
                                 "python_calls": calls,
                                 "iters": res.iters}}
    for rnd in range(args.rounds):
        for label in (("other", "this") if rnd % 2 == 0
                      else ("this", "other")):
            t = trees[label]
            t0, c0 = time.perf_counter(), time.process_time()
            t["solve"](t["b"])
            sync()
            t["times"].append((time.perf_counter() - t0) * 1e3)
            t["cpu"].append((time.process_time() - c0) * 1e3)
    for t in trees.values():
        t["line"].update(solve_ms=float(np.median(t["times"])),
                         fastest_ms=min(t["times"]), solve_ms_all=t["times"],
                         cpu_ms=float(np.median(t["cpu"])),
                         cpu_ms_all=t["cpu"])
        print(json.dumps(t["line"]), flush=True)
    this, other = trees["this"]["line"], trees["other"]["line"]
    for line in (other, this):
        print(f"{line['tree']}: {line['ops']} operations, {line['reads']} "
              f"read-backs, {line['kernels']} device kernels, "
              f"{line['python_calls']} Python calls, "
              f"{line['iters']} outer iterations; solve ms median "
              f"{line['solve_ms']:.3f}, fastest {line['fastest_ms']:.3f}, "
              f"host CPU ms median {line['cpu_ms']:.3f}")

    def wins(key):
        return sum(a < b for a, b in zip(this[key], other[key]))
    print(f"this / other: operations {this['ops'] / other['ops']:.4f}, "
          f"Python calls {this['python_calls'] / other['python_calls']:.4f}, "
          f"median ms {this['solve_ms'] / other['solve_ms']:.4f}, fastest "
          f"ms {this['fastest_ms'] / other['fastest_ms']:.4f}, host CPU ms "
          f"{this['cpu_ms'] / other['cpu_ms']:.4f}; this tree faster in "
          f"{wins('solve_ms_all')} of {args.rounds} rounds (host CPU time: "
          f"{wins('cpu_ms_all')})")
    # Each round's ratio, this tree's solve over the other's: its mean log
    # and that mean's standard error.
    logr = np.log(np.asarray(this["solve_ms_all"])
                  / np.asarray(other["solve_ms_all"]))
    print(f"pairwise mean log ratio {logr.mean():+.4f} +- "
          f"{logr.std() / np.sqrt(len(logr)):.4f}")


def python_calls(fn) -> int:
    """The calls of Python functions and builtins that ``fn()`` makes (the
    events that cProfile counts): the host work of a host-bound solve,
    free of the timing noise of a shared host."""
    calls = 0

    def count(frame, event, arg):
        nonlocal calls
        calls += event in ("call", "c_call")
    sys.setprofile(count)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return calls


if __name__ == "__main__":
    main()
