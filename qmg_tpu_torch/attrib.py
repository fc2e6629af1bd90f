"""One solve's time by part, level by level (the port's counterpart of
scripts/probe_2048_attrib.py).

    python -m qmg_tpu_torch.attrib [--size 2048] [--n-refine 4]
        [--device cuda] [--fine-kernel wilson-r1] [--coarse-apply plain]
        [--reps 5]

The probe's problem: Wilson2D at m = -0.06 (complex64) on a
``gauss_gauge_u1`` field at beta = 6 from ``QMGRandom(1337)``, the n13
hierarchy of ``--n-refine`` refinements (coarse dof 8, null vectors to
5e-4 in at most 200 iterations, restarts 16 / 8 from 2048^2 on and 32
below, the dense coarsest inverse) built by ``make_kcycle_setup_planes``,
and the right-hand side drawn after the setup (``kcycle.build_problem``).

Each part of a solve (``solve.component_chain``: ``fine``, the level's
exact plain apply; ``transfer``, restrict then prolong; ``smooth2``,
MinRes(2, 0.85); ``precond``, one K-cycle with the applies of the solve:
``--fine-kernel`` on level 0, ``--coarse-apply`` below) is timed as the
marginal of a chain of 8 against a chain of 4 dependent steps, (t8 - t4) /
4, each chain timed on the host clock with the device synchronised
around it (on the CPU with one thread by the thread's CPU time), the
minimum over ``--reps`` rounds that run the two in turn after one
warm-up round, on every level
that has the part: on level l the input is b restricted l times. On
level 0 ``fine:<kernel>`` also times the kernel apply that the K-cycle
uses. ``outer1``, one outer FGCR trip with the identity in place of the
K-cycle (the fine matvec, the orthogonalisation and the store), is the
marginal of 3 fixed trips against 1 (``make_solver(precond_mode="none",
fixed_outer_iters=N)``). Then the solve itself (tol 1e-5, at most 200
outer iterations), a warm-up and ``--reps`` timed, and the probe's model
line: precond + outer1 against the measured ms per outer iteration.

The last line of the standard output is one JSON object:
{"components": {level: {part: ms}}, "outer1_ms", "solve_ms",
"outer_iters", "device", ...}, with the kernel launches of each part's
timings under "launches" and the Krylov iterations of a K-cycle on each
level, in the chains ("kcycle_iters") and in the solve
("solve_kcycle_iters"). On the card "device" is ``nvidia-smi``'s name and
power limit; on the CPU the times are the host's.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import kcycle
from .dslash import device_line
from .solve import FINE_KERNELS, COARSE_APPLIES, make_solver, component_chain
from .stateful import zero_carry

CHAIN = (4, 8)          # the two chain lengths of a part's marginal
OUTER_TRIPS = (1, 3)    # the fixed outer trips of outer1's marginal


def _launched(before: dict) -> dict:
    return {k: n - before[k] for k, n in kcycle.launch_counts().items()
            if n > before[k]}


def parts(mg, fine_kernel, levels=None):
    """(level, part, component_chain keywords) of every part to time, on
    ``levels`` (None: every level)."""
    n_levels = mg.get_num_levels()
    out = []
    for lvl in range(n_levels) if levels is None else levels:
        names = ["fine", "smooth2"]
        if lvl < n_levels - 1:
            names += ["transfer", "precond"]
        for name in names:
            out.append((lvl, name, name, {}))
        if lvl == 0 and fine_kernel is not None:
            out.append((0, f"fine:{fine_kernel}", "fine",
                        {"fine_kernel": fine_kernel}))
    return out


def run(size: int = 2048, n_refine: int = 4, device="cuda",
        fine_kernel: str | None = "wilson-r1", coarse_apply: str = "plain",
        reps: int = 5, levels=None) -> dict:
    """Builds the problem, times every part on ``levels`` (None: every
    level), ``outer1`` and the solve; returns the measurements."""
    problem = kcycle.build_problem(size, device, n_refine=n_refine)
    mg, b, restart = problem["mg"], problem["b"], problem["restart"]
    fields = [b]
    for lvl in range(mg.get_num_levels() - 1):
        fields.append(mg.get_transfer(lvl).restrict_f2c(fields[-1]))
    solver_kw = {"fine_kernel": fine_kernel, "coarse_apply": coarse_apply}

    n_levels = mg.get_num_levels()
    components, launches, kcycle_iters = {}, {}, {}
    for lvl, label, part, kw in parts(mg, fine_kernel, levels):
        if part == "precond":
            counts = zero_carry(n_levels)
            kw = dict(solver_kw, counts=counts)

        def chain(k, lvl=lvl, part=part, kw=kw):
            return component_chain(mg, fields[lvl], part, k, level=lvl, **kw)

        before = kcycle.launch_counts()
        short, long = kcycle.best_s([lambda k=k: chain(k) for k in CHAIN], device,
                             reps)
        launches.setdefault(lvl, {})[label] = _launched(before)
        components.setdefault(lvl, {})[label] = (
            (long - short) / (CHAIN[1] - CHAIN[0]) * 1e3)
        if part == "precond":
            steps = (1 + reps) * sum(CHAIN)
            kcycle_iters[lvl] = (counts["iters"] / steps).tolist()

    trips = [make_solver(mg, tol=1e-30, max_iter=200, restart_freq=restart,
                         precond_mode="none", fixed_outer_iters=n, **solver_kw)
             for n in OUTER_TRIPS]
    t_one, t_more = kcycle.best_s([lambda s=s: s(b) for s in trips], device, reps)
    outer1_ms = (t_more - t_one) / (OUTER_TRIPS[1] - OUTER_TRIPS[0]) * 1e3

    solve = make_solver(mg, tol=kcycle.TOL, max_iter=kcycle.MAX_ITER,
                        restart_freq=restart, **solver_kw)
    solves = []
    (solve_s,) = kcycle.best_s([lambda: solves.append(solve(b))], device, reps)
    res, carry = solves[-1]
    # Krylov iterations per K-cycle on each level below the outer solve.
    solve_iters = [0.0] + (carry["iters"][1:] / max(res.iters, 1)).tolist()
    return {"size": size, "n_refine": n_refine, "fine_kernel": fine_kernel,
            "coarse_apply": coarse_apply, "reps": reps,
            "levels": [f"{lat.x_len}x{lat.y_len} nc{lat.nc}"
                       for lat in mg.lattice_list],
            "setup_s": problem["setup_s"], "components": components,
            "launches": launches, "outer1_ms": outer1_ms,
            "kcycle_iters": kcycle_iters, "solve_kcycle_iters": solve_iters,
            "solve_ms": solve_s * 1e3, "outer_iters": int(res.iters),
            "device": device_line(device)}


def model_line(r: dict) -> str:
    """The probe's model: one K-cycle plus one outer trip against the
    measured ms per outer iteration."""
    precond = r["components"][0]["precond"]
    per_iter = r["solve_ms"] / max(r["outer_iters"], 1)
    return (f"model: precond {precond:.3f} + outer {r['outer1_ms']:.3f} = "
            f"{precond + r['outer1_ms']:.3f} ms/iter vs measured "
            f"{per_iter:.3f}")


def print_report(r: dict):
    print(f"attrib {r['size']}^2, {len(r['levels'])} levels "
          f"({', '.join(r['levels'])}), fine_kernel {r['fine_kernel']}, "
          f"coarse_apply {r['coarse_apply']}, on {r['device']}; setup "
          f"{r['setup_s']:.3f} s")
    print(f"ms per step, marginal of {CHAIN[1]} against {CHAIN[0]} steps, "
          f"min over {r['reps']}:")
    for lvl, row in r["components"].items():
        print(f"  level {lvl} ({r['levels'][lvl]}): " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in row.items()))
    for lvl, row in r["launches"].items():
        for name, counts in row.items():
            if counts:
                print(f"  launches over level {lvl} {name}'s timings: "
                      f"{counts}")
    print("Krylov iterations per K-cycle by level: "
          + "; ".join(f"chain from level {lvl} "
                      + " ".join(f"{v:.2f}" for v in its)
                      for lvl, its in r["kcycle_iters"].items())
          + "; in the solve "
          + " ".join(f"{v:.2f}" for v in r["solve_kcycle_iters"]))
    print(f"outer1 (fine matvec + GCR store/ortho): {r['outer1_ms']:.4f} "
          "ms/trip (marginal)")
    print(f"full solve: {r['solve_ms']:.3f} ms / {r['outer_iters']} outers "
          f"= {r['solve_ms'] / max(r['outer_iters'], 1):.3f} ms/iter")
    print(model_line(r))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--n-refine", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fine-kernel", default="wilson-r1",
                   choices=[*FINE_KERNELS, "none"],
                   help="level 0's apply inside the K-cycle")
    p.add_argument("--coarse-apply", default="plain",
                   choices=list(COARSE_APPLIES))
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but no CUDA device")
    if args.reps < 1 or args.n_refine < 1:
        raise SystemExit("--reps and --n-refine take a number >= 1")
    r = run(args.size, args.n_refine, args.device,
            None if args.fine_kernel == "none" else args.fine_kernel,
            args.coarse_apply, args.reps)
    print_report(r)
    print(json.dumps({k: r[k] for k in (
        "components", "outer1_ms", "solve_ms", "outer_iters", "device",
        "size", "n_refine", "fine_kernel", "coarse_apply", "launches",
        "kcycle_iters", "solve_kcycle_iters", "setup_s")}))


if __name__ == "__main__":
    main()
