"""bench.py's benchmark on the port: its three modes, its flags and its
JSON line.

    python -m qmg_tpu_torch.bench [--mode dslash|kcycle|refine]
        [--size 2048] [--kernel phase-r1] [--iters 400] [--warmup 1]
        [--setup host|device] [--coarse-apply auto|jnp|gather|small]
        [--no-direct] [--nrhs N] [--fixed-schedule OUTER[,INNER]]
        [--calibrated] [--outer original|schur] [--deflate N] [--chain K]
        [--hbm-roofline-gbs 3350] [--device cuda]

The last line of the standard output is bench.py's JSON object
{"metric", "value", "unit", "vs_baseline"} with bench.py's metric names,
units and ``vs_baseline``, plus "device": ``nvidia-smi``'s name and power
limit of the card ("cpu" with ``--device cpu``, whose times are the
host's). The human line goes to the standard error.

  dslash  ``wilson_dslash_effective_bandwidth`` in GB/s: ``--iters`` steps
          of the renormalised chain x <- M x / |M x| on bench.py's
          operator (m = -0.075), timed after ``--warmup`` chains
          (``dslash.run``), on bench.py's byte count, (nc^2 + 4 nc^2 +
          2 nc) * 8 B a site for the apply plus 2 nc * 8 B for the
          renormalisation, 224 B a site, whatever the kernel;
          ``vs_baseline`` is that rate over ``--hbm-roofline-gbs``
          (default the H100 SXM's 3350 GB/s,
          ``dslash_kernel.HBM_BYTES_S``). It counts bytes the Wilson
          kernels do not move (they stream 4 phases, not 5 nc^2
          coefficients: K1 moves 96 B a site), so it can pass 1 and is
          no roofline share. ``own_traffic_gbs`` / ``own_traffic_pct``
          count the kernel's own bytes (``dslash.step_bytes``):
          ``own_traffic_pct`` is the share of the roofline.
  kcycle  ``wilson_kcycle_solve_time`` in ms, ``vs_baseline`` ms per
          outer iteration: the n13 flagship (``kcycle.build_problem`` /
          ``run_solver``: a warm-up, then one timed solve to 1e-5). With
          ``--nrhs N`` ``wilson_kcycle_batched_ms_per_rhs``
          (``run_batched`` without its sequential solves; ``vs_baseline``
          N); with ``--chain K``
          ``wilson_kcycle_batched_steady_ms_per_rhs``: (t_K - t_1) /
          (K - 1) / N, t_k the time of k solves in a row, each right-hand
          side b + 1e-3 x of the solve before it, each t_k the minimum of
          two alternating rounds (``kcycle.best_s``). ``--chain`` also takes one right-hand
          side (N = 1).
  refine  ``wilson_refined_1e10_solve_time`` in ms, ``vs_baseline`` the
          defect-correction passes: bench.py's ``bench_refine`` problem
          (the host setup with its own config, default inner restarts,
          and the right-hand side in complex128) solved to a complex128
          true residual 1e-10 by ``solve.make_refined_solver`` (inner tol
          1e-5), a warm-up then one timed solve.

``--setup host`` (bench.py's default) is the eager
``build_kcycle_hierarchy`` on the device, drawing its gaussians from the
stream as it builds; ``--setup device`` is ``make_kcycle_setup_planes``
from seeds drawn ahead, as ``python -m qmg_tpu_torch.kcycle`` runs it, and
also times a rebuild from ``QMGRandom(7)`` seeds (bench.py's warm setup).
On one device the two build the same hierarchy. ``--deflate`` needs
``--setup device``, as in bench.py.

``--kernel`` takes bench.py's names: in the dslash chain ``phase-r1`` is
K1 (``wilson-r1``), ``phase-split`` K3 (``wilson-split``), ``phase`` K2
(``wilson-phase``), ``pallas`` K4 (``matrix``), ``split`` K5, ``small``
K6 and ``xla`` the plain apply; in a solve they name level 0's apply
inside the K-cycle (``phase-split`` has none: K3 is the chain's kernel
only, as in qmg_tpu). The kernel asked for runs at every size: bench.py
routes sizes below 512^2 to the plain apply and falls back to another
kernel when one fails; here a shape a kernel does not take is refused
and a kernel that does not build or launch ends the run, non-zero.
``--outer schur`` applies no kernel (none takes a Schur apply), so its
``--kernel`` defaults to ``xla``. ``--coarse-apply auto`` and ``jnp`` are
the plain coarse apply. bench.py's ``--tile`` and ``--channels-first``
are TPU tiling and layout options and are refused.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from . import dslash, kcycle
from .dslash_kernel import HBM_BYTES_S
from .lattice import Lattice2D
from .rng import QMGRandom
from .setup import KCycleConfig
from .setup_planes import gauss_seed_planes
from .solve import make_refined_solver

# bench.py's --kernel names -> the dslash chain's kinds (dslash.KINDS).
DSLASH_KINDS = {"phase-r1": "wilson-r1", "phase-split": "wilson-split",
                "phase": "wilson-phase", "pallas": "matrix",
                "split": "split", "small": "small", "xla": "plain"}
# ... -> level 0's apply inside the K-cycle (solve.FINE_KERNELS, None the
# plain apply). K3 has no solver route, in qmg_tpu either.
SOLVE_KERNELS = {"phase-r1": "wilson-r1", "phase": "wilson-phase",
                 "pallas": "matrix", "split": "matrix-split",
                 "small": "small", "xla": None}
COARSE_APPLIES = {"auto": "plain", "jnp": "plain", "gather": "gather",
                  "small": "small"}
TPU_ONLY = ("--tile", "--channels-first")
REFINE_TOL = 1e-10
CHAIN_STEP = 1e-3       # each chained rhs is b + CHAIN_STEP * x_prev
CHAIN_ROUNDS = 2


def parse(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in TPU_ONLY:
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            raise SystemExit(f"{flag} is one of bench.py's TPU tiling and "
                             "layout options; the port takes neither "
                             f"{' nor '.join(TPU_ONLY)}")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--mode", choices=["dslash", "kcycle", "refine"],
                   default="dslash")
    p.add_argument("--kernel", choices=list(DSLASH_KINDS), default=None,
                   help="bench.py's kernel names (default phase-r1; xla "
                        "with --outer schur)")
    p.add_argument("--setup", default="host", choices=["host", "device"])
    p.add_argument("--coarse-apply", default="auto",
                   choices=list(COARSE_APPLIES))
    p.add_argument("--no-direct", action="store_true")
    p.add_argument("--nrhs", type=int, default=1)
    p.add_argument("--fixed-schedule", default=None,
                   metavar="OUTER[,INNER]")
    p.add_argument("--calibrated", action="store_true")
    p.add_argument("--outer", default="original",
                   choices=list(kcycle.OUTERS))
    p.add_argument("--deflate", type=int, default=0)
    p.add_argument("--chain", type=int, default=0)
    p.add_argument("--hbm-roofline-gbs", type=float,
                   default=HBM_BYTES_S / 1e9,
                   help="H100 SXM HBM3 bandwidth (data sheet, 700 W)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.kernel is None:
        args.kernel = ("xla" if args.mode == "kcycle"
                       and args.outer == "schur" else "phase-r1")
    if args.mode != "dslash" and args.kernel not in SOLVE_KERNELS:
        raise SystemExit(f"--kernel {args.kernel} has no K-cycle route (K3 "
                         "is the dslash chain's kernel only, as in "
                         "qmg_tpu); use phase-r1")
    if args.outer == "schur" and args.kernel != "xla":
        raise SystemExit("--outer schur applies no kernel (none takes a "
                         "Schur apply): use --kernel xla")
    if args.deflate < 0 or args.chain < 0 or args.iters < 1 \
            or args.warmup < 0:
        raise SystemExit("--deflate, --chain and --warmup take numbers >= 0, "
                         "--iters >= 1")
    if args.chain == 1:
        raise SystemExit("--chain K takes K >= 2 (a marginal of K solves "
                         "against one)")
    if args.deflate and args.setup != "device":
        raise SystemExit("--deflate requires --setup device (deflation "
                         "is computed inside the device-resident setup)")
    return args


def bench_dslash(args) -> dict:
    kind = DSLASH_KINDS[args.kernel]
    operator = dslash.make_operator(args.size, 2, args.device)
    t0 = time.perf_counter()
    r = dslash.run(args.size, kind, iters=args.iters, device=args.device,
                   operator=operator, warmup=args.warmup)
    if "us_per_apply" in r:
        us = r["us_per_apply"]
    else:   # the CPU: the host clock around the one chain that ran
        us = (time.perf_counter() - t0) * 1e6 / args.iters
    nc, volume = 2, args.size * args.size
    itemsize = 8        # complex64
    bytes_per_iter = (nc * nc + 4 * nc * nc + 2 * nc) * volume * itemsize \
        + 2 * nc * volume * itemsize
    gbs = bytes_per_iter / (us * 1e-6) / 1e9
    frac = gbs / args.hbm_roofline_gbs
    own_gbs = dslash.step_bytes(kind, nc, volume) / (us * 1e-6) / 1e9
    own_pct = 100.0 * own_gbs / args.hbm_roofline_gbs
    print(f"# wilson dslash {args.size}x{args.size} {args.kernel} ({kind}): "
          f"{us / 1e3:.4f} ms/apply, {volume / us / 1e3:.3f} Gsites/s, "
          f"{gbs:.1f} GB/s ({100 * frac:.1f}% of {args.hbm_roofline_gbs} "
          f"GB/s), own-traffic {own_gbs:.1f} GB/s = {own_pct:.1f}%, "
          f"checksum={r['checksum']:.6e} on {r['device']}", file=sys.stderr)
    return {"line": {"metric": "wilson_dslash_effective_bandwidth",
                     "value": round(gbs, 2), "unit": "GB/s",
                     "vs_baseline": round(frac, 4),
                     "own_traffic_gbs": round(own_gbs, 2),
                     "own_traffic_pct": round(own_pct, 2)},
            "us_per_apply": us, "checksum": r["checksum"], "kernel": kind}


def _warm_setup_s(problem) -> float:
    """bench.py's warm setup: the device setup again from ``QMGRandom(7)``
    seeds (a stream's per-configuration rebuild)."""
    size = problem["size"]
    seeds = gauss_seed_planes(Lattice2D(size, size, 2), problem["cfg"],
                              QMGRandom(7))
    problem["setup_fn"](problem["gauge"], *seeds)
    return problem["setup_fn"].seconds


def chain(solve, b, k: int):
    """``k`` solves in a row, each right-hand side b + 1e-3 x of the solve
    before it (bench.py's steady-state chain)."""
    rhs = b
    for _ in range(k):
        res, _ = solve(rhs)
        rhs = b + CHAIN_STEP * res.x


def bench_kcycle(args) -> dict:
    schedule = kcycle.batched_schedule(args)
    fine_kernel = SOLVE_KERNELS[args.kernel]
    coarse_apply = COARSE_APPLIES[args.coarse_apply]
    problem = kcycle.build_problem(
        args.size, args.device, outer=args.outer, deflate=args.deflate,
        direct=not args.no_direct,
        setup="host" if args.setup == "host" else "kcycle")
    if args.setup == "device":
        print(f"# kcycle {args.size}x{args.size} device setup: "
              f"{problem['setup_s']:.3f} s; warm setup (per-config "
              f"rebuild): {_warm_setup_s(problem):.3f} s", file=sys.stderr)
    else:
        print(f"# kcycle {args.size}x{args.size} host setup: "
              f"{problem['setup_s']:.3f} s", file=sys.stderr)
    out = {"problem": problem}
    try:
        if schedule is False:
            r = kcycle.run_solver(problem, fine_kernel, coarse_apply)
            with contextlib.redirect_stdout(sys.stderr):
                kcycle.print_report(r)
            ok = r["converged"] and np.isfinite(r["rel_res_true"])
            nrhs, b = 1, problem["b"]
            line = {"metric": "wilson_kcycle_solve_time",
                    "value": round(r["solve_ms"], 2), "unit": "ms",
                    "vs_baseline": round(r["ms_per_iter"], 3)}
        else:
            problem, B, probe = kcycle.batched_inputs(
                problem, args.nrhs, schedule == "calibrated")
            r = kcycle.run_batched(problem, B, fine_kernel, coarse_apply,
                                   schedule, probe, sequential=False)
            with contextlib.redirect_stdout(sys.stderr):
                kcycle.print_batched_report(r)
            ok = r["x_finite"] and bool(np.isfinite(r["rel_res_true"]).all())
            if schedule is None:
                ok &= all(r["converged"])
            if schedule == "calibrated":
                msg = kcycle.check_calibrated(r)
                print("# calibrated contract: " + (msg or "met"),
                      file=sys.stderr)
                ok &= msg is None
            nrhs, b = args.nrhs, B
            line = {"metric": "wilson_kcycle_batched_ms_per_rhs",
                    "value": round(r["batched_ms"] / nrhs, 2), "unit": "ms",
                    "vs_baseline": nrhs}
    except ValueError as e:
        raise SystemExit(f"--mode kcycle: {e}")
    if not ok:
        raise SystemExit("--mode kcycle: the solve did not converge to a "
                         "finite solution")
    if args.chain:
        # The solver is warm: bench_kcycle has solved once with it.
        t1, tk = (s * 1e3 for s in kcycle.best_s(
            [lambda: chain(r["solver"], b, 1),
             lambda: chain(r["solver"], b, args.chain)], args.device,
            CHAIN_ROUNDS, warmup=False))
        per_solve = (tk - t1) / (args.chain - 1)
        print(f"# steady-state (chain {args.chain}): {per_solve:.3f} "
              f"ms/solve = {per_solve / nrhs:.3f} ms/rhs; chain of 1 "
              f"{t1:.3f} ms, of {args.chain} {tk:.3f} ms", file=sys.stderr)
        out["steady_ms_per_solve"] = per_solve
        line = {"metric": "wilson_kcycle_batched_steady_ms_per_rhs",
                "value": round(per_solve / nrhs, 2), "unit": "ms",
                "vs_baseline": nrhs}
    out.update(line=line, report=r)
    return out


def refined_solver(mg, fine_kernel, coarse_apply):
    """bench.py's refined solver: inner tol 1e-5, max 200, restart 32."""
    return make_refined_solver(mg, tol=REFINE_TOL, inner_tol=1e-5,
                               max_iter=200, restart_freq=32,
                               fine_kernel=fine_kernel,
                               coarse_apply=coarse_apply)


def bench_refine(args) -> dict:
    # bench_refine's config: the n13 kcycle one with the default restarts.
    n_refine = kcycle.kcycle_config(args.size)[0].n_refine
    cfg = KCycleConfig(n_refine=n_refine, coarse_dof=8, nullvec_tol=5e-4,
                       nullvec_max_iter=200,
                       coarsest_direct=not args.no_direct)
    problem = kcycle.build_problem(args.size, args.device, setup="host",
                                   cfg=cfg, b_dtype=torch.complex128)
    try:
        solve = refined_solver(problem["mg"], SOLVE_KERNELS[args.kernel],
                               COARSE_APPLIES[args.coarse_apply])
    except ValueError as e:
        raise SystemExit(f"--mode refine: {e}")
    solve(problem["b"])     # warm-up
    kcycle._sync(args.device)
    t0 = time.perf_counter()
    res = solve(problem["b"])
    kcycle._sync(args.device)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"# wilson refined {args.size}x{args.size}: {res.outer_iters} "
          f"outer passes, {res.inner_iters} inner iters, true complex128 "
          f"resid {res.rel_resid:.3e} (target {REFINE_TOL}, converged="
          f"{res.converged}) in {ms:.3f} ms", file=sys.stderr)
    if not res.converged:
        raise SystemExit(f"--mode refine: not converged to {REFINE_TOL} "
                         f"(history {res.history})")
    return {"line": {"metric": "wilson_refined_1e10_solve_time",
                     "value": round(ms, 2), "unit": "ms",
                     "vs_baseline": res.outer_iters},
            "result": res, "problem": problem}


MODES = {"dslash": bench_dslash, "kcycle": bench_kcycle,
         "refine": bench_refine}


def main(argv=None) -> dict:
    """Runs one mode and prints its JSON line last; returns the mode's
    results (the JSON object under "line")."""
    args = parse(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but no CUDA device")
    out = MODES[args.mode](args)
    out["line"]["device"] = dslash.device_line(args.device)
    print(json.dumps(out["line"]), flush=True)
    return out


if __name__ == "__main__":
    main()
