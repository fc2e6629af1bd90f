"""The n13 flagship K-cycle solve, end to end (the port's counterpart of
``bench.py --mode kcycle``).

    python -m qmg_tpu_torch.kcycle --size 512 --device cuda

Gauge field ``gauss_gauge_u1`` at beta = 6 from ``QMGRandom(1337)``;
Wilson2D at m = -0.06 (``--wilson-coeff`` w, default 1) in complex64; the
host-driven setup
(``build_kcycle_hierarchy``) on the device; then a warm-up solve and a
timed solve to tol 1e-5 (max 200 outer iterations). Inside the K-cycle
level 0 takes ``--fine-kernel`` (default the rank-1 Wilson kernel, which
needs w = 1; ``wilson-phase`` is the Wilson kernel for any w; ``matrix``,
``matrix-split`` and ``small`` are the generic stencil kernels, ``none``
the plain apply) with ``--coeff-dtype`` coefficients,
and the coarse levels ``--coarse-apply`` (plain, gather, or the
small-lattice kernel where it fits). Prints one line each: the apply of
every level, outer iterations, recursive and true relative residual
(complex128, exact operator), setup s, solve ms, ms/iter, per-level
operator counts and the launches of each kernel. ``--repeats N`` times N
solves and reports the median; ``--profile`` adds one solve under
torch.profiler (device busy share and the kernels with the most device
time).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .lattice import Lattice2D
from .operators.wilson import Wilson2D
from .setup import KCycleConfig, build_kcycle_hierarchy
from .solve import make_solver, FINE_KERNELS
from .stencil import apply_M, make_coeffs
from .linalg import norm2sq
from .rng import QMGRandom
from .wilson_kernel import (wilson_r1_apply, wilson_phase_apply,
                            wilson_split_apply)
from .dslash_kernel import (dslash_apply, dslash_split_apply,
                            dslash_small_apply)
from . import u1

MASS = -0.06
BETA = 6.0
SEED = 1337
TOL = 1e-5
MAX_ITER = 200
# The CUDA kernels' wrappers by the names the reports use.
KERNELS = {"wilson_r1": wilson_r1_apply, "wilson_phase": wilson_phase_apply,
           "wilson_split": wilson_split_apply, "dslash": dslash_apply,
           "dslash_split": dslash_split_apply,
           "dslash_small": dslash_small_apply}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def kcycle_config(size: int):
    """bench.py's kcycle configuration at lattice size ``size``: returns
    (KCycleConfig, outer restart)."""
    n_refine = 2 if size <= 256 else (3 if size <= 1024 else 4)
    restart = 16 if size >= 2048 else 32
    inner_restart = 8 if size >= 2048 else 32
    cfg = KCycleConfig(n_refine=n_refine, coarse_dof=8, nullvec_tol=5e-4,
                       nullvec_max_iter=200,
                       inner_restart_freq=inner_restart,
                       coarsest_restart_freq=restart, coarsest_direct=True)
    return cfg, restart


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def true_residual(op: Wilson2D, b, x) -> float:
    """||b - M x|| / ||b|| in complex128 with the exact plain apply of the
    operator that was solved (its coefficients promoted to complex128)."""
    c = op.coeffs
    c128 = make_coeffs(c.lat, clover=c.clover.to(torch.complex128),
                       hopping=c.hopping.to(torch.complex128),
                       shift=c.shift, eo_shift=c.eo_shift,
                       dof_shift=c.dof_shift, dtype=torch.complex128)
    b128 = b.to(torch.complex128)
    r = b128 - apply_M(c128, x.to(torch.complex128))
    return float(torch.sqrt(norm2sq(r) / norm2sq(b128)))


def profile_solve(solve, b, solve_ms: float, top: int = 12):
    """One solve under torch.profiler: prints its device time as a share
    of ``solve_ms``, the median wall time of the unprofiled solves (the
    profiler's own host cost inflates the profiled wall), the number of
    device kernels, and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    print(f"profile: device busy {busy_us / 1e3:.3f} ms = "
          f"{100 * busy_us / (solve_ms * 1e3):.1f}% of the unprofiled solve "
          f"({solve_ms:.3f} ms); wall with the profiler on "
          f"{wall_us / 1e3:.3f} ms; {n_kernels} device kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:7d} x  "
              f"{e.key[:90]}")


def build_problem(size: int = 512, device="cuda",
                  wilson_coeff: float = 1.0) -> dict:
    """The gauge field, the fine operator (Wilson coefficient
    ``wilson_coeff``), the hierarchy (setup timed) and the right-hand side
    (drawn after the setup, as bench.py does)."""
    lat = Lattice2D(size, size, 2)
    rng = QMGRandom(SEED)
    gauge = u1.gauss_gauge_u1(lat, rng, BETA)
    cfg, restart = kcycle_config(size)

    _sync(device)
    t0 = time.perf_counter()
    op = Wilson2D(lat, MASS, gauge, wilson_coeff, dtype=torch.complex64,
                  device=device)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    _sync(device)
    setup_s = time.perf_counter() - t0
    b = torch.as_tensor(rng.gaussian_cv(lat)).to(device=device,
                                                  dtype=torch.complex64)
    return {"size": size, "device": device, "op": op, "mg": mg, "b": b,
            "restart": restart, "setup_s": setup_s}


def run_solver(problem: dict, fine_kernel: str | None = "wilson-r1",
               coarse_apply: str = "plain", coeff_dtype=None,
               profile: bool = False, repeats: int = 1) -> dict:
    """One solver on ``problem``'s hierarchy: a warm-up solve and
    ``repeats`` timed solves (the median is reported); ``profile`` adds
    one profiled solve after the timed ones (CUDA only). ``launches`` are
    the kernel launches per timed solve."""
    device, mg, b = problem["device"], problem["mg"], problem["b"]
    solve = make_solver(mg, tol=TOL, max_iter=MAX_ITER,
                        restart_freq=problem["restart"],
                        fine_kernel=fine_kernel, coarse_apply=coarse_apply,
                        coeff_dtype=coeff_dtype)
    solve(b)  # warm-up
    _sync(device)
    launches0 = launch_counts()
    times_s = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res, carry = solve(b)
        _sync(device)
        times_s.append(time.perf_counter() - t0)
    launches = {k: (n - launches0[k]) // repeats
                for k, n in launch_counts().items()}
    solve_s = float(np.median(times_s))
    if profile:
        profile_solve(solve, b, solve_s * 1e3)
    rel_rec = float(torch.sqrt(res.res_sq / norm2sq(b)))
    return {
        "size": problem["size"],
        "wilson_coeff": problem["op"].wilson_coeff,
        "device": str(device),
        "levels": [f"{lat.x_len}x{lat.y_len} nc{lat.nc}"
                   for lat in mg.lattice_list],
        "fine_kernel": fine_kernel,
        "coarse_apply": coarse_apply,
        "coeff_dtype": str(coeff_dtype or torch.float32).split(".")[-1],
        "level_applies": solve.level_applies,
        "iters": res.iters,
        "converged": bool(res.converged),
        "rel_res_recursive": rel_rec,
        "rel_res_true": true_residual(problem["op"], b, res.x),
        "x_finite": bool(torch.isfinite(torch.view_as_real(res.x)).all()),
        "x_shape": tuple(res.x.shape),
        "setup_s": problem["setup_s"],
        "solve_ms": solve_s * 1e3,
        "solve_ms_all": [t * 1e3 for t in times_s],
        "ms_per_iter": solve_s * 1e3 / max(res.iters, 1),
        "counts": carry["counts"].tolist(),
        "level_iters": carry["iters"].tolist(),
        "launches": launches,
    }


def run_kcycle(size: int = 512, device="cuda",
               fine_kernel: str | None = "wilson-r1",
               coarse_apply: str = "plain", coeff_dtype=None,
               profile: bool = False, repeats: int = 1,
               wilson_coeff: float = 1.0) -> dict:
    """Setup + one solver (``build_problem`` then ``run_solver``)."""
    return run_solver(build_problem(size, device, wilson_coeff), fine_kernel,
                      coarse_apply, coeff_dtype, profile=profile,
                      repeats=repeats)


def print_report(r: dict):
    print(f"kcycle {r['size']}^2 w={r['wilson_coeff']:g} on {r['device']}: "
          f"fine_kernel "
          f"{r['fine_kernel']}, coarse_apply {r['coarse_apply']}, "
          f"coefficients {r['coeff_dtype']}")
    print("level applies: " + ", ".join(
        f"{lvl} {name}" for lvl, name in zip(r["levels"],
                                             r["level_applies"])))
    print(f"outer iterations: {r['iters']} (converged {r['converged']})")
    print(f"relative residual: recursive {r['rel_res_recursive']:.3e}, "
          f"true (c128) {r['rel_res_true']:.3e}")
    print(f"setup s: {r['setup_s']:.3f}")
    print(f"solve ms: {r['solve_ms']:.3f}, ms/iter: {r['ms_per_iter']:.3f}"
          + (f" (median of {len(r['solve_ms_all'])}: "
             + ", ".join(f"{t:.3f}" for t in r["solve_ms_all"]) + ")"
             if len(r["solve_ms_all"]) > 1 else ""))
    print("per-level op counts [nullvec, krylov, presmooth, postsmooth]: "
          f"{r['counts']}; krylov iterations per level {r['level_iters']}")
    print("kernel launches per timed solve: " + ", ".join(
        f"{k} {n}" for k, n in r["launches"].items()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fine-kernel", default="wilson-r1",
                   choices=[*FINE_KERNELS, "none"])
    p.add_argument("--wilson-coeff", type=float, default=1.0,
                   help="Wilson2D's Wilson coefficient w (wilson-r1 needs "
                        "1)")
    p.add_argument("--coarse-apply", default="plain",
                   choices=["plain", "gather", "small"])
    p.add_argument("--coeff-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="coefficient stream of the matrix kernels")
    p.add_argument("--repeats", type=int, default=1,
                   help="timed solves; the median is reported")
    p.add_argument("--profile", action="store_true",
                   help="also profile one solve (device time by kernel)")
    args = p.parse_args(argv)
    is_cuda = torch.device(args.device).type == "cuda"
    if is_cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but no CUDA device")
    if args.profile and not is_cuda:
        raise SystemExit("--profile measures the card; use --device cuda")
    r = run_kcycle(args.size, args.device,
                   None if args.fine_kernel == "none" else args.fine_kernel,
                   args.coarse_apply,
                   torch.bfloat16 if args.coeff_dtype == "bfloat16"
                   else None,
                   profile=args.profile, repeats=args.repeats,
                   wilson_coeff=args.wilson_coeff)
    print_report(r)
    if not (r["converged"] and np.isfinite(r["rel_res_true"])):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
