"""The n13 flagship K-cycle solve, end to end (the port's counterpart of
``bench.py --mode kcycle``).

    python -m qmg_tpu_torch.kcycle --size 512 --device cuda

Gauge field ``gauss_gauge_u1`` at beta = 6 from ``QMGRandom(1337)``;
Wilson2D at m = -0.06 (``--wilson-coeff`` w, default 1) in complex64; the
host-driven setup (``make_kcycle_setup_planes`` from the seeds of
``gauss_seed_planes``) on the device; then a warm-up solve and a
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

``--outer schur`` solves the n19 configuration instead (bench.py
``--mode kcycle --outer schur``): null vectors on the right-block-Jacobi
operator by restarted GCR, rbjacobi coarsening, and on every level the
even-half Schur complement of the rbjacobi operator (RIGHT_SCHUR), b
prepared and x reconstructed inside the solve. No kernel applies a
Schur operator, so ``--fine-kernel`` defaults to ``none`` and
``--coarse-apply`` to ``plain`` there, and other values are refused. The
true residual is that of the reconstructed full x against the exact
ORIGINAL operator.

``--deflate N`` (bench.py ``--mode kcycle --setup device --deflate N``)
solves the coarsest level with CG on its normal operator M^dag M
(MDAGGER_M, no dense inverse) from an initial guess that projects the
right-hand side onto the N lowest eigenpairs of that operator; the timed
setup ends with the deflation stage that computes them
(``StatefulMultigridMG.deflate_coarsest``); with ``--outer schur`` the
levels above stay RIGHT_SCHUR and the deflation stage runs on that
hierarchy's coarsest. ``--no-direct`` keeps the iterative coarsest
(restarted GCR, or CG with ``--deflate``) instead of the dense inverse.
The report adds the coarsest level's Krylov iterations per visit.

``--nrhs N`` (bench.py's ``--nrhs`` mode) solves N right-hand sides in
one batched solve (``make_batched_solver``): the gaussians bench.py draws
after the setup, in one outer FGCR whose lanes each follow their own
sequential trajectory, the rhs axis through K1's and K6's rhs entries
(``--fine-kernel wilson-r1`` or ``none``, ``--coarse-apply plain`` or
``small``). ``--fixed-schedule OUTER`` runs exactly OUTER outer trips on
every lane with the adaptive inner loops, ``OUTER,INNER`` also fixes every
intermediate level at INNER trips (it needs the dense coarsest);
``--calibrated`` takes the outer count of one adaptive solve of a probe
right-hand side (drawn first) plus one, and holds every lane to bench.py's
contract: rel res_sq = res_sq / (tol^2 ||b||^2) at most 1, and the largest
at least 1e-2 (no more than a decade of overshoot in the residual). It
composes with ``--outer schur``, ``--deflate N`` and ``--no-direct``. The
report gives every lane's outer iterations beside its own sequential
solve's, its recursive and true residuals, and the batched and sequential
ms (``--repeats`` alternates them and takes medians).

``--setup adaptive`` builds the hierarchy by the n22 adaptive setup
instead (the reference's tests/n22_wilson_kcycle_adaptive, qmg_tpu's
``make_adaptive_setup_planes``): Richardson-smoothed test vectors on every
level, ``--n-setup N`` passes (default 1) that smooth them with the
current K-cycle and rebuild the levels below, the solve-phase parameters
restored, then the dense coarsest inverse unless ``--no-direct``. The
gauge field, mass and right-hand side are the n13 problem's (the stream
skips the n13 setup's draws), and the setup's gaussians come from the
same stream after the right-hand side. The timed setup covers all of it.
The report adds the setup's stages (``setup_fn.stages``; every setup but
``--setup host`` has them). The adaptive setup takes the original
formulation on one device (no ``--outer schur``, ``--deflate``,
``--shards`` or ``--distributed``), as qmg_tpu's
``make_adaptive_setup_planes`` takes no mesh.

Every report ends with the reference's per-level operator report
(``[QMG-OPS-STATS]``: NULLVEC, the setup's work, and KRYLOV, PRESMOOTH
and POSTSMOOTH over the run's solves) and ``[QMG-ITER-STATS]``
(``query_average_iterations``).

Level 0 can be cut into y-slabs (``parallel.Mesh``; fine kernel
``wilson-r1``, the slab kernel, or ``none``), for the setup and the
solve, in every formulation (``--outer schur``, ``--deflate``, ``--nrhs``,
whose batched solve takes ``--fine-kernel none``, its default there):

    python -m qmg_tpu_torch.kcycle --size 2048 --shards 4
    torchrun --nproc-per-node N -m qmg_tpu_torch.kcycle --distributed

``--shards NY`` holds the NY slabs in this process, on the one device.
``--distributed`` takes one slab per process of a ``torch.distributed``
job, from the environment that ``torchrun`` sets (NCCL for ``--device
cuda``, each rank on the card of its LOCAL_RANK; gloo for ``cpu``). The
setup is the sharded one (``make_kcycle_setup_planes(mesh=)``) from the
seeds of ``gauss_seed_planes`` on the same stream, so the hierarchy and b
are the unsharded ones: every rank builds its slab of level 0 and the
coarse levels whole, and checks them against the other ranks' copies.
Rank 0 prints the report, with the setup's seconds and the bytes each
collective moved (``Mesh.sent``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .lattice import Lattice2D
from .operators.wilson import Wilson2D
from .setup import (KCycleConfig, SCHUR_CONFIG, AdaptiveConfig,
                    build_kcycle_hierarchy)
from .setup_planes import (gauss_seed_planes, adaptive_seed_planes,
                           make_adaptive_setup_planes,
                           make_kcycle_setup_planes)
from .solve import (make_solver, make_batched_solver,
                    make_fixed_batched_solver, make_calibrated_batched_solver,
                    FINE_KERNELS)
from .stencil import apply_M, StencilType
from .linalg import norm2sq, reductions, lane_reductions
from .rng import QMGRandom
from .parallel import Mesh, shard_field
from .shard_dslash import make_sharded_dslash
from .wilson_kernel import (wilson_r1_apply, wilson_r1_rhs_apply,
                            wilson_r1_halo_apply, wilson_phase_apply,
                            wilson_split_apply)
from .dslash_kernel import (dslash_apply, dslash_split_apply,
                            dslash_small_apply, dslash_small_rhs_apply)
from . import u1

MASS = -0.06
BETA = 6.0
SEED = 1337
TOL = 1e-5
MAX_ITER = 200
# The CUDA kernels' wrappers by the names the reports use.
KERNELS = {"wilson_r1": wilson_r1_apply,
           "wilson_r1_rhs": wilson_r1_rhs_apply,
           "wilson_r1_halo": wilson_r1_halo_apply,
           "wilson_phase": wilson_phase_apply,
           "wilson_split": wilson_split_apply, "dslash": dslash_apply,
           "dslash_split": dslash_split_apply,
           "dslash_small": dslash_small_apply,
           "dslash_small_rhs": dslash_small_rhs_apply}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


OUTERS = {"original": StencilType.ORIGINAL,
          "schur": StencilType.RIGHT_SCHUR}


SETUPS = ("kcycle", "adaptive")
ADAPTIVE_ONLY = ("the adaptive setup takes the original formulation on one "
                 "device, with no deflation, as qmg_tpu's "
                 "make_adaptive_setup_planes does: it takes no mesh")
HOST_ONLY = ("the host setup (the eager build_kcycle_hierarchy) takes no "
             "mesh and no deflation: deflation is a stage of the device "
             "setup, as in bench.py")
OPS_NAMES = ("NULLVEC", "KRYLOV", "PRESMOOTH", "POSTSMOOTH")


def kcycle_config(size: int, outer: str = "original", deflate: int = 0,
                  direct: bool = True, n_refine: int | None = None):
    """bench.py's kcycle configuration at lattice size ``size`` (with
    ``outer="schur"`` its ``--outer schur`` one, the n19 configuration;
    with ``deflate`` its ``--deflate`` one, a CG coarsest on M^dag M;
    ``direct=False`` its ``--no-direct``; ``n_refine`` in place of the
    depth it takes by size): returns (KCycleConfig, outer restart)."""
    if n_refine is None:
        n_refine = 2 if size <= 256 else (3 if size <= 1024 else 4)
    restart = 16 if size >= 2048 else 32
    inner_restart = 8 if size >= 2048 else 32
    extra = dict(SCHUR_CONFIG) if outer == "schur" else {}
    if deflate:
        extra["coarsest_stencil_app"] = StencilType.MDAGGER_M
    cfg = KCycleConfig(n_refine=n_refine, coarse_dof=8, nullvec_tol=5e-4,
                       nullvec_max_iter=200,
                       inner_restart_freq=inner_restart,
                       coarsest_restart_freq=restart,
                       coarsest_direct=direct and not deflate, **extra)
    return cfg, restart



def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def best_s(fns, device, reps: int, warmup: bool = True) -> list:
    """Seconds of each of ``fns()`` with the device synchronised around
    it, the minimum over ``reps`` rounds that call them in turn, after one
    warm-up round (``warmup``): by the host clock, or on the CPU with one
    intra-op thread by this thread's CPU time, all of the work's there,
    which a thread that the host preempts does not accrue (idle BLAS and
    OpenMP workers spin, so the process's CPU time is not the work's)."""
    clock = (time.thread_time if torch.device(device).type == "cpu"
             and torch.get_num_threads() == 1 else time.perf_counter)
    if warmup:
        for fn in fns:
            fn()
    best = [float("inf")] * len(fns)
    for _ in range(reps):
        for i, fn in enumerate(fns):
            _sync(device)
            t0 = clock()
            fn()
            _sync(device)
            best[i] = min(best[i], clock() - t0)
    return best


def true_residual(op: Wilson2D, b, x, mesh: Mesh | None = None) -> float:
    """||b - M x|| / ||b|| in complex128 with the exact plain apply of the
    operator that was solved (its coefficients promoted to complex128).
    On a distributed ``mesh``, ``op``, ``b`` and ``x`` are the rank's
    blocks: the apply exchanges halos and the norms are summed over the
    ranks."""
    c128 = op.coeffs.to(torch.complex128)
    b128, x128 = b.to(torch.complex128), x.to(torch.complex128)
    if mesh is None or not mesh.distributed:
        r = b128 - apply_M(c128, x128)
        return float(torch.sqrt(norm2sq(r) / norm2sq(b128)))
    _, norm2sq_all, _ = reductions(mesh.all_sum)
    r = b128 - make_sharded_dslash(c128, mesh)(x128)
    return float(torch.sqrt(norm2sq_all(r) / norm2sq_all(b128)))


def profile_solve(solve, b, solve_ms: float, top: int = 12):
    """One solve under torch.profiler: prints its device time as a share
    of ``solve_ms``, the median wall time of the unprofiled solves (the
    profiler's own host cost inflates the profiled wall), the number of
    device kernels, and the kernels with the most device time. Returns
    (device busy ms, device kernels)."""
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
    return busy_us / 1e3, n_kernels


def build_problem(size: int = 512, device="cuda",
                  wilson_coeff: float = 1.0, mesh: Mesh | None = None,
                  outer: str = "original", deflate: int = 0,
                  direct: bool = True, setup: str = "kcycle",
                  n_setup: int = 1, n_refine: int | None = None,
                  cfg: KCycleConfig | None = None,
                  b_dtype=torch.complex64) -> dict:
    """The gauge field, the fine operator (Wilson coefficient
    ``wilson_coeff``), the hierarchy of the ``outer`` formulation and the
    right-hand side (drawn after the setup, as bench.py does); ``rng`` is
    the stream after it. The setup is ``make_kcycle_setup_planes`` from
    the seeds of ``gauss_seed_planes``, the numbers that
    ``build_kcycle_hierarchy`` draws from the same stream level by level
    (timed: ``setup_s``; the setup function and the config are kept as
    ``setup_fn`` and ``cfg``). ``setup="host"`` is bench.py's ``--setup
    host``: ``build_kcycle_hierarchy`` drawing its gaussians from the
    stream as it builds, timed with the draws. On one device both build
    the same hierarchy with the same code (the port's
    ``make_kcycle_setup_planes`` is that build from seeds drawn ahead).
    ``mesh`` is the mesh the solvers will cut level
    0 over, and the setup's too: on a distributed one ``op`` and ``b`` are
    the rank's blocks and ``cut`` takes a whole field to the rank's block;
    in process they are whole and the hierarchy is the unsharded one.
    ``deflate``, ``direct`` and ``n_refine`` as in ``kcycle_config``; a
    deflated setup ends with the deflation stage. ``cfg`` replaces
    ``kcycle_config``'s hierarchy config (bench.py's refine mode: its
    restarts are the defaults), and ``b_dtype`` is the right-hand side's
    dtype (complex128: the gaussian as drawn). ``setup="adaptive"``
    builds the hierarchy of the same problem by the n22 setup with
    ``n_setup`` passes (``adaptive_problem``)."""
    if outer not in OUTERS:
        raise ValueError(f"unknown outer formulation {outer!r}")
    if setup not in SETUPS + ("host",):
        raise ValueError(f"unknown setup {setup!r}")
    if setup == "adaptive" and (mesh is not None or outer != "original"
                                or deflate):
        raise ValueError(ADAPTIVE_ONLY)
    if setup == "host" and (mesh is not None or deflate):
        raise ValueError(HOST_ONLY)
    lat = Lattice2D(size, size, 2)
    rng = QMGRandom(SEED)
    gauge = u1.gauss_gauge_u1(lat, rng, BETA)
    n13_cfg, restart = kcycle_config(size, outer, deflate, direct, n_refine)
    cfg = cfg or n13_cfg
    # The host setup draws its gaussians from the stream as it builds.
    seeds = None if setup == "host" else gauss_seed_planes(lat, cfg, rng)

    def cut(whole):
        if mesh is None or not mesh.distributed:
            return whole
        (block,) = shard_field(whole, mesh, whole.ndim - 3)
        return block.contiguous()

    if setup == "adaptive":
        # The n13 problem's right-hand side, after the n13 setup's draws.
        b = torch.as_tensor(rng.gaussian_cv(lat)).to(device=device,
                                                      dtype=torch.complex64)
        return adaptive_problem(
            {"size": size, "device": device, "gauge": gauge, "b": b,
             "rng": rng, "restart": restart, "mesh": None,
             "outer": "original", "wilson_coeff": wilson_coeff,
             "cut": cut}, n_setup, direct)
    setup_fn = None
    if setup == "host":
        op = Wilson2D(lat, MASS, gauge, wilson_coeff, dtype=torch.complex64,
                      device=device)
        _sync(device)
        t0 = time.perf_counter()
        mg = build_kcycle_hierarchy(lat, op, cfg, rng)
        _sync(device)
        setup_s = time.perf_counter() - t0
    else:
        setup_fn = make_kcycle_setup_planes(
            lat, cfg, MASS, wilson_coeff, dtype=torch.complex64,
            device=device, deflate_low=deflate, mesh=mesh)
        mg = setup_fn(gauge, *seeds)
        setup_s = setup_fn.seconds
    b = cut(torch.as_tensor(rng.gaussian_cv(lat)).to(device=device,
                                                      dtype=b_dtype))
    return {"size": size, "device": device, "op": mg.get_stencil(0),
            "mg": mg, "b": b, "restart": restart,
            "setup_s": setup_s, "mesh": mesh, "outer": outer,
            "gauge": gauge, "rng": rng, "wilson_coeff": wilson_coeff,
            "setup": (setup if mesh is None else "sharded kcycle"),
            "stages": None if setup_fn is None else setup_fn.stages,
            "cut": cut, "cfg": cfg, "setup_fn": setup_fn}


def adaptive_problem(problem: dict, n_setup: int = 1, direct: bool = True,
                     seeds=None) -> dict:
    """``problem`` (a ``build_problem`` dict: its gauge field, right-hand
    side and restarts) with the hierarchy of the n22 adaptive setup in
    place of its own: ``make_adaptive_setup_planes`` with ``n_setup``
    passes and, with ``direct``, the dense coarsest inverse, from
    ``seeds`` (``adaptive_seed_planes``' pair; by default drawn from
    ``problem["rng"]``). The depth, coarse dof and solve-phase restarts are
    ``kcycle_config``'s. The setup is timed as a whole (``setup_s``) and
    by stage (``stages``); ``seeds`` are kept."""
    size, device = problem["size"], problem["device"]
    lat = Lattice2D(size, size, 2)
    cfg, _ = kcycle_config(size, direct=direct)
    acfg = AdaptiveConfig(n_refine=cfg.n_refine, coarse_dof=cfg.coarse_dof,
                          n_setup=n_setup,
                          inner_restart_freq=cfg.inner_restart_freq,
                          coarsest_restart_freq=cfg.coarsest_restart_freq)
    if seeds is None:
        seeds = adaptive_seed_planes(lat, acfg, problem["rng"])
    setup_fn = make_adaptive_setup_planes(
        lat, acfg, MASS, problem["wilson_coeff"], dtype=torch.complex64,
        device=device, coarsest_direct=direct)
    _sync(device)
    t0 = time.perf_counter()
    mg = setup_fn(problem["gauge"], *seeds)
    _sync(device)
    return dict(problem, op=mg.get_stencil(0), mg=mg,
                setup_s=time.perf_counter() - t0, setup="adaptive",
                n_setup=n_setup, stages=setup_fn.stages, seeds=seeds)


def run_solver(problem: dict, fine_kernel: str | None = "wilson-r1",
               coarse_apply: str = "plain", coeff_dtype=None,
               profile: bool = False, repeats: int = 1) -> dict:
    """One solver on ``problem``'s hierarchy, in its outer formulation: a
    warm-up solve and ``repeats`` timed solves (the median is reported);
    ``profile`` adds one profiled solve after the timed ones (CUDA only;
    its device time and kernel count are reported too). ``launches`` are
    the kernel launches per timed solve. Level 0 is cut over
    ``problem["mesh"]`` when there is one. The Schur formulation takes
    ``fine_kernel=None``."""
    device, mg, b = problem["device"], problem["mg"], problem["b"]
    mesh, outer = problem["mesh"], problem["outer"]
    solve = make_solver(mg, tol=TOL, max_iter=MAX_ITER,
                        restart_freq=problem["restart"],
                        fine_kernel=fine_kernel, coarse_apply=coarse_apply,
                        coeff_dtype=coeff_dtype, mesh=mesh,
                        outer_type=OUTERS[outer])
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
    busy_ms, n_kernels = (profile_solve(solve, b, solve_s * 1e3) if profile
                          else (None, None))
    _, norm2sq_all, _ = reductions(
        mesh.all_sum if mesh is not None and mesh.distributed else None)
    # The recursive residual is the solved (prepared) system's.
    rhs = problem["op"].prepare_M(b, OUTERS[outer])
    rel_rec = float(torch.sqrt(res.res_sq / norm2sq_all(rhs)))
    level_iters = carry["iters"].tolist()
    return {
        "size": problem["size"],
        "outer": outer,
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
        "mesh": mesh,
        "rel_res_true": true_residual(problem["op"], b, res.x, mesh),
        "x_finite": bool(torch.isfinite(torch.view_as_real(res.x)).all()),
        "x_shape": tuple(res.x.shape),
        "setup_s": problem["setup_s"],
        "solve_ms": solve_s * 1e3,
        "solve_ms_all": [t * 1e3 for t in times_s],
        "ms_per_iter": solve_s * 1e3 / max(res.iters, 1),
        "counts": carry["counts"].tolist(),
        "level_iters": level_iters,
        # Each Krylov iteration of the level above visits the coarsest once.
        "coarsest_iters_per_visit": (level_iters[-1] / level_iters[-2]
                                     if len(level_iters) > 1
                                     and level_iters[-2] else None),
        "coarsest": mg.level_types()[-1].name.lower()
        + (" direct" if mg.coarsest_solve.direct
           and mg.coarsest_dinv is not None else "")
        + (f", deflated by {mg.coarsest_evecs.shape[0]} eigenpairs"
           if mg.coarsest_evecs is not None and mg.coarsest_solve.deflate
           else ""),
        "launches": launches,
        "device_busy_ms": busy_ms,      # of the profiled solve, or None
        "device_kernels": n_kernels,
        "setup": problem["setup"],
        "setup_stages": problem["stages"],
        # The hierarchy's trackers: the setup's work, then every solve so
        # far (this run's warm-up, timed and profiled ones included).
        "ops": mg.tracker["counts"].tolist(),
        "avg_iters": mg.query_average_iterations(),
        "solver": solve,
    }


def run_kcycle(size: int = 512, device="cuda",
               fine_kernel: str | None = "wilson-r1",
               coarse_apply: str = "plain", coeff_dtype=None,
               profile: bool = False, repeats: int = 1,
               wilson_coeff: float = 1.0, mesh: Mesh | None = None,
               outer: str = "original", deflate: int = 0,
               direct: bool = True, setup: str = "kcycle",
               n_setup: int = 1) -> dict:
    """Setup + one solver (``build_problem`` then ``run_solver``)."""
    return run_solver(build_problem(size, device, wilson_coeff, mesh, outer,
                                    deflate, direct, setup, n_setup),
                      fine_kernel, coarse_apply, coeff_dtype, profile=profile,
                      repeats=repeats)


def bench_rhs(problem: dict, nrhs: int) -> torch.Tensor:
    """bench.py's ``--nrhs`` right-hand sides: ``problem``'s own (the first
    gaussian drawn after the setup) and ``nrhs - 1`` more from the stream
    after it, (nrhs, *cv_shape) on the problem's device (the rank's
    blocks on a distributed mesh)."""
    lat = Lattice2D(problem["size"], problem["size"], 2)
    more = [problem["cut"](torch.as_tensor(problem["rng"].gaussian_cv(
        lat)).to(device=problem["device"], dtype=torch.complex64))
        for _ in range(nrhs - 1)]
    return torch.stack([problem["b"]] + more)


def batched_inputs(problem: dict, nrhs: int, calibrated: bool = False):
    """(problem, B, probe): bench.py's ``--nrhs`` right-hand sides
    (``bench_rhs``) and, for ``--calibrated``, the probe right-hand side,
    which bench.py draws first: the problem's own b becomes the probe and
    the problem takes the next gaussian of the stream as its b."""
    probe = None
    if calibrated:
        probe = problem["b"]
        lat = Lattice2D(problem["size"], problem["size"], 2)
        problem = dict(problem, b=problem["cut"](torch.as_tensor(
            problem["rng"].gaussian_cv(lat)).to(device=problem["device"],
                                                dtype=torch.complex64)))
    return problem, bench_rhs(problem, nrhs), probe


def run_batched(problem: dict, B, fine_kernel: str | None = "wilson-r1",
                coarse_apply: str = "plain", schedule=None, probe=None,
                repeats: int = 1, profile: bool = False,
                sequential: bool = True) -> dict:
    """One batched solver on ``problem``'s hierarchy in its outer
    formulation, on the right-hand sides ``B`` (nrhs, *cv_shape), beside
    the sequential solves of the same fields (``make_solver``, one per
    lane): a warm-up of each, then ``repeats`` turns of one batched solve
    and the nrhs sequential ones (medians reported). ``schedule`` is None
    (adaptive), ``(outer, inner)`` (``make_fixed_batched_solver``: exactly
    ``outer`` outer trips; ``inner`` not None also fixes every
    intermediate level at that many trips, for this solver only) or
    "calibrated" (``make_calibrated_batched_solver`` on ``probe``).
    ``launches`` are the kernel launches of one batched solve.
    ``sequential=False`` leaves the sequential solves out (their entries
    are None)."""
    device, mg, op = problem["device"], problem["mg"], problem["op"]
    mesh = problem["mesh"]
    outer_type = OUTERS[problem["outer"]]
    kw = dict(tol=TOL, max_iter=MAX_ITER, restart_freq=problem["restart"],
              fine_kernel=fine_kernel, coarse_apply=coarse_apply,
              outer_type=outer_type, mesh=mesh)
    saved = list(mg.level_solve_list)
    try:
        outer_iters = None
        if schedule == "calibrated":
            solve, outer_iters = make_calibrated_batched_solver(mg, probe,
                                                                **kw)
        elif schedule is not None:
            outer_iters, inner = schedule
            if inner is not None:
                for lvl in range(1, mg.get_num_levels() - 1):
                    mg.level_solve_list[lvl] = dataclasses.replace(
                        saved[lvl], fixed_trips=True,
                        intermediate_iters=int(inner))
            solve = make_fixed_batched_solver(
                mg, outer_iters, allow_masked_inner=inner is None, **kw)
        else:
            solve = make_batched_solver(mg, **kw)
        single = make_solver(mg, **kw)
        solve(B)        # warm-up
        if sequential:
            single(B[0])
        _sync(device)
        batched_s, sequential_s, launches, seq = [], [], None, None
        for _ in range(repeats):
            launches0 = launch_counts()
            t0 = time.perf_counter()
            res, carry = solve(B)
            _sync(device)
            batched_s.append(time.perf_counter() - t0)
            launches = {k: n - launches0[k]
                        for k, n in launch_counts().items()}
            if sequential:
                t0 = time.perf_counter()
                seq = [single(b) for b in B]
                _sync(device)
                sequential_s.append(time.perf_counter() - t0)
        busy_ms, n_kernels = (
            profile_solve(solve, B, float(np.median(batched_s)) * 1e3)
            if profile else (None, None))
    finally:
        mg.level_solve_list = saved
    # Each lane's rel res_sq: its squared recursive residual over tol^2
    # ||rhs||^2 of the system it solved (bench.py's calibrated contract).
    _, norm2sq_lanes, _ = lane_reductions(
        mesh.all_sum if mesh is not None and mesh.distributed else None)
    rel_sq = (res.res_sq / (TOL ** 2 * norm2sq_lanes(
        op.prepare_M(B, outer_type)))).cpu().numpy()
    nrhs = B.shape[0]
    return {
        "size": problem["size"], "outer": problem["outer"],
        "device": str(device), "nrhs": nrhs, "mesh": mesh,
        "levels": [f"{lat.x_len}x{lat.y_len} nc{lat.nc}"
                   for lat in mg.lattice_list],
        "fine_kernel": fine_kernel, "coarse_apply": coarse_apply,
        "level_applies": solve.level_applies,
        "schedule": ("adaptive" if schedule is None else
                     f"calibrated {outer_iters}" if schedule == "calibrated"
                     else "fixed " + ",".join(
                         str(v) for v in schedule if v is not None)),
        "iters": res.iters.tolist(),
        "sequential_iters": seq and [r.iters for r, _ in seq],
        "converged": res.converged.cpu().tolist(),
        "rel_res_recursive": (np.sqrt(rel_sq) * TOL).tolist(),
        "rel_res_sq_of_target": rel_sq.tolist(),
        "rel_res_true": [true_residual(op, B[k], res.x[k], mesh)
                         for k in range(nrhs)],
        "sequential_rel_res_true": seq and [
            true_residual(op, B[k], seq[k][0].x, mesh) for k in range(nrhs)],
        "x_finite": bool(torch.isfinite(torch.view_as_real(res.x)).all()),
        "level_iters": carry["iters"].tolist(),
        "batched_ms": float(np.median(batched_s)) * 1e3,
        "sequential_ms": (float(np.median(sequential_s)) * 1e3
                          if sequential else None),
        "batched_ms_all": [t * 1e3 for t in batched_s],
        "sequential_ms_all": [t * 1e3 for t in sequential_s],
        "launches": launches,
        "device_busy_ms": busy_ms,
        "device_kernels": n_kernels,
        "setup_s": problem["setup_s"],
        "solver": solve,
    }


def check_calibrated(r: dict):
    """bench.py's calibrated contract on a ``run_batched`` report: every
    lane meets the tolerance (rel res_sq <= 1) and the largest is at least
    1e-2. Returns the failure's message, or None."""
    rel = np.asarray(r["rel_res_sq_of_target"])
    if rel.max() > 1.0:
        return (f"calibrated schedule missed the tolerance: worst rel "
                f"res_sq {rel.max():.3e} of the target")
    if rel.max() < 1e-2:
        return (f"calibrated schedule overshoots by more than a decade: "
                f"largest rel res_sq {rel.max():.3e} of the target")
    return None


def print_batched_report(r: dict):
    if r["mesh"] is not None:
        print(f"level 0 cut over {r['mesh']}")
    print(f"kcycle {r['size']}^2 on {r['device']}, outer {r['outer']} "
          f"({OUTERS[r['outer']].name}), {r['nrhs']} right-hand sides in one "
          f"batched solve, schedule {r['schedule']}: fine_kernel "
          f"{r['fine_kernel']}, coarse_apply {r['coarse_apply']}")
    print("level applies: " + ", ".join(
        f"{lvl} {name}" for lvl, name in zip(r["levels"],
                                             r["level_applies"])))
    seq = r["sequential_ms"] is not None
    print("lane: outer iterations (sequential), recursive relres, rel "
          "res_sq of the target, true relres (sequential's)" if seq else
          "lane: outer iterations, recursive relres, rel res_sq of the "
          "target, true relres")
    for k in range(r["nrhs"]):
        print(f"  lane {k}: {r['iters'][k]}"
              + (f" ({r['sequential_iters'][k]})" if seq else "")
              + f", {r['rel_res_recursive'][k]:.3e}, "
              f"{r['rel_res_sq_of_target'][k]:.3e}, "
              f"{r['rel_res_true'][k]:.3e}"
              + (f" ({r['sequential_rel_res_true'][k]:.3e})" if seq else ""))
    print(f"batched solve ms: {r['batched_ms']:.3f} = "
          f"{r['batched_ms'] / r['nrhs']:.3f} per rhs"
          + (f"; sequential {r['sequential_ms']:.3f} = "
             f"{r['sequential_ms'] / r['nrhs']:.3f} per rhs" if seq else "")
          + (" (medians of alternating turns: batched "
             + ", ".join(f"{t:.3f}" for t in r["batched_ms_all"])
             + "; sequential "
             + ", ".join(f"{t:.3f}" for t in r["sequential_ms_all"]) + ")"
             if len(r["batched_ms_all"]) > 1 and seq else ""))
    print(f"setup s: {r['setup_s']:.3f}")
    if r["mesh"] is not None:
        print(f"bytes handed to the collectives: {r['mesh'].sent}")
    print(f"per-lane krylov iterations per level {r['level_iters']}")
    print("kernel launches per batched solve: " + ", ".join(
        f"{k} {n}" for k, n in r["launches"].items()))


def mesh_from_env(device: str):
    """(mesh, device) of this process in a ``torch.distributed`` job
    started by ``torchrun``: one y-slab per rank, NCCL for a CUDA device
    (the card of LOCAL_RANK), gloo for the CPU. Starts the process group;
    the caller ends it with ``destroy_process_group``."""
    import torch.distributed as dist
    if torch.device(device).type == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=torch.device(device))
    else:
        dist.init_process_group("gloo")
    return Mesh(dist.get_world_size(), 1, dist.group.WORLD), device


def print_report(r: dict):
    if r["mesh"] is not None:
        print(f"level 0 cut over {r['mesh']}")
    print(f"kcycle {r['size']}^2 w={r['wilson_coeff']:g} on {r['device']}, "
          f"outer {r['outer']} ({OUTERS[r['outer']].name}): fine_kernel "
          f"{r['fine_kernel']}, coarse_apply {r['coarse_apply']}, "
          f"coefficients {r['coeff_dtype']}")
    print("level applies: " + ", ".join(
        f"{lvl} {name}" for lvl, name in zip(r["levels"],
                                             r["level_applies"])))
    print(f"coarsest solve: {r['coarsest']}")
    print(f"outer iterations: {r['iters']} (converged {r['converged']})")
    print(f"relative residual: recursive {r['rel_res_recursive']:.3e}"
          + (" (of the prepared even-half system)" if r["outer"] == "schur"
             else "")
          + f", true (c128, full x, ORIGINAL operator) "
          f"{r['rel_res_true']:.3e}")
    print(f"setup s: {r['setup_s']:.3f} ({r['setup']} setup)")
    if r["mesh"] is not None:
        print(f"bytes handed to the collectives: {r['mesh'].sent}")
    if r["setup_stages"]:
        print("setup stages s: " + ", ".join(
            f"{label} {sec:.3f}" for label, sec in r["setup_stages"]))
    print(f"solve ms: {r['solve_ms']:.3f}, ms/iter: {r['ms_per_iter']:.3f}"
          + (f" (median of {len(r['solve_ms_all'])}: "
             + ", ".join(f"{t:.3f}" for t in r["solve_ms_all"]) + ")"
             if len(r["solve_ms_all"]) > 1 else ""))
    print("per-level op counts [nullvec, krylov, presmooth, postsmooth]: "
          f"{r['counts']}; krylov iterations per level {r['level_iters']}"
          + (f"; coarsest iterations per visit "
             f"{r['coarsest_iters_per_visit']:.2f}"
             if r["coarsest_iters_per_visit"] is not None else ""))
    print("kernel launches per timed solve: " + ", ".join(
        f"{k} {n}" for k, n in r["launches"].items()))
    for lvl, counts in enumerate(r["ops"]):
        print(f"[QMG-OPS-STATS]: Level {lvl} " + " ".join(
            f"{name} {n}" for name, n in zip(OPS_NAMES, counts)))
    print("[QMG-ITER-STATS]: avg iterations per level "
          + " ".join(f"{v:.2f}" for v in r["avg_iters"]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--device", default="cuda")
    p.add_argument("--outer", default="original", choices=list(OUTERS),
                   help="outer formulation: original (n13) or schur (n19: "
                        "RIGHT_SCHUR on every level)")
    p.add_argument("--fine-kernel", default=None,
                   choices=[*FINE_KERNELS, "none"],
                   help="default wilson-r1 (none with --outer schur)")
    p.add_argument("--wilson-coeff", type=float, default=1.0,
                   help="Wilson2D's Wilson coefficient w (wilson-r1 needs "
                        "1)")
    p.add_argument("--coarse-apply", default=None,
                   choices=["plain", "gather", "small"],
                   help="default plain")
    p.add_argument("--coeff-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="coefficient stream of the matrix kernels")
    p.add_argument("--shards", type=int, default=None, metavar="NY",
                   help="cut level 0 into NY y-slabs held in this process")
    p.add_argument("--distributed", action="store_true",
                   help="one y-slab per rank of the torch.distributed job "
                        "that torchrun started")
    p.add_argument("--deflate", type=int, default=0, metavar="N",
                   help="CG coarsest on M^dag M, deflated by its N lowest "
                        "eigenpairs (the setup's deflation stage)")
    p.add_argument("--no-direct", action="store_true",
                   help="iterative coarsest instead of the dense inverse")
    p.add_argument("--setup", default="kcycle", choices=list(SETUPS),
                   help="hierarchy setup: kcycle (n13 null vectors) or "
                        "adaptive (n22)")
    p.add_argument("--n-setup", type=int, default=1, metavar="N",
                   help="adaptive passes of --setup adaptive")
    p.add_argument("--nrhs", type=int, default=1,
                   help="solve this many right-hand sides in one batched "
                        "solve, beside their sequential solves")
    p.add_argument("--fixed-schedule", default=None, metavar="OUTER[,INNER]",
                   help="--nrhs mode: exactly OUTER outer trips (adaptive "
                        "inner loops); OUTER,INNER also fixes every "
                        "intermediate level at INNER trips")
    p.add_argument("--calibrated", action="store_true",
                   help="--nrhs mode: the outer trips of one adaptive "
                        "probe solve + 1, held to bench.py's contract")
    p.add_argument("--repeats", type=int, default=1,
                   help="timed solves; the median is reported")
    p.add_argument("--profile", action="store_true",
                   help="also profile one solve (device time by kernel)")
    args = p.parse_args(argv)
    if args.outer == "schur":
        if args.fine_kernel not in (None, "none") or \
                args.coarse_apply not in (None, "plain"):
            raise SystemExit("--outer schur takes --fine-kernel none and "
                             "--coarse-apply plain: no kernel applies a "
                             "Schur operator")
    schedule = batched_schedule(args)
    if args.deflate < 0:
        raise SystemExit("--deflate takes a number of eigenpairs >= 0")
    if args.setup == "adaptive" and (
            args.outer == "schur" or args.deflate or args.shards is not None
            or args.distributed):
        raise SystemExit(f"--setup adaptive: {ADAPTIVE_ONLY}")
    if args.n_setup < 0:
        raise SystemExit("--n-setup takes a number of passes >= 0")
    sharded = args.distributed or args.shards is not None
    if args.fine_kernel is None:
        # No kernel applies a Schur operator, and K7 takes no rhs axis.
        args.fine_kernel = ("none" if args.outer == "schur"
                            or (sharded and schedule is not False)
                            else "wilson-r1")
    if args.coarse_apply is None:
        args.coarse_apply = "plain"
    is_cuda = torch.device(args.device).type == "cuda"
    if is_cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but no CUDA device")
    if args.profile and not is_cuda:
        raise SystemExit("--profile measures the card; use --device cuda")
    if args.distributed and args.shards is not None:
        raise SystemExit("--shards and --distributed exclude each other")
    if sharded and args.fine_kernel not in ("wilson-r1", "none"):
        raise SystemExit("--shards and --distributed take --fine-kernel "
                         "wilson-r1 (the slab kernel) or none; the other "
                         "kernels are single-device")
    mesh, device, is_root = None, args.device, True
    if args.distributed:
        mesh, device = mesh_from_env(args.device)
        is_root = mesh.blocks == [(0, 0)]
    elif args.shards is not None:
        mesh = Mesh(args.shards, 1)
    try:
        if schedule is not False:
            return _main_batched(args, schedule, mesh, device, is_root)
        r = run_kcycle(args.size, device,
                       None if args.fine_kernel == "none"
                       else args.fine_kernel,
                       args.coarse_apply,
                       torch.bfloat16 if args.coeff_dtype == "bfloat16"
                       else None,
                       profile=args.profile, repeats=args.repeats,
                       wilson_coeff=args.wilson_coeff, mesh=mesh,
                       outer=args.outer, deflate=args.deflate,
                       direct=not args.no_direct, setup=args.setup,
                       n_setup=args.n_setup)
    finally:
        if args.distributed:
            import torch.distributed as dist
            dist.destroy_process_group()
    if is_root:
        print_report(r)
    if not (r["converged"] and np.isfinite(r["rel_res_true"])):
        raise SystemExit(1)


def batched_schedule(args):
    """False for one right-hand side (``args.nrhs`` 1), else the batched
    schedule that ``run_batched`` takes, from ``args.fixed_schedule`` and
    ``args.calibrated``; the flags' refusals."""
    if args.nrhs < 1:
        raise SystemExit("--nrhs takes a number of right-hand sides >= 1")
    if args.nrhs == 1:
        if args.fixed_schedule or args.calibrated:
            raise SystemExit("--fixed-schedule and --calibrated belong to "
                             "the --nrhs mode (--nrhs > 1)")
        return False
    if args.calibrated:
        if args.fixed_schedule:
            raise SystemExit("--calibrated picks its own outer trip count; "
                             "drop --fixed-schedule")
        return "calibrated"
    if args.fixed_schedule:
        try:
            parts = [int(v) for v in args.fixed_schedule.split(",")]
        except ValueError:
            parts = []
        if len(parts) not in (1, 2) or min(parts) < 1:
            raise SystemExit("--fixed-schedule takes OUTER or OUTER,INNER "
                             "(positive trip counts)")
        return (parts[0], parts[1] if len(parts) == 2 else None)
    return None


def _main_batched(args, schedule, mesh=None, device=None, is_root=True):
    """The ``--nrhs`` mode of ``main``, with level 0 cut over ``mesh``
    when there is one."""
    device = device or args.device
    problem = build_problem(args.size, device, args.wilson_coeff,
                            mesh=mesh, outer=args.outer,
                            deflate=args.deflate, direct=not args.no_direct,
                            setup=args.setup, n_setup=args.n_setup)
    problem, B, probe = batched_inputs(problem, args.nrhs,
                                       schedule == "calibrated")
    try:
        r = run_batched(problem, B,
                        None if args.fine_kernel == "none"
                        else args.fine_kernel, args.coarse_apply, schedule,
                        probe, repeats=args.repeats, profile=args.profile)
    except ValueError as e:
        raise SystemExit(f"--nrhs: {e}")
    if is_root:
        print_batched_report(r)
    failed = not (r["x_finite"] and np.isfinite(r["rel_res_true"]).all())
    if schedule is None:
        failed |= not all(r["converged"])
    if schedule == "calibrated":
        msg = check_calibrated(r)
        print("calibrated contract: " + (msg or "met (largest rel res_sq "
                                         "in [1e-2, 1])"))
        failed |= msg is not None
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
