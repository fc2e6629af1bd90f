"""The Wilson MG measurement stream (the reference's n16 test, the port's
counterpart of examples/wilson_mg_stream.py).

    python -m qmg_tpu_torch.stream --L 512 --n-refine 3 --batched

Non-compact heatbath evolution of a U(1) gauge field (``u1``; the C++
sweep by default); for every configuration a full setup rebuild from
gaussian seeds drawn ahead (``setup_planes``) on the device, then the
Wilson propagators of two point sources at the origin (one per spin)
through the MG solve, and the folded per-timeslice pion correlator
(summed over parity, x and colour). ``--batched`` solves both sources of
a configuration in one batched solve (``make_batched_solver``). By
default every solver routes level 0 through the rank-1 Wilson kernel and
the small coarse levels through K6 (``fine_kernel="wilson-r1"``,
``coarse_apply="small"``); on the CPU the same options take the kernels'
plain twins. The random numbers are drawn in qmg_tpu's order: the
thermalization, then per configuration the heatbath, the seeds, the
solves; so from the same seed both packages evolve the same
configurations.

Prints ``[QMG-MEAS]`` per configuration, then the mean plaquette, the
correlator (``[QMG-PION]``), effective masses (``[QMG-MASS]``) and the
jackknifed plateau and cosh-fit pion masses (``[QMG-PION-MASS(-FIT)]``).
``--save FILE`` writes the per-configuration correlators as an ``.npz``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .lattice import Lattice2D
from .setup import KCycleConfig
from .setup_planes import make_kcycle_setup_planes, gauss_seed_planes
from .solve import make_solver, make_batched_solver
from .reductions import norm2sq_timeslice
from .rng import QMGRandom
from . import u1, measure

MAX_ITER = 200
FINE_KERNEL = "wilson-r1"
COARSE_APPLY = "small"


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timeslices(x) -> np.ndarray:
    """Per-timeslice |x|^2 of one propagator, float64 on the host."""
    return norm2sq_timeslice(x.to(torch.complex128)).cpu().numpy()


def _lane_printer(icfg: int, t_start: float):
    """A ``make_batched_solver`` trace that prints one line per lane."""
    def trace(k, iters, rsq, true_rsq, bsq):
        rel = torch.sqrt(rsq / bsq).cpu().numpy()
        true = (torch.sqrt(true_rsq / bsq).cpu().numpy()
                if true_rsq is not None else None)
        when = "end" if true is None else "restart"
        for lane in range(len(iters)):
            print(f"[QMG-LANES]: config {icfg} outer trip {k} ({when}, "
                  f"{time.perf_counter() - t_start:.2f}s) lane {lane} "
                  f"iters {int(iters[lane])} rel res {rel[lane]:.3e}"
                  + (f" true {true[lane]:.3e}" if true is not None else ""),
                  flush=True)
    return trace


def run_stream(L=32, beta=6.0, mass=-0.06, n_configs=10, n_therm=1000,
               n_update=100, n_refine=2, coarse_dof=8, tol=2e-6,
               seed=1337, verbose=True, batched=False, device="cuda",
               sweep="native", log=None, fine_kernel=FINE_KERNEL,
               coarse_apply=COARSE_APPLY, trace_lanes=False):
    """Returns (pion_mean, pion_err, plaqs, iters_list, pions), as
    examples/wilson_mg_stream.run_stream does. ``sweep`` is the heatbath's
    ("native" or "numpy"; qmg_tpu takes its native sweep where its library
    is built). ``log``, a list, receives one dict per configuration: its
    plaquette, outer iterations (per source), the correlator, and the
    heatbath, setup and solve seconds (host clock, device synchronised).
    ``fine_kernel`` and ``coarse_apply`` are the solvers' options
    (``make_solver``'s; None and "plain" take the plain applies).
    ``trace_lanes`` prints, for a batched solve, every lane's outer
    iterations and relative residuals (recursive and true) at every
    restart of the outer solve and at its end (``[QMG-LANES]``)."""
    lat = Lattice2D(L, L, 2)
    lat_g = lat.with_nc(1)
    rng = QMGRandom(seed)
    cfg = KCycleConfig(n_refine=n_refine, coarse_dof=coarse_dof,
                       nullvec_tol=5e-4, nullvec_max_iter=200,
                       coarsest_direct=True)
    setup_fn = make_kcycle_setup_planes(lat, cfg, mass, device=device)
    solver_kw = dict(tol=tol, max_iter=MAX_ITER, restart_freq=32,
                     fine_kernel=fine_kernel, coarse_apply=coarse_apply)

    # Point sources at the origin, one per spin (reference n16:468).
    srcs = torch.stack([measure.point_source(lat, 0, 0, c,
                                             dtype=torch.complex64,
                                             device=device)
                        for c in range(2)])

    ph = np.zeros((2, 2, L, lat_g.xh))
    if verbose:
        print(f"[QMG-NOTE]: thermalizing {n_therm} heatbath updates",
              flush=True)
    t0 = time.perf_counter()
    ph = u1.heatbath_noncompact_update(ph, lat_g, beta, n_therm, rng, sweep)
    if verbose:
        print(f"[QMG-NOTE]: thermalized in {time.perf_counter() - t0:.1f}s",
              flush=True)

    pions, plaqs, iters_list = [], [], []
    t_start = time.time()
    for icfg in range(n_configs):
        t0 = time.perf_counter()
        ph = u1.heatbath_noncompact_update(ph, lat_g, beta, n_update, rng,
                                           sweep)
        t1 = time.perf_counter()
        seeds = gauss_seed_planes(lat, cfg, rng)
        mg = setup_fn(np.exp(1j * ph), *seeds)
        _sync(device)
        t2 = time.perf_counter()
        pion = np.zeros(L)
        ok = True
        if batched:
            trace = _lane_printer(icfg, t2) if trace_lanes else None
            res, _ = make_batched_solver(mg, trace=trace, **solver_kw)(srcs)
            its = [int(i) for i in res.iters]
            it = max(its)
            if it >= MAX_ITER:
                ok = False
            else:
                for k in range(len(srcs)):
                    pion += measure.fold_correlator(_timeslices(res.x[k]))
        else:
            solve, its = make_solver(mg, **solver_kw), []
            for s in srcs:
                res, _ = solve(s)
                it = int(res.iters)
                its.append(it)
                if it >= MAX_ITER:
                    ok = False
                    break
                pion += measure.fold_correlator(_timeslices(res.x))
        _sync(device)
        t3 = time.perf_counter()
        if not ok:
            print(f"[QMG-WARNING]: config {icfg} MG solve hit max_iter - "
                  "skipping config")
            continue
        pions.append(pion)
        iters_list.append(it)
        links = u1.phases_to_links(torch.as_tensor(ph))
        plaqs.append(float(u1.get_plaquette_u1(links, lat_g).real))
        if log is not None:
            log.append({"config": icfg, "plaq": plaqs[-1], "iters": its,
                        "pion": pion, "heatbath_s": t1 - t0,
                        "setup_s": t2 - t1, "solve_s": t3 - t2})
        if verbose:
            print(f"[QMG-MEAS]: config {icfg+1}/{n_configs} "
                  f"plaq {plaqs[-1]:.5f} mg-iters {it} "
                  f"(setup+solves {t3 - t1:.2f}s, "
                  f"total {time.time()-t_start:.0f}s)")

    pions = np.array(pions)
    mean = pions.mean(axis=0)
    err = (pions.std(axis=0) / np.sqrt(max(len(pions), 1))
           if len(pions) > 1 else np.zeros(L))
    return mean, err, plaqs, iters_list, pions


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=32)
    p.add_argument("--beta", type=float, default=6.0)
    p.add_argument("--mass", type=float, default=-0.06)
    p.add_argument("--n-configs", type=int, default=10)
    p.add_argument("--n-therm", type=int, default=1000)
    p.add_argument("--n-update", type=int, default=100)
    p.add_argument("--n-refine", type=int, default=2)
    p.add_argument("--tol", type=float, default=2e-6)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--batched", action="store_true",
                   help="solve all sources of a config in one batched "
                        "solve")
    p.add_argument("--save", default=None,
                   help="save per-config folded correlators to this .npz")
    p.add_argument("--trace-lanes", action="store_true",
                   help="with --batched, print every lane's outer "
                        "iterations and residuals at each restart")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but no CUDA device")

    mean, err, plaqs, iters, pions = run_stream(
        L=args.L, beta=args.beta, mass=args.mass,
        n_configs=args.n_configs, n_therm=args.n_therm,
        n_update=args.n_update, n_refine=args.n_refine, tol=args.tol,
        batched=args.batched, device=device, trace_lanes=args.trace_lanes)

    print(f"[QMG-MEAS]: mean plaquette {np.mean(plaqs):.6f} "
          f"(+/- {np.std(plaqs)/np.sqrt(max(len(plaqs),1)):.6f})")
    print("[QMG-PION]: t C(t) err")
    for t in range(len(mean)):
        print(f"[QMG-PION]: {t} {mean[t]:.8e} {err[t]:.3e}")
    masses = measure.effective_mass_acosh(mean)
    mid = len(masses) // 2
    print(f"[QMG-MASS]: effective masses around t=L/4..L/2: "
          f"{[f'{m:.4f}' for m in masses[mid - 4:mid + 1]]}")
    L = args.L
    lo, hi = L // 4, L // 2 - 1
    if len(pions) > 2:
        jk = []
        for drop in range(len(pions)):
            sub = np.delete(pions, drop, axis=0).mean(axis=0)
            jk.append(np.nanmean(measure.effective_mass_acosh(sub)[lo:hi]))
        jk = np.array(jk)
        m_pi = np.nanmean(jk)
        m_err = np.sqrt((len(jk) - 1) * np.nanvar(jk))
        print(f"[QMG-PION-MASS]: m = {args.mass} -> m_pi = {m_pi:.5f} "
              f"+/- {m_err:.5f} (plateau t in [{lo},{hi}))")
        try:
            m_fit, e_fit, _ = measure.fit_cosh_mass(pions, lo, hi)
            print(f"[QMG-PION-MASS-FIT]: m = {args.mass} -> m_pi = "
                  f"{m_fit:.5f} +/- {e_fit:.5f} (cosh fit t in "
                  f"[{lo},{hi}))")
        except (RuntimeError, ValueError) as e:
            print(f"[QMG-WARNING]: cosh fit failed ({e})")
    if args.save:
        np.savez(args.save, pions=pions, plaqs=np.array(plaqs),
                 mass=args.mass, beta=args.beta, L=L)
        print(f"[QMG-NOTE]: per-config correlators saved to {args.save}")


if __name__ == "__main__":
    main()
