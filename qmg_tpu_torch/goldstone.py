"""The goldstone (pion) mass measurement stream (port of
examples/wilson_goldstone.py: the reference's tests n15 for Wilson and
n20 for staggered fermions).

    python -m qmg_tpu_torch.goldstone --op staggered --L 32 --mass 0.1

Non-compact U(1) heatbath evolution from ``QMGRandom(1337)`` (the C++
sweep by default); per configuration the operator's links refreshed
(``update_links``), then BiCGstab(6) on one point source at the origin
per dof, and the folded per-timeslice pion correlator summed over the
sources. Prints the example's ``[QMG-...]`` lines: the plaquette, the
correlator, the acosh effective mass, the jackknifed plateau on
[L/4, L/2 - 1) and the jackknifed cosh fit over the same window.

On the card the solves run in complex64 (default tol 2e-6) and the
operator is applied by ``--fine-kernel`` (``solve.FINE_KERNELS``), bound
once per configuration: by default the generic stencil kernel K4
("matrix": nc = 1 for staggered fermions, nc = 2 for Wilson ones);
``none`` is the plain apply. On the CPU (``--device cpu``) the solves run
in complex128 (default tol 1e-10) through the plain apply, as the example
does on its CPU backend; a kernel named there runs as its complex64
twin.

Every solve's true residual ||b - M x|| / ||b|| (the plain apply, in the
solve's dtype) must be within ``TRUE_RES_FACTOR`` x tol, or the
configuration counts as not converged and is skipped. This is what the
Wilson leg meets: with the shadow residual r~ = r0 a point source, the
first BiCG product <r~, M r1> is 0 in exact arithmetic for Wilson at
w = 1 (the projectors (1 -+ gamma_mu) of a hop and its return hop
multiply to 0), so rounding alone steers the solve, and its recursive
residual meets tol while the true one stays O(1), in qmg_tpu's example
as here. The Wilson kernels ("wilson-r1", "wilson-phase") apply those
projectors exactly, so the product is an exact 0 and the solve breaks
down at once. Staggered solves are not affected.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .lattice import Lattice2D
from .operators import Staggered2D, Wilson2D
from .reductions import norm2sq_timeslice
from .rng import QMGRandom
from .solve import FINE_KERNELS, WILSON_KERNELS, _matrix_apply, _wilson_apply
from .dslash_kernel import dslash_apply, dslash_split_apply, \
    dslash_small_apply
from .wilson_kernel import wilson_r1_apply, wilson_phase_apply
from . import measure, solvers, u1

OPS = ("wilson", "staggered")
DEFAULT_KERNEL = "matrix"
# Each kernel's wrapper, whose ``launches`` counts its launches.
KERNEL_WRAPPERS = {"wilson-r1": wilson_r1_apply,
                   "wilson-phase": wilson_phase_apply,
                   "matrix": dslash_apply, "matrix-split": dslash_split_apply,
                   "small": dslash_small_apply}
MAX_ITER = 4000
BICGSTAB_L = 6
# A solve's true relative residual may exceed tol by this factor (the
# recursive residual of a complex64 solve drifts from the true one).
TRUE_RES_FACTOR = 100.0


def default_tol(dtype) -> float:
    return 2e-6 if dtype == torch.complex64 else 1e-10


def resolve_kernel(fine_kernel, device) -> str | None:
    """The fine kernel a run uses: ``None`` or "none" is the plain apply;
    "auto" is K4 on the card and the plain apply on the CPU."""
    if fine_kernel == "auto":
        return DEFAULT_KERNEL if torch.device(device).type == "cuda" \
            else None
    if fine_kernel in (None, "none"):
        return None
    if fine_kernel not in FINE_KERNELS:
        raise ValueError(f"fine_kernel must be one of {FINE_KERNELS}, "
                         f"'none' or 'auto', got {fine_kernel!r}")
    return fine_kernel


def make_operator(op: str, lat: Lattice2D, mass, gauge, *, dtype, device):
    if op == "wilson":
        return Wilson2D(lat, mass, gauge, dtype=dtype, device=device)
    if op == "staggered":
        return Staggered2D(lat, mass, gauge, dtype=dtype, device=device)
    raise ValueError(f"op must be one of {OPS}, got {op!r}")


def bind_matvec(st, fine_kernel: str | None):
    """The operator's apply: the plain ``apply_M``, or ``fine_kernel``
    bound to the operator's current coefficients."""
    if fine_kernel is None:
        return st.apply_M
    if fine_kernel in WILSON_KERNELS:
        return _wilson_apply(st, fine_kernel)
    return _matrix_apply(st.coeffs, fine_kernel)


def true_residual(st, x, b) -> float:
    """||b - M x|| / ||b|| through the plain apply."""
    return float(torch.linalg.vector_norm(b - st.apply_M(x))
                 / torch.linalg.vector_norm(b))


def point_sources(lat: Lattice2D, *, dtype, device):
    """One unit source at the origin per dof."""
    return [measure.point_source(lat, 0, 0, c, dtype=dtype, device=device)
            for c in range(lat.nc)]


def staggered_problem(size: int, mass: float = 0.1, seed: int = 1337, *,
                      dtype, device):
    """One staggered solve's operator and right-hand side: ``Staggered2D``
    at ``mass`` on a gauss gauge at beta 6 from ``QMGRandom(seed)``, and a
    gaussian field drawn after it (the 2048^2 solve that chip_smoke.py
    holds to qmg_tpu's count)."""
    lat = Lattice2D(size, size, 1)
    rng = QMGRandom(seed)
    g = u1.gauss_gauge_u1(lat, rng, 6.0)
    b = torch.as_tensor(rng.gaussian_cv(lat)).to(device=device, dtype=dtype)
    return Staggered2D(lat, mass, g, dtype=dtype, device=device), b


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_goldstone(op="staggered", L=32, beta=6.0, mass=-0.06, n_configs=40,
                  n_therm=1000, n_update=100, tol=None, device="cuda",
                  dtype=None, fine_kernel="auto", sweep="native", seed=1337,
                  verbose=True, log=None):
    """Returns (pions (n_kept, L), plaqs, iters): the folded correlator of
    every configuration whose solves all converged, to tol and with a true
    residual within ``TRUE_RES_FACTOR`` x tol (the others are skipped with
    a warning, as the example skips what did not converge), the
    plaquettes and BiCGstab
    iterations of the last source of each kept configuration. ``dtype``
    defaults to complex64 on the card and complex128 on the CPU; ``log``,
    a list, receives one dict per configuration: its plaquette,
    iterations, convergence and true residual per source, the correlator,
    the kernel's launches and the heatbath and solve seconds (host clock,
    device synchronised)."""
    if dtype is None:
        dtype = (torch.complex64 if torch.device(device).type == "cuda"
                 else torch.complex128)
    tol = default_tol(dtype) if tol is None else tol
    kernel = resolve_kernel(fine_kernel, device)
    counter = KERNEL_WRAPPERS.get(kernel)
    lat = Lattice2D(L, L, 2 if op == "wilson" else 1)
    lat_g = lat.with_nc(1)
    rng = QMGRandom(seed)
    srcs = point_sources(lat, dtype=dtype, device=device)

    ph = np.zeros((2, 2, L, lat_g.xh))
    if verbose:
        print(f"[QMG-NOTE]: thermalizing {n_therm} heatbath updates",
              flush=True)
    ph = u1.heatbath_noncompact_update(ph, lat_g, beta, n_therm, rng, sweep)

    st = None
    pions, plaqs, iters_kept = [], [], []
    t_start = time.time()
    for cfg in range(n_configs):
        t0 = time.perf_counter()
        ph = u1.heatbath_noncompact_update(ph, lat_g, beta, n_update, rng,
                                           sweep)
        gauge = np.exp(1j * ph)
        t1 = time.perf_counter()
        if st is None:
            st = make_operator(op, lat, mass, gauge, dtype=dtype,
                               device=device)
        else:
            st.update_links(gauge)
        launches0 = counter.launches if counter is not None else 0
        matvec = bind_matvec(st, kernel)
        results = [solvers.bicgstab_l(matvec, s, max_iter=MAX_ITER, tol=tol,
                                      l=BICGSTAB_L) for s in srcs]
        pion = np.zeros(L)
        for res in results:
            corr = norm2sq_timeslice(res.x.to(torch.complex128))
            pion += measure.fold_correlator(corr.cpu().numpy())
        _sync(device)
        t2 = time.perf_counter()
        iters = [int(r.iters) for r in results]
        true_res = [true_residual(st, r.x, b) for r, b in zip(results, srcs)]
        converged = [bool(r.converged) and t <= TRUE_RES_FACTOR * tol
                     for r, t in zip(results, true_res)]
        links = u1.phases_to_links(torch.as_tensor(ph))
        plaq = float(u1.get_plaquette_u1(links, lat_g).real)
        if log is not None:
            log.append({"config": cfg, "plaq": plaq, "iters": iters,
                        "converged": converged, "true_res": true_res,
                        "pion": pion,
                        "launches": (counter.launches - launches0
                                     if counter is not None else 0),
                        "heatbath_s": t1 - t0, "solve_s": t2 - t1})
        if not all(converged):
            print(f"[QMG-WARNING]: config {cfg} solve did not converge "
                  f"(iterations {iters}, true residuals "
                  f"{[f'{t:.2e}' for t in true_res]}) - skipping config",
                  flush=True)
            continue
        pions.append(pion)
        plaqs.append(plaq)
        iters_kept.append(iters[-1])
        if verbose and (cfg + 1) % 10 == 0:
            print(f"[QMG-MEAS]: config {cfg+1}/{n_configs} plaq "
                  f"{plaq:.5f} iters {iters[-1]} "
                  f"({time.time() - t_start:.0f}s)", flush=True)
    return np.array(pions).reshape(-1, L), plaqs, iters_kept


def plateau_mass(pions, lo: int, hi: int):
    """Jackknifed mean of the acosh effective mass over [lo, hi): (m,
    error)."""
    jk = np.array([np.nanmean(measure.effective_mass_acosh(
        np.delete(pions, drop, axis=0).mean(axis=0))[lo:hi])
        for drop in range(len(pions))])
    return float(np.nanmean(jk)), float(np.sqrt((len(jk) - 1)
                                                * np.nanvar(jk)))


def report(pions, plaqs, mass, L):
    """The example's closing lines."""
    mean = pions.mean(axis=0)
    err = pions.std(axis=0) / np.sqrt(len(pions))
    print(f"[QMG-GAUGE-FINAL]: plaquette {np.mean(plaqs):.6f} +/- "
          f"{np.std(plaqs) / np.sqrt(len(plaqs)):.6f}")
    print("[QMG-BEGIN-PION]")
    for j in range(L):
        print(j, mean[j], "+/-", err[j])
    print("[QMG-END-PION]")
    meff = measure.effective_mass_acosh(mean)
    print("[QMG-BEGIN-PION-EFFMASS]")
    for j in range(1, L - 1):
        print(j, meff[j])
    print("[QMG-END-PION-EFFMASS]")
    lo, hi = L // 4, L // 2 - 1
    m_pi, m_err = plateau_mass(pions, lo, hi)
    print(f"[QMG-PION-MASS]: m = {mass} -> m_pi = {m_pi:.5f} +/- "
          f"{m_err:.5f} (plateau t in [{lo},{hi}))")
    try:
        m_fit, e_fit, _ = measure.fit_cosh_mass(pions, lo, hi)
        print(f"[QMG-PION-MASS-FIT]: m = {mass} -> m_pi = {m_fit:.5f} "
              f"+/- {e_fit:.5f} (cosh fit t in [{lo},{hi}))")
    except (RuntimeError, ValueError, TypeError) as e:
        print(f"[QMG-WARNING]: cosh fit failed ({e})")
    return m_pi, m_err


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--op", choices=list(OPS), default="wilson")
    p.add_argument("--L", type=int, default=32)
    p.add_argument("--beta", type=float, default=6.0)
    p.add_argument("--mass", type=float, default=-0.06)
    p.add_argument("--n-configs", type=int, default=40)
    p.add_argument("--n-therm", type=int, default=1000)
    p.add_argument("--n-update", type=int, default=100)
    p.add_argument("--tol", type=float, default=None,
                   help="default 2e-6 on the card, 1e-10 on the CPU")
    p.add_argument("--fine-kernel", default="auto",
                   choices=["auto", *FINE_KERNELS, "none"],
                   help="default: matrix (K4) on the card, the plain apply "
                        "on the CPU")
    p.add_argument("--device", default="cuda")
    p.add_argument("--save", default=None,
                   help="save per-config folded correlators to this .npz")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but no CUDA device")
    pions, plaqs, _ = run_goldstone(
        op=args.op, L=args.L, beta=args.beta, mass=args.mass,
        n_configs=args.n_configs, n_therm=args.n_therm,
        n_update=args.n_update, tol=args.tol, device=args.device,
        fine_kernel=args.fine_kernel)
    if len(pions) < 2:
        raise SystemExit(f"{len(pions)} configurations converged: too few "
                         "to jackknife")
    report(pions, plaqs, args.mass, args.L)
    if args.save:
        np.savez(args.save, pions=pions, plaqs=np.array(plaqs),
                 mass=args.mass, beta=args.beta, L=args.L)
        print(f"[QMG-NOTE]: per-config correlators saved to {args.save}")


if __name__ == "__main__":
    main()
