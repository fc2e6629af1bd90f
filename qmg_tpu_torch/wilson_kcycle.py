"""The n13 study, end to end: the counterpart of examples/wilson_kcycle.py
(reference tests/n13_wilson_kcycle/wilson_kcycle.cpp).

    python -m qmg_tpu_torch.wilson_kcycle L mass beta n_refine
        [--tol 1e-10] [--spectrum [--spectrum-nev N]]
        [--colinear [--colinear-nev 64]] [--coarsest-direct]
        [--cfg-dir DIR] [--device cuda | --cpu]

e.g. ``python -m qmg_tpu_torch.wilson_kcycle 256 -0.075 6.0 2``. In
complex128 on the card as on the CPU (the reference's doubles; tol 1e-10
is out of reach in complex64). The gauge field is the shipped heatbath
config of (L, beta) when ``--cfg-dir`` holds it, else the example's
heatbath: ``QMGRandom(1337)``, 10 x 400 non-compact updates from a cold
start, a ``[QMG-HEATBATH]`` line with plaquette and topology after each.
Then the n13 hierarchy (``KCycleConfig(n_refine, coarse_dof=8, tol)``,
``build_kcycle_hierarchy``) on the device, a right-hand side from the same
stream, and ``mg.solve`` (outer flexible GCR around the K-cycle, plain
applies). The example's coarsest solve is restarted GCR(32) to 0.2; from
two refinements on it stagnates in both packages (1000 iterations at
relres 0.27-0.72 a visit at 64^2, the same on qmg_tpu's solve of the
same hierarchy), and a 256^2 solve does not finish in 15 minutes on the
card. ``--coarsest-direct`` takes the dense coarsest inverse instead, as
bench.py's n13 configuration does. Prints the example's ``[QMG-*]``
lines: gauge, setup, the converged / check-tolerance lines, timing, the
per-level operator counts, iterations and flops.

``--spectrum`` prints the fine and first coarse operators' spectra
(``[ORIG-SPECTRUM]``, ``[COARSE-SPECTRUM]``; reference n13 do_spectrum):
dense, or with ``--spectrum-nev N`` the N eigenvalues nearest 0 by
shift-invert Arnoldi (``eig.shift_invert_eigensystem``, Rayleigh-refined).
The example inverts with BiCGstab(6), which does not reach 1e-10 within
its 4000 iterations at 256^2 (the port's own solve there stops at 3996
unconverged); here each level's inverse is that level's own multigrid
solve to 1e-10 (flexible GCR around the level's K-cycle; restarted GCR on
the coarsest), which the Rayleigh refinement makes no difference to the
eigenvalues it reports. ``--colinear`` prints, for the ``--colinear-nev``
lowest-|lambda| fine eigenvectors v of the dense spectrum, ||(1 - P P^dag)
v|| / ||v|| and ||(1 - P A_c^-1 P^dag A) v|| / ||v|| with BiCGstab(6)
coarse solves (``[QMG-OVERLAP]``; reference n13 do_colinear).

``run(...)`` returns the printed numbers as a dict (and the hierarchy, its
operator and the right-hand side); ``main`` prints them. The command runs
on the card unless ``--cpu`` or ``--device cpu`` is given, and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .lattice import Lattice2D
from .rng import QMGRandom
from . import u1, solvers, eig
from .operators.wilson import Wilson2D
from .setup import KCycleConfig, build_kcycle_hierarchy
from .stateful import zero_carry
from .linalg import norm2sq
from .kcycle import OPS_NAMES, _sync

__all__ = ["find_config", "run", "main"]

SEED = 1337
HEATBATH_UPDATES = 4000
HEATBATH_REPORT = 400
SPECTRUM_TOL = 1e-10       # the shift-invert solves
COLINEAR_TOL = 1e-10       # the coarse BiCGstab(6) solves
COLINEAR_MAX_ITER = 1000


def find_config(L: int, beta: float, cfg_dir: str | None):
    """The reference's shipped heatbath config of (L, beta) in ``cfg_dir``
    (``l{L}t{L}b60_heatbath.dat`` at beta 6, ``b100`` at beta 10), or
    None."""
    b = {6.0: "b60", 10.0: "b100"}.get(beta)
    if cfg_dir is None or b is None:
        return None
    path = os.path.join(cfg_dir, f"l{L}t{L}{b}_heatbath.dat")
    return path if os.path.exists(path) else None


def _plaq_topo(links: torch.Tensor, lat: Lattice2D):
    return (float(u1.get_plaquette_u1(links, lat).real),
            float(u1.get_topo_u1(links, lat)))


def make_gauge(L: int, beta: float, rng, device, cfg_dir=None,
               sweep: str = "native", out=print):
    """(2, 2, Y, Xh) complex128 links on ``device``, the config's source,
    the heatbath's (update, plaquette, topology) reports and its
    seconds."""
    lat_g = Lattice2D(L, L, 1)
    path = find_config(L, beta, cfg_dir)
    if path:
        out(f"[QMG-GAUGE]: loaded {path}")
        return (torch.as_tensor(u1.read_gauge_u1(lat_g, path)).to(device),
                path, [], 0.0)
    out(f"[QMG-NOTE]: L = {L} beta = {beta} requires heatbath generation.")
    ph = np.zeros((2, 2, L, L // 2))
    reports = []
    t0 = time.perf_counter()
    for i in range(0, HEATBATH_UPDATES, HEATBATH_REPORT):
        ph = u1.heatbath_noncompact_update(ph, lat_g, beta, HEATBATH_REPORT,
                                           rng, sweep)
        plaq, topo = _plaq_topo(
            u1.phases_to_links(torch.as_tensor(ph).to(device)), lat_g)
        reports.append((i, plaq, topo))
        out(f"[QMG-HEATBATH]: Update {i} Plaq {plaq:.6f} Topo {topo:.3f}")
    seconds = time.perf_counter() - t0
    return (u1.phases_to_links(torch.as_tensor(ph).to(device)), "heatbath",
            reports, seconds)


def _level_solve(mg, level: int, tol: float, cfg: KCycleConfig):
    """v -> an approximate inverse of level ``level``'s operator applied to
    v: flexible GCR around the level's K-cycle, restarted GCR on the
    coarsest; plain applies, nothing counted on the trackers."""
    st = mg.get_stencil(level)
    n_levels = mg.get_num_levels()
    if level == n_levels - 1:
        def solve(v):
            return solvers.gcr_restart(st.apply_M, v, max_iter=cfg.max_iter,
                                       tol=tol,
                                       restart_freq=cfg.restart_freq).x
        return solve
    precond = mg.make_preconditioner(level)

    def solve(v):
        res, _ = solvers.gcr_var_precond_restart(
            st.apply_M, v, precond, max_iter=cfg.max_iter, tol=tol,
            restart_freq=cfg.restart_freq,
            precond_carry=zero_carry(n_levels))
        return res.x
    return solve


def _spectrum(mg, cfg, nev: int, dense_fine, device, out):
    """[ORIG-SPECTRUM] and [COARSE-SPECTRUM]: (per level eigenvalues, the
    fine eigenpairs' relative residuals ||M v - lambda v|| / |lambda| for
    the shift-invert path, else None)."""
    spectra, fine_res = [], None
    for lvl, tag in ((0, "ORIG-SPECTRUM"), (1, "COARSE-SPECTRUM")):
        st = mg.get_stencil(lvl)
        mv = st.get_apply_function()
        shape = st.lat.cv_shape()
        if nev > 0:
            evals, evecs = eig.shift_invert_eigensystem(
                _level_solve(mg, lvl, SPECTRUM_TOL, cfg), shape, nev=nev,
                sigma=0.0, matvec=mv, device=device)
            if lvl == 0:
                fine_res = [float(torch.sqrt(
                    norm2sq(mv(v) - complex(lam) * v) / norm2sq(v)))
                    / abs(lam) for lam, v in zip(evals, evecs)]
        elif lvl == 0 and dense_fine is not None:
            evals = dense_fine[0]
        else:
            evals, _ = eig.dense_eigensystem(mv, shape, device=device)
        spectra.append(evals)
        for i, ev in enumerate(evals):
            out(f"[{tag}]: {i} {ev.real} + I {ev.imag}")
    return spectra, fine_res


def _colinear(mg, evals, evecs, nev: int, device, out):
    """[QMG-OVERLAP] rows (i, lambda, |lambda|, onePP, onePAPA) for the
    ``nev`` lowest-|lambda| fine eigenvectors (0: all)."""
    st0, st1 = mg.get_stencil(0), mg.get_stencil(1)
    transfer = mg.get_transfer(0)
    order = np.argsort(np.abs(evals))
    evals, evecs = evals[order], evecs[order]
    coarse_mv = st1.get_apply_function()
    nev = evecs.shape[0] if nev == 0 else min(nev, evecs.shape[0])
    rows = []
    for i in range(nev):
        v = torch.as_tensor(evecs[i]).to(device)
        nv = float(torch.sqrt(norm2sq(v)))
        one_pp = float(torch.sqrt(norm2sq(
            v - transfer.prolong_c2f(transfer.restrict_f2c(v))))) / nv
        pdag_av = transfer.restrict_f2c(st0.apply_M(v))
        inv = solvers.bicgstab_l(coarse_mv, pdag_av,
                                 max_iter=COLINEAR_MAX_ITER,
                                 tol=COLINEAR_TOL, l=6)
        one_papa = float(torch.sqrt(norm2sq(
            v - transfer.prolong_c2f(inv.x)))) / nv
        rows.append((i, complex(evals[i]), abs(evals[i]), one_pp, one_papa,
                     bool(inv.converged)))
        out(f"[QMG-OVERLAP]: {i} {evals[i].real} + I {evals[i].imag} "
            f"{abs(evals[i])} | {one_pp} | {one_papa}")
    return rows


def run(L: int, mass: float, beta: float, n_refine: int, tol: float = 1e-10,
        spectrum: bool = False, spectrum_nev: int = 0,
        colinear: bool = False, colinear_nev: int = 64,
        coarsest_direct: bool = False, device="cuda",
        cfg_dir: str | None = None, sweep: str = "native",
        out=print) -> dict:
    """The n13 study (see the module docstring); ``out`` takes each
    printed line. ``sweep`` is the heatbath's (``u1.SWEEPS``).
    ``coarsest_direct`` solves the coarsest level with its dense inverse
    instead of the example's restarted GCR. Returns the printed numbers,
    the hierarchy ``mg``, its operator ``op`` and the right-hand side
    ``b``."""
    dtype = torch.complex128
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(SEED)
    gauge, source, heatbath, heatbath_s = make_gauge(
        L, beta, rng, device, cfg_dir, sweep, out)
    plaq, topo = _plaq_topo(gauge, lat)
    out(f"[QMG-GAUGE]: plaquette {plaq:.6f} topo {topo:.3f}")

    op = Wilson2D(lat, mass, gauge, dtype=dtype, device=device)
    cfg = KCycleConfig(n_refine=n_refine, coarse_dof=8, tol=tol,
                       coarsest_direct=coarsest_direct)
    _sync(device)
    t0 = time.perf_counter()
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    _sync(device)
    setup_s = time.perf_counter() - t0
    out(f"[QMG-SETUP]: {mg.get_num_levels()} levels built in "
        f"{setup_s:.1f}s")

    b = torch.as_tensor(rng.gaussian_cv(lat)).to(device=device, dtype=dtype)
    t0 = time.perf_counter()
    res = mg.solve(b, tol=tol, max_iter=cfg.max_iter,
                   restart_freq=cfg.restart_freq)
    _sync(device)
    solve_s = time.perf_counter() - t0
    bsq = norm2sq(b)
    resid = float(torch.sqrt(norm2sq(b - op.apply_M(res.x)) / bsq))
    alleged = float(torch.sqrt(res.res_sq / bsq))
    converged = bool(res.converged)
    out(f"Multigrid {'converged' if converged else 'failed'} in "
        f"{res.iters} iterations with alleged tolerance {alleged:.3e}.")
    out(f"Check tolerance {resid:.3e}")
    out(f"[QMG-TIMING]: solve wall time {solve_s:.2f}s")

    # Operator counts per level (reference n22:506-522 format); flops of
    # 5 site matvecs of nc x nc complex an apply.
    total_flops = 0.0
    ops = []
    for lvl in range(mg.get_num_levels()):
        counts = [mg.get_tracker_count(t, lvl) for t in range(4)]
        ops.append(counts)
        out(f"[QMG-OPS-STATS]: Level {lvl} "
            + " ".join(f"{n} {c}" for n, c in zip(OPS_NAMES, counts)))
        lat_l = mg.get_lattice(lvl)
        total_flops += sum(counts) * 5 * lat_l.volume * (
            8 * lat_l.nc ** 2 - 2 * lat_l.nc)
    avg_iters = mg.query_average_iterations()
    out("[QMG-ITER-STATS]: avg iterations per level "
        + " ".join(f"{v:.2f}" for v in avg_iters))
    out(f"[QMG-FLOPS]: ~{total_flops / 1e9:.2f} GFLOP of operator applies"
        f" ({total_flops / solve_s / 1e9:.1f} GFLOP/s over the solve)")

    result = {
        "L": L, "device": str(device), "gauge_source": source,
        "heatbath": heatbath, "heatbath_s": heatbath_s,
        "plaquette": plaq, "topo": topo, "levels": mg.get_num_levels(),
        "setup_s": setup_s, "iters": res.iters, "converged": converged,
        "alleged": alleged, "resid": resid, "solve_s": solve_s,
        "ops": ops, "avg_iters": avg_iters, "gflop": total_flops / 1e9,
        "spectra": None, "fine_eig_res": None, "overlap": None,
        "mg": mg, "op": op, "b": b, "x": res.x}

    dense_fine = None
    if colinear or (spectrum and spectrum_nev == 0):
        st0 = mg.get_stencil(0)
        dense_fine = eig.dense_eigensystem(st0.get_apply_function(),
                                           st0.lat.cv_shape(),
                                           device=device)
    if spectrum:
        result["spectra"], result["fine_eig_res"] = _spectrum(
            mg, cfg, spectrum_nev, dense_fine, device, out)
    if colinear:
        result["overlap"] = _colinear(mg, *dense_fine, colinear_nev, device,
                                      out)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("L", type=int)
    p.add_argument("mass", type=float, help="try -0.075 for beta 6.0")
    p.add_argument("beta", type=float)
    p.add_argument("n_refine", type=int)
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--spectrum", action="store_true",
                   help="print the fine and first coarse spectra")
    p.add_argument("--spectrum-nev", type=int, default=0,
                   help="with --spectrum: only the nev eigenvalues nearest "
                        "0 per level, by shift-invert Arnoldi")
    p.add_argument("--colinear", action="store_true",
                   help="per-eigenvector colinearity with the coarse space")
    p.add_argument("--colinear-nev", type=int, default=64,
                   help="lowest-|lambda| eigenvectors of --colinear (0: the "
                        "full spectrum)")
    p.add_argument("--coarsest-direct", action="store_true",
                   help="the dense coarsest inverse instead of the "
                        "example's restarted GCR (which stagnates from two "
                        "refinements on)")
    p.add_argument("--cfg-dir", default=None,
                   help="directory of the reference's shipped heatbath "
                        "configs (l{L}t{L}b60_heatbath.dat)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device} requested but no CUDA device "
                         "(use --cpu)")
    r = run(args.L, args.mass, args.beta, args.n_refine, tol=args.tol,
            spectrum=args.spectrum, spectrum_nev=args.spectrum_nev,
            colinear=args.colinear, colinear_nev=args.colinear_nev,
            coarsest_direct=args.coarsest_direct, device=device,
            cfg_dir=args.cfg_dir)
    if not (r["converged"] and r["resid"] <= 10 * args.tol):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
