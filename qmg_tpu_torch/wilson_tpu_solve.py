"""Setup, checkpoint and solve on the card: the counterpart of
examples/wilson_tpu_solve.py.

    python -m qmg_tpu_torch.wilson_tpu_solve L mass [--beta 6.0]
        [--n-refine 2] [--tol 1e-5] [--schur] [--ckpt PATH]
        [--device cuda | --cpu]

e.g. ``python -m qmg_tpu_torch.wilson_tpu_solve 512 -0.06 --n-refine 3
--ckpt mg.npz``. The example's problem in complex64: the shipped heatbath
config of (L, beta) when ``--cfg-dir`` holds it, else ``gauss_gauge_u1``
from ``QMGRandom(1337)``; its ``KCycleConfig`` (``nullvec_tol=5e-4``,
``nullvec_max_iter=300``, the dense coarsest inverse; with ``--schur`` the
n19 formulation: RIGHT_SCHUR on every level, rbjacobi coarsening with its
derived sets built, the iterative coarsest). The hierarchy is built on the
device (the example builds it on the host only because of the TPU's
real-plane boundary). With ``--ckpt`` an existing file is restored
(``checkpoint.load_hierarchy``; one that qmg_tpu's example wrote loads
too) and a new one is written after the setup
(``checkpoint.save_hierarchy``). The right-hand side is the example's,
drawn from the stream after the setup's draws; a restored run skips those
draws (``setup_planes.gauss_seed_planes``), so it solves the same system.

The solve is ``solve.make_solver(mg, tol, max_iter=200, restart_freq=16)``
with its defaults: inside the K-cycle level 0 takes the rank-1 Wilson
kernel (K1; its plain twin on the CPU), the outer matvec stays exact; the
Schur solve takes plain applies (no kernel applies a Schur operator). A
first solve (the kernels built at first use), a timed solve, and the
complex128 true residual of the timed solve's x against the exact
operator. Prints the example's ``[QMG-TPU]`` lines and exits 1 when the
true residual exceeds 10 x tol. ``run(...)`` returns the numbers as a
dict.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .lattice import Lattice2D
from .rng import QMGRandom
from . import u1
from .operators.wilson import Wilson2D
from .setup import KCycleConfig, build_kcycle_hierarchy
from .setup_planes import gauss_seed_planes
from .checkpoint import save_hierarchy, load_hierarchy
from .stencil import StencilType
from .solve import make_solver
from .kcycle import true_residual, _sync
from .wilson_kernel import wilson_r1_apply
from .wilson_kcycle import find_config

__all__ = ["tpu_solve_config", "run", "main"]

SEED = 1337
MAX_ITER = 200
RESTART = 16


def tpu_solve_config(n_refine: int, schur: bool) -> KCycleConfig:
    """The example's hierarchy configuration."""
    st = StencilType.RIGHT_SCHUR if schur else StencilType.ORIGINAL
    return KCycleConfig(n_refine=n_refine, coarse_dof=8, nullvec_tol=5e-4,
                        nullvec_max_iter=300, coarsest_direct=not schur,
                        fine_stencil_app=st, coarsest_stencil_app=st,
                        precond_coarsen_rbjacobi=schur,
                        build_extra=2 if schur else 0)


def run(L: int, mass: float, beta: float = 6.0, n_refine: int = 2,
        tol: float = 1e-5, schur: bool = False, ckpt: str | None = None,
        device="cuda", cfg_dir: str | None = None, out=print) -> dict:
    """The example's workflow (see the module docstring); ``out`` takes
    each printed line. Returns outer iterations, true residual, setup /
    first / timed solve times, whether the hierarchy was restored and the
    K1 launches of the timed solve."""
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(SEED)
    outer = StencilType.RIGHT_SCHUR if schur else StencilType.ORIGINAL
    cfg = tpu_solve_config(n_refine, schur)
    path = find_config(L, beta, cfg_dir)
    gauge = (u1.read_gauge_u1(lat, path) if path
             else u1.gauss_gauge_u1(lat, rng, beta))
    op = Wilson2D(lat, mass, gauge, dtype=torch.complex64, device=device)
    restored = bool(ckpt) and os.path.exists(ckpt)
    setup_s = None
    if restored:
        mg = load_hierarchy(ckpt, op, device=device)
        out(f"[QMG-TPU] restored hierarchy ({mg.get_num_levels()} levels) "
            f"from {ckpt}")
        gauss_seed_planes(lat, KCycleConfig(
            n_refine=mg.get_num_levels() - 1, coarse_dof=cfg.coarse_dof),
            rng)
    else:
        _sync(device)
        t0 = time.perf_counter()
        mg = build_kcycle_hierarchy(lat, op, cfg, rng)
        _sync(device)
        setup_s = time.perf_counter() - t0
        out(f"[QMG-TPU] hierarchy setup {setup_s:.0f} s "
            f"({mg.get_num_levels()} levels)")
        if ckpt:
            save_hierarchy(mg, ckpt)
            out(f"[QMG-TPU] checkpointed to {ckpt}")
    b = torch.as_tensor(rng.gaussian_cv(lat)).to(device=device,
                                                  dtype=torch.complex64)

    solve = make_solver(mg, tol=tol, max_iter=MAX_ITER, restart_freq=RESTART,
                        fine_kernel=None if schur else "wilson-r1",
                        outer_type=outer)
    name = (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "cpu")
    t0 = time.perf_counter()
    solve(b)
    _sync(device)
    first_s = time.perf_counter() - t0
    out(f"[QMG-TPU] compile+first solve {first_s:.1f} s on {name}")
    launches0 = wilson_r1_apply.launches
    t0 = time.perf_counter()
    res, carry = solve(b)
    _sync(device)
    solve_s = time.perf_counter() - t0
    launches = wilson_r1_apply.launches - launches0
    resid = true_residual(op, b, res.x)
    out(f"[QMG-TPU] solve: {res.iters} outer iters, {solve_s * 1e3:.1f} ms, "
        f"true resid {resid:.2e}")
    ok = resid <= 10 * tol
    if not ok:
        out("[QMG-TPU] WARNING: true residual exceeds tolerance")
    return {"L": L, "schur": schur, "device": name, "restored": restored,
            "levels": mg.get_num_levels(), "setup_s": setup_s,
            "first_s": first_s, "solve_ms": solve_s * 1e3,
            "iters": res.iters, "converged": bool(res.converged),
            "resid": resid, "ok": ok, "k1_launches": launches,
            "counts": carry["counts"].tolist(), "mg": mg, "b": b}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("L", type=int)
    p.add_argument("mass", type=float)
    p.add_argument("--beta", type=float, default=6.0)
    p.add_argument("--n-refine", type=int, default=2)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--schur", action="store_true",
                   help="n19 rbjacobi-Schur configuration")
    p.add_argument("--ckpt", default=None,
                   help="hierarchy checkpoint path (restored if it exists)")
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
    r = run(args.L, args.mass, args.beta, args.n_refine, args.tol,
            args.schur, args.ckpt, device, args.cfg_dir)
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
