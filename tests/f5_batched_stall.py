"""Which side the complex64 stall of a batched solve is on (ROADMAP
Queue 3, F5): the same hierarchy through qmg_tpu's
``make_batched_planes_solver`` and through the port's
``make_batched_solver``, and alone through each package's single solve.
The port's single solve (``make_solver``) is its batched solve of a
one-lane batch, so its line and the one-lane batch's must agree; the two
lanes of the batch differ from it only where the batch's products round
differently.

The problem is the n16 stream's at L^2 (m = -0.06, tol 2e-6, seed 1337;
``--n-refine``, default 2): ``n_updates`` non-compact heatbath updates
from the cold start, the port's setup on that configuration from seeds
drawn after them (``setup_planes``), complex64 throughout, and two
identical point sources at the origin (spin 0) as the batch. Both
packages solve the one float32 state (``state_to_numpy``; qmg_tpu patches it into a ``structure_only``
scaffold). Prints each lane's outer iterations, recursive and true
relative residuals for both packages, and the single solves' counts.

    JAX_PLATFORMS=cpu python tests/f5_batched_stall.py --L 128 \
        --n-updates 2100 [--n-refine 3]
"""

import argparse
import time

import numpy as np
import torch
import jax
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.setup import (KCycleConfig as JKCycleConfig,
                           build_kcycle_hierarchy as jbuild)
from qmg_tpu.tpu_compat import (make_batched_planes_solver,
                                make_planes_solver, host_to_planes,
                                from_planes)

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.setup import KCycleConfig
from qmg_tpu_torch.setup_planes import (make_kcycle_setup_planes,
                                        gauss_seed_planes)
from qmg_tpu_torch.solve import (make_solver, make_batched_solver,
                                 state_to_numpy, state_from_numpy)
from qmg_tpu_torch.kcycle import true_residual
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch import u1, measure

MASS = -0.06
TOL = 2e-6
CFG = dict(coarse_dof=8, nullvec_tol=5e-4, nullvec_max_iter=200,
           coarsest_direct=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=128)
    p.add_argument("--n-updates", type=int, default=2100,
                   help="default: the stream's first configuration after "
                        "--n-therm 2000 (and --n-update 100)")
    p.add_argument("--n-refine", type=int, default=2)
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    L = args.L
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    cfg = KCycleConfig(n_refine=args.n_refine, **CFG)
    t0 = time.perf_counter()
    ph = u1.heatbath_noncompact_update(np.zeros((2, 2, L, L // 2)),
                                       lat.with_nc(1), 6.0, args.n_updates,
                                       rng)
    seeds = gauss_seed_planes(lat, cfg, rng)
    mg = make_kcycle_setup_planes(lat, cfg, MASS, device="cpu")(
        np.exp(1j * ph), *seeds)
    state = state_to_numpy(mg)
    plaq = u1.get_plaquette_u1(u1.phases_to_links(torch.as_tensor(ph)),
                               lat.with_nc(1))
    print(f"{L}^2 after {args.n_updates} updates: plaquette "
          f"{float(plaq.real):.5f}, setup {time.perf_counter() - t0:.1f} s",
          flush=True)
    src = measure.point_source(lat, 0, 0, 0, dtype=torch.complex64)
    B = torch.stack([src, src])
    kw = dict(tol=TOL, max_iter=200, restart_freq=32)

    tmg = state_from_numpy(state, cfg, device="cpu")
    op = tmg.get_stencil(0)
    # The plain applies (qmg_tpu's jnp route), and the stream's routes:
    # the rank-1 Wilson kernel and K6 (their plain twins on the CPU).
    for fine, coarse in ((None, "plain"), ("wilson-r1", "small")):
        route = f"{fine or 'plain'} + {coarse}"
        batched = make_batched_solver(tmg, fine_kernel=fine,
                                      coarse_apply=coarse, **kw)
        res, _ = batched(B)
        for k in range(2):
            print(f"port batched ({route}) lane {k}: {int(res.iters[k])} "
                  f"outer, recursive {float(torch.sqrt(res.res_sq[k])):.3e}"
                  f", true {true_residual(op, B[k], res.x[k]):.3e}",
                  flush=True)
        one, _ = make_solver(tmg, fine_kernel=fine, coarse_apply=coarse,
                             **kw)(src, track=False)
        lane, _ = batched(B[:1])
        print(f"port single ({route}): {one.iters} outer, true "
              f"{true_residual(op, src, one.x):.3e}; one-lane batch: "
              f"{int(lane.iters[0])} outer, true "
              f"{true_residual(op, src, lane.x[0]):.3e}", flush=True)

    jlat = JLattice2D(L, L, 2)
    jop = JWilson2D(jlat, MASS, jnp.ones((2, 2, L, L // 2), jnp.complex64),
                    dtype=jnp.complex64)
    jmg = jbuild(jlat, jop, JKCycleConfig(n_refine=args.n_refine, **CFG),
                 None, structure_only=True)
    b_p = host_to_planes(src.numpy())
    bsolve, _ = make_batched_planes_solver(jmg, **kw)
    X_p, iters, res_sq = jax.jit(bsolve)(state, jnp.stack([b_p, b_p]))
    X = np.array(from_planes(X_p))
    for k in range(2):
        print(f"qmg_tpu batched lane {k}: {int(iters[k])} outer, recursive "
              f"{float(np.sqrt(res_sq[k])):.3e}, true "
              f"{true_residual(op, B[k], torch.as_tensor(X[k])):.3e}",
              flush=True)
    solve, _ = make_planes_solver(jmg, **kw)
    x_p, it, _ = jax.jit(solve)(state, b_p)
    x = torch.as_tensor(np.array(from_planes(x_p)))
    print(f"qmg_tpu single: {int(it)} outer, true "
          f"{true_residual(op, src, x):.3e}", flush=True)


if __name__ == "__main__":
    main()
