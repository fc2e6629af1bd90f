"""What qmg_tpu's batched solve does on a Schur hierarchy without
``outer_type`` (ROADMAP Queue 3, F12): bench.py's ``--nrhs`` mode builds
its batched solver with ``make_batched_planes_solver(mg, ...)`` and no
``outer_type`` even under ``--outer schur``, although the single path
passes it. This script builds the n19 hierarchy at 16^2 (complex128, one
refinement, the dense coarsest, as tests/test_n19_schur_kcycle.py does) and
solves three gaussians through the batched solver without ``outer_type``
and with ``outer_type=RIGHT_SCHUR``, printing each one's per-lane outer
iterations and true residuals, or the error it raised. The port's
``--nrhs`` mode passes ``outer_type``.

    JAX_PLATFORMS=cpu python tests/f12_batched_schur_outer_type.py
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from qmg_tpu.lattice import Lattice2D  # noqa: E402
from qmg_tpu import u1  # noqa: E402
from qmg_tpu.operators import Wilson2D  # noqa: E402
from qmg_tpu.operators.coarse import CoarseOperator2D  # noqa: E402
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy  # noqa: E402
from qmg_tpu.stencil import StencilType  # noqa: E402
from qmg_tpu.tpu_compat import (make_batched_planes_solver,  # noqa: E402
                                mg_state_planes, derived_state_planes,
                                host_to_planes, from_planes)
from qmg_tpu.rng import QMGRandom  # noqa: E402


def main():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    lat = Lattice2D(16, 16, 2)
    rng = QMGRandom(1337)
    op = Wilson2D(lat, -0.05, jnp.asarray(u1.gauss_gauge_u1(lat, rng, 6.0)))
    schur = StencilType.RIGHT_SCHUR
    mg = build_kcycle_hierarchy(lat, op, KCycleConfig(
        n_refine=1, coarse_dof=8, coarsest_direct=True,
        fine_stencil_app=schur, coarsest_stencil_app=schur,
        nullvec_stype=StencilType.RIGHT_JACOBI, nullvec_solver="gcr_restart",
        precond_coarsen_rbjacobi=True,
        build_extra=CoarseOperator2D.BUILD_RBJACOBI), rng)
    B = np.stack([rng.gaussian_cv(lat) for _ in range(3)])
    state = mg_state_planes(mg, dtype=np.float64)
    state.update(derived_state_planes(mg, schur, dtype=np.float64))
    Bp = jnp.stack([host_to_planes(b, np.float64) for b in B])
    for label, kw in (("without outer_type (bench.py --nrhs)", {}),
                      ("outer_type=RIGHT_SCHUR", {"outer_type": schur})):
        try:
            solve, _ = make_batched_planes_solver(
                mg, tol=1e-8, max_iter=200, restart_freq=32, **kw)
            Xp, iters, _ = jax.jit(solve)(state, Bp)
        except Exception as e:  # the finding is the error itself
            print(f"{label}: {type(e).__name__}: {str(e)[:300]}")
            continue
        X = np.asarray(from_planes(Xp))
        true = [float(np.linalg.norm(B[k] - np.asarray(op.apply_M(
            jnp.asarray(X[k])))) / np.linalg.norm(B[k])) for k in range(3)]
        print(f"{label}: outer iterations {np.asarray(iters).tolist()}, "
              f"true relres {', '.join(f'{t:.3e}' for t in true)}")


if __name__ == "__main__":
    main()
