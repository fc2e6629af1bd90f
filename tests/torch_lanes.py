"""Lane-by-lane checks of the port's batched solve, shared by the
tests/test_torch_*.py files that hold a formulation's batched solve (Schur,
the deflated CG coarsest, the CGNE smoother) to the port's single solve and
to qmg_tpu's vmapped batched solve (``make_batched_planes_solver``) on the
same hierarchy, at complex128."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from qmg_tpu.tpu_compat import (make_batched_planes_solver, host_to_planes,
                                from_planes)

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.reductions import gaussian_wall_source
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch.solve import make_solver, make_batched_solver

X_RTOL = 1e-10


def three_rhs(b):
    """(3, *cv_shape) complex128: the gaussian ``b``, a point source at the
    origin (colour 0) and a gaussian wall on timeslice 1, colour 1."""
    b = np.asarray(b)
    _, y_len, xh, nc = b.shape
    point = np.zeros_like(b)
    point[0, 0, 0, 0] = 1.0
    wall = gaussian_wall_source(Lattice2D(2 * xh, y_len, nc), 1, 1,
                                QMGRandom(7))
    return np.stack([b, point, wall])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_lanes(tmg, B, **solver_kw):
    """The port's batched solve of ``B`` against its single solves, lane by
    lane: outer iterations, ops_count and the per-level carry exactly, x
    within ``X_RTOL`` relative. Returns the batched result."""
    Bt = torch.as_tensor(B)
    res, carry = make_batched_solver(tmg, fine_kernel=None, **solver_kw)(Bt)
    assert bool(res.converged.all())
    single = make_solver(tmg, fine_kernel=None, **solver_kw)
    for k in range(len(B)):
        one, one_carry = single(Bt[k], track=False)
        assert int(res.iters[k]) == one.iters, k
        assert int(res.ops_count[k]) == one.ops_count, k
        assert carry["counts"][k].tolist() == one_carry["counts"].tolist()
        assert carry["iters"][k].tolist() == one_carry["iters"].tolist()
        assert _rel(res.x[k], one.x) <= X_RTOL, k
    return res


def check_qmg_tpu(jmg, state, B, res, **solver_kw):
    """qmg_tpu's vmapped batched solve of ``B`` on the planes ``state``:
    each lane's outer iterations those of the port's batched result
    ``res``, x within ``X_RTOL`` relative."""
    solve, _ = make_batched_planes_solver(jmg, **solver_kw)
    Xp, iters, _ = jax.jit(solve)(
        state, jnp.stack([host_to_planes(b, np.float64) for b in B]))
    X = np.asarray(from_planes(Xp))
    assert np.asarray(iters).tolist() == res.iters.tolist()
    for k in range(len(B)):
        assert _rel(res.x[k], X[k]) <= X_RTOL, k
