"""Port vs qmg_tpu solvers on the same operator and rhs (complex128):
identical iteration and operator counts, solutions to 1e-10."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import solvers as jsolvers, u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch import solvers as tsolvers
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D

torch.set_num_threads(1)

L = 16
MASS = -0.06


@pytest.fixture(scope="module")
def system():
    lat = Lattice2D(L, L, 2)
    g = ju1.gauss_gauge_u1(lat, JQMGRandom(1337), 6.0)
    jop = JWilson2D(lat, MASS, jnp.asarray(g), dtype=jnp.complex128)
    top = TWilson2D(TLattice2D(L, L, 2), MASS, g, dtype=torch.complex128)
    b = JQMGRandom(21).gaussian_cv(lat)
    return jop.get_apply_function(), top.get_apply_function(), b


def _compare(jres, tres, x_tol=1e-10):
    assert tres.iters == int(jres.iters)
    assert tres.ops_count == int(jres.ops_count)
    assert bool(tres.converged) == bool(jres.converged)
    jx = np.asarray(jres.x)
    rel = np.linalg.norm(tres.x.numpy() - jx) / np.linalg.norm(jx)
    assert rel <= x_tol, rel


@pytest.mark.parametrize("max_iter,tol", [(2, 1e-15), (12, 0.3)],
                         ids=["unrolled", "tolerance"])
def test_minres_relaxed(system, max_iter, tol):
    jmv, tmv, b = system
    jres = jsolvers.minres(jmv, jnp.asarray(b), max_iter=max_iter, tol=tol,
                           omega=0.85)
    tres = tsolvers.minres(tmv, torch.as_tensor(b), max_iter=max_iter,
                           tol=tol, omega=0.85)
    _compare(jres, tres)


def test_bicgstab_l(system):
    jmv, tmv, b = system
    jres = jsolvers.bicgstab_l(jmv, jnp.asarray(b), max_iter=300, tol=1e-8,
                               l=6)
    tres = tsolvers.bicgstab_l(tmv, torch.as_tensor(b), max_iter=300,
                               tol=1e-8, l=6)
    assert bool(tres.converged)
    _compare(jres, tres)


def test_gcr_restart(system):
    jmv, tmv, b = system
    jres = jsolvers.gcr_restart(jmv, jnp.asarray(b), max_iter=400, tol=1e-8,
                                restart_freq=16)
    tres = tsolvers.gcr_restart(tmv, torch.as_tensor(b), max_iter=400,
                                tol=1e-8, restart_freq=16)
    assert bool(tres.converged)
    _compare(jres, tres)


def test_gcr_var_precond_restart(system):
    """Flexible GCR with a MinRes(2) preconditioner threading a counter
    carry."""
    jmv, tmv, b = system

    def jprec(r, carry):
        return jsolvers.minres(jmv, r, max_iter=2, tol=1e-15,
                               omega=0.85).x, carry + 1

    def tprec(r, carry):
        return tsolvers.minres(tmv, r, max_iter=2, tol=1e-15,
                               omega=0.85).x, carry + 1

    jres, jcarry = jsolvers.gcr_var_precond_restart(
        jmv, jnp.asarray(b), jprec, max_iter=200, tol=1e-8, restart_freq=8,
        precond_carry=jnp.int32(0))
    tres, tcarry = tsolvers.gcr_var_precond_restart(
        tmv, torch.as_tensor(b), tprec, max_iter=200, tol=1e-8,
        restart_freq=8, precond_carry=0)
    assert bool(tres.converged)
    assert tcarry == int(jcarry) == tres.iters
    _compare(jres, tres)
