"""Port vs qmg_tpu on the rest of the Krylov suite (complex128): CG and
restarted CG, unrestarted GCR and flexible GCR, BiCGstab, TFQMR and
Richardson with identical iteration and operator counts and solutions
within 1e-10; the n11 CGNR / CGNE pair (qmg_tpu's
tests/test_n11_wilson_solvers.py); the direction-store guard; and the
K-cycle with ``restart_freq = -1`` on the intermediate and coarsest levels
(unrestarted flexible GCR and GCR) at qmg_tpu's outer and per-level
counts."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import solvers as jsolvers, u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.setup import (KCycleConfig as JKCycleConfig,
                           build_kcycle_hierarchy as jbuild)
from qmg_tpu.stencil import StencilType as JStencilType
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch import solvers as tsolvers
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.setup import (KCycleConfig as TKCycleConfig,
                                 build_kcycle_hierarchy as tbuild)
from qmg_tpu_torch.solve import make_solver
from qmg_tpu_torch.stencil import StencilType

torch.set_num_threads(1)

# qmg_tpu's n11 battery: 16^2, m = -0.03, tol 1e-8.
L = 16
MASS = -0.03
TOL = 1e-8


@pytest.fixture(scope="module")
def system():
    lat = Lattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(lat, rng, 6.0)
    b = rng.gaussian_cv(lat)
    jop = JWilson2D(lat, MASS, jnp.asarray(g))
    top = TWilson2D(TLattice2D(L, L, 2), MASS, g, dtype=torch.complex128)
    return jop, top, b


def _compare(jres, tres, x_tol=1e-10):
    assert tres.iters == int(jres.iters)
    assert tres.ops_count == int(jres.ops_count)
    assert bool(tres.converged) == bool(jres.converged)
    jx = np.asarray(jres.x)
    rel = np.linalg.norm(tres.x.numpy() - jx) / np.linalg.norm(jx)
    assert rel <= x_tol, rel


def _resid(top, b, x):
    bt = torch.as_tensor(b)
    return float(torch.linalg.vector_norm(bt - top.apply_M(x))
                 / torch.linalg.vector_norm(bt))


# Each solver: the operator type it solves (its right-hand side prepared
# for that type) and its arguments.
CASES = {
    "cg": (StencilType.MDAGGER_M, dict(max_iter=8000, tol=TOL)),
    "cg_restart": (StencilType.M_MDAGGER,
                   dict(max_iter=8000, tol=TOL, restart_freq=64)),
    "gcr": (StencilType.ORIGINAL, dict(max_iter=400, tol=TOL)),
    "bicgstab": (StencilType.ORIGINAL, dict(max_iter=4000, tol=TOL)),
    "tfqmr": (StencilType.ORIGINAL, dict(max_iter=4000, tol=TOL)),
    "richardson": (StencilType.ORIGINAL,
                   dict(max_iter=40, tol=1e-10, omega=0.2, blocksize=7)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solver_matches_qmg_tpu(system, name):
    jop, top, b = system
    stype, kw = CASES[name]
    jb, tb = jnp.asarray(b), torch.as_tensor(b)
    jres = getattr(jsolvers, name)(
        jop.get_apply_function(JStencilType(int(stype))),
        jop.prepare_M(jb, JStencilType(int(stype))), **kw)
    tres = getattr(tsolvers, name)(top.get_apply_function(stype),
                                   top.prepare_M(tb, stype), **kw)
    if name != "richardson":
        assert bool(tres.converged)
    _compare(jres, tres)


def test_gcr_var_precond_matches_qmg_tpu(system):
    """Unrestarted flexible GCR around a MinRes(2) preconditioner that
    threads a counter carry."""
    jop, top, b = system
    jmv, tmv = jop.get_apply_function(), top.get_apply_function()

    def jprec(r, carry):
        return jsolvers.minres(jmv, r, max_iter=2, tol=1e-15,
                               omega=0.85).x, carry + 1

    def tprec(r, carry):
        return tsolvers.minres(tmv, r, max_iter=2, tol=1e-15,
                               omega=0.85).x, carry + 1

    jres, jc = jsolvers.gcr_var_precond(jmv, jnp.asarray(b), jprec,
                                        max_iter=200, tol=TOL,
                                        precond_carry=jnp.int32(0))
    tres, tc = tsolvers.gcr_var_precond(tmv, torch.as_tensor(b), tprec,
                                        max_iter=200, tol=TOL,
                                        precond_carry=0)
    assert bool(tres.converged)
    assert tc == int(jc) == tres.iters
    _compare(jres, tres)


def test_cgnr_cgne_same_solution(system):
    """n11 / n17: CG on M^dag M x = M^dag b and on M M^dag y = b, x =
    M^dag y, reconstruct one solution (true residual < 1e-6 each, 1e-6
    apart), each at qmg_tpu's counts."""
    jop, top, b = system
    xs = []
    for stype in (StencilType.MDAGGER_M, StencilType.M_MDAGGER):
        jt = JStencilType(int(stype))
        jres = jsolvers.cg(jop.get_apply_function(jt),
                           jop.prepare_M(jnp.asarray(b), jt), max_iter=8000,
                           tol=TOL)
        tb = torch.as_tensor(b)
        tres = tsolvers.cg(top.get_apply_function(stype),
                           top.prepare_M(tb, stype), max_iter=8000, tol=TOL)
        _compare(jres, tres)
        x = top.reconstruct_M(tres.x, tb, stype)
        assert _resid(top, b, x) < 1e-6
        xs.append(x)
    assert float(torch.linalg.vector_norm(xs[0] - xs[1])
                 / torch.linalg.vector_norm(xs[0])) < 1e-6


def test_gcr_store_guard():
    """The unrestarted store (max_iter directions) over the 8 GiB limit is
    refused before any allocation, as in qmg_tpu; the restarted solve of
    the same field is not."""
    assert tsolvers.GCR_STORE_LIMIT_BYTES == jsolvers.GCR_STORE_LIMIT_BYTES
    big = torch.zeros((1 << 22,), dtype=torch.complex128)
    with pytest.raises(ValueError, match="direction store"):
        tsolvers.gcr(lambda x: x, big, max_iter=100000)
    with pytest.raises(ValueError, match="direction store"):
        tsolvers.gcr_var_precond(lambda x: x, big, lambda r, c: (r, c),
                                 max_iter=100000)
    res = tsolvers.gcr_restart(lambda x: 2 * x,
                               torch.ones(64, dtype=torch.complex128),
                               max_iter=50, tol=1e-12, restart_freq=8)
    assert bool(res.converged)
    # Just under the limit the store is allowed, just over it refused, at
    # the same size as qmg_tpu's guard.
    n = 1 << 10
    at_limit = jsolvers.GCR_STORE_LIMIT_BYTES // (2 * n * 16)
    field = torch.zeros((n,), dtype=torch.complex128)
    tsolvers._check_store(at_limit, field)
    with pytest.raises(ValueError, match="direction store"):
        tsolvers._check_store(at_limit + 1, field)
    with pytest.raises(ValueError, match="direction store"):
        jsolvers.gcr(lambda x: x, jnp.zeros((n,), jnp.complex128),
                     max_iter=at_limit + 1)


def test_kcycle_unrestarted_matches_qmg_tpu():
    """``intermediate_restart_freq = coarsest_restart_freq = -1`` (16^2,
    two refinements): the intermediate level solves with unrestarted
    flexible GCR and the coarsest with unrestarted GCR, at qmg_tpu's
    outer and per-level counts."""
    lat = Lattice2D(L, L, 2)
    kw = dict(n_refine=2, coarse_dof=4, nullvec_max_iter=150,
              nullvec_tol=5e-4, inner_restart_freq=-1,
              coarsest_restart_freq=-1)
    jrng, trng = JQMGRandom(1337), JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(lat, jrng, 6.0)
    ju1.gauss_gauge_u1(lat, trng, 6.0)
    jmg = jbuild(lat, JWilson2D(lat, -0.05, jnp.asarray(g)),
                 JKCycleConfig(**kw), jrng)
    top = TWilson2D(TLattice2D(L, L, 2), -0.05, g, dtype=torch.complex128)
    tmg = tbuild(TLattice2D(L, L, 2), top, TKCycleConfig(**kw), trng)
    assert [ls.intermediate_restart_freq for ls in tmg.level_solve_list] \
        == [-1, -1]
    b = jrng.gaussian_cv(lat)
    n = jmg.get_num_levels()
    jres = jmg.solve(jnp.asarray(b), tol=1e-9, max_iter=300,
                     restart_freq=32)
    res, carry = make_solver(tmg, tol=1e-9, max_iter=300, restart_freq=32,
                             fine_kernel=None)(torch.as_tensor(b))
    assert bool(res.converged) and res.iters == int(jres.iters)
    # The solve's counts (qmg_tpu's trackers also hold the setup's).
    assert carry["counts"][:, 1:].tolist() == [
        [jmg.get_tracker_count(t, lvl) for t in range(1, 4)]
        for lvl in range(n)]
    assert carry["iters"].tolist() == [jmg.get_iterations_count(lvl)
                                       for lvl in range(n)]
    assert _resid(top, b, res.x) < 1e-8
