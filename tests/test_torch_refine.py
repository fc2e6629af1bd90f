"""Port vs qmg_tpu on mixed-precision refinement (qmg_tpu's
tests/test_refine.py): the outer complex128 operator (a complex64
stencil's coefficients promoted with ``StencilCoeffs.to`` and applied by
``apply_M``) against qmg_tpu's host apply of the same stencil, shifts
included; the refined solve of a complex64 hierarchy to a true complex128
residual below 1e-10 in the same passes and inner iterations as qmg_tpu's
``make_refined_planes_solver`` on the same hierarchy; and the stop at an
inner solver's floor."""

import numpy as np
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1, checkpoint as jcheckpoint
from qmg_tpu import refine as jrefine
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.tpu_compat import make_refined_planes_solver
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch import checkpoint as tcheckpoint
from qmg_tpu_torch.kcycle import true_residual
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.refine import refine_solve
from qmg_tpu_torch.setup import (KCycleConfig as TKCycleConfig,
                                 build_kcycle_hierarchy as tbuild)
from qmg_tpu_torch.solve import make_refined_solver
from qmg_tpu_torch.stencil import make_coeffs, apply_M

torch.set_num_threads(1)


def test_promoted_apply_matches_host_apply():
    """A complex64 Wilson operator's coefficients promoted to complex128
    apply as qmg_tpu's complex128 host copy of the same operator (the
    outer operator of its refinement)."""
    lat = Lattice2D(16, 16, 2)
    rng = JQMGRandom(1337)
    g = np.asarray(ju1.gauss_gauge_u1(lat, rng, 6.0)).astype(np.complex64)
    op = TWilson2D(TLattice2D(16, 16, 2), -0.05, g, dtype=torch.complex64)
    c128 = op.coeffs.to(torch.complex128)
    assert c128.ref.dtype == torch.complex128
    assert op.coeffs.ref.dtype == torch.complex64
    x = rng.gaussian_cv(lat)
    got = apply_M(c128, torch.as_tensor(x)).numpy()
    jop = JWilson2D(lat, -0.05, jnp.asarray(g), dtype=jnp.complex64)
    want = jrefine.HostStencil(jop).apply(x)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_promoted_apply_shifts():
    """The shifts of a complex64 set survive the promotion: the eo and
    dof shifts as qmg_tpu's complex128 host apply takes them."""
    lat = Lattice2D(8, 8, 4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=lat.cv_shape()) + 1j * rng.normal(size=lat.cv_shape())
    clover = (rng.normal(size=lat.cm_shape())
              + 1j * rng.normal(size=lat.cm_shape())).astype(np.complex64)
    c64 = make_coeffs(TLattice2D(8, 8, 4), clover=torch.as_tensor(clover),
                      shift=0.3, eo_shift=0.1, dof_shift=0.05,
                      dtype=torch.complex64)
    c128 = c64.to(torch.complex128)
    assert (c128.shift, c128.eo_shift, c128.dof_shift) \
        == (c64.shift, c64.eo_shift, c64.dof_shift)
    got = apply_M(c128, torch.as_tensor(x)).numpy()
    want = jrefine.host_apply_M(clover, None, x, shift=c64.shift,
                                eo_shift=c64.eo_shift,
                                dof_shift=c64.dof_shift)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def _refined_problem(L, n_refine, tmp_path):
    """A complex64 hierarchy built by the port from a complex64 gauge (the
    host operator is that of the same links), and qmg_tpu's copy of it
    through a checkpoint."""
    lat = Lattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    g = np.asarray(ju1.gauss_gauge_u1(lat, rng, 6.0)).astype(np.complex64)
    op = TWilson2D(TLattice2D(L, L, 2), -0.05, g, dtype=torch.complex64)
    mg = tbuild(TLattice2D(L, L, 2), op,
                TKCycleConfig(n_refine=n_refine, coarse_dof=8,
                              coarsest_direct=True), rng)
    b = rng.gaussian_cv(lat)
    path = str(tmp_path / "mg.npz")
    tcheckpoint.save_hierarchy(mg, path)
    jmg = jcheckpoint.load_hierarchy(
        path, JWilson2D(lat, -0.05, jnp.asarray(g), dtype=jnp.complex64))
    return mg, jmg, b


def test_refine_reaches_1e10_32sq(tmp_path):
    """The complex64 K-cycle inside complex128 defect correction clears
    1e-10 (a bare complex64 solve stops near 1e-6), in the passes and
    inner iterations of qmg_tpu's refined solver on the same hierarchy."""
    mg, jmg, b = _refined_problem(32, 2, tmp_path)
    solve = make_refined_solver(mg, tol=1e-10, inner_tol=1e-5,
                                max_iter=200, restart_freq=32,
                                fine_kernel=None)
    res = solve(torch.as_tensor(b))
    assert res.converged, f"history={res.history}"
    assert res.rel_resid < 1e-10 and res.outer_iters <= 8
    assert res.history[0] == 1.0
    assert res.x.dtype == torch.complex128
    assert true_residual(mg.get_stencil(0), torch.as_tensor(b), res.x) < 1e-10
    jsolve, _ = make_refined_planes_solver(jmg, tol=1e-10, inner_tol=1e-5,
                                           max_iter=200, restart_freq=32)
    jres = jsolve(b)
    assert jres.converged
    assert res.outer_iters == jres.outer_iters
    assert res.inner_iters == jres.inner_iters
    np.testing.assert_allclose(res.history, jres.history, rtol=0.5)


def test_refine_inner_floor_detected():
    """A solver that makes no progress stops the loop after one pass,
    unconverged, as in qmg_tpu."""
    lat = TLattice2D(16, 16, 2)
    g = ju1.gauss_gauge_u1(Lattice2D(16, 16, 2), JQMGRandom(1337), 6.0)
    c = TWilson2D(lat, -0.05, g, dtype=torch.complex128).coeffs
    b = JQMGRandom(2).gaussian_cv(Lattice2D(16, 16, 2))

    def bad_inner(r):
        return r * 0, 0

    res = refine_solve(lambda x: apply_M(c, x), bad_inner,
                       torch.as_tensor(b), tol=1e-10, max_outer=5)
    jres = jrefine.refine_solve(jrefine.HostStencil(
        clover=c.clover.numpy(), hopping=c.hopping.numpy(), shift=c.shift),
        bad_inner, b, tol=1e-10, max_outer=5)
    assert not res.converged and res.outer_iters <= 1
    assert (res.outer_iters, res.history) == (jres.outer_iters,
                                              jres.history)
    zero = refine_solve(lambda x: apply_M(c, x), bad_inner,
                        torch.zeros(lat.cv_shape(), dtype=torch.complex128))
    assert zero.converged and zero.outer_iters == 0
