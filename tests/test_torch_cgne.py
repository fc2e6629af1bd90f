"""Port vs qmg_tpu on the CGNE smoother and the normal-operator solves
(complex128): the K-cycle whose smoothers run MinRes on M M^dag and then
M^dag (``LevelSolveMG(pre_cgne=, post_cgne=)``) at qmg_tpu's outer and
per-level counts, on ORIGINAL and on right-block-Jacobi levels, and
batched lane by lane; and the
n17 / n21 normal solves of qmg_tpu's tests/test_n17_n18_n21_variants.py
(CGNR and CGNE on M and on its rbjacobi form reconstruct one solution) at
qmg_tpu's counts.

qmg_tpu gets the port's hierarchy through a checkpoint
(``qmg_tpu_torch.checkpoint.save_hierarchy`` ->
``qmg_tpu.checkpoint.load_hierarchy``), so both solve on the same
coefficients."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1, solvers as jsolvers, checkpoint as jcheckpoint
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.stencil import StencilType as JStencilType
from qmg_tpu.rng import QMGRandom as JQMGRandom
from qmg_tpu.tpu_compat import mg_state_planes

from qmg_tpu_torch import solvers as tsolvers, checkpoint as tcheckpoint
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.setup import (KCycleConfig as TKCycleConfig,
                                 build_kcycle_hierarchy as tbuild)
from qmg_tpu_torch.solve import make_solver
from qmg_tpu_torch.stencil import StencilType, DERIVED_BUILDS
from torch_lanes import three_rhs, check_lanes, check_qmg_tpu

torch.set_num_threads(1)

L = 32
MASS = -0.05


def _tracker(jmg):
    n = jmg.get_num_levels()
    return (np.array([[jmg.get_tracker_count(t, lvl) for t in range(4)]
                      for lvl in range(n)]),
            np.array([jmg.get_iterations_count(lvl) for lvl in range(n)]))


@pytest.fixture(scope="module")
def hierarchy(tmp_path_factory):
    """The port's 32^2 hierarchy (two refinements to 2^2 nc8, GCR
    coarsest) and the same one loaded by qmg_tpu."""
    lat = TLattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(Lattice2D(L, L, 2), rng, 6.0)
    top = TWilson2D(lat, MASS, g, dtype=torch.complex128)
    tmg = tbuild(lat, top, TKCycleConfig(n_refine=2, coarse_dof=8,
                                         nullvec_max_iter=150,
                                         nullvec_tol=5e-4), rng)
    b = rng.gaussian_cv(Lattice2D(L, L, 2))
    path = str(tmp_path_factory.mktemp("cgne") / "mg.npz")
    tcheckpoint.save_hierarchy(tmg, path)
    jmg = jcheckpoint.load_hierarchy(
        path, JWilson2D(Lattice2D(L, L, 2), MASS, jnp.asarray(g)))
    return top, tmg, jmg, b


@pytest.mark.parametrize("fine,pre,post", [
    (StencilType.ORIGINAL, True, True),
    (StencilType.ORIGINAL, True, False),
    (StencilType.RIGHT_JACOBI, True, True)],
    ids=["original-pre-post", "original-pre", "rbjacobi-pre-post"])
def test_cgne_kcycle_matches_qmg_tpu(hierarchy, fine, pre, post):
    """The CGNE-smoother K-cycle (every level; outer operator the levels'
    type) at qmg_tpu's outer and per-level counts, and M M^dag's sets
    built once, by the solver's make, not per iteration."""
    top, tmg, jmg, b = hierarchy
    saved_t = list(tmg.level_solve_list)
    saved_j = list(jmg.level_solve_list)
    kw = dict(fine_stencil_app=fine, pre_cgne=pre, post_cgne=post)
    tmg.level_solve_list = [dataclasses.replace(ls, **kw) for ls in saved_t]
    jmg.level_solve_list = [dataclasses.replace(
        ls, **dict(kw, fine_stencil_app=JStencilType(int(fine))))
        for ls in saved_j]
    # qmg_tpu's compiled-solve cache is not keyed on the level configs.
    jmg._solve_cache.clear()
    try:
        c0, i0 = _tracker(jmg)
        jres = jmg.solve(jnp.asarray(b), tol=1e-9, max_iter=300,
                         restart_freq=32,
                         outer_type=JStencilType(int(fine)))
        c1, i1 = _tracker(jmg)
        solve = make_solver(tmg, tol=1e-9, max_iter=300, restart_freq=32,
                            fine_kernel=None, outer_type=fine)
        built = DERIVED_BUILDS.copy()
        res, carry = solve(torch.as_tensor(b))
        assert DERIVED_BUILDS == built
    finally:
        tmg.level_solve_list = saved_t
        jmg.level_solve_list = saved_j
    assert bool(res.converged) and res.iters == int(jres.iters)
    assert carry["counts"].tolist() == (c1 - c0).tolist()
    assert carry["iters"].tolist() == (i1 - i0).tolist()
    # Each CGNE smoothing is 2 x MinRes ops + 1 (the M^dag apply).
    assert carry["counts"][0, 2] > 0
    bt = torch.as_tensor(b)
    rel = torch.linalg.vector_norm(bt - top.apply_M(res.x)) \
        / torch.linalg.vector_norm(bt)
    assert float(rel) < 1e-8


def test_batched_cgne_matches_single_and_qmg_tpu(hierarchy):
    """The batched K-cycle with the CGNE smoother before and after on the
    fine level (one smoother closure serves every level; the coarse
    levels' CGNE would only lengthen qmg_tpu's jit), on a gaussian, a
    point and a wall source: each lane the port's single solve
    (iterations, carries, ops exactly; x to 1e-10) and qmg_tpu's
    ``make_batched_planes_solver`` on the same hierarchy (iterations; x
    to 1e-10)."""
    _, tmg, jmg, b = hierarchy
    saved_t = list(tmg.level_solve_list)
    saved_j = list(jmg.level_solve_list)
    tmg.level_solve_list = [dataclasses.replace(saved_t[0], pre_cgne=True,
                                                post_cgne=True)] + saved_t[1:]
    jmg.level_solve_list = [dataclasses.replace(saved_j[0], pre_cgne=True,
                                                post_cgne=True)] + saved_j[1:]
    try:
        B = three_rhs(b)
        kw = dict(tol=1e-9, max_iter=300, restart_freq=32)
        res = check_lanes(tmg, B, **kw)
        check_qmg_tpu(jmg, mg_state_planes(jmg, dtype=np.float64), B, res,
                      **kw)
    finally:
        tmg.level_solve_list = saved_t
        jmg.level_solve_list = saved_j


# --- n17 / n21: the normal solves on a noised-clover Wilson operator ------

@pytest.fixture(scope="module")
def noised_wilson():
    """qmg_tpu's n18 operator: 12^2, m = 0.25, the clover noised so that
    the block-Jacobi B is a nontrivial per-site matrix."""
    lat = Lattice2D(12, 12, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(lat, rng, 6.0)
    noise = 0.125 * (rng.gaussian_real(lat.cm_shape())
                     + 1j * rng.gaussian_real(lat.cm_shape()))
    jop = JWilson2D(lat, 0.25, jnp.asarray(g))
    jop.update_coeffs(clover=jop.coeffs.clover + jnp.asarray(noise))
    top = TWilson2D(TLattice2D(12, 12, 2), 0.25, g, dtype=torch.complex128)
    top.update_coeffs(clover=top.coeffs.clover + torch.as_tensor(noise))
    return jop, top, rng.gaussian_cv(lat)


@pytest.mark.parametrize("pair", [
    (StencilType.MDAGGER_M, StencilType.M_MDAGGER),
    (StencilType.RBJ_MDAGGER_M, StencilType.RBJ_M_MDAGGER)],
    ids=["n17", "n21-rbjacobi"])
def test_normal_solves_match_qmg_tpu(noised_wilson, pair):
    """CGNR and CGNE at qmg_tpu's counts and solutions (1e-10), each with a
    true residual < 1e-6, the two solutions 1e-5 apart."""
    jop, top, b = noised_wilson
    bt = torch.as_tensor(b)
    xs = []
    for stype in pair:
        jt = JStencilType(int(stype))
        jres = jsolvers.cg(jop.get_apply_function(jt),
                           jop.prepare_M(jnp.asarray(b), jt), max_iter=8000,
                           tol=1e-10)
        tres = tsolvers.cg(top.get_apply_function(stype),
                           top.prepare_M(bt, stype), max_iter=8000,
                           tol=1e-10)
        assert bool(tres.converged)
        assert (tres.iters, tres.ops_count) == (int(jres.iters),
                                                int(jres.ops_count))
        jx = np.asarray(jop.reconstruct_M(jres.x, jnp.asarray(b), jt))
        x = top.reconstruct_M(tres.x, bt, stype)
        assert np.linalg.norm(x.numpy() - jx) / np.linalg.norm(jx) < 1e-10
        rel = torch.linalg.vector_norm(bt - top.apply_M(x)) \
            / torch.linalg.vector_norm(bt)
        assert float(rel) < 1e-6
        xs.append(x)
    assert float(torch.linalg.vector_norm(xs[0] - xs[1])
                 / torch.linalg.vector_norm(xs[0])) < 1e-5
