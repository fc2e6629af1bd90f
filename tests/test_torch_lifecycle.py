"""Port vs qmg_tpu on the hierarchy's lifecycle (complex128, 16^2):
``push_level`` three times, ``pop_level``, ``update_level`` with new
transfers, the per-level trackers (``get_tracker_count``,
``query_average_iterations``, ``shift_all_to_nullvec``,
``reset_tracker``) and ``StatefulMultigridMG.solve``; what a change of the
coarsest level drops; solvers made before a change are refused; the n09
free-field leg (geometric null vectors, 3 then 2 levels); the
``structure_only`` scaffold and ``KCycleConfig``'s fields.

Both packages push levels from the same raw null vectors (those of a
qmg_tpu n13 build with 2x2 blocking, and a numpy-seeded perturbation of
them for the updates), so the transfers and Galerkin levels are compared
element by element."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.setup import (KCycleConfig as JKCycleConfig,
                           build_kcycle_hierarchy as jbuild)
from qmg_tpu.stateful import (StatefulMultigridMG as JStatefulMG,
                              LevelSolveMG as JLevelSolveMG,
                              CoarsestSolveMG as JCoarsestSolveMG)
from qmg_tpu.transfer import (TransferMG as JTransferMG,
                              DoublingType as JDoublingType)
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.setup import (KCycleConfig as TKCycleConfig,
                                 build_kcycle_hierarchy as tbuild)
from qmg_tpu_torch.stateful import (StatefulMultigridMG, LevelSolveMG,
                                    CoarsestSolveMG, DSLASH_NULLVEC,
                                    DSLASH_KRYLOV)
from qmg_tpu_torch.transfer import TransferMG, DoublingType
from qmg_tpu_torch.solve import make_solver, make_batched_solver
from qmg_tpu_torch import u1 as tu1

torch.set_num_threads(1)

L = 16
MASS = -0.05
BLOCK = 2
NC = 4
LEVEL_SOLVE = dict(intermediate_tol=0.2, intermediate_iters=1000,
                   intermediate_restart_freq=32, pre_iters=2, post_iters=2)
COARSEST = dict(coarsest_tol=0.2, coarsest_iters=1000,
                coarsest_restart_freq=32)
SOLVE = dict(tol=1e-9, max_iter=300, restart_freq=32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _lats():
    return [(L >> k, L >> k, 2 if k == 0 else NC) for k in range(4)]


@pytest.fixture(scope="module")
def raws():
    """The gauge field, right-hand side and two sets of raw (doubled) null
    vectors per level: qmg_tpu's n13 build at 2x2 blocking, and the same
    plus 0.1 x a numpy-seeded gaussian."""
    lat = Lattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(lat, rng, 6.0)
    jop = JWilson2D(lat, MASS, jnp.asarray(g), dtype=jnp.complex128)
    jmg = jbuild(lat, jop, JKCycleConfig(
        n_refine=3, x_block=BLOCK, y_block=BLOCK, coarse_dof=NC,
        nullvec_max_iter=100, nullvec_tol=5e-4), rng)
    a = [np.asarray(jmg.get_global_null_vectors(i)) for i in range(3)]
    noise = np.random.default_rng(11)
    b = [v + 0.1 * (noise.standard_normal(v.shape)
                    + 1j * noise.standard_normal(v.shape)) for v in a]
    return g, rng.gaussian_cv(lat), a, b


def _jax_push(jmg, raw, lvl, update=False):
    lats = [Lattice2D(*d) for d in _lats()]
    t = JTransferMG(lats[lvl], lats[lvl + 1], jnp.asarray(raw),
                    do_block_ortho=True, doubling=JDoublingType.PROJECTION)
    kw = dict(build_stencil=True, is_chiral=True, nvecs=raw)
    if update:
        jmg.update_level(lvl + 1, lats[lvl + 1], t,
                         JLevelSolveMG(**LEVEL_SOLVE), **kw)
    else:
        jmg.push_level(lats[lvl + 1], t, JLevelSolveMG(**LEVEL_SOLVE), **kw)


def _port_push(tmg, raw, lvl, update=False):
    lats = [TLattice2D(*d) for d in _lats()]
    raw = torch.as_tensor(np.array(raw))
    t = TransferMG(lats[lvl], lats[lvl + 1], raw,
                   doubling=DoublingType.PROJECTION)
    kw = dict(build_stencil=True, is_chiral=True, nvecs=raw)
    if update:
        tmg.update_level(lvl + 1, lats[lvl + 1], t,
                         LevelSolveMG(**LEVEL_SOLVE), **kw)
    else:
        tmg.push_level(lats[lvl + 1], t, LevelSolveMG(**LEVEL_SOLVE), **kw)


def _pair(raws):
    g = raws[0]
    jmg = JStatefulMG(Lattice2D(L, L, 2),
                      JWilson2D(Lattice2D(L, L, 2), MASS, jnp.asarray(g),
                                dtype=jnp.complex128),
                      JCoarsestSolveMG(**COARSEST))
    tmg = StatefulMultigridMG(
        TLattice2D(L, L, 2),
        TWilson2D(TLattice2D(L, L, 2), MASS, g, dtype=torch.complex128,
                  device="cpu"),
        CoarsestSolveMG(**COARSEST))
    return jmg, tmg


def _tracker(jmg):
    n = jmg.get_num_levels()
    return (np.array([[jmg.get_tracker_count(t, lvl) for t in range(4)]
                      for lvl in range(n)]),
            np.array([jmg.get_iterations_count(lvl) for lvl in range(n)]))


def _same_trackers(jmg, tmg):
    counts, iters = _tracker(jmg)
    assert tmg.tracker["counts"].tolist() == counts.tolist()
    assert tmg.tracker["iters"].tolist() == iters.tolist()
    n = jmg.get_num_levels()
    for lvl in range(n):
        for t in range(4):
            assert tmg.get_tracker_count(t, lvl) == \
                jmg.get_tracker_count(t, lvl)
        assert tmg.get_total_count(lvl) == jmg.get_total_count(lvl)
        assert tmg.get_iterations_count(lvl) == \
            jmg.get_iterations_count(lvl)
    assert tmg.query_average_iterations() == pytest.approx(
        jmg.query_average_iterations(), rel=1e-15)


def _same_levels(jmg, tmg, bar=1e-12):
    assert jmg.get_num_levels() == tmg.get_num_levels()
    assert tmg.is_stencil_managed == jmg.is_stencil_managed
    for lvl in range(jmg.get_num_levels()):
        jl, tl = jmg.get_lattice(lvl), tmg.get_lattice(lvl)
        assert (jl.x_len, jl.y_len, jl.nc) == (tl.x_len, tl.y_len, tl.nc)
        jc, tc = jmg.get_stencil(lvl).coeffs, tmg.get_stencil(lvl).coeffs
        assert _rel(tc.clover, jc.clover) <= bar
        assert _rel(tc.hopping, jc.hopping) <= bar
    for lvl in range(jmg.get_num_levels() - 1):
        assert _rel(tmg.get_transfer(lvl)._nvb,
                    jmg.get_transfer(lvl)._nvb) <= bar
        assert _rel(tmg.get_global_null_vectors(lvl),
                    jmg.get_global_null_vectors(lvl)) == 0.0


def _jax_solve(jmg, b, **kw):
    jmg._solve_cache.clear()
    return jmg.solve(jnp.asarray(b), **(kw or SOLVE))


def test_push_pop_update_solve_and_trackers(raws):
    """Three pushes, a pop and two updates: the same levels (1e-12); then a
    solve with qmg_tpu's outer count, per-level counts and average
    iterations; ``shift_all_to_nullvec`` and ``reset_tracker`` act alike."""
    _, b, a, bb = raws
    jmg, tmg = _pair(raws)
    for lvl in range(3):
        _jax_push(jmg, a[lvl], lvl)
        _port_push(tmg, a[lvl], lvl)
    _same_levels(jmg, tmg)
    jmg.pop_level()
    tmg.pop_level()
    _same_levels(jmg, tmg)
    for lvl in range(2):
        _jax_push(jmg, bb[lvl], lvl, update=True)
        _port_push(tmg, bb[lvl], lvl, update=True)
    _same_levels(jmg, tmg)
    jmg.add_tracker_count(DSLASH_NULLVEC, 7, 1)
    tmg.add_tracker_count(DSLASH_NULLVEC, 7, 1)

    jres = _jax_solve(jmg, b)
    tres = tmg.solve(torch.as_tensor(b), **SOLVE)
    assert bool(jres.converged) and bool(tres.converged)
    assert int(tres.iters) == int(jres.iters)
    assert _rel(tres.x, jres.x) <= 1e-9
    _same_trackers(jmg, tmg)
    assert tmg.query_average_iterations()[0] == float(tres.iters)

    jmg.shift_all_to_nullvec(1)
    tmg.shift_all_to_nullvec(1)
    _same_trackers(jmg, tmg)
    assert tmg.get_tracker_count(DSLASH_KRYLOV, 1) == 0
    jmg.reset_tracker(2)
    tmg.reset_tracker(2)
    _same_trackers(jmg, tmg)
    tmg.add_iterations_count(3, 0)
    jmg.add_iterations_count(3, 0)
    _same_trackers(jmg, tmg)
    jmg.reset_tracker()
    tmg.reset_tracker()
    _same_trackers(jmg, tmg)
    assert tmg.get_total_count(0) == 0

    # An untracked solve leaves the trackers as they are.
    tres = tmg.solve(torch.as_tensor(b), track=False, **SOLVE)
    assert tmg.get_total_count(0) == 0 and bool(tres.converged)
    # From the solution, no iteration is needed.
    tres2 = tmg.solve(torch.as_tensor(b), x0=tres.x, **SOLVE)
    assert int(tres2.iters) == 0


def test_update_keeps_trackers(raws):
    """``update_level`` keeps the level's counts, ``pop_level`` drops the
    popped level's, ``push_level`` starts a new level at zero."""
    _, _, a, bb = raws
    jmg, tmg = _pair(raws)
    for lvl in range(2):
        _jax_push(jmg, a[lvl], lvl)
        _port_push(tmg, a[lvl], lvl)
    for lvl, n in ((0, 5), (1, 6), (2, 9)):
        jmg.add_tracker_count(DSLASH_KRYLOV, n, lvl)
        tmg.add_tracker_count(DSLASH_KRYLOV, n, lvl)
        jmg.add_iterations_count(n + 1, lvl)
        tmg.add_iterations_count(n + 1, lvl)
    _jax_push(jmg, bb[1], 1, update=True)
    _port_push(tmg, bb[1], 1, update=True)
    _same_trackers(jmg, tmg)
    assert tmg.get_tracker_count(DSLASH_KRYLOV, 2) == 9
    jmg.pop_level()
    tmg.pop_level()
    _same_trackers(jmg, tmg)
    _jax_push(jmg, bb[1], 1)
    _port_push(tmg, bb[1], 1)
    _same_trackers(jmg, tmg)
    assert tmg.get_total_count(2) == 0


@pytest.mark.parametrize("change", ["update_coarsest", "update_middle",
                                    "pop", "push"])
def test_coarsest_change_drops_dense_inverse(raws, change):
    """A change of the coarsest level drops its dense inverse (as qmg_tpu
    does) and its deflation pairs (which belong to the old coarsest
    operator); an update of a finer level keeps both."""
    _, _, a, bb = raws
    jmg, tmg = _pair(raws)
    for lvl in range(3):
        _jax_push(jmg, a[lvl], lvl)
        _port_push(tmg, a[lvl], lvl)
    jmg.prepare_direct_coarsest()
    tmg.prepare_direct_coarsest()
    tmg.coarsest_evals = torch.ones(1, dtype=torch.complex128)
    tmg.coarsest_evecs = torch.ones((1,) + tmg.get_lattice(3).cv_shape(),
                                    dtype=torch.complex128)
    if change == "update_coarsest":
        _jax_push(jmg, bb[2], 2, update=True)
        _port_push(tmg, bb[2], 2, update=True)
    elif change == "update_middle":
        _jax_push(jmg, bb[1], 1, update=True)
        _port_push(tmg, bb[1], 1, update=True)
    elif change == "pop":
        jmg.pop_level()
        tmg.pop_level()
    else:
        jmg.pop_level()
        tmg.pop_level()
        jmg.prepare_direct_coarsest()
        tmg.prepare_direct_coarsest()
        _jax_push(jmg, bb[2], 2)
        _port_push(tmg, bb[2], 2)
    kept = change == "update_middle"
    assert (jmg.coarsest_dinv is not None) == kept
    assert (tmg.coarsest_dinv is not None) == kept
    assert (tmg.coarsest_evecs is not None) == kept
    assert tmg.coarsest_solve.direct == jmg.coarsest_solve.direct


@pytest.mark.parametrize("change", ["pop_level", "update_level",
                                    "push_level", "prepare_direct_coarsest",
                                    "deflate_coarsest"])
def test_solver_refused_after_change(raws, change):
    """A solver holds the levels it was made on: once the hierarchy has
    changed, its solve (and a batched one's) raises instead of solving on
    the old levels; a new solver solves."""
    _, b, a, bb = raws
    _, tmg = _pair(raws)
    for lvl in range(3):
        _port_push(tmg, a[lvl], lvl)
    b = torch.as_tensor(b)
    solve = make_solver(tmg, fine_kernel=None, **SOLVE)
    batched = make_batched_solver(tmg, fine_kernel=None, **SOLVE)
    assert bool(solve(b)[0].converged)
    version = tmg.version
    if change == "pop_level":
        tmg.pop_level()
    elif change == "update_level":
        _port_push(tmg, bb[1], 1, update=True)
    elif change == "push_level":
        tmg.pop_level()
        _port_push(tmg, bb[2], 2)
    elif change == "prepare_direct_coarsest":
        tmg.prepare_direct_coarsest()
    else:
        from qmg_tpu_torch.stencil import StencilType
        tmg.coarsest_solve.coarsest_stencil_app = StencilType.MDAGGER_M
        tmg.deflate_coarsest(2, 0)
    assert tmg.version > version
    with pytest.raises(RuntimeError, match="hierarchy changed"):
        solve(b)
    with pytest.raises(RuntimeError, match="hierarchy changed"):
        batched(b[None])
    res, _ = make_solver(tmg, fine_kernel=None, **SOLVE)(b)
    assert bool(res.converged)


def test_free_wilson_pop_levels():
    """qmg_tpu's ``test_free_wilson_kcycle_pop_levels`` (n09): the free
    Wilson operator at m = 0.1, per-spin constant null vectors, 4x4
    blocking; solved at 3 then 2 levels, each at qmg_tpu's outer count and
    per-level counts."""
    jlat, tlat = Lattice2D(L, L, 2), TLattice2D(L, L, 2)
    kw = dict(n_refine=2, coarse_dof=2, free_null_vectors=True, x_block=4,
              y_block=4)
    jmg = jbuild(jlat, JWilson2D(jlat, 0.1, ju1.unit_gauge_u1(jlat)),
                 JKCycleConfig(**kw), JQMGRandom(1337))
    tmg = tbuild(tlat, TWilson2D(tlat, 0.1, tu1.unit_gauge_u1(tlat),
                                 dtype=torch.complex128, device="cpu"),
                 TKCycleConfig(**kw))
    b = JQMGRandom(1337).gaussian_cv(jlat)
    for depth in (3, 2):
        assert jmg.get_num_levels() == tmg.get_num_levels() == depth
        for lvl in range(depth - 1):
            assert _rel(tmg.get_transfer(lvl)._nvb,
                        jmg.get_transfer(lvl)._nvb) <= 1e-14
        jmg.reset_tracker()
        tmg.reset_tracker()
        jres = _jax_solve(jmg, b, tol=1e-10, max_iter=1000)
        tres = tmg.solve(torch.as_tensor(b), tol=1e-10, max_iter=1000)
        assert bool(jres.converged) and bool(tres.converged)
        assert int(tres.iters) == int(jres.iters)
        _same_trackers(jmg, tmg)
        tmg.pop_level()
        jmg.pop_level()
    with pytest.raises(ValueError, match="per-spin"):
        tbuild(tlat, tmg.get_stencil(0),
               TKCycleConfig(**dict(kw, coarse_dof=4)))
    with pytest.raises(ValueError, match="cannot pop"):
        tmg.pop_level()


def test_structure_only_scaffold(raws):
    """``structure_only`` draws nothing and builds qmg_tpu's scaffold
    shapes: zero null vectors, identity clover, zero hopping, no dense
    inverse."""
    g = raws[0]
    jlat, tlat = Lattice2D(L, L, 2), TLattice2D(L, L, 2)
    kw = dict(n_refine=2, coarse_dof=8, coarsest_direct=True)
    jmg = jbuild(jlat, JWilson2D(jlat, MASS, jnp.asarray(g)),
                 JKCycleConfig(**kw), JQMGRandom(1), structure_only=True)
    tmg = tbuild(tlat, TWilson2D(tlat, MASS, g, dtype=torch.complex64,
                                 device="cpu"),
                 TKCycleConfig(**kw), structure_only=True)
    assert tmg.get_num_levels() == jmg.get_num_levels() == 3
    assert tmg.coarsest_dinv is None
    for lvl in (1, 2):
        jc, tc = jmg.get_stencil(lvl).coeffs, tmg.get_stencil(lvl).coeffs
        assert tuple(tc.clover.shape) == tuple(jc.clover.shape)
        assert np.array_equal(np.asarray(tc.clover), np.asarray(jc.clover))
        assert np.array_equal(np.asarray(tc.hopping),
                              np.asarray(jc.hopping))
        jt, tt = jmg.get_transfer(lvl - 1), tmg.get_transfer(lvl - 1)
        assert tuple(tt._nvb.shape) == tuple(jt._nvb.shape)
        assert not bool(tt._nvb.abs().sum())
    with pytest.raises(ValueError, match="neither rng nor seeds"):
        tbuild(tlat, tmg.get_stencil(0), TKCycleConfig(**kw),
               JQMGRandom(1), structure_only=True)


def test_kcycle_config_fields():
    """``KCycleConfig`` has qmg_tpu's fields with qmg_tpu's defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(JKCycleConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TKCycleConfig)}
    assert list(tf) == list(jf)
    for name, default in jf.items():
        assert tf[name] == default, name


def test_mg_solve_takes_the_outer_system(raws):
    """``mg.solve(outer_type=RIGHT_SCHUR)`` solves the system it is given,
    as qmg_tpu's does: on the prepared even-half right-hand side it takes
    ``make_solver``'s iterations (which prepares b and reconstructs x
    itself) and returns that solve's even-half solution."""
    from qmg_tpu_torch.setup import SCHUR_CONFIG
    from qmg_tpu_torch.stencil import StencilType
    g, b = raws[0], torch.as_tensor(raws[1])
    tlat = TLattice2D(L, L, 2)
    op = TWilson2D(tlat, MASS, g, dtype=torch.complex128, device="cpu")
    mg = tbuild(tlat, op, TKCycleConfig(n_refine=1, coarse_dof=4,
                                        nullvec_max_iter=100,
                                        nullvec_tol=5e-4, **SCHUR_CONFIG),
                JQMGRandom(3))
    schur = StencilType.RIGHT_SCHUR
    res_full, _ = make_solver(mg, fine_kernel=None, outer_type=schur,
                              **SOLVE)(b)
    y = op.prepare_M(b, schur)
    res = mg.solve(y, outer_type=schur, **SOLVE)
    assert bool(res.converged) and res.iters == res_full.iters
    assert tuple(res.x.shape) == tuple(y.shape)
    assert _rel(op.reconstruct_M(res.x, b, schur), res_full.x) <= 1e-12
    with pytest.raises(ValueError, match="prepared"):
        make_solver(mg, fine_kernel=None, outer_type=schur, **SOLVE)(
            b, x0=torch.zeros_like(b))
