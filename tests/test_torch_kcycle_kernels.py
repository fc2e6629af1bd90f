"""The K-cycle on the generic stencil kernels: the port's ``make_solver``
with every fine_kernel x coarse_apply pair on a hierarchy that qmg_tpu
built (carried over by ``state_from_numpy``), its outer count against
qmg_tpu's ``make_planes_solver`` with its Pallas kernels in interpret
mode, the bf16 coefficient stream, and the scope of the overrides.

On the CPU the kernels' wrappers run their plain twins. qmg_tpu's
small-lattice kernel at nc = 8 takes about ten minutes of interpret-mode
tracing inside one solve, so where the port's coarse levels take
``coarse_apply="small"`` qmg_tpu's take its jnp apply, the function that
kernel computes (tests/test_pallas_dslash.py holds them equal); every
other option is the same on both sides.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.setup import (KCycleConfig as JKCycleConfig,
                           build_kcycle_hierarchy as jbuild)
from qmg_tpu.tpu_compat import (make_planes_solver, mg_state_planes,
                                host_to_planes)
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.solve import make_solver, state_from_numpy
from qmg_tpu_torch.kcycle import true_residual, kcycle_config
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.stateful import StatefulMultigridMG, CoarsestSolveMG

torch.set_num_threads(1)

L = 32
MASS = -0.06
TOL = 1e-5
FINE = ["matrix", "matrix-split", "small"]
COARSE = ["plain", "gather", "small"]


@pytest.fixture(scope="module")
def jax_state_32():
    """qmg_tpu's hierarchy with bench.py's kcycle config at 32^2 (three
    levels: 32^2 nc2, 8^2 nc8, 2^2 nc8 with the dense coarsest inverse),
    its float32 state, and the rhs drawn after the setup."""
    lat = Lattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    gauge = jnp.asarray(ju1.gauss_gauge_u1(lat, rng, 6.0), jnp.complex64)
    op = JWilson2D(lat, MASS, gauge, dtype=jnp.complex64)
    cfg, restart = kcycle_config(L)
    jcfg = JKCycleConfig(n_refine=cfg.n_refine, coarse_dof=8,
                         nullvec_tol=5e-4, nullvec_max_iter=200,
                         inner_restart_freq=cfg.inner_restart_freq,
                         coarsest_restart_freq=restart,
                         coarsest_direct=True)
    mg = jbuild(lat, op, jcfg, rng)
    b = rng.gaussian_cv(lat)
    return mg, mg_state_planes(mg), cfg, b


def _port_solve(state, cfg, b, **kw):
    tmg = state_from_numpy(state, cfg, device="cpu")
    bt = torch.as_tensor(b).to(torch.complex64)
    solve = make_solver(tmg, tol=TOL, max_iter=200, restart_freq=32, **kw)
    res, _ = solve(bt)
    return tmg, solve, res, true_residual(tmg.get_stencil(0), bt, res.x)


@pytest.mark.parametrize("coarse_apply", COARSE)
@pytest.mark.parametrize("fine_kernel", FINE)
def test_port_solve_on_kernels(jax_state_32, fine_kernel, coarse_apply):
    """Every pair converges to a true residual under 10 tol, takes the
    applies it names, and leaves no override behind."""
    _, state, cfg, b = jax_state_32
    tmg, solve, res, rel = _port_solve(state, cfg, b,
                                       fine_kernel=fine_kernel,
                                       coarse_apply=coarse_apply)
    assert bool(res.converged) and rel < 10 * TOL
    # level 1 (8^2 nc8) and the coarsest 2^2 both qualify for either
    # coarse apply
    assert solve.level_applies == [fine_kernel] + [coarse_apply] * 2
    assert all(tmg.get_stencil(lvl).apply_override is None
               for lvl in range(tmg.get_num_levels()))


@pytest.mark.parametrize("fine_kernel, coarse_apply", [
    ("matrix", "small"), ("matrix-split", "plain"), ("small", "gather")])
def test_outer_count_matches_qmg_tpu(jax_state_32, fine_kernel,
                                     coarse_apply):
    mg, state, cfg, b = jax_state_32
    jcoarse = {"plain": "jnp", "small": "jnp"}.get(coarse_apply,
                                                    coarse_apply)
    solve, _ = make_planes_solver(mg, tol=TOL, max_iter=200,
                                  restart_freq=32, use_pallas_fine=True,
                                  pallas_kind=fine_kernel,
                                  pallas_interpret=True,
                                  coarse_apply=jcoarse)
    _, it_j, _ = jax.jit(solve)(state, host_to_planes(b))
    _, _, res, rel = _port_solve(state, cfg, b, fine_kernel=fine_kernel,
                                 coarse_apply=coarse_apply)
    assert abs(res.iters - int(it_j)) <= 1, (res.iters, int(it_j))
    assert rel < 10 * TOL


@pytest.mark.parametrize("fine_kernel", ["matrix", "small", "wilson-r1"])
def test_small_path_makes_no_layout_copy(jax_state_32, monkeypatch,
                                         fine_kernel):
    """K6 is applied in the solve's own layout: with the split-layout
    copies made to raise, the "small" applies still solve, in the outer
    count of the plain coarse apply, and ``level_applies`` still names
    them."""
    from qmg_tpu_torch import solve as solve_module
    _, state, cfg, b = jax_state_32
    _, _, plain, _ = _port_solve(state, cfg, b, fine_kernel=fine_kernel,
                                 coarse_apply="plain")

    def refuse(t):
        raise AssertionError("the small path made a split-layout copy")

    monkeypatch.setattr(solve_module, "x_to_split", refuse)
    monkeypatch.setattr(solve_module, "x_from_split", refuse)
    _, solve, res, rel = _port_solve(state, cfg, b, fine_kernel=fine_kernel,
                                     coarse_apply="small")
    assert solve.level_applies == [fine_kernel, "small", "small"]
    assert bool(res.converged) and rel < 10 * TOL
    assert res.iters == plain.iters


def test_matrix_split_keeps_its_layout_copies(jax_state_32, monkeypatch):
    """K5 is applied in its own split layout, between the two copies."""
    from qmg_tpu_torch import solve as solve_module
    _, state, cfg, b = jax_state_32
    calls = {"to": 0, "from": 0}
    to_split, from_split = solve_module.x_to_split, solve_module.x_from_split

    def count_to(t):
        calls["to"] += 1
        return to_split(t)

    def count_from(t):
        calls["from"] += 1
        return from_split(t)

    monkeypatch.setattr(solve_module, "x_to_split", count_to)
    monkeypatch.setattr(solve_module, "x_from_split", count_from)
    _, _, res, _ = _port_solve(state, cfg, b, fine_kernel="matrix-split",
                               coarse_apply="small")
    assert bool(res.converged) and calls["to"] == calls["from"] > 0


def test_bf16_coefficients_converge(jax_state_32):
    _, state, cfg, b = jax_state_32
    _, solve, res, rel = _port_solve(state, cfg, b, fine_kernel="matrix",
                                     coarse_apply="small",
                                     coeff_dtype=torch.bfloat16)
    assert bool(res.converged) and rel < 1e-3


def test_small_coarse_apply_keeps_plain_where_it_does_not_fit():
    """A level that the small kernel refuses (odd Y) or of volume 1 keeps
    the plain apply."""
    from qmg_tpu_torch.solve import _coarse_apply
    from qmg_tpu_torch.stencil import Stencil2D, make_coeffs
    for x_len, y_len in ((4, 3), (1, 1)):
        lat = TLattice2D(x_len, y_len, 8)
        c = make_coeffs(lat, clover=torch.zeros(lat.cm_shape(),
                                                 dtype=torch.complex64),
                        hopping=torch.zeros(lat.hopping_shape(),
                                            dtype=torch.complex64),
                        dtype=torch.complex64)
        assert _coarse_apply(Stencil2D(c), "small") == (None, "plain")


def _one_level_mg():
    lat = TLattice2D(8, 8, 2)
    gauge = np.ones((2, 2, 8, 4), np.complex128)
    op = TWilson2D(lat, MASS, gauge, dtype=torch.complex64)
    return StatefulMultigridMG(lat, op, CoarsestSolveMG())


@pytest.mark.parametrize("kw, message", [
    (dict(fine_kernel="wilson-r1", coeff_dtype=torch.bfloat16),
     "matrix kernels"),
    (dict(fine_kernel=None, coeff_dtype=torch.bfloat16), "matrix kernels"),
    (dict(fine_kernel="matrix", coeff_dtype=torch.float16), "bfloat16"),
    (dict(fine_kernel="tiled"), "fine_kernel"),
    (dict(coarse_apply="pallas"), "coarse_apply")])
def test_make_solver_refuses(kw, message):
    with pytest.raises(ValueError, match=message):
        make_solver(_one_level_mg(), **kw)


def test_jnp_is_the_plain_coarse_apply():
    solve = make_solver(_one_level_mg(), fine_kernel="matrix",
                        coarse_apply="jnp")
    assert solve.level_applies == ["matrix"]
