"""Port vs qmg_tpu on the adaptive setup from seeds drawn ahead (qmg_tpu's
tests/test_adaptive_planes.py), by function at complex64 on 32^2 with
qmg_tpu's oracle configuration (n_refine 2, coarse_dof 4, one pass): the
port's ``make_adaptive_setup_planes`` hierarchy against qmg_tpu's traced
state on the same seeds, key by key; each package's solver on both states
(the exchange both ways); the pass does not degrade the preconditioner;
the dense coarsest inverse; the refusals and the stage timings."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.setup import (AdaptiveConfig as JAdaptiveConfig,
                           KCycleConfig as JKCycleConfig,
                           build_kcycle_hierarchy as jbuild)
from qmg_tpu.setup_planes import (make_adaptive_setup_planes as jmake,
                                  adaptive_seed_planes as jseed_planes)
from qmg_tpu.tpu_compat import (host_to_planes, from_planes,
                                make_planes_solver)
from qmg_tpu.linalg import norm2sq
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.setup import AdaptiveConfig, KCycleConfig
from qmg_tpu_torch.setup_planes import make_adaptive_setup_planes
from qmg_tpu_torch.solve import (make_solver, state_to_numpy,
                                 state_from_numpy)
from qmg_tpu_torch.kcycle import true_residual

torch.set_num_threads(1)

L = 32
MASS = -0.05
ACFG = dict(n_refine=2, coarse_dof=4, n_setup=1)
# qmg_tpu's bar for its traced adaptive state against its eager one at
# complex64 (PARITY.md, "Setup equivalence oracles"); the two packages part
# by at most 1.8e-6 here (measured), as the flow is fixed-iteration.
C64_BAR = 2e-2
SOLVE = dict(tol=1e-5, max_iter=200)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _complex(p):
    p = np.asarray(p)
    return p[..., 0] + 1j * p[..., 1]


class QuantRng:
    """Rounds the gaussians to complex64, as the float32 planes hold
    them."""

    def __init__(self, inner):
        self.inner = inner

    def gaussian_cv(self, lat):
        return np.asarray(self.inner.gaussian_cv(lat)).astype(np.complex64)


@pytest.fixture(scope="module")
def states():
    """qmg_tpu's traced states and the port's hierarchies from the same
    seeds: one pass without and with the dense coarsest inverse, and no
    pass (the Richardson-only hierarchy)."""
    lat = Lattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    gauge = np.asarray(ju1.gauss_gauge_u1(lat, rng, 6.0)).astype(
        np.complex64)
    b = np.asarray(rng.gaussian_cv(lat)).astype(np.complex64)
    init, passes = jseed_planes(lat, JAdaptiveConfig(**ACFG),
                                QuantRng(JQMGRandom(4242)))
    tinit = [_complex(s) for s in init]
    tpasses = [[[_complex(s) for s in lvl] for lvl in per] for per in passes]
    out = {}
    for name, n_setup, direct in (("pass", 1, False), ("direct", 1, True),
                                  ("richardson", 0, False)):
        kw = dict(ACFG, n_setup=n_setup)
        jstate = jmake(lat, JAdaptiveConfig(**kw), MASS,
                       coarsest_direct=direct)(host_to_planes(gauge), init,
                                               passes[:n_setup])
        setup_fn = make_adaptive_setup_planes(
            TLattice2D(L, L, 2), AdaptiveConfig(**kw), MASS, device="cpu",
            coarsest_direct=direct)
        tmg = setup_fn(gauge, tinit, tpasses[:n_setup])
        out[name] = ({k: np.asarray(jax.device_get(v))
                      for k, v in jstate.items()}, tmg, setup_fn.stages)
    return gauge, b, out


def _port_solve(state, b):
    mg = state_from_numpy(state, KCycleConfig(n_refine=2, coarse_dof=4),
                          device="cpu")
    res, _ = make_solver(mg, fine_kernel=None, **SOLVE)(torch.as_tensor(b))
    return res, true_residual(mg.get_stencil(0), torch.as_tensor(b), res.x)


@pytest.fixture(scope="module")
def jax_solver(states):
    gauge, _, _ = states
    lat = Lattice2D(L, L, 2)
    op = JWilson2D(lat, MASS, jnp.asarray(gauge), dtype=jnp.complex64)
    scaffold = jbuild(lat, op, JKCycleConfig(n_refine=2, coarse_dof=4),
                      JQMGRandom(1), structure_only=True)
    solve, _ = make_planes_solver(scaffold, **SOLVE)
    solve = jax.jit(solve)

    def run(state, b):
        x, iters, _ = solve({k: jnp.asarray(v) for k, v in state.items()},
                            host_to_planes(b))
        bj = jnp.asarray(b)
        resid = float(jnp.sqrt(norm2sq(bj - op.apply_M(from_planes(x)))
                               / norm2sq(bj)))
        return int(iters), resid
    return run


@pytest.mark.parametrize("name", ["pass", "direct", "richardson"])
def test_state_matches_qmg_tpu(states, name):
    """``state_to_numpy`` of the port's hierarchy has qmg_tpu's keys (no
    setup-internal test vectors), each array within ``C64_BAR``."""
    _, _, out = states
    jstate, tmg, _ = out[name]
    tstate = state_to_numpy(tmg)
    assert set(tstate) == set(jstate)
    assert ("cdinv" in tstate) == (name == "direct")
    for key in jstate:
        assert tstate[key].shape == jstate[key].shape, key
        assert _rel(_complex(tstate[key]), _complex(jstate[key])) <= \
            C64_BAR, key


@pytest.mark.parametrize("source", ["qmg_tpu", "port"])
@pytest.mark.parametrize("solver", ["qmg_tpu", "port"])
def test_solvers_on_both_states(states, jax_solver, source, solver):
    """Each package's solver on each package's state (the exchange both
    ways): within +-1 outer iteration of qmg_tpu's solve of its own state,
    true residual below 1e-4."""
    _, b, out = states
    jstate, tmg, _ = out["pass"]
    state = jstate if source == "qmg_tpu" else state_to_numpy(tmg)
    ref_iters, _ = jax_solver(jstate, b)
    if solver == "qmg_tpu":
        iters, resid = jax_solver(state, b)
    else:
        res, resid = _port_solve(state, b)
        iters = res.iters
        assert bool(res.converged)
    assert abs(iters - ref_iters) <= 1
    assert resid < 1e-4


def test_pass_does_not_degrade(states, jax_solver):
    """The pass's hierarchy takes at most the Richardson-only hierarchy's
    count + 1, in both packages."""
    _, b, out = states
    counts = {}
    for name in ("pass", "richardson"):
        jstate, tmg, _ = out[name]
        counts[name] = (jax_solver(jstate, b)[0],
                        _port_solve(state_to_numpy(tmg), b)[0].iters)
    for k in range(2):
        assert counts["pass"][k] <= counts["richardson"][k] + 1


def test_direct_coarsest(states):
    """``coarsest_direct``: the dense inverse is qmg_tpu's ``cdinv`` within
    the complex64 bar, and the port's solve with it takes the count of its
    solve on qmg_tpu's state (which loads ``cdinv``) +-1."""
    _, b, out = states
    jstate, tmg, stages = out["direct"]
    assert tmg.coarsest_solve.direct and tmg.coarsest_dinv is not None
    assert _rel(tmg.coarsest_dinv, _complex(jstate["cdinv"])) <= C64_BAR
    res, _ = make_solver(tmg, fine_kernel=None, **SOLVE)(
        torch.as_tensor(b))
    ref, resid = _port_solve(jstate, b)
    assert bool(res.converged) and resid < 1e-4
    assert abs(res.iters - ref.iters) <= 1
    assert stages[-1][0] == "cdinv"


def test_stage_timings(states):
    """Every stage of the setup is timed, in the order it ran."""
    _, _, out = states
    labels = [label for label, _ in out["pass"][2]]
    assert labels == ["operator", "init L0", "init L1", "pass 0 L0",
                      "pass 0 rebuild L1", "pass 0 L1"]
    assert all(sec >= 0 for _, sec in out["pass"][2])
    assert [label for label, _ in out["richardson"][2]] == [
        "operator", "init L0", "init L1"]


def test_refusals():
    """qmg_tpu's refusals (fine nc != 2, wrong seed counts), the TPU-only
    ``matmul_precision``, an unknown option, a dense inverse too large."""
    lat = TLattice2D(L, L, 2)
    acfg = AdaptiveConfig(**ACFG)
    with pytest.raises(ValueError, match="TPU"):
        make_adaptive_setup_planes(lat, acfg, MASS, device="cpu",
                                   matmul_precision="highest")
    with pytest.raises(TypeError, match="unexpected"):
        make_adaptive_setup_planes(lat, acfg, MASS, device="cpu", tile=8)
    with pytest.raises(ValueError, match="nc must be 2"):
        make_adaptive_setup_planes(TLattice2D(L, L, 4), acfg, MASS,
                                   device="cpu")
    with pytest.raises(ValueError, match="too large"):
        make_adaptive_setup_planes(
            TLattice2D(256, 256, 2), AdaptiveConfig(n_refine=1), MASS,
            device="cpu", coarsest_direct=True)
    setup_fn = make_adaptive_setup_planes(lat, acfg, MASS, device="cpu")
    gauge = np.ones((2, 2, L, L // 2), np.complex128)
    with pytest.raises(ValueError, match="init seed"):
        setup_fn(gauge, [], [[[]]])
    seeds = [np.zeros((2,) + lat.cv_shape()), np.zeros((2, 2, 8, 4, 4))]
    with pytest.raises(ValueError, match="pass seed groups"):
        setup_fn(gauge, seeds, [])
    with pytest.raises(ValueError, match="rebuild seed"):
        setup_fn(gauge, seeds, [[[], []]])
    with pytest.raises(ValueError, match="gaussians must be"):
        setup_fn(gauge, seeds[::-1], [[[seeds[1]], []]])
