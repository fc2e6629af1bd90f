"""Port vs qmg_tpu on the n19 Schur K-cycle (qmg_tpu's
tests/test_n19_schur_kcycle.py; bench.py ``--mode kcycle --outer
schur``): null vectors on the rbjacobi operator by restarted GCR, rbjacobi
coarsening, RIGHT_SCHUR on every level. The hierarchy built by both
packages from the same seeds, the outer and per-level operator counts,
the direct coarsest on the half space, the batched Schur solve lane by
lane, the state exchange both ways with the derived sets (``rbjcinv{l}``
... ``schurf{l}``), the derived sets built once, and the refusals.

Run as a script it prints qmg_tpu's and the port's outer iteration counts
with bench.py's ``--outer schur`` configuration at one size in complex64
(the reference count that ``chip_smoke.py`` embeds as
``JAX_ITERS_512_SCHUR``):

    JAX_PLATFORMS=cpu python tests/test_torch_schur_kcycle.py --size 512
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.operators.coarse import CoarseOperator2D as JCoarse
from qmg_tpu.setup import (KCycleConfig as JKCycleConfig,
                           build_kcycle_hierarchy as jbuild)
from qmg_tpu.stencil import StencilType as JStencilType
from qmg_tpu.tpu_compat import (make_planes_solver, mg_state_planes,
                                derived_state_planes, host_to_planes)
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.setup import (KCycleConfig as TKCycleConfig,
                                 build_kcycle_hierarchy as tbuild,
                                 SCHUR_CONFIG)
from qmg_tpu_torch.solve import (make_solver, make_batched_solver,
                                 state_from_numpy, state_to_numpy)
from qmg_tpu_torch.stencil import StencilType, DERIVED_BUILDS
from qmg_tpu_torch.kcycle import (kcycle_config, true_residual, run_kcycle,
                                  main as kcycle_main, MASS)
from qmg_tpu_torch.parallel import Mesh
from torch_lanes import three_rhs, check_lanes, check_qmg_tpu

torch.set_num_threads(1)

SCHUR = StencilType.RIGHT_SCHUR
JSCHUR = JStencilType.RIGHT_SCHUR
TOL = 1e-5
# The reference test's configuration (test_n19_schur_kcycle.py): 16^2,
# m = -0.05, one refinement to 4^2 nc8.
N19_L = 16
N19_MASS = -0.05


def _jax_schur_kw():
    return dict(fine_stencil_app=JSCHUR, coarsest_stencil_app=JSCHUR,
                nullvec_stype=JStencilType.RIGHT_JACOBI,
                nullvec_solver="gcr_restart", precond_coarsen_rbjacobi=True,
                build_extra=JCoarse.BUILD_RBJACOBI)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _level_of(key):
    """The level whose setup an array's value depends on: a key's digits,
    the null vectors of level l feeding level l + 1, None for the coarsest
    inverse."""
    if key == "cdinv":
        return None
    lvl = int(key[len(key.rstrip("0123456789")):])
    return lvl + 1 if key.startswith("nvb") else lvl


def build_pair(L, n_refine, mass, dtype_j, dtype_t, direct, **cfg_kw):
    """The n19 hierarchy at L^2 built by qmg_tpu and by the port from the
    same seeds, and the right-hand side drawn after the setup."""
    lat = Lattice2D(L, L, 2)
    jrng, trng = JQMGRandom(1337), JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(lat, jrng, 6.0)
    jop = JWilson2D(lat, mass, jnp.asarray(g, dtype_j), dtype=dtype_j)
    jmg = jbuild(lat, jop, JKCycleConfig(
        n_refine=n_refine, coarse_dof=8, coarsest_direct=direct,
        **cfg_kw, **_jax_schur_kw()), jrng)
    g_t = ju1.gauss_gauge_u1(lat, trng, 6.0)
    tlat = TLattice2D(L, L, 2)
    top = TWilson2D(tlat, mass, g_t, dtype=dtype_t)
    tcfg = TKCycleConfig(n_refine=n_refine, coarse_dof=8,
                         coarsest_direct=direct, **cfg_kw, **SCHUR_CONFIG)
    tmg = tbuild(tlat, top, tcfg, trng)
    b = jrng.gaussian_cv(lat)
    assert np.array_equal(b, trng.gaussian_cv(lat))
    return jop, jmg, top, tmg, tcfg, b


def jax_tracker(jmg):
    """qmg_tpu's per-level counters: (counts (n_levels, 4), iterations)."""
    n = jmg.get_num_levels()
    return (np.array([[jmg.get_tracker_count(t, lvl) for t in range(4)]
                      for lvl in range(n)]),
            np.array([jmg.get_iterations_count(lvl) for lvl in range(n)]))


def solve_both(pair, tol=1e-10):
    """qmg_tpu's ``mg.solve(outer_type=RIGHT_SCHUR)`` on its hierarchy
    (b prepared and x reconstructed around it) and the port's
    ``make_solver(outer_type=RIGHT_SCHUR)`` on its own. Returns (qmg_tpu's
    result, its per-level counts and iterations of this solve, the port's
    result and carry)."""
    jop, jmg, top, tmg, _, b = pair
    counts0, iters0 = jax_tracker(jmg)
    jres = jmg.solve(jop.prepare_M(jnp.asarray(b), JSCHUR), tol=tol,
                     max_iter=400, restart_freq=32, outer_type=JSCHUR)
    counts1, iters1 = jax_tracker(jmg)
    res, carry = make_solver(tmg, tol=tol, max_iter=400, restart_freq=32,
                             fine_kernel=None, outer_type=SCHUR)(
                                 torch.as_tensor(b))
    return jres, counts1 - counts0, iters1 - iters0, res, carry


# --- the n19 configuration at complex128 ----------------------------------

@pytest.fixture(scope="module", params=["direct", "gcr"])
def n19_pair(request):
    return build_pair(N19_L, 1, N19_MASS, jnp.complex128, torch.complex128,
                      request.param == "direct")


def test_schur_solve_counts_match_qmg_tpu(n19_pair):
    """The same outer count and per-level operator and iteration counts as
    qmg_tpu's ``mg.solve(outer_type=RIGHT_SCHUR)`` (the setup's null-vector
    counts too), and a reconstructed x with a true residual < 1e-9."""
    jop, jmg, top, tmg, _, b = n19_pair
    jres, j_counts, j_iters, res, carry = solve_both(n19_pair)
    assert bool(res.converged) and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert carry["counts"].tolist() == j_counts.tolist()
    assert carry["iters"].tolist() == j_iters.tolist()
    assert tmg.tracker["counts"][:, 0].tolist() == [
        jmg.get_tracker_count(0, lvl) for lvl in range(2)]
    assert tuple(res.x.shape) == (2, N19_L, N19_L // 2, 2)
    assert true_residual(top, torch.as_tensor(b), res.x) < 1e-9


def test_direct_coarsest_on_half_space(n19_pair):
    jop, jmg, top, tmg, _, b = n19_pair
    if not tmg.coarsest_solve.direct:
        assert tmg.coarsest_dinv is None and jmg.coarsest_dinv is None
        return
    half = tmg.get_stencil(1).solve_size_shape(SCHUR)
    assert half == (4, 2, 8)
    n_half = int(np.prod(half))
    assert tuple(tmg.coarsest_dinv.shape) == (n_half, n_half)
    assert _rel(tmg.coarsest_dinv.numpy(), np.asarray(jmg.coarsest_dinv)) \
        <= 1e-7


def test_n19_hierarchy_matches_qmg_tpu(n19_pair):
    """Level 0 exact (its derived sets: QR against QR, <= 1e-12), level 1
    <= 1e-9 (the ORIGINAL hierarchy's bar, test_torch_kcycle.py)."""
    _, jmg, _, tmg, _, _ = n19_pair
    js = mg_state_planes(jmg, dtype=np.float64)
    js.update(derived_state_planes(jmg, JSCHUR, dtype=np.float64))
    ts = state_to_numpy(tmg, dtype=np.float64, outer_type=SCHUR)
    assert set(js) == set(ts)
    assert {"rbjcinv0", "rbjh0", "schurf0", "rbjcinv1", "schurf1"} <= set(ts)
    for k in sorted(js):
        lvl = _level_of(k)
        if k in ("clover0", "hopping0", "shifts0"):
            bound = 0.0
        elif lvl == 0:
            bound = 1e-12
        else:
            bound = 1e-9
        rel = _rel(ts[k], js[k])
        assert rel <= bound, f"{k}: {rel:.3e} > {bound}"


@pytest.fixture(scope="module")
def pinned_32():
    """The n19 hierarchy at 32^2 with two refinements, the null-vector
    GCR pinned (tol 0, 24 iterations) as test_torch_kcycle.py pins
    BiCGstab(6)."""
    return build_pair(32, 2, MASS, jnp.complex128, torch.complex128, True,
                      nullvec_tol=0.0, nullvec_max_iter=24)


def test_pinned_schur_hierarchy_bars(pinned_32):
    """Level 0 exact, level 1 <= 1e-9, level 2 and the dense inverse
    <= 1e-7 (the ORIGINAL hierarchy's bars); the derived sets of level 0
    <= 1e-12."""
    _, jmg, _, tmg, _, _ = pinned_32
    js = mg_state_planes(jmg, dtype=np.float64)
    js.update(derived_state_planes(jmg, JSCHUR, dtype=np.float64))
    ts = state_to_numpy(tmg, dtype=np.float64, outer_type=SCHUR)
    assert set(js) == set(ts)
    bounds = {1: 1e-9, 2: 1e-7, None: 1e-7}
    for k in sorted(js):
        lvl = _level_of(k)
        if k in ("clover0", "hopping0", "shifts0"):
            bound = 0.0
        elif lvl == 0:
            bound = 1e-12
        else:
            bound = bounds[lvl]
        rel = _rel(ts[k], js[k])
        assert rel <= bound, f"{k}: {rel:.3e} > {bound}"


def test_pinned_schur_solve_counts(pinned_32):
    jres, j_counts, j_iters, res, carry = solve_both(pinned_32)
    assert res.iters == int(jres.iters)
    assert carry["counts"].tolist() == j_counts.tolist()
    assert carry["iters"].tolist() == j_iters.tolist()
    assert true_residual(pinned_32[2], torch.as_tensor(pinned_32[5]),
                         res.x) < 1e-9


def test_batched_schur_matches_single_and_qmg_tpu(n19_pair):
    """The batched n19 solve of a gaussian, a point and a wall source on
    qmg_tpu's hierarchy (its float64 planes state, derived sets included):
    each lane the port's single Schur solve (iterations, carries, ops
    exactly; x to 1e-10) and qmg_tpu's ``make_batched_planes_solver(...,
    outer_type=RIGHT_SCHUR)`` (iterations; x to 1e-10)."""
    _, jmg, _, _, tcfg, b = n19_pair
    state = _jax_state(jmg, np.float64)
    tmg = state_from_numpy(state, tcfg, device="cpu")
    B = three_rhs(b)
    kw = dict(tol=1e-10, max_iter=400, restart_freq=32)
    res = check_lanes(tmg, B, outer_type=SCHUR, **kw)
    check_qmg_tpu(jmg, state, B, res, outer_type=JSCHUR, **kw)


# --- the state exchange ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_bench_32():
    """qmg_tpu's hierarchy with bench.py's ``--outer schur`` configuration
    at 32^2 in complex64, and the rhs drawn after the setup."""
    lat = Lattice2D(32, 32, 2)
    rng = JQMGRandom(1337)
    gauge = jnp.asarray(ju1.gauss_gauge_u1(lat, rng, 6.0), jnp.complex64)
    op = JWilson2D(lat, MASS, gauge, dtype=jnp.complex64)
    cfg, restart = kcycle_config(32, "schur")
    jcfg = JKCycleConfig(n_refine=cfg.n_refine, coarse_dof=8,
                         nullvec_tol=5e-4, nullvec_max_iter=200,
                         inner_restart_freq=cfg.inner_restart_freq,
                         coarsest_restart_freq=restart, coarsest_direct=True,
                         **_jax_schur_kw())
    mg = jbuild(lat, op, jcfg, rng)
    return mg, cfg, restart, rng.gaussian_cv(lat)


def _jax_planes_count(mg, state, b, restart, tol, dtype=np.float32):
    solve, _ = make_planes_solver(mg, tol=tol, max_iter=200,
                                  restart_freq=restart, outer_type=JSCHUR)
    xp, iters, _ = jax.jit(solve)(state, host_to_planes(b, dtype))
    return int(iters), np.asarray(xp)


def _jax_state(mg, dtype=np.float32):
    state = mg_state_planes(mg, dtype=dtype)
    state.update(derived_state_planes(mg, JSCHUR, dtype=dtype))
    return state


@pytest.fixture(scope="module")
def jax_c64(jax_bench_32):
    """qmg_tpu's float32 planes state (with its derived sets) and its
    planes solver's outer count on it."""
    mg, _, restart, b = jax_bench_32
    state = _jax_state(mg)
    return state, _jax_planes_count(mg, state, b, restart, TOL)[0]


def test_qmg_tpu_state_drives_port_c64(jax_bench_32, jax_c64):
    """qmg_tpu's float32 planes state (with its derived sets) in the port:
    qmg_tpu's outer count +-1, a true residual < 10 tol, the derived sets
    adopted (none re-derived)."""
    _, cfg, restart, b = jax_bench_32
    state, it_j = jax_c64
    tmg = state_from_numpy(state, cfg, device="cpu")
    before = sum(DERIVED_BUILDS.values())
    bt = torch.as_tensor(b).to(torch.complex64)
    solve = make_solver(tmg, tol=TOL, max_iter=200, restart_freq=restart,
                        fine_kernel=None, outer_type=SCHUR)
    res, _ = solve(bt)
    assert sum(DERIVED_BUILDS.values()) == before
    assert abs(res.iters - it_j) <= 1, (res.iters, it_j)
    assert true_residual(tmg.get_stencil(0), bt, res.x) < 10 * TOL


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_mesh_schur_c64_near_qmg_tpu(jax_bench_32, jax_c64, shape):
    """The Schur solve with level 0 on an in-process mesh (the fused apply,
    prepare and reconstruct block by block) on qmg_tpu's float32 state:
    qmg_tpu's ``make_planes_solver(outer_type=RIGHT_SCHUR)`` count +-1 on
    the same state, the unsharded port's count, a true residual < 10
    tol."""
    _, cfg, restart, b = jax_bench_32
    state, it_j = jax_c64
    tmg = state_from_numpy(state, cfg, device="cpu")
    bt = torch.as_tensor(b).to(torch.complex64)
    kw = dict(tol=TOL, max_iter=200, restart_freq=restart, fine_kernel=None,
              outer_type=SCHUR)
    res, _ = make_solver(tmg, mesh=Mesh(*shape), **kw)(bt)
    one, _ = make_solver(tmg, **kw)(bt)
    assert abs(res.iters - it_j) <= 1, (res.iters, it_j)
    assert res.iters == one.iters
    assert true_residual(tmg.get_stencil(0), bt, res.x) < 10 * TOL


def test_qmg_tpu_state_drives_port_c128(jax_bench_32):
    """The same state as float64 planes: qmg_tpu's count exactly."""
    mg, cfg, restart, b = jax_bench_32
    state = _jax_state(mg, np.float64)
    it_j, xj = _jax_planes_count(mg, state, b, restart, 1e-8, np.float64)
    tmg = state_from_numpy(state, cfg, device="cpu")
    res, _ = make_solver(tmg, tol=1e-8, max_iter=200, restart_freq=restart,
                         fine_kernel=None, outer_type=SCHUR)(
                             torch.as_tensor(b))
    assert res.iters == it_j
    x = res.x.numpy()
    assert _rel(x, xj[..., 0] + 1j * xj[..., 1]) < 1e-6


def test_port_derives_qmg_tpu_sets(jax_bench_32):
    """qmg_tpu's state without its derived sets: the port derives them
    (QR inverse, rbjacobi pieces, fused Schur) to qmg_tpu's values
    (<= 1e-12 at complex128), under qmg_tpu's keys."""
    mg, cfg, _, _ = jax_bench_32
    base = mg_state_planes(mg, dtype=np.float64)
    derived = derived_state_planes(mg, JSCHUR, dtype=np.float64)
    tmg = state_from_numpy(base, cfg, device="cpu")
    ts = state_to_numpy(tmg, dtype=np.float64, outer_type=SCHUR)
    assert set(ts) == set(base) | set(derived)
    for k in derived:
        assert _rel(ts[k], derived[k]) <= 1e-12, k


def test_port_state_drives_qmg_tpu(jax_bench_32):
    """The port's own setup, handed to qmg_tpu's planes solver through
    ``state_to_numpy(outer_type=RIGHT_SCHUR)``: the same outer count as
    the port's solve (+-1 at complex64)."""
    mg, cfg, restart, b = jax_bench_32
    lat = TLattice2D(32, 32, 2)
    rng = JQMGRandom(1337)
    gauge = ju1.gauss_gauge_u1(Lattice2D(32, 32, 2), rng, 6.0)
    op = TWilson2D(lat, MASS, gauge, dtype=torch.complex64)
    tmg = tbuild(lat, op, cfg, rng)
    bt = torch.as_tensor(b).to(torch.complex64)
    res, _ = make_solver(tmg, tol=TOL, max_iter=200, restart_freq=restart,
                         fine_kernel=None, outer_type=SCHUR)(bt)
    state = state_to_numpy(tmg, outer_type=SCHUR)
    assert set(state) == set(_jax_state(mg))
    it_j, _ = _jax_planes_count(mg, state, b, restart, TOL)
    assert abs(res.iters - it_j) <= 1, (res.iters, it_j)


# --- builds once, refusals, entry point ------------------------------------

def test_derived_sets_built_once(jax_bench_32):
    _, cfg, restart, b = jax_bench_32
    tmg = state_from_numpy(mg_state_planes(jax_bench_32[0]), cfg,
                           device="cpu")
    before = DERIVED_BUILDS.copy()
    solve = make_solver(tmg, tol=TOL, max_iter=200, restart_freq=restart,
                        fine_kernel=None, outer_type=SCHUR)
    built = DERIVED_BUILDS.copy()
    assert built["rbjacobi"] - before["rbjacobi"] == tmg.get_num_levels()
    assert built["schur_fused"] - before["schur_fused"] == \
        tmg.get_num_levels()
    bt = torch.as_tensor(b).to(torch.complex64)
    r1, _ = solve(bt)
    r2, _ = solve(bt)
    assert DERIVED_BUILDS == built
    assert r1.iters == r2.iters
    assert torch.equal(r1.x, r2.x)


def test_schur_solver_refusals(jax_bench_32):
    mg, cfg, restart, b = jax_bench_32
    tmg = state_from_numpy(mg_state_planes(mg), cfg, device="cpu")
    for kw in (dict(fine_kernel="wilson-r1"), dict(fine_kernel="matrix"),
               dict(fine_kernel=None, coarse_apply="small"),
               dict(fine_kernel=None, coarse_apply="gather"),
               dict(fine_kernel="wilson-r1", mesh=Mesh(2, 1))):
        with pytest.raises(ValueError, match="override"):
            make_solver(tmg, outer_type=SCHUR, **kw)
    with pytest.raises(ValueError, match="fine_stencil_app"):
        make_solver(tmg, fine_kernel=None)          # ORIGINAL outer
    with pytest.raises(ValueError, match="fine_stencil_app"):
        make_batched_solver(tmg, fine_kernel=None)  # ORIGINAL outer


def test_unported_types_refused():
    """A level type outside qmg_tpu's three is a ValueError, as there; an
    unknown null-vector solver too. The CGNE smoother and the
    normal-operator coarsest, refused before they were ported, are
    accepted (their solves: tests/test_torch_cgne.py and
    test_torch_deflation.py)."""
    from qmg_tpu_torch.stateful import LevelSolveMG, CoarsestSolveMG
    from qmg_tpu_torch.setup import generate_null_vectors
    for kw in (dict(pre_cgne=True), dict(post_cgne=True)):
        assert LevelSolveMG(**kw).pre_cgne == kw.get("pre_cgne", False)
    with pytest.raises(ValueError, match="fine_stencil_app"):
        LevelSolveMG(fine_stencil_app=StencilType.DAGGER)
    for t in (StencilType.M_MDAGGER, StencilType.MDAGGER_M,
              StencilType.RBJ_MDAGGER_M):
        cs = CoarsestSolveMG(coarsest_stencil_app=t)
        assert cs.deflate and cs.normal_shift == 0.0
    op = TWilson2D(TLattice2D(8, 8, 2), MASS,
                   ju1.gauss_gauge_u1(Lattice2D(8, 8, 2), JQMGRandom(1), 6.))
    with pytest.raises(ValueError, match="null-vector solver"):
        generate_null_vectors(op, 1, JQMGRandom(1), solver="cg")


@pytest.mark.parametrize("argv", [
    ["--fine-kernel", "wilson-r1"], ["--fine-kernel", "matrix"],
    ["--coarse-apply", "small"], ["--coarse-apply", "gather"],
    ["--shards", "2", "--fine-kernel", "wilson-r1"],
    ["--distributed", "--coarse-apply", "small"]])
def test_cli_refusals(argv):
    with pytest.raises(SystemExit, match="outer schur"):
        kcycle_main(["--outer", "schur", "--size", "16", "--device", "cpu"]
                    + argv)


def test_entry_point_schur_on_cpu(capsys):
    kcycle_main(["--outer", "schur", "--size", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "outer schur (RIGHT_SCHUR)" in out
    assert "32x32 nc2 right_schur" in out
    r = run_kcycle(32, "cpu", fine_kernel=None, outer="schur")
    assert r["converged"] and r["rel_res_true"] < 10 * TOL
    assert r["x_shape"] == (2, 32, 16, 2)
    assert not any(r["launches"].values())


if __name__ == "__main__":
    import argparse
    import time
    p = argparse.ArgumentParser(description="qmg_tpu's and the port's outer "
                                "iteration counts with bench.py's kcycle "
                                "--outer schur configuration (complex64)")
    p.add_argument("--size", type=int, default=512)
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    size = args.size
    lat = Lattice2D(size, size, 2)
    rng = JQMGRandom(1337)
    gauge = jnp.asarray(ju1.gauss_gauge_u1(lat, rng, 6.0), jnp.complex64)
    op = JWilson2D(lat, MASS, gauge, dtype=jnp.complex64)
    cfg_, restart_ = kcycle_config(size, "schur")
    t0 = time.perf_counter()
    jmg = jbuild(lat, op, JKCycleConfig(
        n_refine=cfg_.n_refine, coarse_dof=8, nullvec_tol=5e-4,
        nullvec_max_iter=200, inner_restart_freq=cfg_.inner_restart_freq,
        coarsest_restart_freq=restart_, coarsest_direct=True,
        **_jax_schur_kw()), rng)
    b_ = rng.gaussian_cv(lat)
    print(f"qmg_tpu setup {time.perf_counter() - t0:.1f} s", flush=True)
    it_j, _ = _jax_planes_count(jmg, _jax_state(jmg), b_, restart_, TOL)
    print(f"qmg_tpu {size}^2 --outer schur: {it_j} outer iterations",
          flush=True)
    r = run_kcycle(size, "cpu", fine_kernel=None, outer="schur")
    print(f"port {size}^2 --outer schur (own setup, CPU): {r['iters']} outer "
          f"iterations, true residual {r['rel_res_true']:.3e}")
