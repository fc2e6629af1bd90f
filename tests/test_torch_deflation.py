"""Port vs qmg_tpu on the deflated normal-operator coarsest (qmg_tpu's
tests/test_deflation.py; bench.py ``--mode kcycle --setup device
--deflate N``): ``deflate_coarsest``'s eigenvalues within 1e-10 and the
projector onto the kept eigenvectors, the deflated K-cycle (CG on
M^dag M from the deflation guess) at qmg_tpu's outer and per-level counts
at 16^2 and 32^2, on the n19 Schur levels, and batched lane by lane,
``normal_shift``, the refusals, the setup's deflation
stage against qmg_tpu's ``make_kcycle_setup_planes(deflate_low=...,
deflate_high=...)``, the ``cevals`` / ``cevecs`` state exchange both ways,
and the entry point.

Eigenvectors are compared through the orthogonal projector onto their
span, never element by element: ``numpy.linalg.eig`` may return any basis
of a (near-)degenerate eigenspace.

Run as a script it prints qmg_tpu's and the port's outer iteration counts
with bench.py's kcycle ``--deflate 8`` configuration at one size in
complex64 (the reference count that ``chip_smoke.py`` embeds as
``JAX_ITERS_512_DEFLATE``):

    PYTHONPATH=. JAX_PLATFORMS=cpu \
        python tests/test_torch_deflation.py --size 512
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1, checkpoint as jcheckpoint
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.setup import (KCycleConfig as JKCycleConfig,
                           build_kcycle_hierarchy as jbuild)
from qmg_tpu.stencil import StencilType as JStencilType
from qmg_tpu.tpu_compat import (make_planes_solver, mg_state_planes,
                                host_to_planes)
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch import checkpoint as tcheckpoint
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.setup import (KCycleConfig as TKCycleConfig,
                                 build_kcycle_hierarchy as tbuild)
from qmg_tpu_torch.setup_planes import (make_kcycle_setup_planes,
                                        gauss_seed_planes)
from qmg_tpu_torch.solve import (make_solver, state_from_numpy,
                                 state_to_numpy)
from qmg_tpu_torch.stencil import StencilType
from qmg_tpu_torch.kcycle import (run_kcycle, true_residual, kcycle_config,
                                  main as kcycle_main, MASS, TOL)
from torch_lanes import three_rhs, check_lanes, check_qmg_tpu

torch.set_num_threads(1)

MDM = StencilType.MDAGGER_M
JMDM = JStencilType.MDAGGER_M
# qmg_tpu's test_deflation configuration: m = -0.05, one refinement to nc4,
# the lowest 4 and highest 2 eigenpairs.
DEFL_MASS = -0.05
CFG = dict(coarse_dof=4, nullvec_max_iter=150, nullvec_tol=5e-4)
LOW, HIGH = 4, 2


def _tracker(jmg):
    n = jmg.get_num_levels()
    return (np.array([[jmg.get_tracker_count(t, lvl) for t in range(4)]
                      for lvl in range(n)]),
            np.array([jmg.get_iterations_count(lvl) for lvl in range(n)]))


def jax_solve(jmg, b, tol=1e-9):
    """qmg_tpu's ``mg.solve``: its result, and this solve's per-level
    counts and iterations."""
    c0, i0 = _tracker(jmg)
    res = jmg.solve(jnp.asarray(b), tol=tol, max_iter=300, restart_freq=32)
    c1, i1 = _tracker(jmg)
    return res, c1 - c0, i1 - i0


def port_solve(tmg, b, tol=1e-9):
    return make_solver(tmg, tol=tol, max_iter=300, restart_freq=32,
                       fine_kernel=None)(torch.as_tensor(b))


def assert_same_counts(jout, tout):
    jres, jcounts, jiters = jout
    res, carry = tout
    assert bool(res.converged) and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert carry["counts"].tolist() == jcounts.tolist()
    assert carry["iters"].tolist() == jiters.tolist()


def projector(vecs):
    """The orthogonal projector onto the span of ``vecs`` (k, ...)."""
    v = np.asarray(vecs).reshape(len(vecs), -1).T
    q = np.linalg.qr(v)[0]
    return q @ q.conj().T


def spectrum_gaps(vals, low, high):
    """Relative gaps at the low and high selection cuts."""
    s = np.sort(np.real(vals))
    gaps = []
    if low:
        gaps.append((s[low] - s[low - 1]) / abs(s[low - 1]))
    if high:
        gaps.append((s[-high] - s[-high - 1]) / abs(s[-high]))
    return gaps


@pytest.fixture(scope="module")
def pair16():
    """qmg_tpu's test_deflation hierarchy at 16^2 built by both packages
    from the same seeds at complex128, both deflated (4 low, 2 high), and
    the right-hand side drawn after the setup."""
    lat = Lattice2D(16, 16, 2)
    jrng, trng = JQMGRandom(1337), JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(lat, jrng, 6.0)
    ju1.gauss_gauge_u1(lat, trng, 6.0)
    jop = JWilson2D(lat, DEFL_MASS, jnp.asarray(g))
    jmg = jbuild(lat, jop, JKCycleConfig(n_refine=1, coarsest_stencil_app=JMDM,
                                         **CFG), jrng)
    tlat = TLattice2D(16, 16, 2)
    top = TWilson2D(tlat, DEFL_MASS, g, dtype=torch.complex128)
    tcfg = TKCycleConfig(n_refine=1, coarsest_stencil_app=MDM, **CFG)
    tmg = tbuild(tlat, top, tcfg, trng)
    jmg.deflate_coarsest(num_low=LOW, num_high=HIGH)
    tmg.deflate_coarsest(LOW, HIGH)
    b = jrng.gaussian_cv(lat)
    assert np.array_equal(b, trng.gaussian_cv(lat))
    return jop, jmg, top, tmg, tcfg, b


def test_deflate_coarsest_matches_qmg_tpu(pair16):
    """The kept eigenvalues within 1e-10 of qmg_tpu's, real and positive
    (M^dag M), the cut away from any cluster, the projector onto the kept
    vectors within 1e-8, unit vectors, eigenpairs of the port's own
    coarsest operator."""
    _, jmg, _, tmg, _, _ = pair16
    vals = tmg.coarsest_evals.numpy()
    jvals = np.asarray(jmg.coarsest_evals)
    assert vals.shape == (LOW + HIGH,)
    assert tuple(tmg.coarsest_evecs.shape) == (LOW + HIGH, 2, 4, 2, 4)
    assert np.max(np.abs(np.sort(vals.real) - np.sort(jvals.real))) \
        <= 1e-10 * np.max(np.abs(jvals))
    assert np.all(vals.real > 0) and np.max(np.abs(vals.imag)) < 1e-12
    st = tmg.get_stencil(1)
    from qmg_tpu_torch import eig
    dense, _ = eig.dense_eigensystem(st.get_apply_function(MDM),
                                     st.lat.cv_shape(), device="cpu")
    assert min(spectrum_gaps(dense, LOW, HIGH)) > 1e-3
    for part in (slice(0, LOW), slice(LOW, LOW + HIGH)):
        p_t = projector(tmg.coarsest_evecs.numpy()[part])
        p_j = projector(np.asarray(jmg.coarsest_evecs)[part])
        assert np.max(np.abs(p_t - p_j)) <= 1e-8
    norms = torch.linalg.vector_norm(
        tmg.coarsest_evecs.reshape(LOW + HIGH, -1), dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-12)
    mv = st.get_apply_function(MDM)
    for lam, v in zip(tmg.coarsest_evals, tmg.coarsest_evecs):
        r = mv(v) - lam * v
        assert float(torch.linalg.vector_norm(r) / abs(lam)) < 1e-9


def test_deflated_kcycle_counts_16(pair16):
    """The deflated solve at qmg_tpu's outer and per-level counts, a true
    residual < 1e-8, and no more outer iterations than undeflated + 2
    (qmg_tpu's own bar)."""
    jop, jmg, top, tmg, _, b = pair16
    tout = port_solve(tmg, b)
    assert_same_counts(jax_solve(jmg, b), tout)
    assert true_residual(top, torch.as_tensor(b), tout[0].x) < 1e-8
    tmg.coarsest_solve.deflate = False
    try:
        plain, _ = port_solve(tmg, b)
    finally:
        tmg.coarsest_solve.deflate = True
    assert tout[0].iters <= plain.iters + 2


def test_normal_shift(pair16):
    """``normal_shift`` adds shift * I to the coarsest normal operator: the
    inexact coarsest solve still preconditions, at qmg_tpu's counts.
    (qmg_tpu's compiled-solve cache is not keyed on the shift, so it is
    cleared around the shifted solve.)"""
    jop, jmg, top, tmg, _, b = pair16
    jmg.coarsest_solve.normal_shift = tmg.coarsest_solve.normal_shift = 0.05
    jmg._solve_cache.clear()
    try:
        jout = jax_solve(jmg, b)
        tout = port_solve(tmg, b)
        assert_same_counts(jout, tout)
        assert tout[0].iters != port_solve_unshifted(tmg, b)
    finally:
        jmg.coarsest_solve.normal_shift = 0.0
        tmg.coarsest_solve.normal_shift = 0.0
        jmg._solve_cache.clear()


def port_solve_unshifted(tmg, b):
    shift = tmg.coarsest_solve.normal_shift
    tmg.coarsest_solve.normal_shift = 0.0
    try:
        return port_solve(tmg, b)[0].iters
    finally:
        tmg.coarsest_solve.normal_shift = shift


def test_deflate_requires_normal_op(pair16):
    """Deflating a non-normal coarsest is refused, as in qmg_tpu; zero
    pairs leave the hierarchy as it is."""
    top = pair16[2]
    tlat = top.lat
    mg = tbuild(tlat, top, TKCycleConfig(n_refine=1, **CFG),
                JQMGRandom(5))
    with pytest.raises(ValueError, match="normal op"):
        mg.deflate_coarsest(2, 0)
    mg.coarsest_solve.coarsest_stencil_app = MDM
    mg.deflate_coarsest(0, 0)
    assert mg.coarsest_evecs is None


def test_batched_deflated_matches_single_and_qmg_tpu(pair16):
    """The batched deflated solve (CG on M^dag M from the deflation guess,
    per lane) of a gaussian, a point and a wall source on qmg_tpu's
    deflated state: each lane the port's single solve (iterations,
    carries, ops exactly; x to 1e-10) and qmg_tpu's
    ``make_batched_planes_solver`` (iterations; x to 1e-10)."""
    _, jmg, _, _, tcfg, b = pair16
    state = mg_state_planes(jmg, dtype=np.float64)
    tmg = state_from_numpy(state, tcfg, device="cpu")
    B = three_rhs(b)
    kw = dict(tol=1e-9, max_iter=300, restart_freq=32)
    res = check_lanes(tmg, B, **kw)
    check_qmg_tpu(jmg, state, B, res, **kw)


def test_schur_deflated_kcycle_matches_qmg_tpu(tmp_path):
    """``--outer schur --deflate``: the port's n19 levels (RIGHT_SCHUR) over
    an M^dag M coarsest deflated by 4 low and 2 high pairs at 16^2
    (complex128), handed to qmg_tpu through a checkpoint with the port's
    eigenpairs (their parity with qmg_tpu's: the tests above): qmg_tpu's
    ``mg.solve(outer_type=RIGHT_SCHUR)`` outer and per-level counts and a
    true residual < 1e-8."""
    from qmg_tpu_torch.setup import SCHUR_CONFIG
    lat = Lattice2D(16, 16, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(lat, rng, 6.0)
    top = TWilson2D(TLattice2D(16, 16, 2), DEFL_MASS, g,
                    dtype=torch.complex128)
    tmg = tbuild(top.lat, top, TKCycleConfig(
        n_refine=1, coarse_dof=8,
        **dict(SCHUR_CONFIG, coarsest_stencil_app=MDM)), rng)
    tmg.deflate_coarsest(LOW, HIGH)
    b = rng.gaussian_cv(lat)
    path = str(tmp_path / "schur16.npz")
    tcheckpoint.save_hierarchy(tmg, path)
    jop = JWilson2D(lat, DEFL_MASS, jnp.asarray(g))
    jmg = jcheckpoint.load_hierarchy(path, jop)
    jmg.coarsest_evals = jnp.asarray(tmg.coarsest_evals.numpy())
    jmg.coarsest_evecs = jnp.asarray(tmg.coarsest_evecs.numpy())
    jschur = JStencilType.RIGHT_SCHUR
    c0, i0 = _tracker(jmg)
    jres = jmg.solve(jop.prepare_M(jnp.asarray(b), jschur), tol=1e-9,
                     max_iter=300, restart_freq=32, outer_type=jschur)
    c1, i1 = _tracker(jmg)
    res, carry = make_solver(tmg, tol=1e-9, max_iter=300, restart_freq=32,
                             fine_kernel=None,
                             outer_type=StencilType.RIGHT_SCHUR)(
                                 torch.as_tensor(b))
    assert tmg.level_types() == [StencilType.RIGHT_SCHUR, MDM]
    assert_same_counts((jres, c1 - c0, i1 - i0), (res, carry))
    assert carry["iters"][-1] > 0
    assert true_residual(top, torch.as_tensor(b), res.x) < 1e-8


def test_state_exchange_both_ways(pair16):
    """``cevals`` / ``cevecs`` cross the state dict: qmg_tpu's deflated
    state drives the port's solver at the count of qmg_tpu's planes
    solver on that state, and the port's state drives qmg_tpu's planes
    solver at the port's count (float64 planes)."""
    _, jmg, _, tmg, tcfg, b = pair16
    jstate = mg_state_planes(jmg, dtype=np.float64)
    assert {"cevals", "cevecs"} <= set(jstate)
    solve, _ = make_planes_solver(jmg, tol=1e-9, max_iter=300,
                                  restart_freq=32)
    solve = jax.jit(solve)
    _, it_j, _ = solve(jstate, host_to_planes(b, np.float64))
    loaded = state_from_numpy(jstate, tcfg, device="cpu")
    assert tuple(loaded.coarsest_evecs.shape) == (LOW + HIGH, 2, 4, 2, 4)
    res, _ = port_solve(loaded, b)
    assert res.iters == int(it_j)

    tstate = state_to_numpy(tmg, dtype=np.float64)
    assert set(tstate) == set(jstate)
    _, it_t, _ = solve(tstate, host_to_planes(b, np.float64))
    assert int(it_t) == port_solve(tmg, b)[0].iters


@pytest.fixture(scope="module")
def port32():
    """The port's 32^2 hierarchy (two refinements to 2^2 nc8, an MDAGGER_M
    coarsest), handed to qmg_tpu through a checkpoint, both deflated (4
    low, 2 high)."""
    lat = TLattice2D(32, 32, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(Lattice2D(32, 32, 2), rng, 6.0)
    top = TWilson2D(lat, DEFL_MASS, g, dtype=torch.complex128)
    tmg = tbuild(lat, top, TKCycleConfig(
        n_refine=2, coarse_dof=8, nullvec_max_iter=150, nullvec_tol=5e-4,
        coarsest_stencil_app=MDM), rng)
    b = rng.gaussian_cv(Lattice2D(32, 32, 2))
    return top, tmg, g, b


def test_deflated_kcycle_counts_32(port32, tmp_path):
    top, tmg, g, b = port32
    path = str(tmp_path / "mg32.npz")
    tcheckpoint.save_hierarchy(tmg, path)
    jmg = jcheckpoint.load_hierarchy(
        path, JWilson2D(Lattice2D(32, 32, 2), DEFL_MASS, jnp.asarray(g)))
    jmg.deflate_coarsest(num_low=LOW, num_high=HIGH)
    tmg.deflate_coarsest(LOW, HIGH)
    np.testing.assert_allclose(np.sort(tmg.coarsest_evals.numpy().real),
                               np.sort(np.asarray(jmg.coarsest_evals).real),
                               rtol=1e-10)
    tout = port_solve(tmg, b)
    assert_same_counts(jax_solve(jmg, b), tout)
    assert true_residual(top, torch.as_tensor(b), tout[0].x) < 1e-8


def test_setup_stage_matches_qmg_tpu():
    """The setup's deflation stage against qmg_tpu's traced one (complex128,
    the same gauge and seeds): the kept eigenvalues within 1e-9 and their
    projectors within 1e-6 (two independent setups: the coarsest operators
    agree to the setup's own bars), and the solve on each converges."""
    from qmg_tpu.setup_planes import (
        make_kcycle_setup_planes as jmake_setup,
        gauss_seed_planes as jgauss_seeds)
    lat = Lattice2D(16, 16, 2)
    g = ju1.gauss_gauge_u1(lat, JQMGRandom(1337), 6.0)
    jcfg = JKCycleConfig(n_refine=1, coarsest_stencil_app=JMDM, **CFG)
    tcfg = TKCycleConfig(n_refine=1, coarsest_stencil_app=MDM, **CFG)
    jstate = jmake_setup(lat, jcfg, DEFL_MASS, dtype=jnp.complex128,
                         per_level_jit=True, deflate_low=LOW,
                         deflate_high=HIGH)(
        host_to_planes(g, np.float64),
        *jgauss_seeds(lat, jcfg, JQMGRandom(99), dtype=np.float64))
    tlat = TLattice2D(16, 16, 2)
    tmg = make_kcycle_setup_planes(tlat, tcfg, DEFL_MASS,
                                   dtype=torch.complex128, device="cpu",
                                   deflate_low=LOW, deflate_high=HIGH)(
        g, *gauss_seed_planes(tlat, tcfg, JQMGRandom(99)))
    jvals = np.asarray(jstate["cevals"])
    jvals = jvals[..., 0] + 1j * jvals[..., 1]
    jvecs = np.asarray(jstate["cevecs"])
    jvecs = jvecs[..., 0] + 1j * jvecs[..., 1]
    vals = tmg.coarsest_evals.numpy()
    np.testing.assert_allclose(np.sort(vals.real), np.sort(jvals.real),
                               rtol=1e-9)
    for part in (slice(0, LOW), slice(LOW, LOW + HIGH)):
        assert np.max(np.abs(projector(tmg.coarsest_evecs.numpy()[part])
                             - projector(jvecs[part]))) <= 1e-6
    b = JQMGRandom(3).gaussian_cv(lat)
    res, _ = port_solve(tmg, b)
    assert bool(res.converged)
    loaded = state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                              tcfg, device="cpu")
    assert bool(port_solve(loaded, b)[0].converged)


def test_setup_stage_refusals():
    lat = TLattice2D(16, 16, 2)
    with pytest.raises(ValueError, match="NORMAL"):
        make_kcycle_setup_planes(lat, TKCycleConfig(n_refine=1, **CFG),
                                 -0.05, device="cpu", deflate_low=2)
    with pytest.raises(ValueError, match="too large"):
        make_kcycle_setup_planes(
            TLattice2D(512, 512, 2),
            TKCycleConfig(n_refine=2, coarsest_stencil_app=MDM), -0.05,
            device="cpu", deflate_low=2)


def test_entry_point_deflate(capsys):
    """``kcycle --deflate 4`` (and ``--no-direct``) on the CPU: the CG
    coarsest on M^dag M deflated by 4 pairs, converged to tol, also with
    level 0 on a mesh (the sharded setup's deflation stage)."""
    kcycle_main(["--size", "32", "--device", "cpu", "--deflate", "4"])
    out = capsys.readouterr().out
    assert "2x2 nc8 mdagger_m" in out
    assert "coarsest solve: mdagger_m, deflated by 4 eigenpairs" in out
    assert "coarsest iterations per visit" in out
    cfg, _ = kcycle_config(32, deflate=4)
    assert cfg.coarsest_stencil_app == MDM and not cfg.coarsest_direct
    r = run_kcycle(32, "cpu", fine_kernel=None, deflate=4)
    assert r["converged"] and r["rel_res_true"] < 10 * TOL
    assert r["level_applies"][-1] == "mdagger_m"
    r = run_kcycle(32, "cpu", fine_kernel=None, direct=False)
    assert r["converged"] and r["coarsest"] == "original"
    kcycle_main(["--size", "32", "--device", "cpu", "--deflate", "4",
                 "--shards", "2"])
    out = capsys.readouterr().out
    assert "level 0 cut over Mesh(2, 1, in-process)" in out
    assert "deflated by 4 eigenpairs" in out
    with pytest.raises(SystemExit, match="exclude each other"):
        kcycle_main(["--size", "16", "--device", "cpu", "--deflate", "4",
                     "--shards", "2", "--distributed"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_deflated_solve_on_card(cuda):
    """64^2 ``--deflate 8`` on the card with the rank-1 kernel: the CPU's
    outer count (+-1: complex64 rounds differently there), a true residual
    below 10 tol, K1 launched."""
    cpu = run_kcycle(64, "cpu", deflate=8)
    card = run_kcycle(64, cuda, deflate=8)
    assert card["converged"] and card["rel_res_true"] < 10 * TOL
    assert abs(card["iters"] - cpu["iters"]) <= 1
    assert card["launches"]["wilson_r1"] > 0


if __name__ == "__main__":
    import argparse
    import time
    p = argparse.ArgumentParser(description="qmg_tpu's and the port's outer "
                                "iteration counts with bench.py's kcycle "
                                "--deflate configuration (complex64)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--deflate", type=int, default=8)
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    size = args.size
    lat = Lattice2D(size, size, 2)
    rng = JQMGRandom(1337)
    gauge = jnp.asarray(ju1.gauss_gauge_u1(lat, rng, 6.0), jnp.complex64)
    op = JWilson2D(lat, MASS, gauge, dtype=jnp.complex64)
    cfg_, restart_ = kcycle_config(size, deflate=args.deflate)
    t0 = time.perf_counter()
    jmg = jbuild(lat, op, JKCycleConfig(
        n_refine=cfg_.n_refine, coarse_dof=8, nullvec_tol=5e-4,
        nullvec_max_iter=200, inner_restart_freq=cfg_.inner_restart_freq,
        coarsest_restart_freq=restart_, coarsest_direct=False,
        coarsest_stencil_app=JMDM), rng)
    jmg.deflate_coarsest(num_low=args.deflate, num_high=0)
    b_ = rng.gaussian_cv(lat)
    print(f"qmg_tpu setup {time.perf_counter() - t0:.1f} s", flush=True)
    solve_, state_ = make_planes_solver(jmg, tol=TOL, max_iter=200,
                                        restart_freq=restart_)
    _, it_j, _ = jax.jit(solve_)(state_, host_to_planes(b_))
    print(f"qmg_tpu {size}^2 --deflate {args.deflate}: {int(it_j)} outer "
          "iterations", flush=True)
    r = run_kcycle(size, "cpu", fine_kernel=None, deflate=args.deflate)
    print(f"port {size}^2 --deflate {args.deflate} (own setup, CPU): "
          f"{r['iters']} outer iterations, true residual "
          f"{r['rel_res_true']:.3e}, level iterations {r['level_iters']}")
