"""Port vs qmg_tpu on the n22 adaptive setup (qmg_tpu's
tests/test_n16_n22_adaptive.py): the full ladder at complex128 on 16^2
(``build_adaptive_hierarchy``, two ``adaptive_pass``es,
``finalize_adaptive``) from the same replayed seeds, the GCR breakdown
guard that the 512^2 flow depends on, the GCR direction store sized by
the iterations a solve can take, K1's twin on an adapted hierarchy, a
checkpoint of one, and the entry point ``kcycle --setup adaptive``.

Run as a script it prints qmg_tpu's outer iteration count on the
adaptive hierarchy of ``kcycle --setup adaptive`` at one size (qmg_tpu's
traced ``make_adaptive_setup_planes`` with the dense coarsest inverse and
its planes solver, complex64, on the CPU), after ``n_setup`` = 1 and 0
passes, and the port's on the CPU (the 512^2 counts are what
``chip_smoke.py`` embeds as ``JAX_ITERS_512_ADAPTIVE``; qmg_tpu's setup
takes ~75 s at 128^2 and ~26 min at 512^2 on the CPU):

    PYTHONPATH=. JAX_PLATFORMS=cpu \\
        python tests/test_torch_adaptive.py --size 512
"""

import collections

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1, solvers as jsolvers
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.setup import (AdaptiveConfig as JAdaptiveConfig,
                           build_adaptive_hierarchy as jbuild_adaptive,
                           adaptive_pass as jadaptive_pass,
                           finalize_adaptive as jfinalize)
from qmg_tpu.setup_planes import adaptive_seed_planes as jseed_planes
from qmg_tpu.stateful import DSLASH_KRYLOV, DSLASH_NULLVEC
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch import checkpoint as tcheckpoint, solvers as tsolvers
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.setup import (AdaptiveConfig, build_adaptive_hierarchy,
                                 adaptive_pass, finalize_adaptive)
from qmg_tpu_torch.setup_planes import (adaptive_seed_planes,
                                        make_adaptive_setup_planes)
from qmg_tpu_torch.solve import make_solver
from qmg_tpu_torch.kcycle import main as kcycle_main, true_residual

torch.set_num_threads(1)

L = 16
MASS = -0.05
LADDER = dict(n_refine=2, coarse_dof=8, n_setup=2)
SOLVE = dict(tol=1e-8, max_iter=400, restart_freq=32)
# PARITY.md's setup-equivalence bars (level 1 ~1e-12, level 2 ~1e-9),
# held at 1e-12 on both levels: the n22 flow is fixed-iteration
# (Richardson 10, K-cycle smoothing 10) and well conditioned, so the two
# packages' reduction orders part by at most 4.1e-15 after two passes
# (measured).
LADDER_BAR = 1e-12
STAGES = ("init", "pass 0", "pass 1")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


class ReplayRng:
    """Hands qmg_tpu's eager flow the port's seeds, in the order drawn."""

    def __init__(self, init, passes):
        flat = list(init) + [s for per in passes for lvl in per for s in lvl]
        self.q = collections.deque(v for s in flat for v in s)

    def gaussian_cv(self, lat):
        v = self.q.popleft()
        assert v.shape == lat.cv_shape(), (v.shape, lat.cv_shape())
        return v


def _arrays(mg, tvs):
    """Per level below 0: the test vectors and null vectors that made it,
    its clover, hopping and shifts."""
    out = {}
    for lvl in range(1, mg.get_num_levels()):
        c = mg.get_stencil(lvl).coeffs
        out[f"tv{lvl - 1}"] = np.asarray(
            tvs[lvl - 1] if isinstance(tvs[lvl - 1], torch.Tensor)
            else np.stack([np.asarray(v) for v in tvs[lvl - 1]]))
        out[f"nvb{lvl - 1}"] = np.asarray(mg.get_transfer(lvl - 1)._nvb)
        out[f"clover{lvl}"] = np.asarray(c.clover)
        out[f"hopping{lvl}"] = np.asarray(c.hopping)
        out[f"shifts{lvl}"] = np.array(
            [complex(c.shift), complex(c.eo_shift), complex(c.dof_shift)])
    return out


def _trackers(jmg):
    n = jmg.get_num_levels()
    return [[jmg.get_tracker_count(t, lvl) for t in range(4)]
            for lvl in range(n)], [jmg.get_iterations_count(lvl)
                                   for lvl in range(n)]


@pytest.fixture(scope="module")
def ladder():
    """The ladder in both packages from the same seeds: after the initial
    levels and each pass, both hierarchies' arrays and a solve's outer
    count (untracked); then the finalized hierarchies and one tracked
    solve."""
    jlat, tlat = Lattice2D(L, L, 2), TLattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(jlat, rng, 6.0)
    b = rng.gaussian_cv(jlat)
    init, passes = adaptive_seed_planes(tlat, AdaptiveConfig(**LADDER),
                                        JQMGRandom(4242))
    replay = ReplayRng(init, passes)
    jacfg, tacfg = JAdaptiveConfig(**LADDER), AdaptiveConfig(**LADDER)
    jmg, jtvs = jbuild_adaptive(
        jlat, JWilson2D(jlat, MASS, jnp.asarray(g), dtype=jnp.complex128),
        jacfg, replay)
    tmg, ttvs = build_adaptive_hierarchy(
        tlat, TWilson2D(tlat, MASS, g, dtype=torch.complex128, device="cpu"),
        tacfg, seeds=init)
    tb = torch.as_tensor(b)
    stages = {}

    def record(stage):
        jmg._solve_cache.clear()
        jres = jmg.solve(jnp.asarray(b), track=False, **SOLVE)
        tres = tmg.solve(tb, track=False, **SOLVE)
        stages[stage] = (_arrays(jmg, jtvs), _arrays(tmg, ttvs), jres, tres)

    record("init")
    for m in range(LADDER["n_setup"]):
        jadaptive_pass(jmg, jtvs, jacfg, replay)
        adaptive_pass(tmg, ttvs, tacfg, seeds=passes[m])
        record(f"pass {m}")
    undrawn = len(replay.q)
    jfinalize(jmg, jacfg)
    finalize_adaptive(tmg, tacfg)
    finalized = (_trackers(jmg), (tmg.tracker["counts"].tolist(),
                                  tmg.tracker["iters"].tolist()))
    jmg._solve_cache.clear()
    jres = jmg.solve(jnp.asarray(b), **SOLVE)
    tres = tmg.solve(tb, **SOLVE)
    return dict(stages=stages, undrawn=undrawn, finalized=finalized,
                jmg=jmg, tmg=tmg, final=(jres, tres), b=b, acfg=tacfg)


def test_seed_order_matches_qmg_tpu():
    """``adaptive_seed_planes`` draws qmg_tpu's numbers in qmg_tpu's order
    (its float64 planes are exact)."""
    acfg = AdaptiveConfig(n_refine=3, coarse_dof=8, n_setup=2)
    init, passes = adaptive_seed_planes(TLattice2D(64, 64, 2), acfg,
                                        JQMGRandom(7))
    jinit, jpasses = jseed_planes(Lattice2D(64, 64, 2),
                                  JAdaptiveConfig(n_refine=3, coarse_dof=8,
                                                  n_setup=2),
                                  JQMGRandom(7), dtype=np.float64)

    def cplx(p):
        p = np.asarray(p)
        return p[..., 0] + 1j * p[..., 1]

    assert len(init) == len(jinit) == 3
    for a, j in zip(init, jinit):
        assert np.array_equal(a, cplx(j))
    assert [[len(lvl) for lvl in per] for per in passes] == \
        [[len(lvl) for lvl in per] for per in jpasses] == [[2, 1, 0]] * 2
    for per, jper in zip(passes, jpasses):
        for lvl, jlvl in zip(per, jper):
            for a, j in zip(lvl, jlvl):
                assert np.array_equal(a, cplx(j))


def test_ladder_consumes_every_seed(ladder):
    assert ladder["undrawn"] == 0


@pytest.mark.parametrize("stage", STAGES)
def test_ladder_arrays(ladder, stage):
    """Test vectors, null vectors, clover, hopping and shifts of every
    coarse level within ``LADDER_BAR`` of qmg_tpu's after the initial
    levels and after each pass."""
    jarr, tarr, _, _ = ladder["stages"][stage]
    assert set(jarr) == set(tarr)
    for name in jarr:
        assert tarr[name].shape == jarr[name].shape, name
        assert _rel(tarr[name], jarr[name]) <= LADDER_BAR, name


@pytest.mark.parametrize("stage", STAGES)
def test_ladder_outer_counts(ladder, stage):
    """The same outer count as qmg_tpu's after every stage, the passes
    improving on the Richardson-only hierarchy."""
    _, _, jres, tres = ladder["stages"][stage]
    assert bool(jres.converged) and bool(tres.converged)
    assert int(tres.iters) == int(jres.iters)
    assert _rel(tres.x, jres.x) <= 1e-9
    if stage != "init":
        assert int(tres.iters) <= int(ladder["stages"]["init"][3].iters)


def test_ladder_finalized(ladder):
    """``finalize_adaptive``: the counters equal qmg_tpu's (the setup's work
    in NULLVEC, the rest zero) and the solve-phase level solves restored;
    then a tracked solve at qmg_tpu's counts and average iterations."""
    (jcounts, jiters), (tcounts, titers) = ladder["finalized"]
    assert tcounts == jcounts and titers == jiters
    assert all(c[DSLASH_KRYLOV] == 0 for c in tcounts)
    assert tcounts[0][DSLASH_NULLVEC] > 0 and tcounts[1][DSLASH_NULLVEC] > 0
    tmg, acfg = ladder["tmg"], ladder["acfg"]
    for lvl in range(tmg.get_num_levels() - 1):
        ls = tmg.get_level_solve(lvl)
        assert (ls.intermediate_tol, ls.intermediate_iters,
                ls.intermediate_restart_freq) == (
            acfg.inner_tol, acfg.inner_max_iter, acfg.inner_restart_freq)
    jres, tres = ladder["final"]
    assert int(tres.iters) == int(jres.iters)
    jmg = ladder["jmg"]
    assert tmg.get_tracker_count(DSLASH_KRYLOV, 0) > 0
    assert (tmg.tracker["counts"].tolist(),
            tmg.tracker["iters"].tolist()) == _trackers(jmg)
    assert tmg.query_average_iterations() == pytest.approx(
        jmg.query_average_iterations(), rel=1e-15)
    assert tmg.query_average_iterations()[0] == float(tres.iters)


def test_breakdown_guard_matches_qmg_tpu():
    """A complex64 flexible GCR driven past its floor: a well-conditioned
    8 x 8 system, |b| ~ 1e-10, tol 1e-10. Once the Krylov space is spent
    the orthogonalized direction's norm^2 falls below float32's smallest
    normal number; both packages' guard then makes the step a no-op (a
    copy without the guard returns NaN at iteration 9). Both stop at
    max_iter with a finite x, not converged, and the same x."""
    rng = np.random.default_rng(3)
    n = 8
    a = (4 * np.eye(n) + 0.3 * (rng.standard_normal((n, n))
                                + 1j * rng.standard_normal((n, n)))
         ).astype(np.complex64)
    d = np.diag(1 / np.diag(a)).astype(np.complex64)
    b = (1e-10 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    ta, td = torch.as_tensor(a), torch.as_tensor(d)
    ja, jd = jnp.asarray(a), jnp.asarray(d)
    kw = dict(max_iter=40, tol=1e-10)
    tres, _ = tsolvers.gcr_var_precond(lambda x: ta @ x, torch.as_tensor(b),
                                       lambda r, c: (td @ r, c), **kw)
    jres, _ = jsolvers.gcr_var_precond(lambda x: ja @ x, jnp.asarray(b),
                                       lambda r, c: (jd @ r, c), **kw)
    assert int(tres.iters) == int(jres.iters) == 40
    assert not bool(tres.converged) and not bool(jres.converged)
    assert bool(torch.isfinite(torch.view_as_real(tres.x)).all())
    assert _rel(tres.x, jres.x) <= 1e-6
    assert _rel(tres.x, np.linalg.solve(a, b)) <= 1e-5


def test_gcr_store_sized_by_iterations():
    """A solve of at most ``max_iter`` iterations stores at most
    ``max_iter`` directions: the adaptive setup's 8-iteration level solves
    with a restart length of 1024 allocate 8 rows, so a field whose
    1024-row store would pass the 8 GiB limit solves (qmg_tpu refuses
    it), with the iterates of a store of 1024 rows."""
    big = torch.ones((1 << 19,), dtype=torch.complex128)
    res, _ = tsolvers.gcr_var_precond_restart(
        lambda x: 2 * x, big, lambda r, c: (r, c), max_iter=8, tol=1e-12,
        restart_freq=1024)
    assert bool(res.converged)
    with pytest.raises(ValueError, match="direction store"):
        jsolvers.gcr_var_precond_restart(
            lambda x: 2 * x, jnp.ones((1 << 19,), jnp.complex128),
            lambda r, c: (r, c), max_iter=8, tol=1e-12, restart_freq=1024)
    rng = np.random.default_rng(5)
    a = (3 * np.eye(24) + rng.standard_normal((24, 24))).astype(np.complex128)
    b = rng.standard_normal(24).astype(np.complex128)
    ta, ja = torch.as_tensor(a), jnp.asarray(a)
    tres = tsolvers.gcr_restart(lambda x: ta @ x, torch.as_tensor(b),
                                max_iter=8, tol=1e-14, restart_freq=1024)
    jres = jsolvers.gcr_restart(lambda x: ja @ x, jnp.asarray(b),
                                max_iter=8, tol=1e-14, restart_freq=1024)
    assert int(tres.iters) == int(jres.iters) == 8
    assert _rel(tres.x, jres.x) <= 1e-13


@pytest.fixture(scope="module")
def adapted32():
    """The port's 32^2 complex64 adaptive hierarchy (n_refine 2,
    coarse_dof 8, one pass, dense coarsest) and a right-hand side."""
    lat = TLattice2D(32, 32, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(Lattice2D(32, 32, 2), rng, 6.0)
    acfg = AdaptiveConfig(n_refine=2, coarse_dof=8, n_setup=1)
    seeds = adaptive_seed_planes(lat, acfg, rng)
    mg = make_adaptive_setup_planes(lat, acfg, -0.06, device="cpu",
                                    coarsest_direct=True)(g, *seeds)
    b = torch.as_tensor(rng.gaussian_cv(lat)).to(torch.complex64)
    return mg, b


def test_wilson_r1_twin_on_adapted_hierarchy(adapted32):
    """``make_solver(fine_kernel="wilson-r1")`` on the CPU takes K1's twin
    on level 0 of the adapted hierarchy: within +-1 of the plain solve's
    count, both to a true residual below the tolerance."""
    mg, b = adapted32
    counts = []
    for kernel in ("wilson-r1", None):
        solve = make_solver(mg, tol=1e-5, max_iter=200, fine_kernel=kernel)
        res, _ = solve(b)
        assert bool(res.converged)
        assert true_residual(mg.get_stencil(0), b, res.x) <= 1e-5
        counts.append(res.iters)
    assert solve.level_applies[0] == "plain"
    assert abs(counts[0] - counts[1]) <= 1


def test_checkpoint_of_adapted_hierarchy(adapted32, tmp_path):
    """Save and load an adapted hierarchy (version-3 format): the same
    arrays, the same outer count and, to complex64 rounding, the same
    solution."""
    mg, b = adapted32
    path = str(tmp_path / "adapted.npz")
    tcheckpoint.save_hierarchy(mg, path)
    loaded = tcheckpoint.load_hierarchy(path, mg.get_stencil(0),
                                        device="cpu")
    assert torch.equal(loaded.coarsest_dinv, mg.coarsest_dinv)
    for lvl in (1, 2):
        assert torch.equal(loaded.get_stencil(lvl).coeffs.hopping,
                           mg.get_stencil(lvl).coeffs.hopping)
    runs = [make_solver(m, tol=1e-5, max_iter=200, fine_kernel=None)(b)[0]
            for m in (mg, loaded)]
    assert runs[0].iters == runs[1].iters
    assert _rel(runs[0].x, runs[1].x) <= 1e-5


def test_entry_point(capsys):
    """``kcycle --setup adaptive`` runs on the CPU and prints the setup's
    stages and the per-level operator report; the combinations it does not
    take are refused."""
    kcycle_main(["--size", "32", "--device", "cpu", "--setup", "adaptive"])
    out = capsys.readouterr().out
    assert "(adaptive setup)" in out
    assert "setup stages s: operator" in out and "pass 0 L0" in out
    for lvl in range(3):
        assert f"[QMG-OPS-STATS]: Level {lvl} NULLVEC" in out
    assert "[QMG-ITER-STATS]: avg iterations per level" in out
    for extra in (["--outer", "schur", "--fine-kernel", "none"],
                  ["--deflate", "4"], ["--shards", "2"]):
        with pytest.raises(SystemExit, match="adaptive"):
            kcycle_main(["--size", "32", "--device", "cpu", "--setup",
                         "adaptive"] + extra)


def main():
    """qmg_tpu's and the port's outer counts on ``kcycle --setup
    adaptive``'s hierarchy at one size, after 1 and 0 passes."""
    import argparse
    import time
    import jax
    from qmg_tpu.setup import KCycleConfig as JKCycleConfig
    from qmg_tpu.setup import build_kcycle_hierarchy as jbuild
    from qmg_tpu.setup_planes import (make_adaptive_setup_planes as jmake,
                                      gauss_seed_planes as jgauss_seeds)
    from qmg_tpu.tpu_compat import (host_to_planes, make_planes_solver,
                                    from_planes)
    from qmg_tpu.linalg import norm2sq
    from qmg_tpu_torch.kcycle import (build_problem, adaptive_problem,
                                      run_solver, kcycle_config, MASS as M,
                                      SEED, BETA, TOL, MAX_ITER)
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=128)
    args = p.parse_args()
    size = args.size
    lat = Lattice2D(size, size, 2)
    cfg, restart = kcycle_config(size)
    rng = JQMGRandom(SEED)
    gauge = np.asarray(ju1.gauss_gauge_u1(lat, rng, BETA)).astype(
        np.complex64)
    jgauss_seeds(lat, JKCycleConfig(n_refine=cfg.n_refine, coarse_dof=8),
                 rng)
    b = np.asarray(rng.gaussian_cv(lat)).astype(np.complex64)
    jacfg = JAdaptiveConfig(n_refine=cfg.n_refine, coarse_dof=8, n_setup=1)
    init, passes = jseed_planes(lat, jacfg, rng)
    op = JWilson2D(lat, M, jnp.asarray(gauge), dtype=jnp.complex64)
    scaffold = jbuild(lat, op, JKCycleConfig(n_refine=cfg.n_refine,
                                             coarse_dof=8,
                                             coarsest_direct=True),
                      JQMGRandom(1), structure_only=True)
    solve, _ = make_planes_solver(scaffold, tol=TOL, max_iter=MAX_ITER,
                                  restart_freq=restart)
    solve = jax.jit(solve)
    problem = build_problem(size, "cpu", setup="adaptive", n_setup=1)
    for n_setup in (1, 0):
        t0 = time.time()
        state = jmake(lat, JAdaptiveConfig(n_refine=cfg.n_refine,
                                           coarse_dof=8, n_setup=n_setup),
                      M, coarsest_direct=True)(host_to_planes(gauge), init,
                                               passes[:n_setup])
        x, iters, _ = solve(state, host_to_planes(b))
        bj = jnp.asarray(b)
        resid = float(jnp.sqrt(norm2sq(bj - op.apply_M(from_planes(x)))
                               / norm2sq(bj)))
        port = run_solver(problem if n_setup else adaptive_problem(
            problem, 0, seeds=(problem["seeds"][0], [])), fine_kernel=None)
        print(f"{size}^2 n_refine {cfg.n_refine} n_setup {n_setup}: qmg_tpu "
              f"{int(iters)} outer iterations (true residual {resid:.3e}, "
              f"setup + solve {time.time() - t0:.1f} s on the CPU); port "
              f"{port['iters']} (true residual {port['rel_res_true']:.3e})",
              flush=True)


if __name__ == "__main__":
    main()
