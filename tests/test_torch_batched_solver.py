"""The batched multi-RHS K-cycle of the port (``solve.make_batched_solver``
and its fixed and calibrated forms) against its sequential solves and
against qmg_tpu's ``make_batched_planes_solver`` on the same hierarchy,
qmg_tpu's problem of test_batched_solver.py (32^2, nrhs 3: a gaussian, a
point and a wall source, lanes converging at different counts); the
batched solvers and the rhs-axis kernels' twins lane by lane; the
refusals. ``cuda``-marked tests hold the rhs kernels against their twins
and the single-field kernels on the card."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.setup import (KCycleConfig as JKCycleConfig,
                           build_kcycle_hierarchy as jbuild)
from qmg_tpu.tpu_compat import (make_batched_planes_solver, mg_state_planes,
                                host_to_planes, from_planes)
from qmg_tpu import u1 as ju1
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.setup import KCycleConfig
from qmg_tpu_torch.solve import (make_solver, make_batched_solver,
                                 make_fixed_batched_solver,
                                 make_calibrated_batched_solver,
                                 state_from_numpy)
from qmg_tpu_torch.stencil import apply_M
from qmg_tpu_torch.transfer import TransferMG
from qmg_tpu_torch.linalg import norm2sq, norm2sq_lanes
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch import solvers, wilson_kernel as wk, dslash_kernel as dk

torch.set_num_threads(1)

L = 32
NRHS = 3
TOL = 1e-5
# qmg_tpu's test config (test_batched_solver.py:34-35)
CFG = dict(n_refine=2, coarse_dof=4, nullvec_max_iter=150, nullvec_tol=5e-4,
           coarsest_direct=True)


@pytest.fixture(scope="module")
def problem():
    """qmg_tpu's hierarchy and right-hand sides, its state in float64
    planes, and its batched solve of them at complex128 on that state."""
    lat = JLattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    g = np.asarray(ju1.gauss_gauge_u1(lat, rng, beta=6.0)).astype(
        np.complex64)
    op = JWilson2D(lat, -0.05, jnp.asarray(g), dtype=jnp.complex64)
    mg = jbuild(lat, op, JKCycleConfig(**CFG), JQMGRandom(7))
    rhs = [np.asarray(rng.gaussian_cv(lat), np.complex64)]
    pt = np.zeros(lat.cv_shape(), np.complex64)
    pt[0, 0, 0, 0] = 1.0
    rhs.append(pt)
    wall = np.zeros(lat.cv_shape(), np.complex64)
    wall[:, 0, :, :] = 1.0
    rhs.append(wall)
    state = mg_state_planes(mg, dtype=np.float64)
    bsolve, _ = make_batched_planes_solver(mg, tol=TOL, max_iter=200,
                                           restart_freq=32)
    X_p, iters, _ = jax.jit(bsolve)(
        state, jnp.stack([host_to_planes(b, dtype=np.float64)
                          for b in rhs]))
    return {"state": state, "rhs": np.stack(rhs),
            "jax_iters": [int(i) for i in np.asarray(iters)],
            "jax_x": np.asarray(from_planes(X_p))}


def _load(problem, **cfg):
    mg = state_from_numpy(problem["state"], KCycleConfig(**CFG, **cfg),
                          device="cpu", dtype=torch.complex128)
    return mg, torch.as_tensor(problem["rhs"]).to(torch.complex128)


@pytest.fixture(scope="module")
def plain_solves(problem):
    """The port's batched and sequential solves with the plain applies
    (qmg_tpu's jnp route) at complex128."""
    mg, B = _load(problem)
    kw = dict(tol=TOL, max_iter=200, restart_freq=32, fine_kernel=None)
    seq = make_solver(mg, **kw)
    batched = make_batched_solver(mg, **kw)(B)
    return {"mg": mg, "B": B, "batched": batched,
            "seq": [seq(B[k]) for k in range(NRHS)]}


def test_lanes_match_sequential_and_jax(problem, plain_solves):
    (res, carry), seq = plain_solves["batched"], plain_solves["seq"]
    its = [int(i) for i in res.iters]
    assert len(set(its)) >= 2, "the rhs should converge at different counts"
    assert its == [int(r.iters) for r, _ in seq]
    assert its == problem["jax_iters"], (its, problem["jax_iters"])
    for k, (r, c) in enumerate(seq):
        x, xs = res.x[k], r.x
        assert float((x - xs).abs().max() / xs.abs().max()) <= 1e-10, k
        # per-lane carries: every level's counts and iterations
        assert np.array_equal(carry["counts"][k], c["counts"]), k
        assert np.array_equal(carry["iters"][k], c["iters"]), k
        assert int(res.ops_count[k]) == int(r.ops_count)
        xj = problem["jax_x"][k]
        assert np.max(np.abs(x.numpy() - xj)) <= 1e-10 * np.max(np.abs(xj))
    assert bool(res.converged.all())


def test_kernel_routes_match_sequential(problem):
    """With the rank-1 kernel on level 0 and K6 on the coarse levels (their
    twins here), each lane follows its sequential solve."""
    mg, B = _load(problem)
    kw = dict(tol=TOL, max_iter=200, restart_freq=32,
              fine_kernel="wilson-r1", coarse_apply="small")
    solve = make_batched_solver(mg, **kw)
    assert solve.level_applies == ["wilson-r1", "small", "small"]
    res, carry = solve(B)
    seq = make_solver(mg, **kw)
    for k in range(NRHS):
        r, c = seq(B[k])
        assert int(res.iters[k]) == int(r.iters), k
        assert float((res.x[k] - r.x).abs().max() / r.x.abs().max()) \
            <= 1e-10, k
        assert np.array_equal(carry["iters"][k], c["iters"]), k
    # the overrides exist only inside a solve
    assert all(mg.get_stencil(lvl).apply_override is None
               for lvl in range(mg.get_num_levels()))


def test_unrestarted_intermediate_matches_sequential(problem):
    """``intermediate_restart_freq = -1`` (unrestarted flexible GCR on level
    1, as in qmg_tpu): each lane follows its sequential solve."""
    mg, B = _load(problem, inner_restart_freq=-1)
    kw = dict(tol=TOL, max_iter=200, restart_freq=32, fine_kernel=None)
    res, carry = make_batched_solver(mg, **kw)(B)
    seq = make_solver(mg, **kw)
    for k in range(NRHS):
        r, c = seq(B[k])
        assert int(res.iters[k]) == int(r.iters), k
        assert np.array_equal(carry["counts"][k], c["counts"]), k
        assert np.array_equal(carry["iters"][k], c["iters"]), k


def test_tracker_absorbs_the_lanes(problem):
    mg, B = _load(problem)
    res, carry = make_batched_solver(mg, tol=TOL, fine_kernel=None)(B)
    assert np.array_equal(mg.tracker["counts"], carry["counts"].sum(0))
    assert np.array_equal(mg.tracker["iters"], carry["iters"].sum(0))
    assert np.array_equal(carry["iters"][:, 0], res.iters)


def test_fixed_schedule(problem):
    """Fixed inner trips, direct coarsest, 16 outer trips on every lane:
    each lane is the single-lane fixed solve of its rhs, and converges."""
    mg, _ = _load(problem, inner_fixed_iters=4)
    assert mg.get_level_solve(1).fixed_trips
    assert mg.get_level_solve(1).intermediate_iters == 4
    rng = QMGRandom(1338)
    B = torch.stack([torch.as_tensor(rng.gaussian_cv(Lattice2D(L, L, 2)))
                     for _ in range(NRHS)])
    solve = make_fixed_batched_solver(mg, outer_iters=16, tol=TOL,
                                      restart_freq=16, fine_kernel=None)
    res, carry = solve(B)
    assert np.all(res.iters == 16)
    assert np.all(carry["iters"][:, 1] == 16 * 4)   # 4 inner trips a cycle
    fine = mg.get_stencil(0).coeffs
    for k in range(NRHS):
        r = B[k] - apply_M(fine, res.x[k])
        assert float(torch.sqrt(norm2sq(r) / norm2sq(B[k]))) < 1e-4
        one, _ = solve(B[k:k + 1])
        assert float((one.x[0] - res.x[k]).abs().max()
                     / res.x[k].abs().max()) <= 1e-12


def test_fixed_inner_trips_adaptive_outer(problem):
    """With fixed inner trips and the adaptive outer loop, the sequential
    solve runs 4 inner trips a K-cycle (no stopping test) and each
    batched lane follows it."""
    mg, B = _load(problem, inner_fixed_iters=4)
    kw = dict(tol=TOL, max_iter=200, restart_freq=32, fine_kernel=None)
    res, carry = make_batched_solver(mg, **kw)(B)
    seq = make_solver(mg, **kw)
    for k in range(NRHS):
        r, c = seq(B[k])
        assert c["iters"][1] == 4 * c["iters"][0]
        assert int(res.iters[k]) == int(r.iters)
        assert np.array_equal(carry["counts"][k], c["counts"]), k
        assert float((res.x[k] - r.x).abs().max() / r.x.abs().max()) \
            <= 1e-10


def test_fixed_schedule_refusals(problem):
    mg, _ = _load(problem)
    with pytest.raises(ValueError, match="fixed_trips"):
        make_fixed_batched_solver(mg, outer_iters=8)
    make_fixed_batched_solver(mg, outer_iters=8, allow_masked_inner=True)
    mg.coarsest_dinv = None
    mg.coarsest_solve.direct = False
    with pytest.raises(ValueError, match="direct coarsest"):
        make_fixed_batched_solver(mg, outer_iters=8)


def test_calibrated(problem):
    """One adaptive probe picks the outer count; gaussian lanes then meet
    the tolerance without a decade of overshoot (qmg_tpu's test)."""
    mg, B = _load(problem)
    solve, outer = make_calibrated_batched_solver(
        mg, B[0], tol=TOL, max_iter=200, restart_freq=32, fine_kernel=None)
    rng = QMGRandom(99)
    lanes = torch.stack([torch.as_tensor(rng.gaussian_cv(Lattice2D(L, L, 2)))
                         for _ in range(NRHS)])
    res, _ = solve(lanes)
    assert np.all(res.iters == outer)
    rel = (res.res_sq / (TOL ** 2 * norm2sq_lanes(lanes))).numpy()
    assert rel.max() <= 1.0 and rel.max() >= 1e-2, rel
    fine = mg.get_stencil(0).coeffs
    for k in range(NRHS):
        r = lanes[k] - apply_M(fine, res.x[k])
        assert float(torch.sqrt(norm2sq(r) / norm2sq(lanes[k]))) < 2 * TOL


def test_refusals(problem):
    mg, B = _load(problem)
    for kind in ("wilson-phase", "matrix", "matrix-split", "small"):
        with pytest.raises(ValueError, match="ROADMAP"):
            make_batched_solver(mg, fine_kernel=kind)
    with pytest.raises(ValueError, match="gather"):
        make_batched_solver(mg, coarse_apply="gather")
    from qmg_tpu_torch.parallel import Mesh
    with pytest.raises(ValueError, match="x-unsharded"):
        make_batched_solver(mg, mesh=Mesh(2, 2))
    mg.get_stencil(0).wilson_coeff = 1.3     # the rank-1 kernel's w = 1
    with pytest.raises(ValueError, match="wilson_coeff=1"):
        make_batched_solver(mg, fine_kernel="wilson-r1")
    solve = make_batched_solver(mg, fine_kernel=None, coarse_apply="jnp")
    with pytest.raises(ValueError, match="right-hand sides"):
        solve(B[0])


def test_batched_krylov_solvers_lane_by_lane():
    """gcr_restart_batched and minres_batched on a small Wilson system:
    lane k is the sequential solver on field k, with a per-lane tensor
    tolerance and lanes that converge at different counts."""
    from qmg_tpu_torch.operators import Wilson2D
    lat = Lattice2D(8, 8, 2)
    g = np.exp(1j * np.random.default_rng(4).uniform(-1, 1, (2, 2, 8, 4)))
    op = Wilson2D(lat, 0.1, g, dtype=torch.complex128)
    rng = np.random.default_rng(5)
    B = torch.as_tensor(rng.normal(size=(3,) + lat.cv_shape())
                        + 1j * rng.normal(size=(3,) + lat.cv_shape()))
    tols = torch.tensor([1e-3, 1e-6, 1e-9], dtype=torch.float64)
    res = solvers.gcr_restart_batched(op.apply_M, B, max_iter=200, tol=tols,
                                      restart_freq=8)
    assert len(set(res.iters.tolist())) == 3
    for k in range(3):
        r = solvers.gcr_restart(op.apply_M, B[k], max_iter=200,
                                tol=float(tols[k]), restart_freq=8)
        assert int(res.iters[k]) == r.iters
        assert int(res.ops_count[k]) == r.ops_count
        assert float((res.x[k] - r.x).abs().max()) <= 1e-12
    for tol in (1e-15, 1e-2):        # the fixed smoother and a tested one
        res = solvers.minres_batched(op.apply_M, B, max_iter=3, tol=tol,
                                     omega=0.85)
        for k in range(3):
            r = solvers.minres(op.apply_M, B[k], max_iter=3, tol=tol,
                               omega=0.85)
            assert int(res.iters[k]) == r.iters
            assert float((res.x[k] - r.x).abs().max()) <= 1e-12
    # lanes outside ``active`` stay at zero
    active = solvers.Lanes(torch.tensor([True, False, True]),
                           np.array([True, False, True]))
    res = solvers.gcr_restart_batched(op.apply_M, B, max_iter=50, tol=1e-6,
                                      active=active)
    assert res.iters[1] == 0 and float(res.x[1].abs().max()) == 0.0


def test_transfer_takes_the_rhs_axis():
    rng = np.random.default_rng(6)
    fine, coarse = Lattice2D(16, 16, 2), Lattice2D(4, 4, 4)
    nv = torch.as_tensor(rng.normal(size=(4,) + fine.cv_shape())
                         + 1j * rng.normal(size=(4,) + fine.cv_shape()))
    t = TransferMG(fine, coarse, nv)
    x = torch.as_tensor(rng.normal(size=(3,) + fine.cv_shape()) + 0j)
    c = t.restrict_f2c(x)
    assert c.shape == (3,) + coarse.cv_shape()
    for k in range(3):
        assert torch.allclose(c[k], t.restrict_f2c(x[k]), rtol=0,
                              atol=1e-13)
        assert torch.allclose(t.prolong_c2f(c)[k], t.prolong_c2f(c[k]),
                              rtol=0, atol=1e-13)


@pytest.mark.parametrize("y_len,xh", [(8, 4), (16, 8), (2, 1)])
def test_rhs_twins_lane_by_lane(y_len, xh):
    """The rhs entries' twins (CPU tensors) equal the single-field twins
    lane by lane, through the wrappers and through bound applies."""
    gen = torch.Generator().manual_seed(y_len)
    phase = torch.randn((4, 2, y_len, xh), dtype=torch.complex64,
                        generator=gen)
    x = torch.randn((5, 2, y_len, xh, 2), dtype=torch.complex64,
                    generator=gen)
    got = wk.wilson_r1_rhs_apply(phase, x, 1.94)
    bound = wk.bind_wilson(wk.wilson_r1_rhs_apply, phase, x.shape, 1.94)
    assert torch.equal(bound(x), got)
    for b in range(5):
        assert torch.equal(got[b], wk.wilson_r1_apply(phase, x[b], 1.94))
    for nc in (2, 8):
        ch = torch.randn((5, 2, y_len, xh, nc, nc), dtype=torch.complex64,
                         generator=gen)
        v = torch.randn((5, 2, y_len, xh, nc), dtype=torch.complex64,
                        generator=gen)
        got = dk.dslash_small_rhs_apply(ch, v)
        assert torch.equal(dk.bind_apply(dk.dslash_small_rhs_apply, ch,
                                         v.shape)(v), got)
        for b in range(5):
            assert torch.equal(got[b], dk.dslash_small_interleaved_apply(
                ch, v[b]))
            assert torch.equal(got[b], dk.dslash_apply_plain(ch, v[b]))


def test_rhs_wrapper_refusals():
    phase = torch.zeros((4, 2, 8, 4), dtype=torch.complex64)
    for bad in ((2, 8, 4, 2), (3, 2, 8, 4, 3), (0, 2, 8, 4, 2),
                (3, 2, 4, 4, 2)):
        with pytest.raises(ValueError):
            wk.wilson_r1_rhs_apply(phase, torch.zeros(bad,
                                                      dtype=torch.complex64),
                                   1.9)
    ch = torch.zeros((5, 2, 8, 4, 8, 8), dtype=torch.complex64)
    x = torch.zeros((4, 2, 8, 4, 8), dtype=torch.complex64)
    for bad in (x[0], x[:0], x[:, :1]):
        with pytest.raises(ValueError, match="layout"):
            dk.dslash_small_rhs_apply(ch, bad)
    big = torch.zeros((5, 2, 512, 256, 8, 8), dtype=torch.complex64,
                      device="meta")
    with pytest.raises(ValueError, match="small kernel"):
        dk.dslash_small_rhs_apply(big, torch.zeros(
            (2, 2, 512, 256, 8), dtype=torch.complex64, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        wk.wilson_r1_rhs_apply(phase.to("meta"), torch.zeros(
            (3, 2, 8, 4, 2), dtype=torch.complex64, device="meta"), 1.9)
    assert dk.apply_bytes(8, 1024, nrhs=8) == (2560 + 8 * 128) * 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("y_len,xh,nrhs", [(8, 4, 3), (512, 256, 8),
                                           (64, 32, 1)])
def test_k1_rhs_on_card(cuda, y_len, xh, nrhs):
    gen = torch.Generator(device=cuda).manual_seed(y_len)
    phase = torch.randn((4, 2, y_len, xh), dtype=torch.complex64,
                        device=cuda, generator=gen)
    x = torch.randn((nrhs, 2, y_len, xh, 2), dtype=torch.complex64,
                    device=cuda, generator=gen)
    n0 = wk.wilson_r1_rhs_apply.launches
    got = wk.wilson_r1_rhs_apply(phase, x, 1.94)
    torch.cuda.synchronize()
    assert wk.wilson_r1_rhs_apply.launches == n0 + 1
    ref = wk.wilson_r1_apply_plain(phase, x, 1.94)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    for b in range(nrhs):
        assert torch.equal(got[b], wk.wilson_r1_apply(phase, x[b], 1.94))


@pytest.mark.cuda
@pytest.mark.parametrize("y_len,xh,nc", [(32, 16, 8), (8, 4, 8), (64, 32, 2)])
@pytest.mark.parametrize("nrhs", [1, 3, 8])
def test_k6_rhs_on_card(cuda, y_len, xh, nc, nrhs):
    gen = torch.Generator(device=cuda).manual_seed(y_len + nc)
    ch = torch.randn((5, 2, y_len, xh, nc, nc), dtype=torch.complex64,
                     device=cuda, generator=gen)
    x = torch.randn((nrhs, 2, y_len, xh, nc), dtype=torch.complex64,
                    device=cuda, generator=gen)
    n0 = dk.dslash_small_rhs_apply.launches
    got = dk.dslash_small_rhs_apply(ch, x)
    torch.cuda.synchronize()
    assert dk.dslash_small_rhs_apply.launches == n0 + 1
    ref = dk.dslash_apply_plain(ch, x)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    for b in range(nrhs):
        assert torch.equal(got[b],
                           dk.dslash_small_interleaved_apply(ch, x[b]))
