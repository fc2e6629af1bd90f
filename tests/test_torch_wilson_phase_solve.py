"""The K-cycle on a Wilson operator at any Wilson coefficient w: the
port's ``make_solver(fine_kernel="wilson-phase")`` on a hierarchy that
qmg_tpu built with ``Wilson2D(wilson_coeff=w)`` and handed over through
``mg_state_planes`` -> ``state_from_numpy`` (which recovers w), against
qmg_tpu's ``make_planes_solver(pallas_kind="wilson-phase")`` with its
Pallas kernel in interpret mode; the refusals; ``Wilson2D``'s
``from_coeffs`` / ``update_links`` / ``gamma5`` / ``sigma1``; and the two
entry points with the new kinds on the CPU.

Run as a script it prints qmg_tpu's outer iteration count with bench.py's
kcycle configuration at one size, w and fine apply - the reference counts
that ``chip_smoke.py`` embeds:

    JAX_PLATFORMS=cpu python tests/test_torch_wilson_phase_solve.py \
        --size 512 --wilson-coeff 1.3
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
from qmg_tpu_torch.kcycle import true_residual, kcycle_config, MASS
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.operators.coarse import CoarseOperator2D
from qmg_tpu_torch.stencil import (make_coeffs, apply_M, ChiralityState,
                                   DefaultChirality)

torch.set_num_threads(1)

L = 32
TOL = 1e-5
W_OTHER = 1.3


def jax_problem(size, w):
    """qmg_tpu's hierarchy with bench.py's kcycle configuration on
    ``Wilson2D(wilson_coeff=w)`` (gauss gauge beta 6, seed 1337,
    m = -0.06, complex64) and the rhs drawn after the setup. Returns
    (mg, the port's config, outer restart, b)."""
    lat = Lattice2D(size, size, 2)
    rng = JQMGRandom(1337)
    gauge = jnp.asarray(ju1.gauss_gauge_u1(lat, rng, 6.0), jnp.complex64)
    op = JWilson2D(lat, MASS, gauge, wilson_coeff=w, dtype=jnp.complex64)
    cfg, restart = kcycle_config(size)
    jcfg = JKCycleConfig(n_refine=cfg.n_refine, coarse_dof=8,
                         nullvec_tol=5e-4, nullvec_max_iter=200,
                         inner_restart_freq=cfg.inner_restart_freq,
                         coarsest_restart_freq=restart,
                         coarsest_direct=True)
    mg = jbuild(lat, op, jcfg, rng)
    return mg, cfg, restart, rng.gaussian_cv(lat)


def jax_outer_count(mg, state, b, restart, pallas: bool):
    """Outer iterations of qmg_tpu's solve to TOL: with the any-w Pallas
    kernel in interpret mode as the fine apply, or with the jnp apply."""
    kw = (dict(use_pallas_fine=True, pallas_kind="wilson-phase",
               pallas_interpret=True, pallas_tile=8) if pallas else {})
    solve, _ = make_planes_solver(mg, tol=TOL, max_iter=200,
                                  restart_freq=restart, **kw)
    _, iters, _ = jax.jit(solve)(state, host_to_planes(b))
    return int(iters)


@pytest.fixture(scope="module", params=[1.0, W_OTHER], ids=["w1", "w1.3"])
def jax_state(request):
    w = request.param
    mg, cfg, restart, b = jax_problem(L, w)
    return w, mg, mg_state_planes(mg), cfg, restart, b


def test_state_load_recovers_wilson_coeff(jax_state):
    w, _, state, cfg, _, _ = jax_state
    fine = state_from_numpy(state, cfg, device="cpu").get_stencil(0)
    assert isinstance(fine, TWilson2D)
    assert abs(fine.wilson_coeff - w) <= 1e-6
    if w == 1.0:
        assert fine.wilson_coeff == 1.0


def test_wilson_phase_solve_matches_qmg_tpu(jax_state):
    w, mg, state, cfg, restart, b = jax_state
    it_j = jax_outer_count(mg, state, b, restart, pallas=True)
    tmg = state_from_numpy(state, cfg, device="cpu")
    bt = torch.as_tensor(b).to(torch.complex64)
    solve = make_solver(tmg, tol=TOL, max_iter=200, restart_freq=restart,
                        fine_kernel="wilson-phase")
    res, _ = solve(bt)
    assert solve.level_applies[0] == "wilson-phase"
    assert bool(res.converged)
    assert abs(res.iters - it_j) <= 1, (res.iters, it_j)
    assert true_residual(tmg.get_stencil(0), bt, res.x) < 10 * TOL
    assert tmg.get_stencil(0).apply_override is None


def test_wilson_phase_equals_plain_fine_apply_count(jax_state):
    """The kernel's twin and the plain apply compute one operator: the
    same outer count (+-1)."""
    _, _, state, cfg, restart, b = jax_state
    bt = torch.as_tensor(b).to(torch.complex64)
    iters = []
    for fine_kernel in ("wilson-phase", None):
        tmg = state_from_numpy(state, cfg, device="cpu")
        res, _ = make_solver(tmg, tol=TOL, max_iter=200,
                             restart_freq=restart,
                             fine_kernel=fine_kernel)(bt)
        iters.append(res.iters)
    assert abs(iters[0] - iters[1]) <= 1, iters


def test_wilson_r1_refuses_other_w(jax_state):
    w, _, state, cfg, _, _ = jax_state
    tmg = state_from_numpy(state, cfg, device="cpu")
    if w == 1.0:
        make_solver(tmg, fine_kernel="wilson-r1")
    else:
        with pytest.raises(ValueError, match="wilson_coeff=1"):
            make_solver(tmg, fine_kernel="wilson-r1")


def _gauge(lat, seed=5):
    rng = np.random.default_rng(seed)
    return np.exp(1j * rng.uniform(-np.pi, np.pi, (2, 2, lat.y_len, lat.xh)))


def _one_level_mg(op):
    from qmg_tpu_torch.stateful import StatefulMultigridMG, CoarsestSolveMG
    return StatefulMultigridMG(op.lat, op, CoarsestSolveMG())


def test_wilson_phase_refuses_bf16_and_non_wilson():
    lat = TLattice2D(8, 8, 2)
    op = TWilson2D(lat, MASS, _gauge(lat), 1.3, dtype=torch.complex64)
    with pytest.raises(ValueError, match="matrix kernels"):
        make_solver(_one_level_mg(op), fine_kernel="wilson-phase",
                    coeff_dtype=torch.bfloat16)
    from qmg_tpu_torch.stencil import Stencil2D
    with pytest.raises(ValueError, match="Wilson2D"):
        make_solver(_one_level_mg(Stencil2D(op.coeffs)),
                    fine_kernel="wilson-phase")


@pytest.mark.parametrize("w", [1.0, 0.9, 1.3])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_from_coeffs_recovers_w(w, dtype):
    lat = TLattice2D(8, 8, 2)
    op = TWilson2D(lat, MASS, _gauge(lat), w, dtype=dtype)
    again = TWilson2D.from_coeffs(op.coeffs)
    assert abs(again.wilson_coeff - w) <= 1e-6
    assert again.coeffs is op.coeffs


@pytest.mark.parametrize("what", ["hopping", "clover", "zero_clover"])
def test_from_coeffs_rejects_non_wilson(what):
    """An nc = 2 set whose hopping is not projector x phase, whose clover
    is not 2w I, or whose clover is zero."""
    lat = TLattice2D(8, 8, 2)
    c = TWilson2D(lat, MASS, _gauge(lat), 1.3, dtype=torch.complex64).coeffs
    clover, hopping = c.clover.clone(), c.hopping.clone()
    if what == "hopping":
        hopping[1, 0, 3, 2, 0, 1] += 0.01
    elif what == "clover":
        clover[1, 2, 1, 1, 1] += 0.01
    else:
        clover.zero_()
    bad = make_coeffs(lat, clover=clover, hopping=hopping, shift=c.shift,
                      dtype=torch.complex64)
    with pytest.raises(ValueError, match="not Wilson|not a Wilson"):
        TWilson2D.from_coeffs(bad)


def test_update_links_equals_fresh_operator():
    lat = TLattice2D(8, 8, 2)
    op = TWilson2D(lat, MASS, _gauge(lat, 5), 1.3, dtype=torch.complex64)
    x = torch.as_tensor(JQMGRandom(3).gaussian_cv(Lattice2D(8, 8, 2))).to(
        torch.complex64)
    op.apply_M(x)                       # builds the cached stacked form
    op.update_links(_gauge(lat, 6))
    fresh = TWilson2D(lat, MASS, _gauge(lat, 6), 1.3, dtype=torch.complex64)
    assert torch.equal(op.coeffs.hopping, fresh.coeffs.hopping)
    assert torch.equal(op.coeffs.clover, fresh.coeffs.clover)
    assert op.coeffs.shift == fresh.coeffs.shift
    assert torch.equal(op.apply_M(x), fresh.apply_M(x))
    assert op.wilson_coeff == 1.3


def test_update_links_matches_qmg_tpu():
    lat, jlat = TLattice2D(8, 8, 2), Lattice2D(8, 8, 2)
    g0, g1 = _gauge(lat, 5), _gauge(lat, 6)
    op = TWilson2D(lat, MASS, g0, 1.3, dtype=torch.complex128)
    jop = JWilson2D(jlat, MASS, jnp.asarray(g0), wilson_coeff=1.3)
    op.update_links(g1)
    jop.update_links(jnp.asarray(g1))
    assert np.allclose(op.coeffs.hopping.numpy(),
                       np.asarray(jop.coeffs.hopping), rtol=0, atol=1e-15)
    x = JQMGRandom(3).gaussian_cv(jlat)
    assert np.allclose(op.apply_M(torch.as_tensor(x)).numpy(),
                       np.asarray(jop.apply_M(jnp.asarray(x))), rtol=0,
                       atol=1e-13)


def test_chirality_interface_matches_qmg_tpu():
    lat, jlat = TLattice2D(8, 8, 2), Lattice2D(8, 8, 2)
    g = _gauge(lat)
    op = TWilson2D(lat, MASS, g, dtype=torch.complex128)
    jop = JWilson2D(jlat, MASS, jnp.asarray(g))
    x = JQMGRandom(3).gaussian_cv(jlat)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    assert np.array_equal(op.gamma5(xt).numpy(), np.asarray(jop.gamma5(xj)))
    assert np.array_equal(op.sigma1(xt).numpy(), np.asarray(jop.sigma1(xj)))
    assert op.get_dof() == jop.get_dof() == 2
    assert int(op.has_chirality()) == int(jop.has_chirality())
    assert op.has_chirality() == ChiralityState.YES
    assert int(op.get_default_chirality()) == int(
        jop.get_default_chirality())
    assert op.get_default_chirality() == DefaultChirality.GAMMA_5
    # gamma5-hermiticity of the operator: g5 M g5 = M^dagger
    y = JQMGRandom(4).gaussian_cv(jlat)
    yt = torch.as_tensor(y)
    lhs = torch.vdot(yt.reshape(-1),
                     op.gamma5(op.apply_M(op.gamma5(xt))).reshape(-1))
    rhs = torch.vdot(op.apply_M(yt).reshape(-1), xt.reshape(-1))
    assert abs(complex(lhs - rhs)) <= 1e-12 * abs(complex(rhs))


@pytest.mark.parametrize("argv, needle", [
    (["--fine-kernel", "wilson-phase"], "32x32 nc2 wilson-phase"),
    (["--fine-kernel", "wilson-phase", "--wilson-coeff", "1.3"], "w=1.3"),
    (["--fine-kernel", "none", "--wilson-coeff", "0.9"], "w=0.9")])
def test_kcycle_cli_new_kinds_on_cpu(capsys, argv, needle):
    from qmg_tpu_torch.kcycle import main
    main(["--size", "32", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert needle in out and "converged True" in out
    assert "wilson_phase 0, wilson_split 0" in out     # CPU: no launch


def test_kcycle_cli_wilson_r1_refuses_other_w():
    from qmg_tpu_torch.kcycle import main
    with pytest.raises(ValueError, match="wilson_coeff=1"):
        main(["--size", "16", "--device", "cpu", "--wilson-coeff", "1.3"])


def test_dslash_chains_agree_on_cpu():
    """The Wilson kinds run one chain: the same checksum as the plain
    apply's after a few steps (float32 rounding only), at w = 1 and, for
    wilson-phase, at w = 1.3."""
    from qmg_tpu_torch.dslash import run
    for w, kinds in ((1.0, ("wilson-r1", "wilson-phase", "wilson-split")),
                     (W_OTHER, ("wilson-phase",))):
        ref = run(16, "plain", iters=10, device="cpu",
                  wilson_coeff=w)["checksum"]
        for kind in kinds:
            r = run(16, kind, iters=10, device="cpu", wilson_coeff=w)
            assert r["wilson_coeff"] == w
            assert abs(r["checksum"] - ref) <= 1e-5 * abs(ref), (kind, w)


@pytest.mark.parametrize("kw, message", [
    (dict(kind="wilson-split", wilson_coeff=1.3), "needs w = 1"),
    (dict(kind="wilson-r1", wilson_coeff=1.3), "needs w = 1"),
    (dict(kind="wilson-phase", nc=8), "nc = 2"),
    (dict(kind="wilson-split", nc=4), "nc = 2"),
    (dict(kind="matrix", nc=8, wilson_coeff=1.3), "--wilson-coeff"),
    (dict(kind="wilson-phase", coeff_dtype=torch.bfloat16),
     "matrix kernels")])
def test_dslash_refusals(kw, message):
    from qmg_tpu_torch.dslash import run
    with pytest.raises(ValueError, match=message):
        run(16, iters=1, device="cpu", **kw)


def test_dslash_cli_new_kinds_on_cpu(capsys):
    import json
    from qmg_tpu_torch.dslash import main, step_bytes
    main(["--size", "16", "--kernel", "wilson-phase", "--wilson-coeff",
          "1.3", "--iters", "3", "--device", "cpu"])
    main(["--size", "16", "--kernel", "wilson-split", "--iters", "3",
          "--device", "cpu"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert [r["kernel"] for r in lines] == ["wilson-phase", "wilson-split"]
    assert lines[0]["wilson_coeff"] == 1.3
    # the Wilson kinds stream 4 phases: 64 B/site + 32 B/site renormalise
    for kind in ("wilson-r1", "wilson-phase", "wilson-split"):
        assert step_bytes(kind, 2, 100) == 96 * 100


def test_only_level_0_is_adopted_as_wilson(jax_state):
    """A coarse level stays a CoarseOperator2D in a loaded hierarchy, and
    the adopted level 0 applies its coefficients as they came."""
    _, _, state, cfg, _, b = jax_state
    tmg = state_from_numpy(state, cfg, device="cpu")
    assert isinstance(tmg.get_stencil(0), TWilson2D)
    assert isinstance(tmg.get_stencil(1), CoarseOperator2D)
    x = torch.as_tensor(b).to(torch.complex64)
    assert torch.equal(tmg.get_stencil(0).apply_M(x),
                       apply_M(tmg.get_stencil(0).coeffs, x))


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="qmg_tpu's outer iteration "
                                "count with bench.py's kcycle configuration")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--wilson-coeff", type=float, default=W_OTHER)
    p.add_argument("--pallas", action="store_true",
                   help="the any-w Pallas kernel in interpret mode as the "
                        "fine apply (default: the jnp apply)")
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    mg_, _, restart_, b_ = jax_problem(args.size, args.wilson_coeff)
    count = jax_outer_count(mg_, mg_state_planes(mg_), b_, restart_,
                            args.pallas)
    print(f"qmg_tpu {args.size}^2 w={args.wilson_coeff} m={MASS} "
          f"{'wilson-phase (interpret)' if args.pallas else 'jnp'} fine "
          f"apply: {count} outer iterations")
