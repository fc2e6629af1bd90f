"""The port's goldstone stream (``qmg_tpu_torch.goldstone``) against
examples/wilson_goldstone.py, the n20 staggered wall-source correlator
against qmg_tpu's, and K4 at nc = 1 (the stencil kernel that applies the
staggered operator on the card) through its twin against qmg_tpu's
``_dslash_kernel`` in interpret mode. Correlators at complex128 agree to
1e-10 (relative to their largest entry).

Run as a script, ``python tests/test_torch_goldstone.py --size N`` prints
qmg_tpu's and the port's iteration counts of the staggered solve that
``chip_smoke.py`` runs on the card at N^2 (complex64 on the CPU; the
constant ``JAX_ITERS_2048_STAGGERED`` there).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The 2048^2 staggered solve of chip_smoke.py phase 20(b).
SOLVE_MASS = 0.1
SOLVE_TOL = 1e-6
SOLVE_SEED = 1337


def _jax():
    """qmg_tpu's modules, imported here so that the script mode can set up
    the JAX CPU backend first."""
    import jax.numpy as jnp
    from qmg_tpu.lattice import Lattice2D
    from qmg_tpu import u1, solvers, measure, native
    from qmg_tpu.rng import QMGRandom
    from qmg_tpu.operators import Staggered2D
    return jnp, Lattice2D, u1, solvers, measure, native, QMGRandom, \
        Staggered2D


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _sweep():
    """The heatbath path qmg_tpu takes: its native sweep where it is
    built."""
    return "native" if _jax()[5].have_heatbath() else "numpy"


# The example's arguments at 16^2: mass, n_configs, n_therm, n_update.
EXAMPLE_ARGS = (0.1, 3, 20, 5)


def test_goldstone_matches_example(tmp_path):
    """Staggered: the same configurations (same stream, same heatbath) and
    the same per-configuration correlators as examples/wilson_goldstone.py
    on its CPU backend (complex128, tol 1e-10)."""
    from qmg_tpu_torch import goldstone
    torch.set_num_threads(1)
    mass, n_configs, n_therm, n_update = EXAMPLE_ARGS
    path = str(tmp_path / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "wilson_goldstone.py"),
         "--op", "staggered", "--L", "16", "--mass", str(mass),
         "--n-configs", str(n_configs), "--n-therm", str(n_therm),
         "--n-update", str(n_update), "--save", path],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(path)
    log = []
    pions, plaqs, iters = goldstone.run_goldstone(
        op="staggered", L=16, mass=mass, n_configs=n_configs,
        n_therm=n_therm, n_update=n_update, device="cpu", sweep=_sweep(),
        verbose=False, log=log)
    assert pions.shape == want["pions"].shape == (n_configs, 16)
    assert _rel(pions, want["pions"]) <= 1e-10
    np.testing.assert_allclose(plaqs, want["plaqs"], rtol=1e-12)
    for e in log:
        assert e["converged"] == [True] and e["launches"] == 0
        assert e["true_res"][0] <= 1e-9


def test_wilson_point_source_solves_fail_in_both_packages():
    """Wilson at w = 1 from a point source: BiCGstab(6) with the source as
    its shadow residual meets tol on its recursive residual, but the true
    residual stays O(1), in qmg_tpu (its bicgstab_l and apply_M, as
    examples/wilson_goldstone.py solves) as in the port. The port checks
    the true residual and skips such configurations; the example keeps
    them."""
    jnp, JLattice2D, ju1, jsolvers, _, _, JQMGRandom, _ = _jax()
    from qmg_tpu.operators import Wilson2D as JWilson
    from qmg_tpu_torch import goldstone
    torch.set_num_threads(1)
    log = []
    pions, _, _ = goldstone.run_goldstone(
        op="wilson", L=16, mass=0.1, n_configs=2, n_therm=20, n_update=5,
        device="cpu", sweep=_sweep(), verbose=False, log=log)
    assert pions.shape == (0, 16)
    for e in log:
        assert e["converged"] == [False, False]
        assert min(e["true_res"]) > 1e-2
    jlat = JLattice2D(16, 16, 2)
    ph = ju1.heatbath_noncompact_update(np.zeros((2, 2, 16, 8)),
                                        jlat.with_nc(1), 6.0, 25,
                                        JQMGRandom(1337))
    jop = JWilson(jlat, 0.1, jnp.asarray(np.exp(1j * np.asarray(ph))))
    src = np.zeros(jlat.cv_shape(), dtype=np.complex128)
    src[0, 0, 0, 0] = 1.0
    res = jsolvers.bicgstab_l(jop.get_apply_function(), jnp.asarray(src),
                              max_iter=4000, tol=1e-10, l=6)
    true_res = float(jnp.linalg.norm(jop.apply_M(res.x) - src))
    assert bool(res.converged) and true_res > 1e-2


def test_staggered_pion_wall_source():
    """n20 with a gaussian wall source on a heatbath configuration:
    qmg_tpu's correlator, positive, falling, with a finite cosh mass."""
    jnp, JLattice2D, ju1, jsolvers, jmeasure, _, JQMGRandom, JStag = _jax()
    from qmg_tpu.reductions import gaussian_wall_source as jwall
    from qmg_tpu_torch.lattice import Lattice2D
    from qmg_tpu_torch.operators import Staggered2D
    from qmg_tpu_torch.rng import QMGRandom
    from qmg_tpu_torch.reductions import gaussian_wall_source
    from qmg_tpu_torch import u1, solvers, measure
    torch.set_num_threads(1)
    L = 16
    jlat = JLattice2D(L, L, 1)
    jrng = JQMGRandom(1337)
    jph = ju1.heatbath_noncompact_update(np.zeros((2, 2, L, L // 2)), jlat,
                                         6.0, 100, jrng)
    jop = JStag(jlat, 0.1, ju1.phases_to_links(jph))
    jsrc = jwall(jlat, timeslice=0, color=0, rng=jrng)

    def jsolve(src):
        return jsolvers.bicgstab_l(jop.get_apply_function(),
                                   jnp.asarray(src), max_iter=4000,
                                   tol=1e-9, l=6).x
    want = jmeasure.pion_correlator(jsolve, jlat, [jsrc])

    lat = Lattice2D(L, L, 1)
    rng = QMGRandom(1337)
    ph = u1.heatbath_noncompact_update(np.zeros((2, 2, L, L // 2)), lat,
                                       6.0, 100, rng, _sweep())
    np.testing.assert_array_equal(ph, np.asarray(jph))
    op = Staggered2D(lat, 0.1, u1.phases_to_links(torch.as_tensor(ph)))
    src = torch.as_tensor(gaussian_wall_source(lat, 0, 0, rng))

    def solve(s):
        res = solvers.bicgstab_l(op.get_apply_function(), s, max_iter=4000,
                                 tol=1e-9, l=6)
        assert bool(res.converged)
        return res.x
    corr = measure.pion_correlator(solve, lat, [src])
    assert _rel(corr, want) <= 1e-10
    assert np.all(corr > 0) and corr[1] > corr[L // 2]
    meff = measure.effective_mass_cosh(corr)[2:L // 2]
    finite = meff[np.isfinite(meff)]
    assert len(finite) > 0 and np.all(finite > 0) and np.all(finite < 3.0)


@pytest.mark.parametrize("kind", ("staggered", "laplace"))
def test_k4_nc1_twin_matches_pallas(kind):
    """K4's twin on a staggered / gauged-Laplace operator's channels (the
    mass pattern in the clover channel, the eta phases in the hopping
    ones) against qmg_tpu's ``_dslash_kernel`` in interpret mode on its
    own channels of the same operator, complex64, 16x16."""
    jnp, JLattice2D, ju1, _, _, _, JQMGRandom, JStag = _jax()
    from qmg_tpu.operators import GaugedLaplace2D as JLap
    from qmg_tpu.pallas_dslash import (make_pallas_dslash_shaped,
                                       _channels_from_coeffs, x_to_planes,
                                       x_from_planes)
    from qmg_tpu_torch.lattice import Lattice2D
    from qmg_tpu_torch.operators import Staggered2D, GaugedLaplace2D
    from qmg_tpu_torch import dslash_kernel as dk
    torch.set_num_threads(1)
    jlat, lat = JLattice2D(16, 16, 1), Lattice2D(16, 16, 1)
    rng = JQMGRandom(1337)
    g = np.array(ju1.gauss_gauge_u1(jlat, rng, 6.0))
    jcls, tcls, m = ((JStag, Staggered2D, 0.1) if kind == "staggered"
                     else (JLap, GaugedLaplace2D, 0.01))
    jc = jcls(jlat, m, jnp.asarray(g, jnp.complex64),
              dtype=jnp.complex64).coeffs
    tc = tcls(lat, m, g, dtype=torch.complex64).coeffs
    x = np.asarray(rng.gaussian_cv(jlat)).astype(np.complex64)
    ck, hk = _channels_from_coeffs(jc)
    fn = make_pallas_dslash_shaped(1, 16, 8, tile=8, interpret=True)
    want = np.asarray(x_from_planes(fn(ck, hk, x_to_planes(jnp.asarray(x)))))
    got = dk.dslash_apply(dk.stencil_channels(tc), torch.as_tensor(x))
    assert float(np.max(np.abs(got.numpy() - want))) <= \
        5e-5 * float(np.max(np.abs(want)))


def test_goldstone_kernel_twin_and_plain_agree():
    """The K4 option on the CPU (its complex64 twin, no launch) and the
    plain complex64 apply give the same correlators to 1e-4, the check
    that chip_smoke.py makes on the card between the kernel and the plain
    apply."""
    from qmg_tpu_torch import goldstone
    torch.set_num_threads(1)
    kw = dict(op="staggered", L=8, mass=0.1, n_configs=2, n_therm=10,
              n_update=5, device="cpu", dtype=torch.complex64,
              sweep=_sweep(), verbose=False)
    logs = {}
    for kernel in ("matrix", "none"):
        logs[kernel] = []
        goldstone.run_goldstone(fine_kernel=kernel, log=logs[kernel], **kw)
    for a, b in zip(logs["matrix"], logs["none"]):
        assert all(a["converged"]) and all(b["converged"])
        assert _rel(a["pion"], b["pion"]) <= 1e-4
        assert a["launches"] == 0


def test_wilson_kernels_break_bicgstab_on_point_sources():
    """The Wilson kernels apply the hopping projectors exactly, so the
    first BiCG product that rounding alone keeps from 0 is an exact 0 and
    BiCGstab (shadow residual = the source) breaks down in its first
    l-cycle, where K4 and the plain apply still meet tol on the recursive
    residual. Hence the K4 default for both ops."""
    from qmg_tpu_torch import goldstone, solvers
    from qmg_tpu_torch.lattice import Lattice2D
    from qmg_tpu_torch.rng import QMGRandom
    from qmg_tpu_torch import u1
    torch.set_num_threads(1)
    lat = Lattice2D(16, 16, 2)
    g = u1.gauss_gauge_u1(lat, QMGRandom(1), 6.0)
    op = goldstone.make_operator("wilson", lat, 0.1, g,
                                 dtype=torch.complex64, device="cpu")
    src = goldstone.point_sources(lat, dtype=torch.complex64,
                                  device="cpu")[0]
    for kernel, ok in (("wilson-r1", False), ("wilson-phase", False),
                       ("matrix", True), (None, True)):
        res = solvers.bicgstab_l(goldstone.bind_matvec(op, kernel), src,
                                 max_iter=600, tol=1e-6, l=6)
        assert bool(res.converged) == ok, kernel
        if not ok:
            assert int(res.iters) == 6 and not torch.isfinite(res.res_sq)
    assert goldstone.resolve_kernel("auto", "cuda") == "matrix"
    assert goldstone.resolve_kernel("auto", "cpu") is None


def test_goldstone_cli_on_cpu(tmp_path, capsys):
    from qmg_tpu_torch import goldstone
    torch.set_num_threads(1)
    path = str(tmp_path / "pions.npz")
    goldstone.main(["--op", "staggered", "--device", "cpu", "--L", "16",
                    "--mass", "0.1", "--n-configs", "3", "--n-therm", "10",
                    "--n-update", "5", "--save", path])
    out = capsys.readouterr().out
    for tag in ("[QMG-GAUGE-FINAL]", "[QMG-BEGIN-PION]",
                "[QMG-PION-MASS]", "[QMG-PION-MASS-FIT]"):
        assert tag in out
    assert np.load(path)["pions"].shape == (3, 16)


def test_goldstone_refusals():
    from qmg_tpu_torch import goldstone
    from qmg_tpu_torch.lattice import Lattice2D
    with pytest.raises(ValueError, match="fine_kernel"):
        goldstone.resolve_kernel("bogus", "cpu")
    with pytest.raises(ValueError, match="op must be"):
        goldstone.make_operator("dwf", Lattice2D(8, 8, 1), 0.1,
                                np.ones((2, 2, 8, 4)), dtype=torch.complex64,
                                device="cpu")
    op = goldstone.make_operator("staggered", Lattice2D(8, 8, 1), 0.1,
                                 np.ones((2, 2, 8, 4)),
                                 dtype=torch.complex64, device="cpu")
    with pytest.raises(ValueError, match="Wilson2D"):
        goldstone.bind_matvec(op, "wilson-r1")
    with pytest.raises(SystemExit):
        goldstone.main(["--op", "staggered", "--device", "cpu", "--L", "8",
                        "--n-configs", "1", "--n-therm", "0", "--n-update",
                        "1", "--mass", "0.1"])


def _script(size):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jnp, JLattice2D, ju1, jsolvers, _, _, JQMGRandom, JStag = _jax()
    from qmg_tpu_torch import solvers
    from qmg_tpu_torch.goldstone import staggered_problem
    jlat = JLattice2D(size, size, 1)
    rng = JQMGRandom(SOLVE_SEED)
    g = ju1.gauss_gauge_u1(jlat, rng, 6.0)
    b = jnp.asarray(rng.gaussian_cv(jlat), jnp.complex64)
    jop = JStag(jlat, SOLVE_MASS, jnp.asarray(g, jnp.complex64),
                dtype=jnp.complex64)
    jres = jsolvers.bicgstab_l(jop.get_apply_function(), b, max_iter=4000,
                               tol=SOLVE_TOL, l=6)
    op, tb = staggered_problem(size, SOLVE_MASS, SOLVE_SEED,
                               dtype=torch.complex64, device="cpu")
    res = solvers.bicgstab_l(op.get_apply_function(), tb, max_iter=4000,
                             tol=SOLVE_TOL, l=6)
    print(f"staggered m={SOLVE_MASS} {size}^2 complex64 tol {SOLVE_TOL} "
          f"BiCGstab(6): qmg_tpu {int(jres.iters)} iterations (converged "
          f"{bool(jres.converged)}), the port {int(res.iters)} (converged "
          f"{bool(res.converged)})")


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=2048)
    _script(p.parse_args().size)
