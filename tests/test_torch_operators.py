"""Port vs qmg_tpu: the Laplace, staggered and domain-wall operators and
``Stencil2D``'s chirality interface (``apply_sigma``), on the same numpy
gauge fields and sources at complex128. Coefficients and applies agree to
1e-12 (relative to the largest entry), solves to 1e-10, with the same
iteration counts. Mirrors test_n02_free_laplace, test_n03_n04_schur,
test_dwf, the staggered spectra of test_n10_n12_eigen and the
free-Laplace legs of test_n07_n08_coarse."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu import u1 as ju1, solvers as jsolvers, eig as jeig
from qmg_tpu.rng import QMGRandom as JQMGRandom
from qmg_tpu.operators import (FreeLaplace2D as JFree, GaugedLaplace2D as
                               JGauged, Staggered2D as JStag,
                               Wilson2D as JWilson)
from qmg_tpu.operators.dwf import create_dwf_ls as jdwf
from qmg_tpu.operators.coarse import CoarseOperator2D as JCoarse
from qmg_tpu.transfer import TransferMG as JTransferMG
from qmg_tpu.stencil import SigmaType as JSigmaType

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.operators import (FreeLaplace2D, GaugedLaplace2D,
                                     Staggered2D, Wilson2D, Dwf2D,
                                     create_dwf_ls, CoarseOperator2D)
from qmg_tpu_torch.operators.dwf import SUPPORTED_LS
from qmg_tpu_torch.stencil import SigmaType, StencilType
from qmg_tpu_torch.transfer import TransferMG
from qmg_tpu_torch import solvers, eig, u1

torch.set_num_threads(1)

COEFF_TOL = 1e-12
SOLVE_TOL = 1e-10
L = 16
MASS = 0.1


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _gauge(n, seed=1337):
    """A gauss gauge at beta 6 (numpy, from qmg_tpu's generator) and the
    rng after it."""
    rng = JQMGRandom(seed)
    return np.array(ju1.gauss_gauge_u1(JLattice2D(n, n, 1), rng, 6.0)), rng


def _pair(kind, n=L, seed=1337):
    """(qmg_tpu operator, port operator, gauge, rng) of one kind."""
    g, rng = _gauge(n, seed)
    if kind == "free":
        return (JFree(JLattice2D(n, n, 1), MASS ** 2),
                FreeLaplace2D(Lattice2D(n, n, 1), MASS ** 2), g, rng)
    if kind == "gauged":
        return (JGauged(JLattice2D(n, n, 1), MASS ** 2, jnp.asarray(g)),
                GaugedLaplace2D(Lattice2D(n, n, 1), MASS ** 2, g), g, rng)
    if kind == "staggered":
        return (JStag(JLattice2D(n, n, 1), MASS, jnp.asarray(g)),
                Staggered2D(Lattice2D(n, n, 1), MASS, g), g, rng)
    if kind == "wilson":
        return (JWilson(JLattice2D(n, n, 2), -0.06, jnp.asarray(g)),
                Wilson2D(Lattice2D(n, n, 2), -0.06, g), g, rng)
    ls = int(kind[3:])   # "dwf4"
    return (jdwf(JLattice2D(n, n, 2 * ls), MASS, jnp.asarray(g), ls=ls),
            create_dwf_ls(Lattice2D(n, n, 2 * ls), MASS, g, ls=ls), g, rng)


def _field(lat, rng):
    return np.asarray(rng.gaussian_cv(lat))


KINDS = ("free", "gauged", "staggered", "dwf2", "dwf4")


@pytest.mark.parametrize("kind", KINDS)
def test_coefficients_and_apply(kind):
    jop, top, _, rng = _pair(kind, n=8)
    for piece in ("clover", "hopping"):
        jc, tc = getattr(jop.coeffs, piece), getattr(top.coeffs, piece)
        assert (jc is None) == (tc is None)
        if jc is not None:
            assert _rel(tc.numpy(), jc) <= COEFF_TOL
    assert top.coeffs.shift == complex(jop.coeffs.shift)
    x = _field(top.lat, rng)
    for stype in (StencilType.ORIGINAL, StencilType.DAGGER,
                  StencilType.MDAGGER_M):
        got = top.apply_M(torch.as_tensor(x), stype).numpy()
        assert _rel(got, jop.apply_M(jnp.asarray(x), int(stype))) \
            <= COEFF_TOL, stype
    assert top.get_dof() == jop.get_dof()
    assert int(top.has_chirality()) == int(jop.has_chirality())
    assert int(top.get_default_chirality()) == \
        int(jop.get_default_chirality())


@pytest.mark.parametrize("kind", ("free", "staggered", "wilson", "dwf4"))
@pytest.mark.parametrize("stype", list(SigmaType))
def test_apply_sigma(kind, stype):
    jop, top, _, rng = _pair(kind, n=8)
    x = _field(top.lat, rng)
    got = top.apply_sigma(torch.as_tensor(x), stype).numpy()
    want = jop.apply_sigma(jnp.asarray(x), JSigmaType(int(stype)))
    assert _rel(got, want) <= COEFF_TOL


def test_chirality_defaults_and_projections():
    """Base-class defaults (UNKNOWN chirality, raising default chirality,
    identity gamma5, dof-half swap) on a coarse operator without
    chirality, and each operator's projections against qmg_tpu's."""
    lat, clat = Lattice2D(8, 8, 2), Lattice2D(4, 4, 4)
    g, rng = _gauge(8)
    nv = np.stack([_field(lat, rng) for _ in range(4)])
    tc = CoarseOperator2D(clat, Wilson2D(lat, -0.06, g),
                          TransferMG(lat, clat, torch.as_tensor(nv)))
    jc = JCoarse(JLattice2D(4, 4, 4), JWilson(JLattice2D(8, 8, 2), -0.06,
                                              jnp.asarray(g)),
                 JTransferMG(JLattice2D(8, 8, 2), JLattice2D(4, 4, 4),
                             jnp.asarray(nv)))
    x = _field(clat, rng)
    assert int(tc.has_chirality()) == int(jc.has_chirality()) == 2
    assert tc.get_dof() == jc.get_dof() == -1
    for fn in ("gamma5", "sigma1"):
        assert _rel(getattr(tc, fn)(torch.as_tensor(x)).numpy(),
                    getattr(jc, fn)(jnp.asarray(x))) == 0
    for kind in ("free", "staggered", "dwf2"):
        jop, top, _, rng = _pair(kind, n=8)
        x = _field(top.lat, rng)
        for got, want in zip(top.chiral_projection_both(torch.as_tensor(x)),
                             jop.chiral_projection_both(jnp.asarray(x))):
            assert _rel(got.numpy(), want) == 0, kind


# --- n02: free Laplace ---

def test_free_laplace_point_source_and_cg():
    """The stencil pattern of one and two applies on a point source, and
    CG to 1e-7 on 32x24 in both packages."""
    lat, jlat = Lattice2D(32, 24, 1), JLattice2D(32, 24, 1)
    top, jop = FreeLaplace2D(lat, MASS ** 2), JFree(jlat, MASS ** 2)
    src = np.zeros(lat.cv_shape(), dtype=np.complex128)
    p, yy, xh = jlat.coord_to_pyx(16, 13)
    src[p, yy, xh, 0] = 1.0
    once = top.apply_M(torch.as_tensor(src))
    twice = top.apply_M(once)
    assert _rel(once.numpy(), jop.apply_M(jnp.asarray(src))) <= COEFF_TOL
    s = 4.0 + MASS ** 2
    assert abs(complex(twice[p, yy, xh, 0]) - (s * s + 4.0)) < 1e-12
    assert abs(float(twice.abs().pow(2).sum())
               - float(np.sum(np.abs(np.asarray(jop.apply_M(
                   jop.apply_M(jnp.asarray(src))))) ** 2))) < 1e-12
    res = solvers.cg(top.get_apply_function(), torch.as_tensor(src),
                     max_iter=4000, tol=1e-7)
    jres = jsolvers.cg(jop.get_apply_function(), jnp.asarray(src),
                       max_iter=4000, tol=1e-7)
    assert bool(res.converged) and int(res.iters) == int(jres.iters)
    assert _rel(res.x.numpy(), jres.x) <= SOLVE_TOL
    dag = top.dagger_coeffs
    assert torch.equal(dag.hopping, top.coeffs.hopping)


# --- n03 / n04: even-odd Schur ---

@pytest.mark.parametrize("kind", ("gauged", "staggered"))
def test_schur_trio_and_solves(kind):
    """prepare_b / apply_eo_prec_M / reconstruct_x against qmg_tpu, the
    full solve (CG for Laplace, restarted GCR for staggered) and the
    eo-Schur CG solve, with the same counts and solutions."""
    jop, top, _, rng = _pair(kind)
    b = _field(top.lat, rng)
    tb, jb = torch.as_tensor(b), jnp.asarray(b)
    xe = _field(top.lat, rng)[0]
    assert _rel(top.prepare_b(tb).numpy(), jop.prepare_b(jb)) <= COEFF_TOL
    assert _rel(top.apply_eo_prec_M(torch.as_tensor(xe)).numpy(),
                jop.apply_eo_prec_M(jnp.asarray(xe))) <= COEFF_TOL
    assert _rel(top.reconstruct_x(torch.as_tensor(xe), tb).numpy(),
                jop.reconstruct_x(jnp.asarray(xe), jb)) <= COEFF_TOL
    if kind == "gauged":
        full = solvers.cg(top.get_apply_function(), tb, max_iter=4000,
                          tol=1e-10)
        jfull = jsolvers.cg(jop.get_apply_function(), jb, max_iter=4000,
                            tol=1e-10)
    else:
        full = solvers.gcr_restart(top.get_apply_function(), tb,
                                   max_iter=4000, tol=1e-10, restart_freq=64)
        jfull = jsolvers.gcr_restart(jop.get_apply_function(), jb,
                                     max_iter=4000, tol=1e-10,
                                     restart_freq=64)
    assert bool(full.converged) and int(full.iters) == int(jfull.iters)
    assert _rel(full.x.numpy(), jfull.x) <= SOLVE_TOL
    res_e = solvers.cg(top.apply_eo_prec_M, top.prepare_b(tb),
                       max_iter=4000, tol=1e-10)
    jres_e = jsolvers.cg(jop.apply_eo_prec_M, jop.prepare_b(jb),
                         max_iter=4000, tol=1e-10)
    assert bool(res_e.converged) and int(res_e.iters) == int(jres_e.iters)
    assert int(res_e.iters) < int(full.iters)
    x = top.reconstruct_x(res_e.x, tb)
    assert _rel(x.numpy(), jop.reconstruct_x(jres_e.x, jb)) <= SOLVE_TOL
    resid = torch.linalg.vector_norm(tb - top.apply_M(x)) \
        / torch.linalg.vector_norm(tb)
    assert float(resid) < 1e-8
    assert _rel(x.numpy(), full.x.numpy()) < 1e-7


def test_staggered_hermiticity_properties():
    """D(m=0)^dagger = -D(m=0); eps D eps = D^dagger."""
    g, rng = _gauge(L)
    lat = Lattice2D(L, L, 1)
    x = torch.as_tensor(_field(lat, rng))
    op0 = Staggered2D(lat, 0.0, g)
    assert _rel(op0.apply_M(x, StencilType.DAGGER).numpy(),
                -op0.apply_M(x).numpy()) < 1e-13
    op = Staggered2D(lat, MASS, g)
    assert _rel(op.gamma5(op.apply_M(op.gamma5(x))).numpy(),
                op.apply_M(x, StencilType.DAGGER).numpy()) < 1e-13


@pytest.mark.parametrize("kind", ("gauged", "staggered", "dwf4"))
def test_update_links(kind):
    """update_links from a new gauge equals a fresh operator on it, and
    drops the derived sets."""
    _, top, _, _ = _pair(kind, n=8, seed=1)
    g2, _ = _gauge(8, seed=2)
    _, fresh, _, _ = _pair(kind, n=8, seed=2)
    top.build_dagger_stencil()
    top.update_links(g2)
    assert not top.built_dagger
    for piece in ("clover", "hopping"):
        a, b = getattr(top.coeffs, piece), getattr(fresh.coeffs, piece)
        assert (a is None and b is None) or torch.equal(a, b)


# --- domain wall ---

def test_dwf_against_stacked_wilson_and_gamma5():
    """One s-slice of D x is the Wilson apply at mass M5 + w; the
    neighbouring slice gets -P_+; Gamma_5 is an involution with Gamma_5 D
    Gamma_5 = D^dagger, equal to qmg_tpu's."""
    ls = 4
    g, rng = _gauge(8)
    lat = Lattice2D(8, 8, 2 * ls)
    op = create_dwf_ls(lat, MASS, g, ls=ls, m5=-1.0)
    jop = jdwf(JLattice2D(8, 8, 2 * ls), MASS, jnp.asarray(g), ls=ls,
               m5=-1.0)
    w_op = Wilson2D(Lattice2D(8, 8, 2), 0.0, g)
    v_w = torch.as_tensor(_field(w_op.lat, rng))
    v = torch.zeros(lat.cv_shape(), dtype=torch.complex128)
    v[..., 2:4] = v_w
    out = op.apply_M(v)
    assert _rel(out[..., 2:4].numpy(), w_op.apply_M(v_w).numpy()) < 1e-12
    assert _rel(out[..., 4].numpy(), -v_w[..., 0].numpy()) < 1e-13
    assert float(out[..., 5].abs().max()) < 1e-13
    x = torch.as_tensor(_field(lat, rng))
    assert torch.equal(op.gamma5(op.gamma5(x)), x)
    assert _rel(op.gamma5(x).numpy(), jop.gamma5(jnp.asarray(x.numpy()))) \
        == 0
    assert _rel(op.gamma5(op.apply_M(op.gamma5(x))).numpy(),
                op.apply_M(x, StencilType.DAGGER).numpy()) < 1e-12
    assert op.get_dof_instance() == 2 * ls


def test_dwf_solve():
    """BiCGstab(6) to 1e-9 in both packages. The applies agree to ~4e-16,
    but over ~30 l-cycles on this non-normal operator the two
    trajectories part by rounding (174 and 180 iterations), so the solve
    is held by function: one l-cycle apart at most, the same solution to
    10x the solve's tolerance, a true residual under 1e-8."""
    jop, top, _, rng = _pair("dwf4", n=8)
    b = _field(top.lat, rng)
    tb = torch.as_tensor(b)
    res = solvers.bicgstab_l(top.get_apply_function(), tb, max_iter=2000,
                             tol=1e-9, l=6)
    jres = jsolvers.bicgstab_l(jop.get_apply_function(), jnp.asarray(b),
                               max_iter=2000, tol=1e-9, l=6)
    assert bool(res.converged) and bool(jres.converged)
    assert abs(int(res.iters) - int(jres.iters)) <= 6
    assert _rel(res.x.numpy(), jres.x) <= 1e-8
    resid = torch.linalg.vector_norm(tb - top.apply_M(res.x)) \
        / torch.linalg.vector_norm(tb)
    assert float(resid) < 1e-8


def test_dwf_refusals():
    g, _ = _gauge(8)
    assert SUPPORTED_LS == (2, 4, 6, 8, 12, 16, 24, 32)
    with pytest.raises(ValueError, match="unsupported Ls"):
        create_dwf_ls(Lattice2D(8, 8, 10), MASS, g, ls=5)
    with pytest.raises(ValueError, match="nc = 2 Ls"):
        Dwf2D(Lattice2D(8, 8, 4), MASS, g, ls=4)
    for cls in (FreeLaplace2D, GaugedLaplace2D, Staggered2D):
        args = (MASS,) if cls is FreeLaplace2D else (MASS, g)
        with pytest.raises(ValueError, match="nc = 1"):
            cls(Lattice2D(8, 8, 2), *args)


# --- n10: staggered spectra ---

@pytest.mark.parametrize("free", (False, True))
def test_staggered_spectrum(free):
    """Interacting: eigenvalues on the line Re = m, symmetric about it;
    free: m +- i sqrt(sin^2 kx + sin^2 ky), four copies each. The port's
    dense spectrum equals qmg_tpu's."""
    n, m = 8, (0.05 if free else MASS)
    lat = Lattice2D(n, n, 1)
    g = (np.asarray(ju1.unit_gauge_u1(JLattice2D(n, n, 1))) if free
         else _gauge(n)[0])
    op = Staggered2D(lat, m, g)
    evals, _ = eig.dense_eigensystem(op.get_apply_function(),
                                     lat.cv_shape(), device="cpu")
    jevals, _ = jeig.dense_eigensystem(
        JStag(JLattice2D(n, n, 1), m, jnp.asarray(g)).get_apply_function(),
        lat.cv_shape())
    np.testing.assert_allclose(np.sort_complex(evals),
                               np.sort_complex(jevals), atol=1e-10)
    np.testing.assert_allclose(evals.real, m, atol=1e-12)
    if not free:
        ims = np.sort(evals.imag)
        np.testing.assert_allclose(ims, -ims[::-1], atol=1e-10)
        return
    ks = 2 * np.pi * np.arange(n) / n
    expect = [np.sqrt(np.sin(kx) ** 2 + np.sin(ky) ** 2)
              for kx in ks[:n // 2] for ky in ks[:n // 2] for _ in range(4)]
    np.testing.assert_allclose(np.sort(np.abs(evals.imag)), np.sort(expect),
                               atol=1e-10)


# --- n07 / n08: the free-Laplace coarse legs ---

def _coarse_levels(lats, mass_sq, seed):
    """The Galerkin levels of a free Laplace over ``lats`` in both
    packages from the same gaussian null vectors; yields (level, port
    operator, qmg_tpu operator, port transfer, fine port operator)."""
    top = FreeLaplace2D(Lattice2D(*lats[0]), mass_sq)
    jop = JFree(JLattice2D(*lats[0]), mass_sq)
    rng = np.random.default_rng(seed)
    for i in range(1, len(lats)):
        flat, clat = Lattice2D(*lats[i - 1]), Lattice2D(*lats[i])
        nv = (rng.normal(size=(clat.nc,) + flat.cv_shape())
              + 1j * rng.normal(size=(clat.nc,) + flat.cv_shape()))
        t = TransferMG(flat, clat, torch.as_tensor(nv))
        jt = JTransferMG(JLattice2D(*lats[i - 1]), JLattice2D(*lats[i]),
                         jnp.asarray(nv))
        nxt = CoarseOperator2D(clat, top, t)
        jnxt = JCoarse(JLattice2D(*lats[i]), jop, jt)
        yield i, nxt, jnxt, t, top
        top, jop = nxt, jnxt


@pytest.mark.parametrize("lats", (
    ((16, 16, 1), (4, 4, 2), (1, 1, 2)),
    ((8, 8, 1), (2, 2, 2), (1, 1, 2))), ids=("two_levels", "dim2_point"))
def test_free_laplace_coarse_build(lats):
    """Each built coarse operator equals qmg_tpu's and the emulated
    restrict(A prolong(x)) (the n08 oracle)."""
    rng = np.random.default_rng(3)
    for _, top, jop, t, fine in _coarse_levels(lats, 0.01, seed=5):
        for piece in ("clover", "hopping"):
            assert _rel(getattr(top.coeffs, piece).numpy(),
                        getattr(jop.coeffs, piece)) <= COEFF_TOL
        xc = torch.as_tensor(rng.normal(size=top.lat.cv_shape())
                             + 0j)
        emulated = t.restrict_f2c(fine.apply_M(t.prolong_c2f(xc)))
        assert _rel(top.apply_M(xc).numpy(), emulated.numpy()) < 1e-12


def test_free_laplace_richardson_vcycle():
    """n07: a two-level Richardson V-cycle on the emulated coarse apply of
    the constant null vector: the same residual history as qmg_tpu's
    arithmetic over 10 cycles, falling at every cycle and by 20x in all."""
    lat0, lat1 = Lattice2D(16, 16, 1), Lattice2D(4, 4, 1)
    op = FreeLaplace2D(lat0, 0.01)
    jop = JFree(JLattice2D(16, 16, 1), 0.01)
    nv = np.ones((1,) + lat0.cv_shape(), dtype=np.complex128)
    t = TransferMG(lat0, lat1, torch.as_tensor(nv))
    jt = JTransferMG(JLattice2D(16, 16, 1), JLattice2D(4, 4, 1),
                     jnp.asarray(nv))
    b = np.asarray(JQMGRandom(2).gaussian_cv(JLattice2D(16, 16, 1)))
    omega, n_relax = 0.2, 4

    def vcycle(pkg):
        if pkg == "port":
            apply, tr, cg = op.apply_M, t, solvers.cg
            x, bb = torch.zeros_like(torch.as_tensor(b)), torch.as_tensor(b)
            nrm = lambda v: float(torch.linalg.vector_norm(v))  # noqa: E731
        else:
            apply, tr, cg = jop.apply_M, jt, jsolvers.cg
            x, bb = jnp.zeros_like(jnp.asarray(b)), jnp.asarray(b)
            nrm = lambda v: float(jnp.linalg.norm(v))  # noqa: E731
        def coarse(v):
            return tr.restrict_f2c(apply(tr.prolong_c2f(v)))

        hist = []
        for _ in range(10):
            r = bb - apply(x)
            hist.append(nrm(r) / nrm(bb))
            z1 = 0 * r
            for _ in range(n_relax):
                z1 = z1 + omega * r
                r = r - omega * apply(r)
            ec = cg(coarse, tr.restrict_f2c(r), max_iter=200, tol=1e-10).x
            x = x + z1 + tr.prolong_c2f(ec)
        return np.array(hist)

    hist, jhist = vcycle("port"), vcycle("jax")
    np.testing.assert_allclose(hist, jhist, rtol=1e-10)
    assert np.all(np.diff(hist) < 0) and hist[-1] < 0.05
