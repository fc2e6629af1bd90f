"""Port vs qmg_tpu on the eigensolvers (qmg_tpu's
tests/test_n10_n12_eigen.py, Wilson cases; complex128): the dense
spectrum within 1e-10, both Krylov-Schur Arnoldi paths (forced below the
dense cutoff, as qmg_tpu's tests force them) within 1e-8 of the dense
spectrum, shift-invert, and the gamma5 symmetry of the Wilson spectrum."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import eig as jeig, u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch import eig as teig, solvers as tsolvers
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D

torch.set_num_threads(1)

MASS = -0.05
CPU = dict(dtype=torch.complex128, device="cpu")


def _ops(L):
    lat = Lattice2D(L, L, 2)
    g = ju1.gauss_gauge_u1(lat, JQMGRandom(1337), 6.0)
    jop = JWilson2D(lat, MASS, jnp.asarray(g))
    top = TWilson2D(TLattice2D(L, L, 2), MASS, g, dtype=torch.complex128)
    return lat, jop, top


@pytest.fixture(scope="module")
def wilson8():
    lat, jop, top = _ops(8)
    dense, vecs = teig.dense_eigensystem(top.get_apply_function(),
                                         lat.cv_shape(), **CPU)
    return lat, jop, top, dense, vecs


def _eigpair_resid(mv, val, vec):
    v = torch.as_tensor(np.asarray(vec))
    r = mv(v) - complex(val) * v
    return float(torch.linalg.vector_norm(r))


def test_dense_spectrum_matches_qmg_tpu(wilson8):
    """The same sorted spectrum as qmg_tpu's within 1e-10 and eigenpairs
    of the port's own operator (residual < 1e-8)."""
    lat, jop, top, dense, vecs = wilson8
    jvals, _ = jeig.dense_eigensystem(jop.get_apply_function(),
                                      lat.cv_shape())
    assert dense.shape == (lat.volume * 2,)
    assert vecs.shape == (lat.volume * 2,) + lat.cv_shape()
    assert np.max(np.abs(dense - jvals)) <= 1e-10 * np.max(np.abs(jvals))
    mv = top.get_apply_function()
    for i in (0, len(dense) // 2, len(dense) - 1):
        assert _eigpair_resid(mv, dense[i], vecs[i]) < 1e-8


def test_wilson_spectrum_gamma5_symmetry(wilson8):
    """gamma5-hermiticity: the eigenvalues come in conjugate pairs."""
    _, _, _, dense, _ = wilson8

    def stable_sort(v):
        return v[np.lexsort((v.imag, np.round(v.real, 6)))]

    np.testing.assert_allclose(stable_sort(np.conj(dense)),
                               stable_sort(dense), atol=1e-6)


@pytest.mark.parametrize("which,nev,ncv,tol", [
    (teig.LARGEST_MAGNITUDE, 8, 32, 1e-8),
    (teig.SMALLEST_MAGNITUDE, 6, None, 1e-9)], ids=["LM", "SM"])
def test_arnoldi_iterative_path(wilson8, monkeypatch, which, nev, ncv, tol):
    """The Krylov-Schur Arnoldi below the dense cutoff (qmg_tpu's two
    monkeypatched cases): eigenvalues within 1e-8 of the dense spectrum,
    Ritz pairs with residuals < 1e-6, vectors on the field's device, and
    the same eigenvalues as qmg_tpu's Arnoldi on the same operator."""
    lat, jop, top, dense, _ = wilson8
    monkeypatch.setattr(teig, "_DENSE_CUTOFF", 8)
    monkeypatch.setattr(jeig, "_DENSE_CUTOFF", 8)
    mv = top.get_apply_function()
    vals, vecs = teig.arnoldi_eigensystem(mv, lat.cv_shape(), nev=nev,
                                          which=which, ncv=ncv, tol=tol,
                                          **CPU)
    assert isinstance(vecs, torch.Tensor) and vecs.device.type == "cpu"
    want = dense[teig._select(dense, which, nev)]
    np.testing.assert_allclose(np.sort(np.abs(vals)), np.sort(np.abs(want)),
                               rtol=1e-8)
    for i in range(nev):
        assert _eigpair_resid(mv, vals[i], vecs[i]) < 1e-6
    jvals, _ = jeig.arnoldi_eigensystem(jop.get_apply_function(),
                                        lat.cv_shape(), nev=nev, which=which,
                                        ncv=ncv, tol=tol)
    np.testing.assert_allclose(np.sort(np.abs(vals)),
                               np.sort(np.abs(jvals)), rtol=1e-8)


def test_dense_cutoff_takes_dense_path(wilson8):
    """At or below the cutoff the selection comes from the dense spectrum
    (a NumPy array of vectors), as in qmg_tpu."""
    lat, _, top, dense, _ = wilson8
    vals, vecs = teig.arnoldi_eigensystem(top.get_apply_function(),
                                          lat.cv_shape(), nev=5,
                                          which=teig.SMALLEST_REAL, **CPU)
    assert isinstance(vecs, np.ndarray)
    np.testing.assert_array_equal(vals, dense[np.argsort(dense.real)[:5]])
    with pytest.raises(ValueError, match="selector"):
        teig._select(dense, "XX", 3)


def test_shift_invert_smallest_magnitude():
    """Shift-invert Arnoldi around BiCGstab(6) at 16^2: the six
    eigenvalues nearest 0 within 1e-8 of qmg_tpu's dense spectrum (the
    Rayleigh quotients), residuals < 1e-6, in order of distance from the
    shift."""
    lat, jop, top = _ops(16)
    mv = top.get_apply_function()

    def solve(v):
        return tsolvers.bicgstab_l(mv, v, max_iter=2000, tol=1e-10).x

    vals, vecs = teig.shift_invert_eigensystem(solve, lat.cv_shape(), nev=6,
                                               sigma=0.0, tol=1e-8,
                                               matvec=mv, **CPU)
    jdense, _ = jeig.dense_eigensystem(jop.get_apply_function(),
                                       lat.cv_shape())
    want = jdense[np.argsort(np.abs(jdense))[:6]]
    np.testing.assert_allclose(np.sort(np.abs(vals)), np.sort(np.abs(want)),
                               rtol=1e-8)
    assert np.all(np.diff(np.abs(vals)) >= 0)
    for i in range(6):
        assert _eigpair_resid(mv, vals[i], vecs[i]) < 1e-6
