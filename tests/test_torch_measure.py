"""Port vs qmg_tpu on the measurement stream's pieces: the timeslice
reductions (1e-12 at complex128), the wall and point sources (bit for bit
from the same rng), the correlator folding and effective masses (1e-12),
the pion correlator of a propagator, and the jackknifed cosh fit (1e-8)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu import reductions as jred, measure as jmeas
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu import u1 as ju1
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch import reductions, measure
from qmg_tpu_torch.operators import Wilson2D
from qmg_tpu_torch.rng import QMGRandom

torch.set_num_threads(1)

L = 16


def _fields(nc=2, seed=1):
    rng = np.random.default_rng(seed)
    shape = (2, L, L // 2, nc)
    return [rng.normal(size=shape) + 1j * rng.normal(size=shape)
            for _ in range(2)]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)),
                                                   1e-300)


@pytest.mark.parametrize("nc", [1, 2, 8])
def test_timeslice_reductions(nc):
    a, b = _fields(nc)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    _close(reductions.norm2sq_timeslice(ta).numpy(),
           jred.norm2sq_timeslice(jnp.asarray(a)), 1e-12)
    _close(reductions.redot_timeslice(ta, tb).numpy(),
           jred.redot_timeslice(jnp.asarray(a), jnp.asarray(b)), 1e-12)
    _close(reductions.dot_timeslice(ta, tb).numpy(),
           jred.dot_timeslice(jnp.asarray(a), jnp.asarray(b)), 1e-12)


def test_timeslice_reductions_keep_a_batch_axis():
    a, b = _fields()
    batch = torch.stack([torch.as_tensor(a), torch.as_tensor(b)])
    got = reductions.norm2sq_timeslice(batch)
    assert got.shape == (2, L)
    for k in range(2):
        assert torch.equal(got[k], reductions.norm2sq_timeslice(batch[k]))


def test_wall_sources_bit_equal():
    jlat, tlat = JLattice2D(L, L, 2), Lattice2D(L, L, 2)
    for kw in ({}, {"deviation": 2.0, "mean": 0.5}):
        want = jred.gaussian_wall_source(jlat, 3, 1, JQMGRandom(42), **kw)
        got = reductions.gaussian_wall_source(tlat, 3, 1, QMGRandom(42),
                                              **kw)
        assert got.dtype == np.complex128 and np.array_equal(got, want)
        want_r = jred.gaussian_wall_source_real(jlat, 5, 0, JQMGRandom(9),
                                                **kw)
        got_r = reductions.gaussian_wall_source_real(tlat, 5, 0,
                                                     QMGRandom(9), **kw)
        assert got_r.dtype == np.float64 and np.array_equal(got_r, want_r)
    with pytest.raises(ValueError, match="timeslice"):
        reductions.gaussian_wall_source(tlat, L, 0, QMGRandom(1))
    with pytest.raises(ValueError, match="color"):
        reductions.gaussian_wall_source(tlat, 0, 2, QMGRandom(1))


def test_point_source():
    jlat, tlat = JLattice2D(L, L, 2), Lattice2D(L, L, 2)
    for x, y, c in ((0, 0, 0), (3, 5, 1), (L - 1, L - 1, 1)):
        want = np.asarray(jmeas.point_source(jlat, x, y, c))
        got = measure.point_source(tlat, x, y, c)
        assert got.dtype == torch.complex128
        assert np.array_equal(got.numpy(), want)
    assert measure.point_source(tlat, 1, 1, 0,
                                dtype=torch.complex64).dtype == \
        torch.complex64
    with pytest.raises(ValueError, match="outside"):
        measure.point_source(tlat, L, 0, 0)
    with pytest.raises(ValueError, match="outside"):
        measure.point_source(tlat, 0, 0, 2)


def _synthetic_corr(T=32, m=0.3, seed=2):
    t = np.arange(T)
    noise = 1 + 0.01 * np.random.default_rng(seed).standard_normal(T)
    return 2.0 * np.cosh(m * (t - T / 2)) * noise


def test_fold_and_effective_masses():
    c = _synthetic_corr()
    folded = measure.fold_correlator(c)
    _close(folded, jmeas.fold_correlator(c), 1e-12)
    np.testing.assert_array_equal(folded[1:], folded[1:][::-1])
    for name in ("effective_mass", "effective_mass_acosh",
                 "effective_mass_cosh"):
        got = getattr(measure, name)(folded)
        want = getattr(jmeas, name)(folded)
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        assert ok.any()
        _close(got[ok], want[ok], 1e-12)
    # acosh: NaN at both ends and where the ratio falls below 1
    m = measure.effective_mass_acosh(np.array([1.0, 2.0, 1.0, 0.5]))
    assert np.isnan(m[0]) and np.isnan(m[-1]) and np.isnan(m[1])


def test_fit_cosh_mass_matches_jax():
    """qmg_tpu's synthetic case (test_n14_n15_n20_measure.py:114)."""
    rng = np.random.default_rng(12345)
    T, m_true, A = 32, 0.108, 2.5
    t = np.arange(T)
    c = A * np.cosh(m_true * (t - T / 2))
    corrs = c[None, :] * (1 + 0.03 * rng.standard_normal((80, T)))
    want = jmeas.fit_cosh_mass(corrs, T // 4, T // 2 - 1)
    got = measure.fit_cosh_mass(corrs, T // 4, T // 2 - 1)
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-8 * abs(w)
    m, err, amp = got
    assert abs(m - m_true) < 3 * err + 2e-3 and 0 < err < 0.01


def test_pion_correlator_matches_jax():
    """The folded per-timeslice |prop|^2 summed over the two point sources,
    with the Wilson apply standing in for the inverter in both packages."""
    jlat, tlat = JLattice2D(L, L, 2), Lattice2D(L, L, 2)
    g = ju1.gauss_gauge_u1(jlat, JQMGRandom(5), 6.0)
    jop = JWilson2D(jlat, -0.06, jnp.asarray(g), dtype=jnp.complex128)
    top = Wilson2D(tlat, -0.06, g, dtype=torch.complex128)
    want = jmeas.pion_correlator(
        jop.apply_M, jlat, [jmeas.point_source(jlat, 0, 0, c)
                            for c in range(2)])
    got = measure.pion_correlator(
        top.apply_M, tlat, [measure.point_source(tlat, 0, 0, c)
                            for c in range(2)])
    _close(got, want, 1e-12)
