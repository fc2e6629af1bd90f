"""Port vs qmg_tpu: cshift, Wilson coefficients and the stencil apply."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import cshift as jcshift, stencil as jstencil, u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch import cshift as tcshift, stencil as tstencil, u1 as tu1
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.rng import QMGRandom as TQMGRandom

torch.set_num_threads(1)

MASS = -0.06


def _cfield(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("nc", [1, 2, 8])
@pytest.mark.parametrize("direction", [0, 1, 2, 3])
def test_cshift_pull_matches_jax(direction, nc):
    field = _cfield(np.random.default_rng(7), (2, 12, 8, nc))
    expect = np.asarray(jcshift.cshift_pull(jnp.asarray(field), direction))
    got = tcshift.cshift_pull(torch.as_tensor(field), direction).numpy()
    np.testing.assert_array_equal(got, expect)


def test_cshift_pull_batch_axis():
    """A leading batch axis pulls each field independently."""
    field = torch.as_tensor(_cfield(np.random.default_rng(3),
                                    (3, 2, 8, 4, 2)))
    for d in range(4):
        got = tcshift.cshift_pull(field, d, batch_dims=1)
        for i in range(3):
            assert torch.equal(got[i], tcshift.cshift_pull(field[i], d))


def test_rng_and_gauge_match_jax():
    lat = Lattice2D(16, 16, 2)
    tlat = TLattice2D(16, 16, 2)
    jg = ju1.gauss_gauge_u1(lat, JQMGRandom(1337), 6.0)
    tg = tu1.gauss_gauge_u1(tlat, TQMGRandom(1337), 6.0)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(
        complex(tu1.get_plaquette_u1(torch.as_tensor(tg), tlat)),
        complex(ju1.get_plaquette_u1(jg, lat)), rtol=1e-14)


def _gauge(L):
    return ju1.gauss_gauge_u1(Lattice2D(L, L, 2), JQMGRandom(1337), 6.0)


def test_wilson_coefficients_match_jax():
    L = 16
    g = _gauge(L)
    jop = JWilson2D(Lattice2D(L, L, 2), MASS, jnp.asarray(g),
                    dtype=jnp.complex128)
    top = TWilson2D(TLattice2D(L, L, 2), MASS, g, dtype=torch.complex128)
    np.testing.assert_array_equal(top.coeffs.clover.numpy(),
                                  np.asarray(jop.coeffs.clover))
    np.testing.assert_array_equal(top.coeffs.hopping.numpy(),
                                  np.asarray(jop.coeffs.hopping))
    assert top.coeffs.shift == complex(jop.coeffs.shift)


def test_wilson_apply_M_matches_jax():
    L = 32
    g = _gauge(L)
    lat = Lattice2D(L, L, 2)
    jop = JWilson2D(lat, MASS, jnp.asarray(g), dtype=jnp.complex128)
    top = TWilson2D(TLattice2D(L, L, 2), MASS, g, dtype=torch.complex128)
    x = JQMGRandom(5).gaussian_cv(lat)
    expect = np.asarray(jstencil.apply_M(jop.coeffs, jnp.asarray(x)))
    got = tstencil.apply_M(top.coeffs, torch.as_tensor(x)).numpy()
    rel = np.max(np.abs(got - expect)) / np.max(np.abs(expect))
    assert rel <= 1e-13, rel


def test_generic_stencil_apply_with_shifts_matches_jax():
    """nc=8 random clover/hopping with mass, eo and dof shifts, and a
    batched apply against per-field applies."""
    rng = np.random.default_rng(11)
    lat = Lattice2D(8, 8, 8)
    clover = _cfield(rng, lat.cm_shape())
    hopping = _cfield(rng, lat.hopping_shape())
    shifts = dict(shift=0.3 + 0.1j, eo_shift=-0.2, dof_shift=0.05j)
    jc = jstencil.make_coeffs(lat, clover=jnp.asarray(clover),
                              hopping=jnp.asarray(hopping), **shifts)
    tc = tstencil.make_coeffs(TLattice2D(8, 8, 8),
                              clover=torch.as_tensor(clover),
                              hopping=torch.as_tensor(hopping), **shifts)
    xs = _cfield(rng, (3,) + lat.cv_shape())
    got = tstencil.apply_M(tc, torch.as_tensor(xs)).numpy()
    for i in range(3):
        expect = np.asarray(jstencil.apply_M(jc, jnp.asarray(xs[i])))
        rel = np.max(np.abs(got[i] - expect)) / np.max(np.abs(expect))
        assert rel <= 1e-13, rel
    np.testing.assert_allclose(
        tstencil.mass_pattern(tc).numpy(), np.asarray(
            jstencil.mass_pattern(jc)), rtol=0, atol=0)


@pytest.mark.parametrize("shape, nc", [((8, 8), 8), ((16, 4), 2),
                                       ((2, 2), 8), ((1, 1), 8)])
def test_gather_apply_matches_jax(shape, nc):
    """build_gather_apply against qmg_tpu's at complex128 (and against
    apply_M); None where qmg_tpu's is None (volume 1, no clover)."""
    rng = np.random.default_rng(nc + shape[0])
    lat, tlat = Lattice2D(*shape, nc), TLattice2D(*shape, nc)
    clover = _cfield(rng, lat.cm_shape())
    hopping = _cfield(rng, lat.hopping_shape())
    shifts = dict(shift=0.3 + 0.1j, eo_shift=-0.2, dof_shift=0.05j)
    jc = jstencil.make_coeffs(lat, clover=jnp.asarray(clover),
                              hopping=jnp.asarray(hopping), **shifts)
    tc = tstencil.make_coeffs(tlat, clover=torch.as_tensor(clover),
                              hopping=torch.as_tensor(hopping), **shifts)
    jfn, tfn = jstencil.build_gather_apply(jc), tstencil.build_gather_apply(tc)
    assert (jfn is None) == (tfn is None) == (lat.volume == 1)
    assert tstencil.build_gather_apply(
        tstencil.make_coeffs(tlat, hopping=torch.as_tensor(hopping))) is None
    if tfn is None:
        return
    x = _cfield(rng, lat.cv_shape())
    got = tfn(torch.as_tensor(x)).numpy()
    expect = np.asarray(jfn(jnp.asarray(x)))
    assert np.max(np.abs(got - expect)) / np.max(np.abs(expect)) <= 1e-13
    np.testing.assert_allclose(
        got, tstencil.apply_M(tc, torch.as_tensor(x)).numpy(), rtol=1e-13,
        atol=1e-13 * np.max(np.abs(expect)))


def test_lattice_eo_pack_matches_jax():
    from qmg_tpu.lattice import eo_pack as jpack, eo_unpack as junpack
    from qmg_tpu_torch.lattice import eo_pack, eo_unpack
    lat, tlat = Lattice2D(8, 6, 2), TLattice2D(8, 6, 2)
    grid = _cfield(np.random.default_rng(2), (6, 8, 2))
    np.testing.assert_array_equal(eo_pack(grid, tlat), jpack(grid, lat))
    np.testing.assert_array_equal(eo_unpack(eo_pack(grid, tlat), tlat), grid)
    np.testing.assert_array_equal(
        eo_unpack(eo_pack(grid, tlat), tlat), junpack(jpack(grid, lat), lat))


def test_std_mt19937_stream_matches_jax():
    from qmg_tpu.rng import StdMT19937 as JStd
    from qmg_tpu_torch.rng import StdMT19937 as TStd
    j, t = JStd(1337), TStd(1337)
    assert [t.raw() for _ in range(700)] == [j.raw() for _ in range(700)]
    assert [t.normal_scalar(0.5) for _ in range(9)] == \
        [j.normal_scalar(0.5) for _ in range(9)]
    assert t.uniform(-1.0, 2.0) == j.uniform(-1.0, 2.0)


def test_u1_generation_and_io_match_jax(tmp_path):
    lat, tlat = Lattice2D(8, 8, 2), TLattice2D(8, 8, 2)
    np.testing.assert_array_equal(
        tu1.rand_gauge_u1(tlat, TQMGRandom(4)),
        ju1.rand_gauge_u1(lat, JQMGRandom(4)))
    np.testing.assert_array_equal(
        tu1.gauss_gauge_u1(tlat, TQMGRandom(4), 0.0),
        ju1.gauss_gauge_u1(lat, JQMGRandom(4), 0.0))
    phases = JQMGRandom(6).gaussian_real((2, 2, 8, 4))
    np.testing.assert_allclose(tu1.phases_to_links(phases).numpy(),
                               np.asarray(ju1.phases_to_links(phases)),
                               rtol=1e-15, atol=1e-15)
    unit = tu1.unit_gauge_u1(tlat, dtype=torch.complex64)
    assert unit.dtype == torch.complex64 and bool((unit == 1).all())
    path = str(tmp_path / "cfg.dat")
    ju1.write_phase_u1(phases, lat, path)
    np.testing.assert_array_equal(tu1.read_gauge_u1(tlat, path),
                                  ju1.read_gauge_u1(lat, path))
