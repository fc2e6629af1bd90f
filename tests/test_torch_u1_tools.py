"""Port vs qmg_tpu on the U(1) gauge toolkit: the counterparts of
test_n01_u1.py's nine tests on the port, and each tool held against
qmg_tpu's on the same inputs (topology, gauge transforms, APE smearing,
the Lorenz fix, both instantons, the config writers and readers)."""

import os

import numpy as np
import pytest
import torch

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu import u1 as ju1
from qmg_tpu import native as jnative
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D, eo_unpack
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch import u1

torch.set_num_threads(1)

L = 32
# qmg_tpu's heatbath takes its native sweep where the library is built.
SWEEP = "native" if jnative.have_heatbath() else "numpy"


def _plaq(g, lat):
    return complex(u1.get_plaquette_u1(torch.as_tensor(g), lat))


def _topo(g, lat):
    return float(u1.get_topo_u1(torch.as_tensor(g), lat))


def _gauss(seed=1337, beta=6.0, size=L):
    """The same gaussian gauge field from both packages' streams."""
    jg = ju1.gauss_gauge_u1(JLattice2D(size, size, 1), JQMGRandom(seed),
                            beta)
    tg = u1.gauss_gauge_u1(Lattice2D(size, size, 1), QMGRandom(seed), beta)
    assert np.array_equal(jg, tg)
    return tg


# --- test_n01_u1.py's nine tests on the port ---

def test_unit_gauge_observables():
    lat = Lattice2D(L, L, 1)
    g = u1.unit_gauge_u1(lat)
    assert abs(_plaq(g, lat) - 1.0) < 1e-14
    assert abs(_topo(g, lat)) < 1e-10


def test_gauge_transform_invariance():
    lat = Lattice2D(L, L, 1)
    rng = QMGRandom(1337)
    g = torch.as_tensor(u1.gauss_gauge_u1(lat, rng, beta=6.0))
    plaq0, topo0 = _plaq(g, lat), _topo(g, lat)
    g2 = u1.apply_gauge_trans_u1(g, u1.rand_trans_u1(lat, rng))
    assert abs(_plaq(g2, lat) - plaq0) < 1e-12
    assert abs(_topo(g2, lat) - topo0) < 1e-9


def test_ape_smear_raises_plaquette():
    lat = Lattice2D(L, L, 1)
    g = torch.as_tensor(u1.gauss_gauge_u1(lat, QMGRandom(1337), beta=3.0))
    plaq0, topo0 = _plaq(g, lat).real, _topo(g, lat)
    gs = u1.apply_ape_smear_u1(g, lat, alpha=0.5, n_iter=5)
    plaq1, topo1 = _plaq(gs, lat).real, _topo(gs, lat)
    assert plaq1 > plaq0
    assert abs(topo1 - round(topo1)) < 1e-6
    assert abs(topo0 - round(topo0)) < 1e-6


def test_write_read_roundtrip(tmp_path):
    lat = Lattice2D(16, 16, 1)
    g = u1.gauss_gauge_u1(lat, QMGRandom(7), beta=6.0)
    path = os.path.join(tmp_path, "cfg.dat")
    u1.write_gauge_u1(g, lat, path)
    np.testing.assert_allclose(u1.read_gauge_u1(lat, path), g, atol=1e-14)


def test_instanton_charge():
    lat = Lattice2D(L, L, 1)
    g = u1.unit_gauge_u1(lat)
    gi = u1.create_instanton_u1(g, lat, 1.0, L // 2, L // 2)
    assert abs(_topo(gi, lat) - 1.0) < 0.25


def test_noncompact_instanton_charge():
    lat = Lattice2D(L, L, 1)
    ph = u1.create_noncompact_instanton_u1(np.zeros((2, 2, L, L // 2)),
                                           lat, 2.0)
    assert abs(_topo(np.exp(1j * ph), lat) - 1.0) < 0.3


def test_shipped_config_plaquette(cfg_dir):
    lat = Lattice2D(32, 32, 1)
    g = u1.read_gauge_u1(lat, os.path.join(cfg_dir,
                                           "l32t32b60_heatbath.dat"))
    plaq = _plaq(g, lat)
    assert abs(plaq.imag) < 0.02
    assert 0.88 < plaq.real < 0.94
    topo = _topo(g, lat)
    assert abs(topo - round(topo)) < 1e-6


def test_heatbath_plaquette_thermalizes():
    beta = 6.0
    lat = Lattice2D(16, 16, 1)
    rng = QMGRandom(1337)
    ph = u1.heatbath_noncompact_update(np.zeros((2, 2, 16, 8)), lat, beta,
                                       60, rng, SWEEP)
    plaqs = []
    for _ in range(20):
        ph = u1.heatbath_noncompact_update(ph, lat, beta, 5, rng, SWEEP)
        plaqs.append(_plaq(u1.phases_to_links(torch.as_tensor(ph)),
                           lat).real)
    assert abs(np.mean(plaqs) - np.exp(-1.0 / (2.0 * beta))) < 0.02


def test_lorentz_gauge_fix():
    lat = Lattice2D(L, L, 1)
    g = u1.gauss_gauge_u1(lat, QMGRandom(1337), beta=6.0)
    plaq0, topo0 = _plaq(g, lat), _topo(g, lat)
    fixed, resid = u1.lorentz_gauge_fix_u1(g, lat, tol=1e-9)
    assert resid < 1e-9
    theta = np.stack([eo_unpack(np.angle(fixed[mu]), lat)
                      for mu in range(2)])
    div = ((theta[0] - np.roll(theta[0], 1, axis=1))
           + (theta[1] - np.roll(theta[1], 1, axis=0)))
    assert float(np.max(np.abs(div))) < 1e-9
    plaq1, topo1 = _plaq(fixed, lat), _topo(fixed, lat)
    np.testing.assert_allclose(plaq1.real, plaq0.real, atol=1e-10)
    np.testing.assert_allclose(plaq1.imag, plaq0.imag, atol=1e-10)
    np.testing.assert_allclose(topo1, topo0, atol=1e-8)


# --- each tool against qmg_tpu's on the same inputs ---

@pytest.mark.parametrize("beta", [3.0, 6.0])
def test_topology_matches_jax(beta):
    g = _gauss(beta=beta)
    want = float(ju1.get_topo_u1(g, JLattice2D(L, L, 1)))
    assert abs(_topo(g, Lattice2D(L, L, 1)) - want) <= 1e-12


def test_gauge_transform_matches_jax():
    """The same QMGRandom gives the same transform, and both packages
    apply it alike."""
    jrng, trng = JQMGRandom(5), QMGRandom(5)
    g = _gauss()
    jt = ju1.rand_trans_u1(JLattice2D(L, L, 1), jrng)
    tt = u1.rand_trans_u1(Lattice2D(L, L, 1), trng)
    assert np.array_equal(jt, tt)
    want = np.asarray(ju1.apply_gauge_trans_u1(g, jt))
    got = u1.apply_gauge_trans_u1(torch.as_tensor(g), tt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_ape_smear_matches_jax():
    g = _gauss(beta=3.0)
    want = np.asarray(ju1.apply_ape_smear_u1(g, JLattice2D(L, L, 1), 0.5, 5))
    got = u1.apply_ape_smear_u1(torch.as_tensor(g), Lattice2D(L, L, 1), 0.5,
                                5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_lorentz_fix_matches_jax():
    g = _gauss()
    tol = 1e-9
    want, jres = ju1.lorentz_gauge_fix_u1(g, JLattice2D(L, L, 1), tol=tol)
    got, tres = u1.lorentz_gauge_fix_u1(torch.as_tensor(g),
                                        Lattice2D(L, L, 1), tol=tol)
    assert isinstance(got, np.ndarray)
    assert tres < tol and jres < tol
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("q, x0, y0", [(1.0, L // 2, L // 2),
                                       (-2.0, 3, 20)])
def test_instanton_matches_jax(q, x0, y0):
    g = _gauss()
    want = ju1.create_instanton_u1(g, JLattice2D(L, L, 1), q, x0, y0)
    got = u1.create_instanton_u1(torch.as_tensor(g), Lattice2D(L, L, 1), q,
                                 x0, y0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("q", [2.0, -1.0])
def test_noncompact_instanton_matches_jax(q):
    ph = np.random.default_rng(4).normal(size=(2, 2, L, L // 2))
    want = ju1.create_noncompact_instanton_u1(ph, JLattice2D(L, L, 1), q)
    got = u1.create_noncompact_instanton_u1(ph, Lattice2D(L, L, 1), q)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    assert not np.array_equal(got, ph)


@pytest.mark.parametrize("kind", ["gauge", "phase"])
def test_writers_match_jax(kind, tmp_path):
    """Byte-identical files, and each package reads the other's."""
    size = 16
    jlat, tlat = JLattice2D(size, size, 1), Lattice2D(size, size, 1)
    g = _gauss(seed=7, size=size)
    field = g if kind == "gauge" else np.angle(g)
    jpath, tpath = tmp_path / "jax.dat", tmp_path / "torch.dat"
    getattr(ju1, f"write_{kind}_u1")(field, jlat, str(jpath))
    getattr(u1, f"write_{kind}_u1")(torch.as_tensor(field), tlat, str(tpath))
    assert jpath.read_bytes() == tpath.read_bytes()
    mine = u1.read_phase_u1(tlat, str(jpath))
    theirs = ju1.read_phase_u1(jlat, str(tpath))
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_allclose(mine, np.angle(g), rtol=0, atol=1e-14)
