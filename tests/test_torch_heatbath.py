"""Port vs qmg_tpu on the non-compact heatbath: both sweeps bit for bit
from the same QMGRandom stream, the non-compact action, the plaquette at
beta = 6, and the sweep's refusals."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu import u1 as ju1
from qmg_tpu import native as jnative
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch import u1

torch.set_num_threads(1)

L = 16
BETA = 6.0
JAX_NATIVE_SRC = os.path.join(os.path.dirname(__file__), "..", "qmg_tpu",
                              "native", "heatbath.cpp")


def _start(seed=5):
    """A random (mu, Y, X) phase field and two equal rngs."""
    ph = np.random.default_rng(seed).normal(size=(2, L, L))
    return ph, JQMGRandom(1337), QMGRandom(1337)


def test_numpy_sweep_bit_equal():
    ph, jrng, trng = _start()
    want = ju1._heatbath_sweeps_numpy(ph.copy(), BETA, 3, jrng)
    got = u1._heatbath_sweeps_numpy(ph.copy(), BETA, 3, trng)
    assert np.array_equal(got, want)
    # the streams were consumed alike
    assert jrng.normal_scalar() == trng.normal_scalar()


def _jax_sweeps_from_source(tmp_path):
    """qmg_tpu's C++ sweep compiled from its source into ``tmp_path`` as
    its Makefile builds it (without -march=native), loaded with ctypes;
    called as qmg_tpu.native.heatbath_sweeps calls it."""
    lib_path = tmp_path / "libjaxheatbath.so"
    subprocess.run(["c++", "-O3", "-ffp-contract=off", "-std=c++17",
                    "-fPIC", "-shared", "-o", str(lib_path), JAX_NATIVE_SRC],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.qmg_heatbath_sweeps
    fn.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                   ctypes.c_int, ctypes.c_double, ctypes.c_int,
                   ctypes.c_uint64]
    fn.restype = None

    def sweeps(ph, beta, n_update, rng):
        ph = np.ascontiguousarray(ph, dtype=np.float64)
        seed = int(rng.gen.integers(0, 2**63 - 1))
        fn(ph.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ph.shape[1],
           ph.shape[2], float(beta), int(n_update), seed)
        return ph
    return sweeps


@pytest.mark.parametrize("reference", ["package", "source"])
def test_native_sweep_bit_equal(reference, tmp_path):
    """The port's C++ sweep against qmg_tpu's: its built library where the
    package has one, and always its source compiled here."""
    if reference == "package":
        if not jnative.have_heatbath():
            pytest.skip("qmg_tpu's libqmgnative.so is not built")
        sweeps = jnative.heatbath_sweeps
    else:
        sweeps = _jax_sweeps_from_source(tmp_path)
    ph, jrng, trng = _start(7)
    for n_update in (1, 4):       # two calls: one seed drawn per call
        want = sweeps(ph.copy(), BETA, n_update, jrng)
        got = u1.heatbath_sweeps_native(ph.copy(), BETA, n_update, trng)
        assert np.array_equal(got, want)
        ph = got
    assert jrng.gen.integers(0, 2**63 - 1) == trng.gen.integers(0, 2**63 - 1)


def test_update_matches_jax_on_its_path():
    """heatbath_noncompact_update of both packages on eo-packed phases,
    the port's sweep chosen as qmg_tpu chooses its own."""
    sweep = "native" if jnative.have_heatbath() else "numpy"
    jlat, tlat = JLattice2D(L, L, 1), Lattice2D(L, L, 1)
    ph0 = np.zeros((2, 2, L, L // 2))
    want = ju1.heatbath_noncompact_update(ph0, jlat, BETA, 5,
                                          JQMGRandom(11))
    got = u1.heatbath_noncompact_update(ph0, tlat, BETA, 5, QMGRandom(11),
                                        sweep)
    assert got.shape == (2, 2, L, L // 2)
    assert np.array_equal(got, want)


def test_numpy_and_native_sweeps_differ_in_draws_only():
    """Both sweeps reach the beta = 6 plaquette from a cold start; they
    consume the rng differently, so their fields differ."""
    tlat = Lattice2D(L, L, 1)
    fields = {}
    for sweep in u1.SWEEPS:
        ph = u1.heatbath_noncompact_update(np.zeros((2, 2, L, L // 2)),
                                           tlat, BETA, 30, QMGRandom(3),
                                           sweep)
        fields[sweep] = ph
        plaq = float(u1.get_plaquette_u1(
            u1.phases_to_links(torch.as_tensor(ph)), tlat).real)
        assert 0.85 < plaq < 0.97, (sweep, plaq)
    assert not np.array_equal(fields["native"], fields["numpy"])


def test_noncompact_action_matches_jax():
    ph = np.random.default_rng(3).normal(size=(2, 2, L, L // 2))
    jlat, tlat = JLattice2D(L, L, 1), Lattice2D(L, L, 1)
    want = float(ju1.get_noncompact_action_u1(ph, BETA, jlat))
    got = float(u1.get_noncompact_action_u1(torch.as_tensor(ph), BETA, tlat))
    assert abs(got - want) <= 1e-12 * abs(want)
    assert float(u1.get_noncompact_action_u1(np.zeros_like(ph), BETA,
                                             tlat)) == 0.0


def test_plaquette_at_beta_6():
    tlat = Lattice2D(32, 32, 1)
    ph = u1.heatbath_noncompact_update(np.zeros((2, 2, 32, 16)), tlat, BETA,
                                       50, QMGRandom(1337))
    plaq = float(u1.get_plaquette_u1(
        u1.phases_to_links(torch.as_tensor(ph)), tlat).real)
    assert 0.85 < plaq < 0.97


def test_sweep_refusals(monkeypatch):
    tlat = Lattice2D(L, L, 1)
    ph = np.zeros((2, 2, L, L // 2))
    with pytest.raises(ValueError, match="sweep"):
        u1.heatbath_noncompact_update(ph, tlat, BETA, 1, QMGRandom(1),
                                      "python")
    with pytest.raises(ValueError, match=r"\(2, Y, X\)"):
        u1.heatbath_sweeps_native(np.zeros((3, L, L)), BETA, 1,
                                  QMGRandom(1))

    # A failed build raises; nothing falls back to the NumPy sweep.
    def broken(source):
        raise RuntimeError(f"no compiler for {source}")
    monkeypatch.setattr(u1, "_LIB", {})
    monkeypatch.setattr(u1, "build_library", broken)
    with pytest.raises(RuntimeError, match="heatbath.cpp"):
        u1.heatbath_noncompact_update(ph, tlat, BETA, 1, QMGRandom(1))
