"""The port's heatbath on the StdMT19937 stream: test_rng.py's C++ oracle
rows bit for bit, the C++ continuation (``u1.heatbath_sweeps_std``) bit for
bit against the plain sweep mid-stream, and against qmg_tpu's
``native.heatbath_sweeps_std``."""

import numpy as np
import pytest
import torch

from qmg_tpu import native as jnative
from qmg_tpu.rng import StdMT19937 as JStdMT19937

from qmg_tpu_torch.lattice import Lattice2D, eo_unpack
from qmg_tpu_torch.rng import StdMT19937
from qmg_tpu_torch import u1

torch.set_num_threads(1)

# test_rng.py's oracle: the reference sweep (u1/u1_utils.h:607-757) with
# std::mt19937(1337) and std::normal_distribution, compiled by g++ against
# libstdc++, at 4x4, beta 6, 2 updates: (A_x, A_y) at y = 0, x = 0, 1, 2.
ORACLE_FIRST_ROWS = [
    (0.26332565145996267, -0.020930124943424194),
    (0.46057326116245878, 0.36725073711624517),
    (-0.038260695492047136, 0.10991781466761363),
]


@pytest.mark.parametrize("sweep", u1.SWEEPS)
def test_heatbath_bit_exact_vs_cxx_oracle(sweep):
    lat = Lattice2D(4, 4, 1)
    ph = u1.heatbath_noncompact_update(np.zeros((2, 2, 4, 2)), lat, 6.0, 2,
                                       StdMT19937(1337), sweep)
    grid = np.stack([eo_unpack(ph[mu], lat) for mu in range(2)])
    got = [(grid[0, 0, x], grid[1, 0, x]) for x in range(3)]
    assert got == ORACLE_FIRST_ROWS


def _mid_stream(cls, n=7):
    """A stream 7 normals in: a cached normal is pending."""
    rng = cls(1337)
    for _ in range(n):
        rng.normal()
    return rng


def _same_stream(a, b):
    assert a._idx == b._idx
    assert np.array_equal(a._mt, b._mt)
    assert a._saved_normal == b._saved_normal
    assert [a.normal() for _ in range(64)] == [b.normal() for _ in range(64)]


def test_native_continuation_equals_plain_sweep():
    ph0 = np.random.default_rng(5).standard_normal((2, 24, 16))
    r_py, r_cc = _mid_stream(StdMT19937), _mid_stream(StdMT19937)
    assert r_cc._saved_normal is not None
    want = u1._heatbath_sweeps_numpy(ph0.copy(), 6.0, 3, r_py)
    got = u1.heatbath_sweeps_std(ph0.copy(), 6.0, 3, r_cc)
    assert np.array_equal(got, want)
    _same_stream(r_py, r_cc)


def test_native_continuation_equals_jax_native():
    if not jnative.have_heatbath():
        pytest.skip("qmg_tpu's libqmgnative.so is not built")
    ph0 = np.random.default_rng(6).standard_normal((2, 16, 24))
    r_j, r_t = _mid_stream(JStdMT19937, 5), _mid_stream(StdMT19937, 5)
    for n_update in (1, 3):
        want = jnative.heatbath_sweeps_std(ph0.copy(), 6.0, n_update, r_j)
        got = u1.heatbath_sweeps_std(ph0.copy(), 6.0, n_update, r_t)
        assert np.array_equal(got, want)
        ph0 = got
    _same_stream(r_j, r_t)


def test_update_dispatch_and_refusals():
    """A StdMT19937 takes the std entry under sweep="native" (it used to
    fail on ``rng.gen``), and an unsupported rng is refused by name."""
    lat = Lattice2D(8, 8, 1)
    ph0 = np.zeros((2, 2, 8, 4))
    a = u1.heatbath_noncompact_update(ph0, lat, 6.0, 2, StdMT19937(3),
                                      "native")
    b = u1.heatbath_noncompact_update(ph0, lat, 6.0, 2, StdMT19937(3),
                                      "numpy")
    assert np.array_equal(a, b)
    with pytest.raises(TypeError, match="Generator"):
        u1.heatbath_noncompact_update(ph0, lat, 6.0, 1,
                                      np.random.default_rng(0))
