"""Port vs qmg_tpu: block-orthonormal transfers and the Galerkin coarse
build from identical null vectors (complex128, <= 1e-12)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1
from qmg_tpu.transfer import TransferMG as JTransferMG, DoublingType as JDT
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.operators.coarse import build_coarse_coeffs as jbuild
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.transfer import TransferMG as TTransferMG, DoublingType
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.operators.coarse import build_coarse_coeffs as tbuild

torch.set_num_threads(1)

MASS = -0.06
NVEC = 4

# (fine X, Y) -> (coarse X, Y): even blocks (reshape path), odd x-blocks
# (permutation path), a point coarse lattice (volume-1 fold) and a coarse
# y extent of 1 (dimension fold).
CASES = {"even": ((16, 16), (4, 4)), "odd_bx": ((12, 8), (4, 4)),
         "point": ((4, 4), (1, 1)), "dim1": ((8, 4), (2, 1))}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    (fx, fy), (cx, cy) = CASES[request.param]
    flat, clat = Lattice2D(fx, fy, 2), Lattice2D(cx, cy, NVEC)
    rng = np.random.default_rng(17)
    nv = (rng.normal(size=(NVEC,) + flat.cv_shape())
          + 1j * rng.normal(size=(NVEC,) + flat.cv_shape()))
    jt = JTransferMG(flat, clat, jnp.asarray(nv),
                     doubling=JDT.PROJECTION)
    tt = TTransferMG(TLattice2D(fx, fy, 2), TLattice2D(cx, cy, NVEC),
                     torch.as_tensor(nv), doubling=DoublingType.PROJECTION)
    return flat, clat, jt, tt


def test_block_orthonormal_null_vectors(pair):
    _, _, jt, tt = pair
    assert _rel(tt._nvb.numpy(), jt._nvb) <= 1e-12
    assert _rel(tt.null_vectors.numpy(), jt.null_vectors) <= 1e-12


def test_restrict_prolong(pair):
    flat, clat, jt, tt = pair
    rng = np.random.default_rng(5)
    f = rng.normal(size=flat.cv_shape()) + 1j * rng.normal(
        size=flat.cv_shape())
    c = rng.normal(size=clat.cv_shape()) + 1j * rng.normal(
        size=clat.cv_shape())
    assert _rel(tt.restrict_f2c(torch.as_tensor(f)).numpy(),
                jt.restrict_f2c(jnp.asarray(f))) <= 1e-12
    assert _rel(tt.prolong_c2f(torch.as_tensor(c)).numpy(),
                jt.prolong_c2f(jnp.asarray(c))) <= 1e-12


def test_galerkin_coarse_coeffs(pair):
    flat, clat, jt, tt = pair
    g = ju1.gauss_gauge_u1(flat, JQMGRandom(1337), 6.0)
    jop = JWilson2D(flat, MASS, jnp.asarray(g), dtype=jnp.complex128)
    top = TWilson2D(TLattice2D(flat.x_len, flat.y_len, 2), MASS, g,
                    dtype=torch.complex128)
    jc = jbuild(clat, jop.coeffs, jt)
    tc = tbuild(TLattice2D(clat.x_len, clat.y_len, NVEC), top.coeffs, tt)
    assert _rel(tc.clover.numpy(), jc.clover) <= 1e-12
    scale = max(float(np.max(np.abs(np.asarray(jc.hopping)))), 1.0)
    assert np.max(np.abs(tc.hopping.numpy() - np.asarray(jc.hopping))) \
        <= 1e-12 * scale
    assert tc.shift == complex(jc.shift)
