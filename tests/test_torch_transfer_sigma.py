"""Port vs qmg_tpu: the transfers with saved block decompositions, the
bi-orthonormal (asymmetric R != P^dagger) transfers, and the coarse
sigma-1 operators built from them, at complex128 on the same numpy null
vectors. Mirrors test_n05_n06_transfer; decompositions and applies agree
to 1e-12 (relative to the largest entry)."""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu.transfer import TransferMG as JTransferMG, DoublingType as JDT
from qmg_tpu.operators import Wilson2D as JWilson
from qmg_tpu.operators.coarse import CoarseOperator2D as JCoarse
from qmg_tpu import u1 as ju1, linalg as jlinalg
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.transfer import TransferMG, DoublingType
from qmg_tpu_torch.operators import Wilson2D
from qmg_tpu_torch.operators.coarse import CoarseOperator2D, CoarseSigmaType
from qmg_tpu_torch.multigrid import MultigridMG
from qmg_tpu_torch import linalg
from qmg_tpu_torch.solve import state_to_numpy
from qmg_tpu_torch.stateful import StatefulMultigridMG, CoarsestSolveMG, \
    LevelSolveMG

torch.set_num_threads(1)

TOL = 1e-12
FINE, COARSE = (16, 16, 2), (4, 4, 4)
SIGMA_TYPES = (CoarseSigmaType.SIGMA_1_L, CoarseSigmaType.SIGMA_1_R,
               CoarseSigmaType.SIGMA_1_L_RBJ, CoarseSigmaType.SIGMA_1_R_RBJ)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _vectors(lat, n, seed):
    """n gaussian fields (numpy) from qmg_tpu's generator."""
    rng = JQMGRandom(seed)
    return np.stack([np.asarray(rng.gaussian_cv(JLattice2D(*lat)))
                     for _ in range(n)])


def _transfers(asym, fine=FINE, coarse=COARSE, save=True,
               doubling=DoublingType.NONE):
    """(port, qmg_tpu) transfers from the same vectors; asymmetric ones
    restrict with a second set."""
    pv = _vectors(fine, coarse[2], 5)
    rv = _vectors(fine, coarse[2], 6) if asym else None
    t = TransferMG(Lattice2D(*fine), Lattice2D(*coarse), torch.as_tensor(pv),
                   save_decomp=save, doubling=doubling,
                   restrict_null_vectors=(None if rv is None
                                          else torch.as_tensor(rv)))
    jt = JTransferMG(JLattice2D(*fine), JLattice2D(*coarse), jnp.asarray(pv),
                     do_block_ortho=True, save_decomp=save,
                     doubling=JDT(int(doubling)),
                     restrict_null_vectors=(None if rv is None
                                            else jnp.asarray(rv)))
    return t, jt, pv, rv


@pytest.mark.parametrize("asym", (False, True), ids=("sym", "asym"))
def test_blocked_vectors_and_decompositions(asym):
    t, jt, _, _ = _transfers(asym)
    assert t.is_symmetric() == jt.is_symmetric() == (not asym)
    assert t.has_decompositions() and jt.has_decompositions()
    assert _rel(t._nvb.numpy(), jt._nvb) <= TOL
    if asym:
        assert _rel(t._restrict_nvb.numpy(), jt._restrict_nvb) <= TOL
        assert _rel(t.restrict_null_vectors.numpy(),
                    jt.restrict_null_vectors) <= TOL
        assert _rel(t.block_L.numpy(), jt.block_L) <= TOL
        assert _rel(t.block_U.numpy(), jt.block_U) <= TOL
        assert t.block_cholesky is None
    else:
        assert _rel(t.block_cholesky.numpy(), jt.block_cholesky) <= TOL
        assert t.block_L is None and t.restrict_null_vectors is None
    xc = np.asarray(JQMGRandom(12).gaussian_cv(JLattice2D(*COARSE)))
    xf = np.asarray(JQMGRandom(13).gaussian_cv(JLattice2D(*FINE)))
    assert _rel(t.prolong_c2f(torch.as_tensor(xc)).numpy(),
                jt.prolong_c2f(jnp.asarray(xc))) <= TOL
    assert _rel(t.restrict_f2c(torch.as_tensor(xf)).numpy(),
                jt.restrict_f2c(jnp.asarray(xf))) <= TOL


def test_restrict_of_prolong_and_null_space():
    """n05: R P = 1 on the coarse space, P R fixes the null vectors, the
    blocks orthonormal."""
    t, _, _, _ = _transfers(False, save=False)
    assert not t.has_decompositions()
    xc = torch.as_tensor(np.asarray(
        JQMGRandom(11).gaussian_cv(JLattice2D(*COARSE))))
    rt = t.restrict_f2c(t.prolong_c2f(xc))
    assert float(linalg.diffnorm2sq(rt, xc)) < 1e-22 * float(
        linalg.norm2sq(xc))
    for v in t.null_vectors:
        assert float(linalg.diffnorm2sq(t.prolong_c2f(t.restrict_f2c(v)),
                                        v)) < 1e-20
    gram = torch.einsum("icbyx,jcbyx->cyxij", t._nvb.conj(), t._nvb)
    assert float(linalg.norminf(gram - torch.eye(COARSE[2]))) < 1e-12


def test_asymmetric_bi_orthonormality():
    """<r_i, p_j> = delta_ij per block, and R P = 1 still."""
    t, _, _, _ = _transfers(True)
    gram = torch.einsum("icbyx,jcbyx->cyxij", t._restrict_nvb.conj(),
                        t._nvb)
    assert float(linalg.norminf(gram - torch.eye(COARSE[2]))) < 1e-10
    xc = torch.as_tensor(np.asarray(
        JQMGRandom(12).gaussian_cv(JLattice2D(*COARSE))))
    rt = t.restrict_f2c(t.prolong_c2f(xc))
    assert float(linalg.diffnorm2sq(rt, xc)) < 1e-18 * float(
        linalg.norm2sq(xc))


@pytest.mark.parametrize("asym", (False, True), ids=("cholesky", "lu"))
def test_decomposition_reconstructs_originals(asym):
    """n06: P_orig = P R (Cholesky, upper triangular) or P_orig = P U and
    R_orig = R L^dagger (L lower, U upper)."""
    t, _, pv, rv = _transfers(asym)
    p_orig = t._to_blocked(torch.as_tensor(pv))
    if not asym:
        chol = t.block_cholesky
        assert float(torch.tril(chol, -1).abs().max()) < 1e-14
        recon = torch.einsum("jcbyx,cyxji->icbyx", t._nvb, chol)
        assert float((recon - p_orig).abs().max()) < 1e-10
        return
    lower, upper = t.block_L, t.block_U
    assert float(torch.tril(upper, -1).abs().max()) < 1e-14
    assert float(torch.triu(lower, 1).abs().max()) < 1e-14
    p_recon = torch.einsum("jcbyx,cyxji->icbyx", t._nvb, upper)
    r_recon = torch.einsum("jcbyx,cyxji->icbyx", t._restrict_nvb,
                           linalg.site_conjtrans(lower))
    assert float((p_recon - p_orig).abs().max()) < 1e-10
    assert float((r_recon - t._to_blocked(torch.as_tensor(rv))).abs().max()
                 ) < 1e-10


def test_point_coarse_lattice_and_unorthonormalized():
    """Coarsening to 1x1; and ``do_block_ortho=False`` keeps the raw
    vectors as qmg_tpu does."""
    t, jt, _, _ = _transfers(False, fine=(4, 4, 2), coarse=(1, 1, 4))
    xc = torch.zeros((2, 1, 1, 4), dtype=torch.complex128)
    xc[0, 0, 0] = torch.arange(1.0, 5.0)
    assert float(linalg.diffnorm2sq(t.restrict_f2c(t.prolong_c2f(xc)),
                                    xc)) < 1e-20
    assert _rel(t.block_cholesky.numpy(), jt.block_cholesky) <= TOL
    pv = _vectors(FINE, 4, 5)
    raw = TransferMG(Lattice2D(*FINE), Lattice2D(*COARSE),
                     torch.as_tensor(pv), do_block_ortho=False)
    jraw = JTransferMG(JLattice2D(*FINE), JLattice2D(*COARSE),
                       jnp.asarray(pv), do_block_ortho=False)
    assert _rel(raw._nvb.numpy(), jraw._nvb) == 0


def test_linalg_helpers():
    a = np.asarray(JQMGRandom(3).gaussian_cv(JLattice2D(8, 8, 2)))
    b = np.asarray(JQMGRandom(4).gaussian_cv(JLattice2D(8, 8, 2)))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert abs(float(linalg.diffnorm2sq(ta, tb))
               - float(jlinalg.diffnorm2sq(jnp.asarray(a), jnp.asarray(b)))
               ) < 1e-12 * float(linalg.diffnorm2sq(ta, tb))
    assert float(linalg.norminf(ta)) == float(jlinalg.norminf(
        jnp.asarray(a)))
    m = np.random.default_rng(1).normal(size=(2, 4, 4, 3, 3)) + 1j
    assert _rel(linalg.site_inv(torch.as_tensor(m)).numpy(),
                jlinalg.site_inv(jnp.asarray(m))) <= TOL


@functools.lru_cache(maxsize=None)
def _coarse_pair(asym, point=False):
    """A chiral coarse Wilson operator over an operator-doubled transfer
    with saved decompositions, in both packages."""
    fine = (4, 4, 2) if point else (8, 8, 2)
    coarse = (1, 1, 4) if point else (2, 2, 4)
    rng = JQMGRandom(11)
    g = np.array(ju1.gauss_gauge_u1(JLattice2D(*fine), rng, 6.0))
    t, jt, _, _ = _transfers(asym, fine=fine, coarse=coarse,
                             doubling=DoublingType.OPERATOR)
    top = CoarseOperator2D(Lattice2D(*coarse),
                           Wilson2D(Lattice2D(*fine), -0.05, g), t,
                           is_chiral=True)
    jop = JCoarse(JLattice2D(*coarse),
                  JWilson(JLattice2D(*fine), -0.05, jnp.asarray(g)), jt,
                  is_chiral=True)
    x = np.asarray(rng.gaussian_cv(JLattice2D(*coarse)))
    if point:
        x[1] = 0
    return top, jop, x


@pytest.mark.parametrize("ctype", SIGMA_TYPES)
@pytest.mark.parametrize("form", ("sym", "asym", "sym_point"))
def test_apply_coarse_sigma(form, ctype):
    top, jop, x = _coarse_pair(form.startswith("asym"),
                               point=form.endswith("point"))
    got = top.apply_coarse_sigma(torch.as_tensor(x), ctype).numpy()
    assert _rel(got, jop.apply_coarse_sigma(jnp.asarray(x), ctype)) <= TOL


def test_coarse_sigma1_chirality():
    """Operator doubling gives the coarse level sigma1 chirality: the
    projections (x +- sigma1 x)/2, gamma5 on the lower half, the same as
    qmg_tpu's; sigma1^L = sigma1^R for a symmetric transfer."""
    top, jop, x = _coarse_pair(False)
    assert int(top.get_default_chirality()) == 2
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    for up in (True, False):
        assert _rel(top.chiral_projection(tx, up).numpy(),
                    jop.chiral_projection(jx, up)) == 0
    assert _rel(top.gamma5(tx).numpy(), jop.gamma5(jx)) == 0
    assert torch.equal(
        top.apply_coarse_sigma(tx, CoarseSigmaType.SIGMA_1_L),
        top.apply_coarse_sigma(tx, CoarseSigmaType.SIGMA_1_R))
    with pytest.raises(ValueError, match="invalid coarse sigma"):
        top.apply_coarse_sigma(tx, 5)


def test_coarse_sigma_needs_decompositions():
    lat, clat = Lattice2D(8, 8, 2), Lattice2D(2, 2, 4)
    g = np.array(ju1.gauss_gauge_u1(JLattice2D(8, 8, 1), JQMGRandom(1), 6.0))
    t = TransferMG(lat, clat, torch.as_tensor(_vectors((8, 8, 2), 4, 5)),
                   doubling=DoublingType.OPERATOR)
    op = CoarseOperator2D(clat, Wilson2D(lat, -0.05, g), t, is_chiral=True)
    with pytest.raises(ValueError, match="save_decomp"):
        op.apply_coarse_sigma(torch.zeros(clat.cv_shape(),
                                          dtype=torch.complex128),
                              CoarseSigmaType.SIGMA_1_L)


def test_state_dict_refuses_asymmetric_transfer():
    """The state dict carries nvb only, and every hierarchy rebuilt from it
    (a distributed mesh's ShardedTransferMG among them) restricts with
    nvb^dagger: an asymmetric transfer is refused, not turned into P^dagger.
    The hierarchy itself restricts with R."""
    top, _, x = _coarse_pair(True)
    t = top.in_transfer
    lat = t.fine_lat
    mg = StatefulMultigridMG(lat, Wilson2D(lat, -0.05, np.ones(
        (2, 2, 8, 4), dtype=np.complex128)), CoarsestSolveMG())
    mg.push_level(t.coarse_lat, t, LevelSolveMG(), stencil=top)
    with pytest.raises(ValueError, match="asymmetric"):
        state_to_numpy(mg)
    xf = torch.as_tensor(_vectors((8, 8, 2), 1, 9)[0])
    want = torch.einsum("vcbyx,cbyx->cyxv", t._restrict_nvb.conj(),
                        t._to_blocked(xf))
    assert torch.allclose(t.restrict_f2c(xf), want, rtol=0, atol=1e-13)
    assert isinstance(mg, MultigridMG)
