"""Port vs qmg_tpu on the stencil variants: the distance-2 and corner
shifts and the half-lattice pulls, the per-site QR inverse, twolink and
corner pieces in ``apply_M``, the derived coefficient sets (dagger,
rbjacobi, rbj-dagger, fused Schur), and ``Stencil2D``'s dispatch over the
nine stencil types, at complex128 on the same numpy-seeded inputs; the
adjoint identity, the fused Schur apply against the two half applies, a
reconstructed Schur solve; the refusals; derived sets dropped on
``update_links``; and, on a CUDA card, the fused Schur apply against the
CPU's."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import cshift as jcshift, stencil as jstencil, u1 as ju1
from qmg_tpu import linalg as jlinalg
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch import cshift as tcshift, stencil as tstencil
from qmg_tpu_torch import linalg as tlinalg
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.operators.coarse import (CoarseOperator2D,
                                            build_coarse_coeffs)
from qmg_tpu_torch.transfer import TransferMG, DoublingType
from qmg_tpu_torch.stencil import StencilType

torch.set_num_threads(1)

MASS = -0.06
TYPES = list(StencilType)


def _cfield(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# --- shifts ---------------------------------------------------------------

@pytest.mark.parametrize("nc", [1, 8])
@pytest.mark.parametrize("direction", list(range(4, 12)))
def test_cshift_pull_distance2_and_corner_match_jax(direction, nc):
    field = _cfield(np.random.default_rng(direction), (2, 12, 8, nc))
    expect = np.asarray(jcshift.cshift_pull(jnp.asarray(field), direction))
    got = tcshift.cshift_pull(torch.as_tensor(field), direction).numpy()
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("direction", list(range(12)))
def test_cshift_pull_half_matches_jax(direction, parity):
    """Each of the 12 directions from each parity, exactly; on a field and
    on per-site matrices (the Schur composition pulls both)."""
    rng = np.random.default_rng(10 * direction + parity)
    for shape in ((12, 8, 2), (12, 8, 2, 2)):
        half = _cfield(rng, shape)
        expect = np.asarray(jcshift.cshift_pull_half(jnp.asarray(half),
                                                     parity, direction))
        got = tcshift.cshift_pull_half(torch.as_tensor(half), parity,
                                       direction).numpy()
        np.testing.assert_array_equal(got, expect)


def test_cshift_half_batch_axis_and_full_consistency():
    """A leading batch axis pulls each half field on its own; a half pull
    is the matching half of the full pull of a field zero on the other
    parity."""
    field = torch.as_tensor(_cfield(np.random.default_rng(3), (3, 8, 4, 2)))
    for d in range(12):
        got = tcshift.cshift_pull_half(field, 1, d, batch_dims=1)
        for i in range(3):
            assert torch.equal(got[i],
                               tcshift.cshift_pull_half(field[i], 1, d))
        full = torch.stack([torch.zeros_like(field[0]), field[0]])
        dest = 1 if d >= 4 else 0
        assert torch.equal(tcshift.cshift_pull(full, d)[dest], got[0])


# --- per-site QR inverse --------------------------------------------------

@pytest.mark.parametrize("nc", [2, 8])
def test_site_inv_qr_matches_jax(nc):
    rng = np.random.default_rng(nc)
    mat = _cfield(rng, (2, 4, 3, nc, nc)) + 2 * np.eye(nc)
    got = tlinalg.site_inv_qr(torch.as_tensor(mat)).numpy()
    expect = np.asarray(jlinalg.site_inv_qr(jnp.asarray(mat)))
    assert _rel(got, expect) <= 1e-12
    ident = np.einsum("...ij,...jk->...ik", mat, got)
    assert np.max(np.abs(ident - np.eye(nc))) <= 1e-12


def test_site_inv_qr_ill_conditioned_block():
    """A block with condition number ~1e8 at complex128: the QR inverse
    still gives B B^-1 = 1 to 1e-7."""
    u, _ = np.linalg.qr(_cfield(np.random.default_rng(5), (8, 8)))
    mat = (u * np.logspace(0, -8, 8)) @ u.conj().T
    inv = tlinalg.site_inv_qr(torch.as_tensor(mat[None])).numpy()[0]
    assert np.max(np.abs(mat @ inv - np.eye(8))) <= 1e-7


# --- inputs: a Wilson operator and random coarse-like stencils ------------

def _random_pieces(lat_shape, nc, seed, distance2):
    """clover 4 + noise, hopping and (optionally) twolink / corner noise,
    all (.., 2, Y, Xh, nc, nc), and three shifts."""
    y_len, xh = lat_shape
    rng = np.random.default_rng(seed)
    cm = (2, y_len, xh, nc, nc)
    kw = dict(clover=4 * np.eye(nc) + 0.3 * _cfield(rng, cm),
              hopping=0.3 * _cfield(rng, (4,) + cm))
    if distance2:
        kw["twolink"] = 0.2 * _cfield(rng, (4,) + cm)
        kw["corner"] = 0.2 * _cfield(rng, (4,) + cm)
    shifts = dict(shift=0.1 + 0.05j, eo_shift=0.03, dof_shift=0.02 - 0.01j)
    return kw, shifts


def _pair(kind, distance2=False):
    """(qmg_tpu Stencil2D, port Stencil2D) on the same coefficients."""
    if kind == "wilson":
        lat = Lattice2D(16, 16, 2)
        g = ju1.gauss_gauge_u1(lat, JQMGRandom(1337), 6.0)
        j = JWilson2D(lat, MASS, jnp.asarray(g))
        t = TWilson2D(TLattice2D(16, 16, 2), MASS, g)
        if distance2:
            kw, _ = _random_pieces((16, 8), 2, 11, True)
            j = jstencil.Stencil2D(j.coeffs.replace(
                twolink=jnp.asarray(kw["twolink"]),
                corner=jnp.asarray(kw["corner"])))
            t = tstencil.Stencil2D(t.coeffs.replace(
                twolink=torch.as_tensor(kw["twolink"]),
                corner=torch.as_tensor(kw["corner"])))
        return j, t
    lat, tlat = Lattice2D(8, 8, 8), TLattice2D(8, 8, 8)
    kw, shifts = _random_pieces((8, 4), 8, 3, distance2)
    j = jstencil.Stencil2D(jstencil.make_coeffs(
        lat, dtype=jnp.complex128, **shifts,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    t = tstencil.Stencil2D(tstencil.make_coeffs(
        tlat, dtype=torch.complex128, **shifts,
        **{k: torch.as_tensor(v) for k, v in kw.items()}))
    return j, t


def _coeff_arrays(c):
    out = {}
    for name in ("clover", "hopping", "twolink", "corner"):
        v = getattr(c, name)
        if v is not None:
            out[name] = np.asarray(v)
    out["shifts"] = np.array([complex(c.shift), complex(c.eo_shift),
                              complex(c.dof_shift)])
    return out


def _assert_coeffs_close(tc, jc, bound):
    ta, ja = _coeff_arrays(tc), _coeff_arrays(jc)
    assert set(ta) == set(ja)
    for k in ta:
        assert _rel(ta[k], ja[k]) <= bound, k


@pytest.mark.parametrize("nc", [2, 8])
def test_apply_M_twolink_corner_matches_jax(nc):
    j, t = _pair("wilson" if nc == 2 else "coarse", distance2=True)
    assert not t.coeffs.is_distance1()
    shape = t.lat.cv_shape()
    x = _cfield(np.random.default_rng(nc), shape)
    got = tstencil.apply_M(t.coeffs, torch.as_tensor(x)).numpy()
    expect = np.asarray(jstencil.apply_M(j.coeffs, jnp.asarray(x)))
    assert _rel(got, expect) <= 1e-13
    # Each piece alone, by direction, as the probe build calls them.
    for fn in ("apply_twolink", "apply_corner"):
        for d in (range(4, 8) if fn == "apply_twolink" else range(8, 12)):
            got = getattr(tstencil, fn)(t.coeffs, torch.as_tensor(x),
                                        d).numpy()
            expect = np.asarray(getattr(jstencil, fn)(
                j.coeffs, jnp.asarray(x), d))
            assert _rel(got, expect) <= 1e-13


@pytest.mark.parametrize("distance2", [False, True], ids=["d1", "d2"])
@pytest.mark.parametrize("kind", ["wilson", "coarse"])
def test_derived_sets_match_jax(kind, distance2):
    """build_dagger, build_rbjacobi (coefficients and B^-1),
    build_rbj_dagger and (distance 1) build_rbj_schur_fused <= 1e-12."""
    j, t = _pair(kind, distance2)
    _assert_coeffs_close(tstencil.build_dagger(t.coeffs),
                         jstencil.build_dagger(j.coeffs), 1e-12)
    jr, tr = jstencil.build_rbjacobi(j.coeffs), \
        tstencil.build_rbjacobi(t.coeffs)
    _assert_coeffs_close(tr.coeffs, jr.coeffs, 1e-12)
    assert _rel(tr.cinv.numpy(), np.asarray(jr.cinv)) <= 1e-12
    jd, td = jstencil.build_rbj_dagger(jr), tstencil.build_rbj_dagger(tr)
    _assert_coeffs_close(td.coeffs, jd.coeffs, 1e-12)
    assert _rel(td.cinv.numpy(), np.asarray(jd.cinv)) <= 1e-12
    if not distance2:
        jf = jstencil.build_rbj_schur_fused(jr)
        tf = tstencil.build_rbj_schur_fused(tr)
        for name in ("clover", "twolink", "corner"):
            assert _rel(getattr(tf, name).numpy(),
                        np.asarray(getattr(jf, name))) <= 1e-12, name


def _vec(t, stype, seed):
    shape = t.solve_size_shape(stype)
    return _cfield(np.random.default_rng(seed), shape)


@pytest.mark.parametrize("stype", TYPES, ids=[s.name for s in TYPES])
@pytest.mark.parametrize("kind", ["wilson", "coarse"])
def test_stencil2d_dispatch_matches_jax(kind, stype):
    """apply_M, prepare_M and reconstruct_M of every type <= 1e-12."""
    j, t = _pair(kind)
    jt = jstencil.StencilType(int(stype))
    x = _vec(t, stype, 1)
    b = _cfield(np.random.default_rng(2), t.lat.cv_shape())
    for name, tgot, jgot in (
            ("apply_M", t.apply_M(torch.as_tensor(x), stype),
             j.apply_M(jnp.asarray(x), jt)),
            ("prepare_M", t.prepare_M(torch.as_tensor(b), stype),
             j.prepare_M(jnp.asarray(b), jt)),
            ("reconstruct_M",
             t.reconstruct_M(torch.as_tensor(x), torch.as_tensor(b), stype),
             j.reconstruct_M(jnp.asarray(x), jnp.asarray(b), jt))):
        assert tuple(tgot.shape) == tuple(jgot.shape), name
        assert _rel(tgot.numpy(), np.asarray(jgot)) <= 1e-12, name
    assert t.solve_size_shape(stype) == tuple(j.solve_size_shape(jt))


# --- properties -------------------------------------------------------------

@pytest.mark.parametrize("distance2", [False, True], ids=["d1", "d2"])
@pytest.mark.parametrize("kind", ["wilson", "coarse"])
def test_adjoint_identity(kind, distance2):
    """<y, M x> = <M^dagger y, x> for the original and the rbjacobi
    operator."""
    _, t = _pair(kind, distance2)
    rng = np.random.default_rng(9)
    x = torch.as_tensor(_cfield(rng, t.lat.cv_shape()))
    y = torch.as_tensor(_cfield(rng, t.lat.cv_shape()))
    for op, dag in ((StencilType.ORIGINAL, StencilType.DAGGER),
                    (StencilType.RIGHT_JACOBI, StencilType.RBJ_DAGGER)):
        lhs = tlinalg.vdot(y, t.apply_M(x, op))
        rhs = tlinalg.vdot(t.apply_M(y, dag), x)
        assert abs(complex(lhs - rhs)) <= 1e-12 * abs(complex(lhs))


@pytest.mark.parametrize("kind", ["wilson", "coarse"])
def test_fused_schur_equals_half_applies(kind):
    """The 9-point fused apply is the two half-hopping applies, on one
    even-half field and on a batch of them."""
    _, t = _pair(kind)
    rbj = t.rbjacobi
    fused = tstencil.build_rbj_schur_fused(rbj)
    x = torch.as_tensor(_cfield(np.random.default_rng(4),
                                (3,) + t.solve_size_shape(
                                    StencilType.RIGHT_SCHUR)))
    seq = tstencil.apply_rbj_schur(rbj, x)
    got = tstencil.apply_rbj_schur_fused(fused, x)
    assert _rel(got.numpy(), seq.numpy()) <= 1e-12
    for i in range(3):
        assert _rel(t.apply_M(x[i], StencilType.RIGHT_SCHUR).numpy(),
                    seq[i].numpy()) <= 1e-12


def _dense(apply, shape):
    n = int(np.prod(shape))
    cols = apply(torch.eye(n, dtype=torch.complex128).reshape((n,) + shape))
    return cols.reshape(n, n).numpy().T


@pytest.mark.parametrize("stype", [StencilType.RIGHT_SCHUR,
                                   StencilType.RIGHT_JACOBI],
                         ids=["schur", "rbjacobi"])
@pytest.mark.parametrize("kind", ["wilson", "coarse"])
def test_reconstructed_solve_solves_M(kind, stype):
    """Solve the prepared system densely, reconstruct: M x = b to 1e-12."""
    _, t = _pair(kind)
    b = torch.as_tensor(_cfield(np.random.default_rng(8), t.lat.cv_shape()))
    shape = t.solve_size_shape(stype)
    mat = _dense(t.get_apply_function(stype), shape)
    y = np.linalg.solve(mat, t.prepare_M(b, stype).numpy().reshape(-1))
    x = t.reconstruct_M(torch.as_tensor(y.reshape(shape)), b, stype)
    r = b - t.apply_M(x)
    assert float(torch.sqrt(tlinalg.norm2sq(r) / tlinalg.norm2sq(b))) \
        <= 1e-12


def test_rbjacobi_coarsening_is_galerkin():
    """The coarse operator built with use_rbjacobi is R (A B^-1) P, with a
    zero shift (qmg_tpu's test_schur_coarse_op_consistency)."""
    _, t = _pair("wilson")
    lat1 = TLattice2D(4, 4, 4)
    rng = np.random.default_rng(7)
    nv = torch.as_tensor(np.stack([_cfield(rng, t.lat.cv_shape())
                                   for _ in range(4)]))
    tr = TransferMG(t.lat, lat1, nv, doubling=DoublingType.PROJECTION)
    coarse = CoarseOperator2D(lat1, t, tr, is_chiral=True, use_rbjacobi=True,
                              build_extra=CoarseOperator2D.BUILD_RBJACOBI)
    assert coarse.built_rbjacobi and coarse.use_rbjacobi
    assert coarse.coeffs.shift == 0
    xc = torch.as_tensor(_cfield(rng, lat1.cv_shape()))
    built = coarse.apply_M(xc)
    emulated = tr.restrict_f2c(t.apply_M(tr.prolong_c2f(xc),
                                         StencilType.RIGHT_JACOBI))
    assert _rel(built.numpy(), emulated.numpy()) <= 1e-11


@pytest.mark.parametrize("extra,built", [
    (CoarseOperator2D.BUILD_ORIGINAL, (False, False, False)),
    (CoarseOperator2D.BUILD_DAGGER, (True, False, False)),
    (CoarseOperator2D.BUILD_RBJACOBI, (False, True, False)),
    (CoarseOperator2D.BUILD_DAGGER_RBJACOBI, (True, True, False)),
    (CoarseOperator2D.BUILD_RBJDAGGER, (False, True, True)),
    (CoarseOperator2D.BUILD_ALL, (True, True, True))])
def test_coarse_build_extra(extra, built):
    _, t = _pair("wilson")
    lat1 = TLattice2D(4, 4, 4)
    rng = np.random.default_rng(1)
    nv = torch.as_tensor(np.stack([_cfield(rng, t.lat.cv_shape())
                                   for _ in range(4)]))
    tr = TransferMG(t.lat, lat1, nv, doubling=DoublingType.PROJECTION)
    c = CoarseOperator2D(lat1, t, tr, build_extra=extra)
    assert (c.built_dagger, c.built_rbjacobi, c.built_rbj_dagger) == built


# --- refusals ---------------------------------------------------------------

def test_schur_and_galerkin_refuse_distance2():
    _, t = _pair("coarse", distance2=True)
    rbj = t.rbjacobi
    x = torch.zeros(t.solve_size_shape(StencilType.RIGHT_SCHUR),
                    dtype=torch.complex128)
    with pytest.raises(ValueError, match="distance-1"):
        tstencil.apply_rbj_schur(rbj, x)
    with pytest.raises(ValueError, match="distance-1"):
        tstencil.build_rbj_schur_fused(rbj)
    with pytest.raises(ValueError, match="distance-1"):
        t.apply_M(x, StencilType.RIGHT_SCHUR)
    nv = torch.ones((4,) + t.lat.cv_shape(), dtype=torch.complex128)
    tr = TransferMG(t.lat, TLattice2D(4, 4, 4), nv)
    with pytest.raises(ValueError, match="distance-1"):
        build_coarse_coeffs(TLattice2D(4, 4, 4), t.coeffs, tr)
    with pytest.raises(ValueError, match="distance-1"):
        t.coeffs.stacked()
    assert tstencil.build_gather_apply(t.coeffs) is None


def test_rbjacobi_refuses_no_clover_no_shift():
    _, t = _pair("coarse")
    st = tstencil.Stencil2D(t.coeffs.replace(clover=None, shift=0j,
                                             eo_shift=0j, dof_shift=0j))
    with pytest.raises(ValueError, match="clover term or shift"):
        st.build_rbjacobi_stencil()
    with pytest.raises(ValueError, match="clover term or shift"):
        st.apply_M(torch.zeros(st.lat.cv_shape(), dtype=torch.complex128),
                   StencilType.RIGHT_JACOBI)
    # A shift alone suffices.
    st.update_shifts(shift=0.5)
    assert st.rbjacobi.cinv is not None


# --- caches ------------------------------------------------------------------

def test_update_links_drops_derived_sets():
    """A Wilson operator's derived sets built on one gauge field are gone
    after update_links, and rebuilt ones equal a fresh operator's."""
    lat, tlat = Lattice2D(16, 16, 2), TLattice2D(16, 16, 2)
    rng = JQMGRandom(1337)
    g1 = ju1.gauss_gauge_u1(lat, rng, 6.0)
    g2 = ju1.gauss_gauge_u1(lat, rng, 6.0)
    op = TWilson2D(tlat, MASS, g1)
    for stype in TYPES:
        op.prebuild_derived(stype)
    assert op.built_dagger and op.built_rbjacobi and op.built_rbj_dagger \
        and op.built_rbj_schur_fused
    old_hop = op.rbjacobi.coeffs.hopping
    op.update_links(g2)
    assert not (op.built_dagger or op.built_rbjacobi or op.built_rbj_dagger
                or op.built_rbj_schur_fused)
    fresh = TWilson2D(tlat, MASS, g2)
    x = torch.as_tensor(_cfield(np.random.default_rng(0), (16, 8, 2)))
    for stype in TYPES:
        shape = op.solve_size_shape(stype)
        v = x if len(shape) == 3 else torch.stack([x, x])
        assert torch.equal(op.apply_M(v, stype), fresh.apply_M(v, stype))
    assert not torch.equal(op.rbjacobi.coeffs.hopping, old_hop)


def test_update_shifts_drops_derived_sets():
    _, t = _pair("coarse")
    cinv = t.rbjacobi.cinv
    t.update_shifts(shift=0.2)
    assert not t.built_rbjacobi
    assert not torch.equal(t.rbjacobi.cinv, cinv)
    assert t.coeffs.shift == 0.2


def test_derived_builds_counted_once():
    _, t = _pair("wilson")
    before = tstencil.DERIVED_BUILDS.copy()
    x = torch.zeros(t.solve_size_shape(StencilType.RIGHT_SCHUR),
                    dtype=torch.complex128)
    for _ in range(3):
        t.apply_M(x, StencilType.RIGHT_SCHUR)
    after = tstencil.DERIVED_BUILDS
    assert after["rbjacobi"] - before["rbjacobi"] == 1
    assert after["schur_fused"] - before["schur_fused"] == 1


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fused_schur_on_card_matches_cpu(cuda_device):
    """The derived sets built on the card (batched QR there) and the fused
    Schur apply, against the same on the CPU: complex64 at 512^2."""
    lat = TLattice2D(512, 512, 2)
    g = ju1.gauss_gauge_u1(Lattice2D(512, 512, 2), JQMGRandom(1337), 6.0)
    x = torch.as_tensor(_cfield(np.random.default_rng(0), (512, 256, 2)))
    outs = []
    for dev in ("cpu", cuda_device):
        op = TWilson2D(lat, MASS, g, dtype=torch.complex64, device=dev)
        outs.append(op.apply_M(x.to(dev, torch.complex64),
                               StencilType.RIGHT_SCHUR).cpu())
    assert _rel(outs[1].numpy(), outs[0].numpy()) <= 1e-5
