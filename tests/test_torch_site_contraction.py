"""The plain stencil apply's per-site contraction
(``linalg.stacked_site_matvec``) on both of its routes, against the
broadcast formula computed at complex128; the applies that end in it
(``apply_M``, the fused Schur apply, the half-hopping apply) through the
product route; the route the thresholds pick and its count in
``linalg.CONTRACTIONS``; the stacked coefficient caches rebuilt after an
update; and, on a CUDA card, the 512^2 nc8 product route without the
broadcast product's memory."""

import collections
import math

import pytest
import torch

from qmg_tpu_torch import linalg, stencil, u1
from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.operators import Wilson2D
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch.stencil import Stencil2D, StencilType, make_coeffs

torch.set_num_threads(1)

TOL = {torch.complex128: 1e-13, torch.complex64: 1e-6}


def _rand(gen, shape, dtype=torch.complex128, device="cpu"):
    re = torch.randn(shape, generator=gen, dtype=torch.float64)
    im = torch.randn(shape, generator=gen, dtype=torch.float64)
    return torch.complex(re, im).to(dtype=dtype, device=device)


def _broadcast_oracle(mats, pulls):
    """sum_{t, j} mats[t, s, i, j] pulls[t][*b, s, j] as the elementwise
    product and a sum, at complex128; ``mats`` (T, *sites, nc, nc)."""
    mats = mats.to(torch.complex128)
    nbrs = torch.stack(pulls).to(torch.complex128)
    n_batch = nbrs.ndim - mats.ndim + 1
    mats = mats.reshape(mats.shape[:1] + (1,) * n_batch + mats.shape[1:])
    return (mats * nbrs.unsqueeze(-2)).sum(dim=(0, -1))


def _rel(got, want):
    return float((got.to(torch.complex128) - want).abs().max()
                 / want.abs().max())


def _force(monkeypatch, route):
    """Every contraction on ``route``, whatever its shape."""
    if route == "product":
        monkeypatch.setattr(linalg, "PRODUCT_MIN_SITES", 0)
        monkeypatch.setattr(linalg, "PRODUCT_MIN_NC", 0)
    else:
        monkeypatch.setattr(linalg, "PRODUCT_MIN_SITES", math.inf)


def _delta(before):
    return dict(collections.Counter(linalg.CONTRACTIONS) - before)


@pytest.mark.parametrize("route", ["product", "broadcast"])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("batch", [(), (3,), (2, 3)])
@pytest.mark.parametrize("terms", [1, 4, 5, 9])
@pytest.mark.parametrize("nc", [1, 2, 4, 8, 16])
def test_route_matches_broadcast_formula(monkeypatch, route, nc, terms,
                                         batch, dtype):
    """Either route, forced, against the broadcast formula at complex128:
    1e-13 in complex128, 1e-6 relative in complex64; one count a call.
    The terms are stacked in the layout of the forced route."""
    gen = torch.Generator().manual_seed(100 * nc + terms)
    sites = (2, 8, 4) if nc >= 8 else (2, 16, 8)
    mats = _rand(gen, (terms,) + sites + (nc, nc), dtype)
    pulls = [_rand(gen, batch + sites + (nc,), dtype) for _ in range(terms)]
    want = _broadcast_oracle(mats, pulls)
    _force(monkeypatch, route)
    stacked = linalg.stack_terms(mats)
    if nc >= linalg.PRODUCT_MIN_NC:
        assert stacked.shape == sites + (nc, terms * nc)
    assert torch.equal(linalg.unstack_terms(stacked, terms), mats)
    before = collections.Counter(linalg.CONTRACTIONS)
    got = linalg.stacked_site_matvec(stacked, pulls)
    assert _delta(before) == {route: 1}
    assert got.shape == batch + sites + (nc,) and got.dtype == dtype
    assert got.is_contiguous()
    assert _rel(got, want) <= TOL[dtype]


def _wilson16():
    lat = Lattice2D(16, 16, 2)
    gauge = u1.gauss_gauge_u1(lat, QMGRandom(1337), 6.0)
    return Wilson2D(lat, -0.06, gauge)


def _coarse16(nc=8, L=16, seed=5):
    """A distance-1 nc-colour set with a well-conditioned clover."""
    lat = Lattice2D(L, L, nc)
    gen = torch.Generator().manual_seed(seed)
    eye = torch.eye(nc, dtype=torch.complex128)
    clover = 4 * eye + 0.2 * _rand(gen, lat.cm_shape())
    hopping = 0.2 * _rand(gen, (4,) + lat.cm_shape())
    return Stencil2D(make_coeffs(lat, clover=clover, hopping=hopping,
                                 shift=0.1))


OPERATORS = {"wilson16": _wilson16, "coarse16_nc8": _coarse16}


def _apply(st, which, x):
    if which == "apply_M":
        return stencil.apply_M(st.coeffs, x)
    if which == "schur_fused":
        return st.apply_M(x.select(1, 0), StencilType.RIGHT_SCHUR)
    return stencil.apply_hopping_half(st.coeffs, x.select(1, 1), 1)


@pytest.mark.parametrize("which", ["apply_M", "schur_fused", "hopping_half"])
@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_applies_through_product_route(monkeypatch, op, which):
    """The three plain applies on 3 fields, product route against
    broadcast route at complex128 (each on an operator built under its
    route, so its stacked sets take that route's layout); the fused Schur
    apply also against the two half-hopping applies it composes."""
    _force(monkeypatch, "broadcast")
    st = OPERATORS[op]()
    gen = torch.Generator().manual_seed(11)
    x = _rand(gen, (3,) + st.lat.cv_shape())
    want = _apply(st, which, x)
    _force(monkeypatch, "product")
    st = OPERATORS[op]()
    st.prebuild_derived(StencilType.RIGHT_SCHUR)
    before = collections.Counter(linalg.CONTRACTIONS)
    got = _apply(st, which, x)
    assert _delta(before).keys() == {"product"}
    assert _rel(got, want) <= 1e-13
    if which == "schur_fused":
        unfused = stencil.apply_rbj_schur(st.rbjacobi, x.select(1, 0))
        assert _rel(got, unfused) <= 1e-12


@pytest.mark.parametrize("sites, nc, route", [
    ((linalg.PRODUCT_MIN_SITES,), linalg.PRODUCT_MIN_NC, "product"),
    ((linalg.PRODUCT_MIN_SITES - 1,), linalg.PRODUCT_MIN_NC, "broadcast"),
    ((linalg.PRODUCT_MIN_SITES,), linalg.PRODUCT_MIN_NC - 1, "broadcast"),
])
def test_thresholds_pick_the_route_and_count_it(sites, nc, route):
    """One count a contraction, on the route the thresholds pick."""
    gen = torch.Generator().manual_seed(3)
    mats = _rand(gen, (5,) + sites + (nc, nc), torch.complex64)
    pulls = [_rand(gen, (2,) + sites + (nc,), torch.complex64)
             for _ in range(5)]
    before = collections.Counter(linalg.CONTRACTIONS)
    got = linalg.stacked_site_matvec(linalg.stack_terms(mats), pulls)
    assert _delta(before) == {route: 1}
    assert _rel(got, _broadcast_oracle(mats, pulls)) <= 1e-6


@pytest.mark.parametrize("L, route", [(32, "broadcast"), (64, "product")])
def test_apply_counts_one_contraction(L, route):
    """An nc8 apply_M is one contraction: a 32^2 lattice's (1024 sites)
    on the broadcast route, a 64^2 lattice's (4096) on the product
    route."""
    st = _coarse16(L=L)
    x = _rand(torch.Generator().manual_seed(2), (2,) + st.lat.cv_shape())
    before = collections.Counter(linalg.CONTRACTIONS)
    stencil.apply_M(st.coeffs, x)
    assert _delta(before) == {route: 1}


def test_stacked_caches_follow_updates():
    """The stacked set, its half-hopping view and the fused Schur set are
    rebuilt after ``update_coeffs`` and ``invalidate_derived``."""
    st = _coarse16()
    first = st.coeffs.stacked()
    assert st.coeffs.stacked() is first
    hopping = 2 * st.coeffs.hopping
    st.update_coeffs(hopping=hopping)
    stacked = st.coeffs.stacked()
    assert stacked is not first
    assert torch.equal(linalg.unstack_terms(stacked, 5)[1:], hopping)
    for parity in (0, 1):
        assert torch.equal(
            linalg.unstack_terms(st.coeffs.hopping_stacked(parity), 4),
            hopping[:, parity])
    fused = st._schur_fused()
    assert torch.equal(linalg.stack_terms(fused.mats), fused.stacked)
    st.invalidate_derived()
    assert not st.built_rbj_schur_fused
    assert st._schur_fused() is not fused
    x = _rand(torch.Generator().manual_seed(4), st.lat.cv_shape()).select(
        0, 0)
    assert _rel(st.apply_M(x, StencilType.RIGHT_SCHUR),
                stencil.apply_rbj_schur(st.rbjacobi, x)) <= 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_product_route_on_card_512_nc8(cuda):
    """The 512^2 nc8 5-term contraction of 8 fields on the card: the
    product route against the broadcast formula, and the call's memory
    below the 5.4 GB broadcast product it no longer builds."""
    linalg.pin_full_precision()
    gen = torch.Generator().manual_seed(512)
    sites, nc, terms, nrhs = (2, 512, 256), 8, 5, 8
    mats = _rand(gen, (terms,) + sites + (nc, nc), torch.complex64, cuda)
    pulls = [_rand(gen, (nrhs,) + sites + (nc,), torch.complex64, cuda)
             for _ in range(terms)]
    stacked = linalg.stack_terms(mats)
    product_bytes = terms * nrhs * math.prod(sites) * nc * nc * 8
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = collections.Counter(linalg.CONTRACTIONS)
    got = linalg.stacked_site_matvec(stacked, pulls)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < product_bytes
    assert _delta(before) == {"product": 1}
    want = torch.zeros(got.shape, dtype=torch.complex128, device=cuda)
    for t in range(terms):
        want += _broadcast_oracle(mats[t:t + 1], pulls[t:t + 1])
    assert _rel(got, want) <= 1e-6
