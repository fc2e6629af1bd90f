"""Generic distance-<=2 stencil engine and its derived operators (port of
qmg_tpu/stencil.py).

Coefficients live in a ``StencilCoeffs`` record: clover (2, Y, Xh, nc, nc),
hopping (4, 2, Y, Xh, nc, nc) over directions {+x, +y, -x, -y}, the
optional parity-preserving twolink and corner pieces (4, 2, Y, Xh, nc, nc)
over {+2x, +2y, -2x, -2y} and {+x+y, -x+y, -x-y, +x-y}, and the scalar
mass / even-odd / dof shifts as Python complex numbers. The apply is
``M x = clover x + sum_d hopping_d x(s + d) [+ twolink, corner] + shifts``.
Every full-lattice apply accepts leading batch axes on ``x``
(``(*batch, 2, Y, Xh, nc)``), which is how the Galerkin probe build runs
all coarse colours at once; the even-half applies take
``(*batch, Y, Xh, nc)``.

The derived operators are coefficient sets computed once from the
original one:

  * ``build_dagger``: M^dagger;
  * ``build_rbjacobi``: the right block Jacobi operator A B^-1, B = clover
    + mass on each site (inverted by batched QR), with B^-1 kept for the
    reconstruction;
  * ``build_rbj_dagger``: (A B^-1)^dagger;
  * ``build_rbj_schur_fused``: the even-odd Schur complement
    S = 1 - D_eo D_oe of the rbjacobi operator on the even half, composed
    into 9 even-half matrices (a diagonal, 4 distance-2, 4 corner), so an
    apply is one stacked matvec over 9 pulls.

``Stencil2D`` holds the original set, builds the derived ones lazily and
caches them (``DERIVED_BUILDS`` counts the builds), and dispatches
``apply_M`` / ``prepare_M`` / ``reconstruct_M`` over the nine
``StencilType``s, and ``apply_sigma`` over the six ``SigmaType``s of the
chirality interface (gamma5 and sigma1, whose defaults operators
override, and the right-block-Jacobi forms B gamma5 and B^-dagger
gamma5). ``build_gather_apply`` is the distance-1 ORIGINAL apply
as an index gather plus one stacked matvec (the solver's
``coarse_apply="gather"``).

Every apply and derived build takes its pull-shifts as a parameter
(``Pulls``): the whole lattice's periodic ones by default, or a mesh's
(``shard_dslash.mesh_pulls``), whose fields are blocks of a lattice cut
over a ``parallel.Mesh`` and whose pulls exchange the halos. The per-site
arithmetic is the same either way; a ``Stencil2D`` takes the pulls of its
``pulls`` attribute.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .lattice import Lattice2D
from .cshift import (cshift_pull, cshift_pull_half, ALL_DIRS, TWOLINK_DIRS,
                     CORNER_DIRS)
from . import linalg

# Opposite slots: +x<->-x, +y<->-y; the twolink and corner slots pair the
# same way (0<->2, 1<->3).
_OPPOSITE_SLOT = (2, 3, 0, 1)

# Builds of each derived coefficient set, over all stencils of the process:
# a solve that rebuilt a set per call would move these.
DERIVED_BUILDS = collections.Counter()


class Pulls(NamedTuple):
    """The pull-shifts that applies and derived builds take: ``full(field,
    direction, batch_dims)`` and ``half(src_half, src_parity, direction,
    batch_dims)``, with ``cshift``'s signatures and results."""
    full: Callable
    half: Callable


# The whole lattice's periodic pulls.
WHOLE = Pulls(cshift_pull, cshift_pull_half)


class StencilType(enum.IntEnum):
    """Matvec variants (same values as qmg_tpu.stencil.StencilType)."""
    ORIGINAL = 0
    DAGGER = 1
    RIGHT_JACOBI = 2
    RIGHT_SCHUR = 3
    M_MDAGGER = 4
    MDAGGER_M = 5
    RBJ_DAGGER = 6
    RBJ_M_MDAGGER = 7
    RBJ_MDAGGER_M = 8


class SigmaType(enum.IntEnum):
    """What ``Stencil2D.apply_sigma`` applies (same values as
    qmg_tpu.stencil.SigmaType)."""
    NONE = 0
    DEFAULT = 1
    GAMMA_5 = 2
    SIGMA_1 = 3
    GAMMA_5_L_RBJ = 4
    GAMMA_5_R_RBJ = 5


class ChiralityState(enum.IntEnum):
    NO = 0
    YES = 1
    UNKNOWN = 2


class DefaultChirality(enum.IntEnum):
    NONE = 0
    GAMMA_5 = 1
    SIGMA_1 = 2


@dataclasses.dataclass
class StencilCoeffs:
    """One coefficient set of a distance-<=2 stencil. ``clover``,
    ``hopping``, ``twolink`` or ``corner`` may be None when the piece does
    not exist."""
    lat: Lattice2D
    clover: Optional[torch.Tensor]
    hopping: Optional[torch.Tensor]
    shift: complex
    eo_shift: complex
    dof_shift: complex
    twolink: Optional[torch.Tensor] = None
    corner: Optional[torch.Tensor] = None
    _stacked: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    def replace(self, **kw) -> "StencilCoeffs":
        """A copy with the given fields replaced (the stacked cache
        dropped)."""
        return dataclasses.replace(self, _stacked=None, **kw)

    def is_distance1(self) -> bool:
        return self.twolink is None and self.corner is None

    def stacked(self) -> torch.Tensor:
        """[clover, hopping_+x, +y, -x, -y] (clover omitted when absent)
        as ``linalg.stack_terms`` lays them out for the set's colour
        count, built once: the matrices of ``apply_M`` and, as a view, of
        ``apply_hopping_half``. Distance-1 sets only."""
        if not self.is_distance1():
            raise ValueError("stacked() serves distance-1 coefficient sets "
                             "(twolink/corner pieces present)")
        if self._stacked is None:
            parts = list(self.hopping)
            if self.clover is not None:
                parts = [self.clover] + parts
            self._stacked = linalg.stack_terms(parts)
        return self._stacked

    def hopping_stacked(self, parity: int) -> torch.Tensor:
        """The four hopping terms at the sites of ``parity`` as
        ``linalg.stack_terms`` lays them out: a view of the hopping (below
        ``linalg.PRODUCT_MIN_NC`` colours) or of ``stacked()``, built on
        each call for a distance-2 set."""
        nc = self.hopping.shape[-1]
        if nc < linalg.PRODUCT_MIN_NC or not self.is_distance1():
            return linalg.stack_terms(self.hopping[:, parity])
        first = nc if self.clover is not None else 0
        return self.stacked()[parity][..., first:first + 4 * nc]

    def to(self, dtype) -> "StencilCoeffs":
        """A copy with every coefficient tensor cast to ``dtype`` on its
        device; the shifts keep their values."""
        def cast(t):
            return None if t is None else t.to(dtype)
        return self.replace(clover=cast(self.clover),
                            hopping=cast(self.hopping),
                            twolink=cast(self.twolink),
                            corner=cast(self.corner))

    @property
    def ref(self) -> torch.Tensor:
        """A coefficient tensor, for the set's dtype and device."""
        return self.clover if self.clover is not None else self.hopping


def _round_scalar(v, dtype) -> complex:
    """A shift as the coefficient dtype holds it (complex64 rounds)."""
    np_dtype = np.complex64 if dtype == torch.complex64 else np.complex128
    return complex(np_dtype(v))


def make_coeffs(lat: Lattice2D, clover=None, hopping=None, shift=0.0,
                eo_shift=0.0, dof_shift=0.0, dtype=torch.complex128,
                twolink=None, corner=None) -> StencilCoeffs:
    return StencilCoeffs(lat=lat, clover=clover, hopping=hopping,
                         shift=_round_scalar(shift, dtype),
                         eo_shift=_round_scalar(eo_shift, dtype),
                         dof_shift=_round_scalar(dof_shift, dtype),
                         twolink=twolink, corner=corner)


def _batch_dims(x) -> int:
    return x.ndim - 4


# ---------------------------------------------------------------------------
# The matvec family.
# ---------------------------------------------------------------------------

def apply_clover(coeffs: StencilCoeffs, x):
    """clover * x on the full lattice."""
    if coeffs.clover is None:
        return torch.zeros_like(x)
    return linalg.site_matvec(coeffs.clover, x)


def _apply_pulled(mats, dirs, x, direction: Optional[int] = None,
                  pulls: Pulls = WHOLE):
    """sum_i mats[i] x(s + dirs[i]) (or only the term of ``direction``)."""
    nb = _batch_dims(x)
    sel = range(len(dirs)) if direction is None else (dirs.index(direction),)
    out = torch.zeros_like(x)
    for i in sel:
        out = out + linalg.site_matvec(mats[i], pulls.full(x, dirs[i], nb))
    return out


def apply_hopping(coeffs: StencilCoeffs, x, direction: Optional[int] = None,
                  pulls: Pulls = WHOLE):
    """Hopping term on both parities; with ``direction``, only that term
    (the Galerkin probe build uses one direction at a time)."""
    if coeffs.hopping is None or coeffs.lat.volume == 1:
        return torch.zeros_like(x)
    return _apply_pulled(coeffs.hopping, ALL_DIRS, x, direction, pulls)


def apply_twolink(coeffs: StencilCoeffs, x, direction: Optional[int] = None,
                  pulls: Pulls = WHOLE):
    """Distance-2 term: sum_mu twolink_mu(s) x(s + 2 mu)."""
    if coeffs.twolink is None or coeffs.lat.volume == 1:
        return torch.zeros_like(x)
    return _apply_pulled(coeffs.twolink, TWOLINK_DIRS, x, direction, pulls)


def apply_corner(coeffs: StencilCoeffs, x, direction: Optional[int] = None,
                 pulls: Pulls = WHOLE):
    """Corner term: sum_{mu,nu} corner_{mu nu}(s) x(s + mu + nu)."""
    if coeffs.corner is None or coeffs.lat.volume == 1:
        return torch.zeros_like(x)
    return _apply_pulled(coeffs.corner, CORNER_DIRS, x, direction, pulls)


def apply_hopping_half(coeffs: StencilCoeffs, x_half, src_parity: int,
                       direction: Optional[int] = None,
                       pulls: Pulls = WHOLE):
    """One parity of the hopping term from a half field: D_eo x_o for
    ``src_parity=1``, D_oe x_e for ``src_parity=0``; returns the
    (*batch, Y, Xh, nc) field on the destination parity."""
    dest = 1 - src_parity
    if coeffs.hopping is None or coeffs.lat.volume == 1:
        return torch.zeros_like(x_half)
    nb = x_half.ndim - 3
    if direction is not None:
        pulled = pulls.half(x_half, src_parity, direction, nb)
        return linalg.site_matvec(coeffs.hopping[direction, dest], pulled)
    pulled = [pulls.half(x_half, src_parity, d, nb) for d in ALL_DIRS]
    return linalg.stacked_site_matvec(coeffs.hopping_stacked(dest), pulled)


def apply_shift(coeffs: StencilCoeffs, x):
    """Mass / even-odd / dof shifts."""
    lat = coeffs.lat
    nc = lat.nc
    nb = _batch_dims(x)
    half = nc // 2
    if lat.volume == 1:
        # The single site lives at parity 0.
        s = coeffs.shift + coeffs.eo_shift
        if nc % 2 == 0:
            d = coeffs.dof_shift
            out = torch.cat([(s + d) * x[..., :half],
                             (s - d) * x[..., half:]], dim=-1)
        else:
            out = s * x
        if x.shape[nb] == 2:
            out = out.clone()
            out.select(nb, 1).zero_()
        return out
    even = (coeffs.shift + coeffs.eo_shift) * x.select(nb, 0)
    odd = (coeffs.shift - coeffs.eo_shift) * x.select(nb, 1)
    out = torch.stack([even, odd], dim=nb)
    if nc % 2 == 0 and coeffs.dof_shift != 0:
        d = coeffs.dof_shift
        out = torch.cat([out[..., :half] + d * x[..., :half],
                         out[..., half:] - d * x[..., half:]], dim=-1)
    return out


def apply_M(coeffs: StencilCoeffs, x, pulls: Pulls = WHOLE):
    """Full operator M x: every coefficient piece as one stacked site
    matvec over [x, x(s+x), x(s+y), x(s-x), x(s-y), (the twolink and
    corner pulls)], plus the shifts."""
    if coeffs.hopping is not None and coeffs.lat.volume > 1:
        nb = _batch_dims(x)
        nbrs = [pulls.full(x, d, nb) for d in ALL_DIRS]
        if coeffs.clover is not None:
            nbrs = [x] + nbrs
        if coeffs.is_distance1():
            mats = coeffs.stacked()
        else:
            mats = list(coeffs.hopping)
            if coeffs.clover is not None:
                mats = [coeffs.clover] + mats
            for piece, dirs in ((coeffs.twolink, TWOLINK_DIRS),
                                (coeffs.corner, CORNER_DIRS)):
                if piece is not None:
                    mats += list(piece)
                    nbrs += [pulls.full(x, d, nb) for d in dirs]
            mats = linalg.stack_terms(mats)
        out = linalg.stacked_site_matvec(mats, nbrs)
        return out + apply_shift(coeffs, x)
    return (apply_clover(coeffs, x) + apply_hopping(coeffs, x, pulls=pulls)
            + apply_twolink(coeffs, x, pulls=pulls)
            + apply_corner(coeffs, x, pulls=pulls) + apply_shift(coeffs, x))


def build_gather_apply(coeffs: StencilCoeffs):
    """The apply as one index gather plus one stacked matvec (port of
    qmg_tpu.stencil.build_gather_apply, the ``coarse_apply="gather"``
    formulation): the neighbour table is ``cshift_pull`` of the site ids,
    built once. Returns apply(x) for an unbatched field, or None where
    qmg_tpu's has none (no clover or hopping, volume 1, or twolink /
    corner pieces)."""
    lat = coeffs.lat
    if (coeffs.hopping is None or coeffs.clover is None or lat.volume <= 1
            or not coeffs.is_distance1()):
        return None
    site_ids = torch.arange(lat.volume).reshape(2, lat.y_len, lat.xh)
    nbr_idx = torch.stack([site_ids.reshape(-1)] + [
        cshift_pull(site_ids, d).reshape(-1) for d in ALL_DIRS]).to(
            coeffs.hopping.device)                      # (5, volume)
    mats = coeffs.stacked()

    def apply_fn(x):
        xg = x.reshape(lat.volume, lat.nc)[nbr_idx]     # (5, volume, nc)
        out = linalg.stacked_site_matvec(
            mats, [g.reshape(x.shape) for g in xg])
        return out + apply_shift(coeffs, x)

    return apply_fn


def apply_M_ee(coeffs: StencilCoeffs, x_even):
    """Clover + shift on the even half."""
    out = torch.zeros_like(x_even)
    if coeffs.clover is not None:
        out = linalg.site_matvec(coeffs.clover[0], x_even)
    return out + coeffs.shift * x_even


def apply_M_oo(coeffs: StencilCoeffs, x_odd):
    """Clover + shift on the odd half."""
    out = torch.zeros_like(x_odd)
    if coeffs.clover is not None:
        out = linalg.site_matvec(coeffs.clover[1], x_odd)
    return out + coeffs.shift * x_odd


# ---------------------------------------------------------------------------
# Derived coefficient sets.
# ---------------------------------------------------------------------------

def build_dagger(coeffs: StencilCoeffs, pulls: Pulls = WHOLE
                 ) -> StencilCoeffs:
    """Coefficients of M^dagger: the clover conj-transposed; the dagger
    coefficient of direction D at s is the conj-transpose of the -D
    coefficient at s + D (every piece); the shifts conjugated."""
    def dagger_piece(mats, dirs):
        if mats is None:
            return None
        return torch.stack([
            linalg.site_conjtrans(pulls.full(mats[_OPPOSITE_SLOT[i]], d))
            for i, d in enumerate(dirs)])

    return coeffs.replace(
        clover=(linalg.site_conjtrans(coeffs.clover)
                if coeffs.clover is not None else None),
        hopping=dagger_piece(coeffs.hopping, ALL_DIRS),
        twolink=dagger_piece(coeffs.twolink, TWOLINK_DIRS),
        corner=dagger_piece(coeffs.corner, CORNER_DIRS),
        shift=coeffs.shift.conjugate(),
        eo_shift=coeffs.eo_shift.conjugate(),
        dof_shift=coeffs.dof_shift.conjugate())


def mass_pattern(coeffs: StencilCoeffs):
    """Per-site diagonal mass matrix with the eo/dof sign structure."""
    lat = coeffs.lat
    nc = lat.nc
    diag_even = np.full((nc,), coeffs.shift + coeffs.eo_shift)
    diag_odd = np.full((nc,), coeffs.shift - coeffs.eo_shift)
    if nc % 2 == 0:
        sgn = np.concatenate([np.ones(nc // 2), -np.ones(nc // 2)])
        diag_even = diag_even + coeffs.dof_shift * sgn
        diag_odd = diag_odd + coeffs.dof_shift * sgn
    if lat.volume == 1:
        diag_odd = diag_even
    pat = torch.as_tensor(np.stack([np.diag(diag_even), np.diag(diag_odd)]),
                          dtype=coeffs.ref.dtype, device=coeffs.ref.device)
    return pat[:, None, None].expand(lat.cm_shape()).clone()


@dataclasses.dataclass
class RBJacobiSet:
    """The rbjacobi coefficient set and B^-1 = (clover + mass)^-1
    (2, Y, Xh, nc, nc), which the reconstruction applies."""
    coeffs: StencilCoeffs
    cinv: torch.Tensor


def build_rbjacobi(coeffs: StencilCoeffs, pulls: Pulls = WHOLE
                   ) -> RBJacobiSet:
    """Right block Jacobi A B^-1, B = clover + mass: clover the identity,
    each piece of direction D at s right-multiplied by B^-1(s + D), shifts
    zero."""
    b = mass_pattern(coeffs)
    if coeffs.clover is not None:
        b = b + coeffs.clover
    cinv = linalg.site_inv_qr(b)

    def rbj_piece(mats, dirs):
        if mats is None:
            return None
        return torch.stack([linalg.site_matmul(mats[i], pulls.full(cinv, d))
                            for i, d in enumerate(dirs)])

    rbj = coeffs.replace(clover=linalg.identity_like(b),
                         hopping=rbj_piece(coeffs.hopping, ALL_DIRS),
                         twolink=rbj_piece(coeffs.twolink, TWOLINK_DIRS),
                         corner=rbj_piece(coeffs.corner, CORNER_DIRS),
                         shift=0j, eo_shift=0j, dof_shift=0j)
    return RBJacobiSet(coeffs=rbj, cinv=cinv)


def build_rbj_dagger(rbj: RBJacobiSet, pulls: Pulls = WHOLE
                     ) -> RBJacobiSet:
    """(A B^-1)^dagger, with B^-dagger."""
    dag = build_dagger(rbj.coeffs, pulls).replace(shift=0j, eo_shift=0j,
                                           dof_shift=0j)
    return RBJacobiSet(coeffs=dag, cinv=linalg.site_conjtrans(rbj.cinv))


# ---------------------------------------------------------------------------
# The even-odd Schur complement of the rbjacobi operator, on even-half
# fields (*batch, Y, Xh, nc). D_ee = D_oo = 1 in the rbjacobi basis.
# ---------------------------------------------------------------------------

def _refuse_distance2(coeffs: StencilCoeffs):
    # The parity-preserving twolink / corner pieces would make D_ee and
    # D_oo non-diagonal, and the eo Schur complement below wrong.
    if not coeffs.is_distance1():
        raise ValueError("eo-Schur requires a distance-1 stencil "
                         "(twolink/corner pieces present)")


def apply_rbj_schur(rbj: RBJacobiSet, x_even, pulls: Pulls = WHOLE):
    """(1 - D_eo D_oe) x_e as two half-hopping applies."""
    _refuse_distance2(rbj.coeffs)
    t_odd = apply_hopping_half(rbj.coeffs, x_even, 0, pulls=pulls)
    return x_even - apply_hopping_half(rbj.coeffs, t_odd, 1, pulls=pulls)


@dataclasses.dataclass
class SchurFused:
    """The Schur complement composed into 9 even-half matrices [diagonal,
    twolink {+2X, +2Y, -2X, -2Y}, corner {+X+Y, -X+Y, -X-Y, +X-Y}], held
    as ``linalg.stack_terms`` lays them out (``stacked``); ``mats`` is
    qmg_tpu's ``schurf`` stacking (9, Y, Xh, nc, nc), a view of it."""
    stacked: torch.Tensor

    @property
    def mats(self):
        return linalg.unstack_terms(self.stacked, 9)

    @property
    def clover(self):
        return self.mats[0]

    @property
    def twolink(self):
        return self.mats[1:5]

    @property
    def corner(self):
        return self.mats[5:9]


# (d2, d1) hopping-slot pairs of each composed offset: d2 the eo (second)
# hop, d1 the oe (first) hop; slots {+x, +y, -x, -y}.
_SCHUR_ZERO_PAIRS = tuple((d2, _OPPOSITE_SLOT[d2]) for d2 in range(4))
_SCHUR_TWOLINK_PAIRS = (((0, 0),), ((1, 1),), ((2, 2),), ((3, 3),))
_SCHUR_CORNER_PAIRS = (((0, 1), (1, 0)), ((2, 1), (1, 2)),
                       ((2, 3), (3, 2)), ((0, 3), (3, 0)))


def build_rbj_schur_fused(rbj: RBJacobiSet, pulls: Pulls = WHOLE
                          ) -> SchurFused:
    """Compose S = 1 - D_eo D_oe: (D_eo D_oe x)(s_e) = sum_{d2, d1}
    H[d2, even](s_e) H[d1, odd](s_e + d2) x(s_e + d2 + d1), grouped by the
    total offset (zero, distance 2, corner)."""
    _refuse_distance2(rbj.coeffs)
    h = rbj.coeffs.hopping                # (4, 2, Y, Xh, nc, nc)
    h_even = h[:, 0]
    # pulled[d2][d1]: H[d1, odd] at s_e + d2, aligned to the even slots.
    pulled = [[pulls.half(h[d1, 1], 1, ALL_DIRS[d2], 0) for d1 in range(4)]
              for d2 in range(4)]

    def compose(pairs):
        out = None
        for d2, d1 in pairs:
            term = linalg.site_matmul(h_even[d2], pulled[d2][d1])
            out = term if out is None else out + term
        return out

    diag = linalg.identity_like(h_even[0]) - compose(_SCHUR_ZERO_PAIRS)
    return SchurFused(stacked=linalg.stack_terms(
        [diag] + [-compose(p) for p in _SCHUR_TWOLINK_PAIRS]
        + [-compose(p) for p in _SCHUR_CORNER_PAIRS]))


def apply_rbj_schur_fused(fused: SchurFused, x_even, pulls: Pulls = WHOLE):
    """S x_e as one stacked matvec over the 9 composed terms."""
    nb = x_even.ndim - 3
    nbrs = [x_even] + [pulls.half(x_even, 0, d, nb)
                       for d in TWOLINK_DIRS + CORNER_DIRS]
    return linalg.stacked_site_matvec(fused.stacked, nbrs)


def prepare_rbj_schur(rbj: RBJacobiSet, b, pulls: Pulls = WHOLE):
    """b_r = b_e - D_eo b_o (D_oo = 1)."""
    nb = b.ndim - 4
    return b.select(nb, 0) - apply_hopping_half(rbj.coeffs, b.select(nb, 1),
                                                1, pulls=pulls)


def reconstruct_rbj_schur(rbj: RBJacobiSet, y_even, b, pulls: Pulls = WHOLE):
    """x_e = B_e^-1 y_e, x_o = B_o^-1 (b_o - D_oe y_e)."""
    nb = b.ndim - 4
    t_odd = apply_hopping_half(rbj.coeffs, y_even, 0, pulls=pulls)
    x_e = linalg.site_matvec(rbj.cinv[0], y_even)
    x_o = linalg.site_matvec(rbj.cinv[1], b.select(nb, 1) - t_odd)
    return torch.stack([x_e, x_o], dim=nb)


# ---------------------------------------------------------------------------
# The stateful wrapper.
# ---------------------------------------------------------------------------

class Stencil2D:
    """An original coefficient set, the derived sets built from it on
    first use and cached, and the uniform apply/prepare/reconstruct
    dispatch over the nine ``StencilType``s. ``apply_override``, when set,
    replaces the ORIGINAL apply (the solver installs the CUDA kernels and
    the gather apply here); it must compute the full ``apply_M``. The
    derived types never take it. ``pulls`` are the pull-shifts of every
    apply and derived build: ``WHOLE`` for a whole lattice, a mesh's
    (``shard_dslash.mesh_pulls``) for a stencil that holds one block of a
    lattice cut over ranks, or that a solve on an in-process mesh applies
    block by block."""

    def __init__(self, coeffs: StencilCoeffs):
        self.coeffs = coeffs
        self.apply_override = None
        self.pulls = WHOLE
        self._dagger: Optional[StencilCoeffs] = None
        self._rbjacobi: Optional[RBJacobiSet] = None
        self._rbj_dagger: Optional[RBJacobiSet] = None
        self._rbj_schur_fused: Optional[SchurFused] = None

    @property
    def lat(self) -> Lattice2D:
        return self.coeffs.lat

    # --- updates drop the derived sets ---
    def update_shifts(self, shift=None, eo_shift=None, dof_shift=None):
        kw = {name: _round_scalar(v, self.coeffs.ref.dtype)
              for name, v in (("shift", shift), ("eo_shift", eo_shift),
                              ("dof_shift", dof_shift)) if v is not None}
        self.coeffs = self.coeffs.replace(**kw)
        self.invalidate_derived()

    def update_coeffs(self, clover=None, hopping=None):
        kw = {name: v for name, v in (("clover", clover),
                                      ("hopping", hopping)) if v is not None}
        self.coeffs = self.coeffs.replace(**kw)
        self.invalidate_derived()

    def clear_stencils(self):
        """Zero the clover and hopping pieces (reference clear_stencils,
        stencil_2d.h:339-375)."""
        c = self.coeffs
        self.coeffs = c.replace(**{
            name: torch.zeros_like(getattr(c, name))
            for name in ("clover", "hopping") if getattr(c, name) is not None})
        self.invalidate_derived()

    def prune_stencils(self, clover: bool = False, hopping: bool = False):
        """Drop the clover and / or hopping piece (reference
        prune_stencils, stencil_2d.h:379-404)."""
        kw = {name: None for name, drop in (("clover", clover),
                                            ("hopping", hopping)) if drop}
        if kw:
            self.coeffs = self.coeffs.replace(**kw)
            self.invalidate_derived()

    def try_prune_stencils(self, tol: float, clover: bool = True,
                           hopping: bool = True):
        """Drop each of the named pieces whose largest magnitude is below
        ``tol`` (reference try_prune_stencils, stencil_2d.h:407-431)."""
        def small(piece):
            return piece is not None and float(piece.abs().max()) < tol
        self.prune_stencils(clover=clover and small(self.coeffs.clover),
                            hopping=hopping and small(self.coeffs.hopping))

    def invalidate_derived(self):
        self._dagger = None
        self._rbjacobi = None
        self._rbj_dagger = None
        self._rbj_schur_fused = None

    # --- lazily built derived sets ---
    @property
    def built_dagger(self) -> bool:
        return self._dagger is not None

    @property
    def built_rbjacobi(self) -> bool:
        return self._rbjacobi is not None

    @property
    def built_rbj_dagger(self) -> bool:
        return self._rbj_dagger is not None

    @property
    def built_rbj_schur_fused(self) -> bool:
        return self._rbj_schur_fused is not None

    def build_dagger_stencil(self) -> StencilCoeffs:
        if self._dagger is None:
            self._dagger = build_dagger(self.coeffs, self.pulls)
            DERIVED_BUILDS["dagger"] += 1
        return self._dagger

    def build_rbjacobi_stencil(self) -> RBJacobiSet:
        if self._rbjacobi is None:
            c = self.coeffs
            if (c.clover is None and c.shift == 0 and c.eo_shift == 0
                    and c.dof_shift == 0):
                raise ValueError("rbjacobi requires a clover term or shift")
            self._rbjacobi = build_rbjacobi(c, self.pulls)
            DERIVED_BUILDS["rbjacobi"] += 1
        return self._rbjacobi

    def build_rbj_dagger_stencil(self) -> RBJacobiSet:
        if self._rbj_dagger is None:
            self._rbj_dagger = build_rbj_dagger(
                self.build_rbjacobi_stencil(), self.pulls)
            DERIVED_BUILDS["rbj_dagger"] += 1
        return self._rbj_dagger

    def _schur_fused(self) -> Optional[SchurFused]:
        """The fused Schur set, or None where the two half applies serve
        (no hopping, or volume 1)."""
        rbj = self.build_rbjacobi_stencil()
        if rbj.coeffs.hopping is None or self.lat.volume <= 1:
            return None
        if self._rbj_schur_fused is None:
            self._rbj_schur_fused = build_rbj_schur_fused(rbj, self.pulls)
            DERIVED_BUILDS["schur_fused"] += 1
        return self._rbj_schur_fused

    @property
    def dagger_coeffs(self) -> StencilCoeffs:
        return self.build_dagger_stencil()

    @property
    def rbjacobi(self) -> RBJacobiSet:
        return self.build_rbjacobi_stencil()

    @property
    def rbj_dagger(self) -> RBJacobiSet:
        return self.build_rbj_dagger_stencil()

    def prebuild_derived(self, stype: StencilType):
        """Build now the derived sets that ``apply_M(x, stype)`` and its
        prepare / reconstruct pair use."""
        t = StencilType(stype)
        if t in (StencilType.DAGGER, StencilType.M_MDAGGER,
                 StencilType.MDAGGER_M):
            self.build_dagger_stencil()
        elif t == StencilType.RIGHT_JACOBI:
            self.build_rbjacobi_stencil()
        elif t == StencilType.RIGHT_SCHUR:
            self._schur_fused()
        elif t in (StencilType.RBJ_DAGGER, StencilType.RBJ_M_MDAGGER,
                   StencilType.RBJ_MDAGGER_M):
            self.build_rbj_dagger_stencil()

    def print_stencil_site(self, x: int, y: int, prefix: str = "",
                           which: str = "original"):
        """Print the stencil at site (x, y): the nonzero shifts, the clover
        and the four hopping matrices, and for the rbjacobi variants B^-1
        (reference print_stencil_site, stencil_2d.h:447-635). ``which``
        is "original", "dagger", "rbjacobi" or "rbj_dagger"."""
        if which == "original":
            coeffs, cinv = self.coeffs, None
        elif which == "dagger":
            coeffs, cinv = self.dagger_coeffs, None
        elif which == "rbjacobi":
            coeffs, cinv = self.rbjacobi.coeffs, self.rbjacobi.cinv
        elif which == "rbj_dagger":
            coeffs, cinv = self.rbj_dagger.coeffs, self.rbj_dagger.cinv
        else:
            raise ValueError(f"unknown stencil variant {which}")
        p, yy, xh = self.lat.coord_to_pyx(x, y)

        def rows(mat):
            for row in mat.cpu().numpy():
                print(prefix + " ".join(str(v) for v in row))
        for name, val in (("Shift", coeffs.shift),
                          ("EO-Shift", coeffs.eo_shift),
                          ("DOF-Shift", coeffs.dof_shift)):
            if complex(val) != 0:
                print(f"{prefix}{name} {complex(val)}")
        if coeffs.clover is not None:
            print(f"{prefix}Clover")
            rows(coeffs.clover[p, yy, xh])
        if coeffs.hopping is not None:
            for d, label in enumerate(("+x", "+y", "-x", "-y")):
                print(f"{prefix}Hopping {label}")
                rows(coeffs.hopping[d, p, yy, xh])
        if cinv is not None:
            print(f"{prefix}Right Block Jacobi Inv Clover")
            rows(cinv[p, yy, xh])

    # --- uniform dispatch ---
    def apply_M(self, x, stype: StencilType = StencilType.ORIGINAL):
        t, p = StencilType(stype), self.pulls
        if t == StencilType.ORIGINAL:
            if self.apply_override is not None:
                return self.apply_override(x)
            return apply_M(self.coeffs, x, p)
        if t == StencilType.DAGGER:
            return apply_M(self.dagger_coeffs, x, p)
        if t == StencilType.RIGHT_JACOBI:
            return apply_M(self.rbjacobi.coeffs, x, p)
        if t == StencilType.RIGHT_SCHUR:
            fused = self._schur_fused()
            if fused is None:
                return apply_rbj_schur(self.rbjacobi, x, p)
            return apply_rbj_schur_fused(fused, x, p)
        if t == StencilType.M_MDAGGER:
            return apply_M(self.coeffs, apply_M(self.dagger_coeffs, x, p), p)
        if t == StencilType.MDAGGER_M:
            return apply_M(self.dagger_coeffs, apply_M(self.coeffs, x, p), p)
        if t == StencilType.RBJ_DAGGER:
            return apply_M(self.rbj_dagger.coeffs, x, p)
        if t == StencilType.RBJ_M_MDAGGER:
            return apply_M(self.rbjacobi.coeffs,
                           apply_M(self.rbj_dagger.coeffs, x, p), p)
        return apply_M(self.rbj_dagger.coeffs,
                       apply_M(self.rbjacobi.coeffs, x, p), p)  # RBJ_MDAGGER_M

    def prepare_M(self, b, stype: StencilType = StencilType.ORIGINAL):
        """b -> the right-hand side of the chosen solve."""
        t, p = StencilType(stype), self.pulls
        if t == StencilType.RIGHT_SCHUR:
            return prepare_rbj_schur(self.rbjacobi, b, p)
        if t == StencilType.MDAGGER_M:
            return apply_M(self.dagger_coeffs, b, p)
        if t == StencilType.RBJ_MDAGGER_M:
            return apply_M(self.rbj_dagger.coeffs, b, p)
        return b

    def reconstruct_M(self, y, b, stype: StencilType = StencilType.ORIGINAL):
        """The chosen solve's result y -> x with M x = b."""
        t, p = StencilType(stype), self.pulls
        if t == StencilType.RIGHT_JACOBI:
            return linalg.site_matvec(self.rbjacobi.cinv, y)
        if t == StencilType.RIGHT_SCHUR:
            return reconstruct_rbj_schur(self.rbjacobi, y, b, p)
        if t == StencilType.M_MDAGGER:
            return apply_M(self.dagger_coeffs, y, p)
        if t == StencilType.RBJ_M_MDAGGER:
            return linalg.site_matvec(self.rbjacobi.cinv,
                                      apply_M(self.rbj_dagger.coeffs, y, p))
        if t == StencilType.RBJ_MDAGGER_M:
            return linalg.site_matvec(self.rbjacobi.cinv, y)
        return y

    def get_apply_function(self, stype: StencilType = StencilType.ORIGINAL):
        t = StencilType(stype)
        return lambda x: self.apply_M(x, t)

    def solve_size_shape(self, stype: StencilType = StencilType.ORIGINAL):
        """Shape of the Krylov vector of a solve of type ``stype``: the
        even half (Y, Xh, nc) for RIGHT_SCHUR, else the full field."""
        lat = self.lat
        if StencilType(stype) == StencilType.RIGHT_SCHUR:
            return (lat.y_len, lat.xh, lat.nc)
        return lat.cv_shape()

    # --- chirality interface; operators override ---
    @staticmethod
    def get_dof(i: int = 0) -> int:
        return -1

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.UNKNOWN

    def get_default_chirality(self) -> DefaultChirality:
        raise NotImplementedError

    def gamma5(self, x):
        """Default gamma5: the identity."""
        return x

    def sigma1(self, x):
        """Default sigma1: swap the two dof halves; the identity for odd
        nc."""
        nc = self.lat.nc
        if nc % 2:
            return x
        half = nc // 2
        return torch.cat([x[..., half:], x[..., :half]], dim=-1)

    def chiral_projection(self, x, is_up: bool):
        raise NotImplementedError

    def chiral_projection_both(self, x):
        """(up, down) chiral projections."""
        return (self.chiral_projection(x, True),
                self.chiral_projection(x, False))

    def apply_sigma(self, x, stype: SigmaType = SigmaType.DEFAULT):
        """x under one of the chirality operators: gamma5, sigma1, the
        default chirality's, B gamma5 (GAMMA_5_R_RBJ, B = clover + shift)
        or B^-dagger gamma5 (GAMMA_5_L_RBJ, from the rbj-dagger set)."""
        t = SigmaType(stype)
        if t == SigmaType.NONE:
            return x
        if t == SigmaType.DEFAULT:
            dc = self.get_default_chirality()
            if dc == DefaultChirality.GAMMA_5:
                return self.gamma5(x)
            if dc == DefaultChirality.SIGMA_1:
                return self.sigma1(x)
            return x
        if t == SigmaType.GAMMA_5:
            return self.gamma5(x)
        if t == SigmaType.SIGMA_1:
            return self.sigma1(x)
        g = self.gamma5(x)
        if t == SigmaType.GAMMA_5_R_RBJ:
            return apply_clover(self.coeffs, g) + self.coeffs.shift * g
        return linalg.site_matvec(self.rbj_dagger.cinv, g)  # GAMMA_5_L_RBJ
