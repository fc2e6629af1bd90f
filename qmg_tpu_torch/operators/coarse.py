"""Galerkin coarse operator built by probing, with the coarse chirality
operators (port of qmg_tpu/operators/coarse.py).

The fine set probed is the fine stencil's original one, or with
``use_rbjacobi`` its right-block-Jacobi form A B^-1 (the n19 Schur path).

For each coarse colour (and parity, and direction) the probe build sets 1 on
coarse sites, prolongs, applies one fine stencil piece, restricts, and
scatters the response into the coarse clover (same-parity rows) or the
coarse hopping term (opposite-parity rows) - exact for distance-1 fine
stencils. All coarse colours run at once as a leading batch axis.
A coarse volume of 1 folds everything into the clover; a coarse
dimension of 1 folds that direction's hopping into the clover.

The coarse chirality follows the transfer's doubling: gamma5 (a sign on
the lower dof half) after projection doubling, sigma1 (the dof halves
swapped) after operator doubling. ``apply_coarse_sigma`` applies sigma1
carried through the transfer's saved block decompositions: with the
Cholesky factor C of a symmetric transfer, C sigma1 C^-1 on both sides;
with the L / U factors of an asymmetric one, L^dagger sigma1 U^-1 on the
left and U sigma1 L^-dagger on the right; and the two right-block-Jacobi
forms B^-dagger sigma1^L and B sigma1^R.
"""

from __future__ import annotations

import torch

from ..lattice import Lattice2D, DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from ..stencil import (Stencil2D, StencilCoeffs, make_coeffs, apply_clover,
                       apply_hopping, DefaultChirality, Pulls, WHOLE)
from ..transfer import TransferMG, DoublingType
from .. import linalg


class CoarseSigmaType:
    """What ``CoarseOperator2D.apply_coarse_sigma`` applies (the values of
    qmg_tpu.operators.coarse.CoarseSigmaType, after ``SigmaType``'s)."""
    SIGMA_1_L = 6
    SIGMA_1_R = 7
    SIGMA_1_L_RBJ = 8
    SIGMA_1_R_RBJ = 9


def build_coarse_coeffs(coarse_lat: Lattice2D, fine_coeffs: StencilCoeffs,
                        transfer: TransferMG, pulls: Pulls = WHOLE
                        ) -> StencilCoeffs:
    """Probe-build the coarse clover + hopping from a fine coefficient set
    (``stencil.coeffs``, or ``stencil.rbjacobi.coeffs`` to coarsen the
    right-block-Jacobi operator). On the blocks of a mesh, ``pulls`` are
    the mesh's and ``transfer`` a ``ShardedTransferMG``: the probes are
    whole, prolonged onto the blocks, each piece applied with the halos
    of the prolonged probe batch, and the responses restricted and
    joined (gathered over the ranks) into the whole coarse level."""
    if not fine_coeffs.is_distance1():
        # The probe responses are sorted into coarse clover and hopping by
        # fine parity, which is exact only when every coupling flips it.
        raise ValueError("Galerkin probe build requires a distance-1 "
                         "fine stencil (twolink/corner pieces present)")
    nc = coarse_lat.nc
    ref = (fine_coeffs.clover if fine_coeffs.clover is not None
           else fine_coeffs.hopping)
    dtype, device = ref.dtype, ref.device
    colors = torch.arange(nc, device=device)

    def probes(parity=None):
        """(nc, 2, Yc, Xhc, nc): batch entry c is 1 at dof c on every
        coarse site (or on one parity)."""
        v = torch.zeros((nc,) + coarse_lat.cv_shape(), dtype=dtype,
                        device=device)
        if parity is None:
            v[colors, :, :, :, colors] = 1.0
        else:
            v[colors, parity, :, :, colors] = 1.0
        return v

    def response(apply_piece, parity=None):
        """Restricted responses as (2, Yc, Xhc, row, col)."""
        fine = transfer.prolong_c2f(probes(parity))
        res = transfer.restrict_f2c(apply_piece(fine))
        return torch.movedim(res, 0, -1).contiguous()

    clover = response(lambda f: apply_clover(fine_coeffs, f))
    hopping = torch.zeros(coarse_lat.hopping_shape(), dtype=dtype,
                          device=device)
    if fine_coeffs.hopping is None:
        return make_coeffs(coarse_lat, clover=clover, hopping=hopping,
                           shift=fine_coeffs.shift, dtype=dtype)

    if coarse_lat.volume == 1:
        clover = clover + response(
            lambda f: apply_hopping(fine_coeffs, f, pulls=pulls))
        return make_coeffs(coarse_lat, clover=clover, hopping=hopping,
                           shift=fine_coeffs.shift, dtype=dtype)

    dim_of_dir = {DIR_XP1: 0, DIR_YP1: 1, DIR_XM1: 0, DIR_YM1: 1}
    for d in (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1):
        folds = coarse_lat.get_dim_mu(dim_of_dir[d]) == 1
        for parity in (0, 1):
            res = response(
                lambda f, d=d: apply_hopping(fine_coeffs, f, direction=d,
                                             pulls=pulls),
                parity)
            other = 1 - parity
            clover[parity] += res[parity]
            if folds:
                clover[other] += res[other]
            else:
                hopping[d, other] += res[other]
    return make_coeffs(coarse_lat, clover=clover, hopping=hopping,
                       shift=fine_coeffs.shift, dtype=dtype)


class CoarseOperator2D(Stencil2D):
    """The Galerkin coarse operator of ``fine_stencil`` (or, with
    ``use_rbjacobi``, of its rbjacobi form) through ``transfer``, with the
    coarse chirality learned from the transfer's doubling type.
    ``build_extra`` (a ``BUILD_*`` constant) builds derived sets of the
    coarse operator at once."""

    BUILD_ORIGINAL = 0
    BUILD_DAGGER = 1
    BUILD_RBJACOBI = 2
    BUILD_DAGGER_RBJACOBI = 3
    BUILD_RBJDAGGER = 4
    BUILD_ALL = 5

    def __init__(self, coarse_lat: Lattice2D, fine_stencil: Stencil2D,
                 transfer: TransferMG, is_chiral: bool = False,
                 use_rbjacobi: bool = False,
                 build_extra: int = BUILD_ORIGINAL):
        fine_coeffs = (fine_stencil.rbjacobi.coeffs if use_rbjacobi
                       else fine_stencil.coeffs)
        coeffs = build_coarse_coeffs(coarse_lat, fine_coeffs, transfer,
                                     fine_stencil.pulls)
        self._init(coeffs, transfer, is_chiral, use_rbjacobi)
        if build_extra in (self.BUILD_DAGGER, self.BUILD_DAGGER_RBJACOBI,
                           self.BUILD_ALL):
            self.build_dagger_stencil()
        if build_extra in (self.BUILD_RBJACOBI, self.BUILD_DAGGER_RBJACOBI,
                           self.BUILD_RBJDAGGER, self.BUILD_ALL):
            self.build_rbjacobi_stencil()
        if build_extra in (self.BUILD_RBJDAGGER, self.BUILD_ALL):
            self.build_rbj_dagger_stencil()

    @classmethod
    def from_coeffs(cls, coeffs: StencilCoeffs, transfer: TransferMG,
                    is_chiral: bool = True, use_rbjacobi: bool = False
                    ) -> "CoarseOperator2D":
        """Adopt a coarse coefficient set built elsewhere (a state dict)."""
        op = cls.__new__(cls)
        op._init(coeffs, transfer, is_chiral, use_rbjacobi)
        return op

    def _init(self, coeffs, transfer, is_chiral, use_rbjacobi):
        Stencil2D.__init__(self, coeffs)
        self.is_chiral = is_chiral
        self.use_rbjacobi = use_rbjacobi
        self.in_transfer = transfer
        self._sigma_1_L = self._sigma_1_R = None
        doubling = transfer.get_doubling()
        if doubling == DoublingType.PROJECTION:
            self._default_chirality = DefaultChirality.GAMMA_5
        elif doubling == DoublingType.OPERATOR:
            self._default_chirality = DefaultChirality.SIGMA_1
        else:
            self._default_chirality = DefaultChirality.NONE

    def get_default_chirality(self) -> DefaultChirality:
        return self._default_chirality

    def gamma5(self, x):
        """A sign flip on the lower dof half (the identity when the level
        is not chiral)."""
        if not self.is_chiral:
            return x
        half = self.lat.nc // 2
        return torch.cat([x[..., :half], -x[..., half:]], dim=-1)

    def chiral_projection(self, x, is_up: bool):
        """gamma5 chirality: keep the upper (up) or lower (down) dof half;
        sigma1 chirality: (x +- sigma1 x) / 2."""
        if not self.is_chiral:
            return x
        if self._default_chirality == DefaultChirality.GAMMA_5:
            half = self.lat.nc // 2
            out = x.clone()
            if is_up:
                out[..., half:] = 0
            else:
                out[..., :half] = 0
            return out
        if self._default_chirality == DefaultChirality.SIGMA_1:
            s = self.sigma1(x)
            return 0.5 * (x + s) if is_up else 0.5 * (x - s)
        return x

    # --- sigma1 through the transfer's saved decompositions ---
    def _build_sigma_lr(self):
        if self._sigma_1_L is not None:
            return
        t = self.in_transfer
        if not t.has_decompositions():
            raise ValueError("the coarse sigma operators need the "
                             "transfer's saved block decompositions "
                             "(TransferMG(save_decomp=True))")
        nc = self.lat.nc
        half = nc // 2
        ref = self.coeffs.ref
        s1 = torch.zeros((nc, nc), dtype=ref.dtype, device=ref.device)
        idx = torch.arange(half, device=ref.device)
        s1[idx, idx + half] = 1.0
        s1[idx + half, idx] = 1.0

        def pad_parity(m):
            """A point coarse lattice's factors live on one (1, 1, 1) site;
            the field layout has two parities."""
            if m.shape[0] == 1 and self.lat.volume == 1:
                return torch.cat([m, m])
            return m

        if t.is_symmetric():
            chol = pad_parity(t.block_cholesky)
            s_l = linalg.site_matmul(chol, linalg.site_matmul(
                s1.expand(chol.shape), linalg.site_inv_qr(chol)))
            self._sigma_1_L = self._sigma_1_R = s_l
            return
        lower, upper = pad_parity(t.block_L), pad_parity(t.block_U)
        ldag = linalg.site_conjtrans(lower)
        s1b = s1.expand(upper.shape)
        self._sigma_1_L = linalg.site_matmul(
            ldag, linalg.site_matmul(s1b, linalg.site_inv_qr(upper)))
        self._sigma_1_R = linalg.site_matmul(
            upper, linalg.site_matmul(s1b, linalg.site_inv_qr(ldag)))

    def apply_coarse_sigma(self, x, ctype: int):
        """x under one of the ``CoarseSigmaType`` operators."""
        self._build_sigma_lr()
        if ctype == CoarseSigmaType.SIGMA_1_L:
            return linalg.site_matvec(self._sigma_1_L, x)
        if ctype == CoarseSigmaType.SIGMA_1_R:
            return linalg.site_matvec(self._sigma_1_R, x)
        if ctype == CoarseSigmaType.SIGMA_1_L_RBJ:
            y = linalg.site_matvec(self._sigma_1_L, x)
            return linalg.site_matvec(self.rbj_dagger.cinv, y)
        if ctype == CoarseSigmaType.SIGMA_1_R_RBJ:
            y = linalg.site_matvec(self._sigma_1_R, x)
            return apply_clover(self.coeffs, y) + self.coeffs.shift * y
        raise ValueError(f"invalid coarse sigma type {ctype}")
