"""Galerkin coarse operator built by probing (port of
qmg_tpu/operators/coarse.py, chirality/gamma5 part).

The fine set probed is the fine stencil's original one, or with
``use_rbjacobi`` its right-block-Jacobi form A B^-1 (the n19 Schur path).

For each coarse colour (and parity, and direction) the probe build sets 1 on
coarse sites, prolongs, applies one fine stencil piece, restricts, and
scatters the response into the coarse clover (same-parity rows) or the
coarse hopping term (opposite-parity rows) - exact for distance-1 fine
stencils. All coarse colours run at once as a leading batch axis.
A coarse volume of 1 folds everything into the clover; a coarse
dimension of 1 folds that direction's hopping into the clover.
"""

from __future__ import annotations

import torch

from ..lattice import Lattice2D, DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from ..stencil import (Stencil2D, StencilCoeffs, make_coeffs, apply_clover,
                       apply_hopping, DefaultChirality)
from ..transfer import TransferMG, DoublingType


def build_coarse_coeffs(coarse_lat: Lattice2D, fine_coeffs: StencilCoeffs,
                        transfer: TransferMG) -> StencilCoeffs:
    """Probe-build the coarse clover + hopping from a fine coefficient set
    (``stencil.coeffs``, or ``stencil.rbjacobi.coeffs`` to coarsen the
    right-block-Jacobi operator)."""
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
        clover = clover + response(lambda f: apply_hopping(fine_coeffs, f))
        return make_coeffs(coarse_lat, clover=clover, hopping=hopping,
                           shift=fine_coeffs.shift, dtype=dtype)

    dim_of_dir = {DIR_XP1: 0, DIR_YP1: 1, DIR_XM1: 0, DIR_YM1: 1}
    for d in (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1):
        folds = coarse_lat.get_dim_mu(dim_of_dir[d]) == 1
        for parity in (0, 1):
            res = response(
                lambda f, d=d: apply_hopping(fine_coeffs, f, direction=d),
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
        coeffs = build_coarse_coeffs(coarse_lat, fine_coeffs, transfer)
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
        doubling = transfer.get_doubling()
        if doubling == DoublingType.PROJECTION:
            self._default_chirality = DefaultChirality.GAMMA_5
        elif doubling == DoublingType.OPERATOR:
            self._default_chirality = DefaultChirality.SIGMA_1
        else:
            self._default_chirality = DefaultChirality.NONE

    def get_default_chirality(self) -> DefaultChirality:
        return self._default_chirality

    def chiral_projection(self, x, is_up: bool):
        """gamma5 chirality: keep the top (up) or bottom (down) dof half."""
        if not self.is_chiral \
                or self._default_chirality == DefaultChirality.NONE:
            return x
        if self._default_chirality != DefaultChirality.GAMMA_5:
            raise NotImplementedError("only gamma5 coarse chirality is "
                                      "ported")
        half = self.lat.nc // 2
        out = x.clone()
        if is_up:
            out[..., half:] = 0
        else:
            out[..., :half] = 0
        return out
