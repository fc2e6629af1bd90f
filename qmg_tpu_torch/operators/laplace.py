"""Free and U(1)-gauged 2D Laplace operators, nc = 1 (port of
qmg_tpu/operators/laplace.py).

    clover        = 4
    hopping_{+mu} = -U_mu(s)
    hopping_{-mu} = -conj(U_mu(s - mu))
    shift         = m^2

``FreeLaplace2D`` has every link 1. ``GaugedLaplace2D`` also solves its
even-odd Schur system: (4 + m^2)^2 - D_eo D_oe on the even half.
"""

from __future__ import annotations

import torch

from ..lattice import Lattice2D, DIR_XM1, DIR_YM1
from ..cshift import cshift_pull
from ..stencil import (Stencil2D, make_coeffs, ChiralityState,
                       DefaultChirality, apply_hopping_half)
from .. import linalg


def _u1_hopping(gauge, scale, *, dtype, device):
    """The nc = 1 hopping term (4, 2, Y, Xh, 1, 1) of a (2, 2, Y, Xh)
    gauge: the forward links and the conjugated links pulled from the
    backward neighbour, direction d scaled by ``scale[d]``."""
    gauge = torch.as_tensor(gauge).to(device=device, dtype=dtype)
    ux, uy = gauge[0], gauge[1]
    hop = torch.stack([
        scale[0] * ux,
        scale[1] * uy,
        scale[2] * torch.conj(cshift_pull(ux, DIR_XM1)),
        scale[3] * torch.conj(cshift_pull(uy, DIR_YM1)),
    ]).resolve_conj()
    return hop[..., None, None]


def _laplace_clover(lat: Lattice2D, *, dtype, device):
    return 4.0 * linalg.identity_like(
        torch.zeros(lat.cm_shape(), dtype=dtype, device=device))


class _NoChirality:
    """The Laplace operators have one dof and no chirality."""

    @staticmethod
    def get_dof(i: int = 0) -> int:
        return 1

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.NO

    def get_default_chirality(self) -> DefaultChirality:
        return DefaultChirality.NONE

    def chiral_projection(self, x, is_up: bool):
        return x


class FreeLaplace2D(_NoChirality, Stencil2D):
    """Free Laplace: clover 4, hopping -1, shift m^2."""

    def __init__(self, lat: Lattice2D, mass_sq, *, dtype=torch.complex128,
                 device="cpu"):
        if lat.nc != 1:
            raise ValueError("FreeLaplace2D only supports nc = 1")
        hopping = torch.full(lat.hopping_shape(), -1.0, dtype=dtype,
                             device=device)
        super().__init__(make_coeffs(
            lat, clover=_laplace_clover(lat, dtype=dtype, device=device),
            hopping=hopping, shift=mass_sq, dtype=dtype))


class GaugedLaplace2D(_NoChirality, Stencil2D):
    """U(1)-gauged Laplace with its even-odd Schur trio."""

    def __init__(self, lat: Lattice2D, mass_sq, gauge, *,
                 dtype=torch.complex128, device="cpu"):
        if lat.nc != 1:
            raise ValueError("GaugedLaplace2D only supports nc = 1")
        hopping = _u1_hopping(gauge, (-1.0,) * 4, dtype=dtype, device=device)
        super().__init__(make_coeffs(
            lat, clover=_laplace_clover(lat, dtype=dtype, device=device),
            hopping=hopping, shift=mass_sq, dtype=dtype))

    def update_links(self, gauge):
        """Refill the hopping term from new links, on the operator's dtype
        and device."""
        h = self.coeffs.hopping
        self.update_coeffs(hopping=_u1_hopping(
            gauge, (-1.0,) * 4, dtype=h.dtype, device=h.device))

    # --- the even-odd Schur trio ---
    def prepare_b(self, b):
        """b' = (4 + m^2) b_e - D_eo b_o, an even-half field."""
        deo_bo = apply_hopping_half(self.coeffs, b[1], src_parity=1)
        return (4.0 + self.coeffs.shift) * b[0] - deo_bo

    def apply_eo_prec_M(self, x_even):
        """((4 + m^2)^2 - D_eo D_oe) x_e."""
        t_odd = apply_hopping_half(self.coeffs, x_even, src_parity=0)
        t_even = apply_hopping_half(self.coeffs, t_odd, src_parity=1)
        s = 4.0 + self.coeffs.shift
        return s * s * x_even - t_even

    def reconstruct_x(self, x_even, b):
        """x_o = (b_o - D_oe x_e) / (4 + m^2); returns the full x."""
        t_odd = apply_hopping_half(self.coeffs, x_even, src_parity=0)
        x_odd = (b[1] - t_odd) / (4.0 + self.coeffs.shift)
        return torch.stack([x_even, x_odd])
