"""2D staggered Dslash, nc = 1 (port of qmg_tpu/operators/staggered.py).

A hopping-only stencil with the mass in ``shift``:

    hopping_{+x} = -U_x(s) / 2
    hopping_{+y} = -eta_y(x) U_y(s) / 2
    hopping_{-x} = +conj(U_x(s - x)) / 2
    hopping_{-y} = +eta_y(x) conj(U_y(s - y)) / 2

with the phase eta_y(x) = (-1)^x. gamma5 is the parity sign epsilon(x)
(+1 on even sites, -1 on odd ones), so chirality is the parity halves.
The even-odd Schur system is m^2 - D_eo D_oe on the even half.
"""

from __future__ import annotations

import torch

from ..lattice import Lattice2D, DIR_XM1, DIR_YM1
from ..cshift import cshift_pull
from ..stencil import (Stencil2D, make_coeffs, ChiralityState,
                       DefaultChirality, apply_hopping_half)


def _staggered_hopping(lat: Lattice2D, gauge, *, dtype, device):
    gauge = torch.as_tensor(gauge).to(device=device, dtype=dtype)
    ux, uy = gauge[0], gauge[1]
    eta = torch.as_tensor(1.0 - 2.0 * (lat.x_coord_grid() % 2),
                          device=device).to(dtype)
    hop = torch.stack([
        -0.5 * ux,
        -0.5 * eta * uy,
        0.5 * torch.conj(cshift_pull(ux, DIR_XM1)),
        0.5 * eta * torch.conj(cshift_pull(uy, DIR_YM1)),
    ]).resolve_conj()
    return hop[..., None, None]


class Staggered2D(Stencil2D):
    def __init__(self, lat: Lattice2D, mass, gauge, *,
                 dtype=torch.complex128, device="cpu"):
        if lat.nc != 1:
            raise ValueError("Staggered2D only supports nc = 1")
        hopping = _staggered_hopping(lat, gauge, dtype=dtype, device=device)
        super().__init__(make_coeffs(lat, clover=None, hopping=hopping,
                                     shift=mass, dtype=dtype))

    def update_links(self, gauge):
        """Refill the hopping term from new links, on the operator's dtype
        and device."""
        h = self.coeffs.hopping
        self.update_coeffs(hopping=_staggered_hopping(
            self.lat, gauge, dtype=h.dtype, device=h.device))

    @staticmethod
    def get_dof(i: int = 0) -> int:
        return 1

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.YES

    def get_default_chirality(self) -> DefaultChirality:
        return DefaultChirality.GAMMA_5

    def gamma5(self, x):
        """epsilon(x): +1 on even sites, -1 on odd ones."""
        return torch.stack([x[0], -x[1]])

    def chiral_projection(self, x, is_up: bool):
        """The even (up) or the odd (down) parity half."""
        zero = torch.zeros_like(x[0])
        return torch.stack([x[0], zero] if is_up else [zero, x[1]])

    # --- the even-odd Schur trio ---
    def prepare_b(self, b):
        """b' = m b_e - D_eo b_o, an even-half field."""
        deo_bo = apply_hopping_half(self.coeffs, b[1], src_parity=1)
        return self.coeffs.shift * b[0] - deo_bo

    def apply_eo_prec_M(self, x_even):
        """(m^2 - D_eo D_oe) x_e."""
        t_odd = apply_hopping_half(self.coeffs, x_even, src_parity=0)
        t_even = apply_hopping_half(self.coeffs, t_odd, src_parity=1)
        m = self.coeffs.shift
        return m * m * x_even - t_even

    def reconstruct_x(self, x_even, b):
        """x_o = (b_o - D_oe x_e) / m; returns the full x."""
        t_odd = apply_hopping_half(self.coeffs, x_even, src_parity=0)
        x_odd = (b[1] - t_odd) / self.coeffs.shift
        return torch.stack([x_even, x_odd])
