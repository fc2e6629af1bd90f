"""2D Wilson-Dirac operator, nc=2 (spin x U(1)); port of
qmg_tpu/operators/wilson.py.

Spin structure per direction::

    clover        = 2w * I
    hopping_{+x}  = 0.5 [[-w,  1], [ 1, -w]] U_x(s)
    hopping_{+y}  = 0.5 [[-w, -i], [ i, -w]] U_y(s)
    hopping_{-x}  = 0.5 [[-w, -1], [-1, -w]] conj(U_x(s-x))
    hopping_{-y}  = 0.5 [[-w,  i], [-i, -w]] conj(U_y(s-y))

mass in ``shift``; gamma5 = diag(1, -1); chirality = spin components.
"""

from __future__ import annotations

import torch

from ..lattice import Lattice2D, DIR_XM1, DIR_YM1
from ..cshift import cshift_pull
from ..stencil import (Stencil2D, StencilCoeffs, make_coeffs, ChiralityState,
                       DefaultChirality)
from .. import linalg

# Relative tolerance of ``Wilson2D.from_coeffs``'s structure check: loose
# enough for complex64 arrays (one float32 rounding of each entry).
FROM_COEFFS_RTOL = 1e-6


def wilson_spin_matrices(w: float, *, dtype, device="cpu"):
    """The four 2x2 spin projectors of the 2D Wilson hopping term, in
    direction order {+x, +y, -x, -y}."""
    i = 1j
    mats = ([[-w, 1], [1, -w]], [[-w, -i], [i, -w]],
            [[-w, -1], [-1, -w]], [[-w, i], [-i, -w]])
    return tuple(0.5 * torch.tensor(m, dtype=dtype, device=device)
                 for m in mats)


def wilson_coeff_arrays(lat: Lattice2D, gauge, w: float, *, dtype, device,
                        block=None):
    """(clover, hopping) of the Wilson operator for a (2, 2, Y, Xh) gauge.

    With ``block`` = (ny, nx, iy, ix), those of block (iy, ix) of the
    lattice cut into ny x nx blocks (``parallel.shard_coeffs`` of the
    whole, bit for bit): only the block's links and the one row below and
    the one packed column to the left that its -y and -x hops read are
    taken from ``gauge`` and moved to ``device``."""
    gauge = torch.as_tensor(gauge)
    if block is None:
        gauge = gauge.to(device=device, dtype=dtype)
        ux, uy = gauge[0], gauge[1]
        ux_m = torch.conj(cshift_pull(ux, DIR_XM1))
        uy_m = torch.conj(cshift_pull(uy, DIR_YM1))
    else:
        ny, nx, iy, ix = block
        y_loc, xh_loc = lat.y_len // ny, lat.xh // nx
        lat = Lattice2D(2 * xh_loc, y_loc, lat.nc)
        rows = (torch.arange(iy * y_loc - 1, (iy + 1) * y_loc)
                % gauge.shape[2]).to(gauge.device)
        cols = (torch.arange(ix * xh_loc - 1, (ix + 1) * xh_loc)
                % gauge.shape[3]).to(gauge.device)
        # ux with the packed column to the left, uy with the row below.
        # The padded -x pull keeps the lattice's row parity (the block's
        # first row is even), and the -y pull masks no row.
        ux = gauge[0][:, rows[1:]][:, :, cols].to(device=device, dtype=dtype)
        uy = gauge[1][:, rows][:, :, cols[1:]].to(device=device, dtype=dtype)
        ux_m = torch.conj(cshift_pull(ux, DIR_XM1))[:, :, 1:]
        uy_m = torch.conj(cshift_pull(uy, DIR_YM1))[:, 1:]
        ux, uy = ux[:, :, 1:], uy[:, 1:]
    sx_p, sy_p, sx_m, sy_m = wilson_spin_matrices(w, dtype=dtype,
                                                  device=device)
    clover = 2.0 * w * linalg.identity_like(
        torch.zeros(lat.cm_shape(), dtype=dtype, device=device))
    hopping = torch.stack([ux[..., None, None] * sx_p,
                           uy[..., None, None] * sy_p,
                           ux_m[..., None, None] * sx_m,
                           uy_m[..., None, None] * sy_m])
    return clover, hopping


class Wilson2D(Stencil2D):
    def __init__(self, lat: Lattice2D, mass, gauge, wilson_coeff: float = 1.0,
                 *, dtype=torch.complex128, device="cpu"):
        if lat.nc != 2:
            raise ValueError("Wilson2D only supports nc = 2")
        self.wilson_coeff = float(wilson_coeff)
        clover, hopping = wilson_coeff_arrays(lat, gauge, self.wilson_coeff,
                                              dtype=dtype, device=device)
        super().__init__(make_coeffs(lat, clover=clover, hopping=hopping,
                                     shift=mass, dtype=dtype))

    @classmethod
    def from_arrays(cls, lat: Lattice2D, mass, clover, hopping,
                    wilson_coeff: float = 1.0) -> "Wilson2D":
        """A Wilson operator on (clover, hopping) that
        ``wilson_coeff_arrays`` built at ``wilson_coeff`` (a block's, or
        joined from the blocks), taken as they are."""
        op = cls.__new__(cls)
        op.wilson_coeff = float(wilson_coeff)
        Stencil2D.__init__(op, make_coeffs(lat, clover=clover,
                                           hopping=hopping, shift=mass,
                                           dtype=clover.dtype))
        return op

    @classmethod
    def from_coeffs(cls, coeffs: StencilCoeffs) -> "Wilson2D":
        """Adopt coefficient arrays built elsewhere (e.g. loaded from a
        state dict) as a Wilson operator. The Wilson coefficient is
        recovered from the clover (2w I); then the structure at that w is
        checked to ``FROM_COEFFS_RTOL``: clover = 2w I and each hopping
        matrix the direction's spin projector times one phase."""
        lat, rtol = coeffs.lat, FROM_COEFFS_RTOL
        if lat.nc != 2 or coeffs.clover is None or coeffs.hopping is None:
            raise ValueError("not a Wilson coefficient set (nc != 2 or a "
                             "missing piece)")
        w = 0.5 * float(coeffs.clover[0, 0, 0, 0, 0].real)
        if w == 0:
            raise ValueError("not a Wilson coefficient set (zero clover: "
                             "w = 0 leaves the phases undetermined)")
        expect_clover = 2.0 * w * linalg.identity_like(coeffs.clover)
        phase = -coeffs.hopping[..., 0, 0] / w        # U_d / 2
        spins = wilson_spin_matrices(w, dtype=coeffs.hopping.dtype,
                                     device=coeffs.hopping.device)
        expect_hop = torch.stack([phase[d][..., None, None] * (spins[d] / 0.5)
                                  for d in range(4)])
        scale = float(coeffs.hopping.abs().max())
        if (float((coeffs.clover - expect_clover).abs().max())
                > rtol * 2 * abs(w)
                or float((coeffs.hopping - expect_hop).abs().max())
                > rtol * scale):
            raise ValueError(f"coefficients are not Wilson (w={w} from the "
                             "clover)")
        op = cls.__new__(cls)
        op.wilson_coeff = w
        Stencil2D.__init__(op, coeffs)
        return op

    def update_links(self, gauge):
        """Rebuild clover and hopping from a new gauge field at the same
        w, mass, dtype and device. The coefficient record is replaced, so
        its cached stacked form is rebuilt at the next apply, and the
        derived sets (B^-1 among them) at their next use."""
        c = self.coeffs
        clover, hopping = wilson_coeff_arrays(
            self.lat, gauge, self.wilson_coeff, dtype=c.hopping.dtype,
            device=c.hopping.device)
        self.update_coeffs(clover=clover, hopping=hopping)

    @staticmethod
    def get_dof(i: int = 0) -> int:
        return 2

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.YES

    def get_default_chirality(self) -> DefaultChirality:
        return DefaultChirality.GAMMA_5

    def gamma5(self, x):
        """diag(1, -1) on spin."""
        return torch.stack([x[..., 0], -x[..., 1]], dim=-1)

    def sigma1(self, x):
        """Spin swap."""
        return torch.flip(x, dims=(-1,))

    def chiral_projection(self, x, is_up: bool):
        """Spin-component projection."""
        keep = 0 if is_up else 1
        out = torch.zeros_like(x)
        out[..., keep] = x[..., keep]
        return out
