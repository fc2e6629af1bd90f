"""Shamir domain-wall operator as a 2D stencil with nc = 2 Ls (port of
qmg_tpu/operators/dwf.py).

Per site the (2 Ls x 2 Ls) clover is

    block-diagonal: Ls copies of 3w I_2 (M5 rides in ``shift``)
    off-diagonal:   -P_+ coupling s -> s+1 at (2j+2, 2j), j < Ls-1
                    -P_- coupling s -> s-1 at (2j+1, 2j+3), j < Ls-1
    mass terms:     +m at (2Ls-1, 1) (m P_-) and (0, 2Ls-2) (m P_+)

and the hopping term is Ls block-diagonal copies of the Wilson hopping.
Gamma_5 = gamma_5 (x) the reflection s -> Ls-1-s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice2D, DIR_XM1, DIR_YM1
from ..cshift import cshift_pull
from ..stencil import (Stencil2D, make_coeffs, ChiralityState,
                       DefaultChirality)
from .wilson import wilson_spin_matrices

SUPPORTED_LS = (2, 4, 6, 8, 12, 16, 24, 32)


def _dwf_clover_block(ls: int, mass, w: float) -> np.ndarray:
    """The constant (2Ls x 2Ls) per-site clover matrix, complex128."""
    n = 2 * ls
    m = np.zeros((n, n), dtype=np.complex128)
    for j in range(ls):
        m[2 * j, 2 * j] = m[2 * j + 1, 2 * j + 1] = 3.0 * w
    for j in range(ls - 1):
        m[2 * j + 2, 2 * j] = -1.0      # -P_+: s+1 <- s on spin up
        m[2 * j + 1, 2 * j + 3] = -1.0  # -P_-: s <- s+1 on spin down
    m[n - 1, 1] = complex(mass)         # m P_- from the first slice
    m[0, n - 2] = complex(mass)         # m P_+ from the last slice
    return m


class Dwf2D(Stencil2D):
    def __init__(self, lat: Lattice2D, mass, gauge, ls: int,
                 m5: float = -1.0, *, dtype=torch.complex128, device="cpu"):
        if ls not in SUPPORTED_LS:
            raise ValueError(f"unsupported Ls {ls} (supported: "
                             f"{SUPPORTED_LS})")
        if lat.nc != 2 * ls:
            raise ValueError(f"Dwf2D requires nc = 2 Ls = {2 * ls}, got "
                             f"{lat.nc}")
        self.ls = ls
        self.mass = mass
        self.m5 = m5
        clover, hopping = self._build(lat, gauge, dtype, device)
        super().__init__(make_coeffs(lat, clover=clover, hopping=hopping,
                                     shift=m5, dtype=dtype))

    def _build(self, lat, gauge, dtype, device):
        w = 1.0
        gauge = torch.as_tensor(gauge).to(device=device, dtype=dtype)
        ux, uy = gauge[0], gauge[1]
        block = torch.as_tensor(_dwf_clover_block(self.ls, self.mass, w),
                                device=device).to(dtype)
        clover = block.expand(lat.cm_shape()).clone()
        eye_s = torch.eye(self.ls, dtype=dtype, device=device)
        big = [torch.kron(eye_s, spin) for spin in
               wilson_spin_matrices(w, dtype=dtype, device=device)]
        ux_m = torch.conj(cshift_pull(ux, DIR_XM1))
        uy_m = torch.conj(cshift_pull(uy, DIR_YM1))
        hopping = torch.stack([u[..., None, None] * m for u, m in
                               zip((ux, uy, ux_m, uy_m), big)])
        return clover, hopping

    def update_links(self, gauge):
        """Rebuild clover and hopping from new links, on the operator's
        dtype and device."""
        h = self.coeffs.hopping
        self.update_coeffs(*self._build(self.lat, gauge, h.dtype, h.device))

    def get_dof_instance(self) -> int:
        return 2 * self.ls

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.YES

    def get_default_chirality(self) -> DefaultChirality:
        return DefaultChirality.GAMMA_5

    def gamma5(self, x):
        """gamma_5 (x) s-reflection: out[s, spin] = (+-1)^spin
        in[Ls-1-s, spin]."""
        v = torch.flip(x.reshape(x.shape[:-1] + (self.ls, 2)), dims=(-2,))
        v = torch.stack([v[..., 0], -v[..., 1]], dim=-1)
        return v.reshape(x.shape)

    def chiral_projection(self, x, is_up: bool):
        """The identity, as in qmg_tpu (the reference stubs it)."""
        return x

    def chiral_projection_both(self, x):
        return x, torch.zeros_like(x)


def create_dwf_ls(lat: Lattice2D, mass, gauge, ls: int, m5: float = -1.0, *,
                  dtype=torch.complex128, device="cpu") -> Dwf2D:
    """A ``Dwf2D`` at Ls = ``ls`` (one of ``SUPPORTED_LS``)."""
    return Dwf2D(lat, mass, gauge, ls, m5, dtype=dtype, device=device)
