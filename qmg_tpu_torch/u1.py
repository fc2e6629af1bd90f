"""U(1) gauge fields (port of the generation/observable subset of
qmg_tpu/u1.py).

Gauge fields are eo-packed complex arrays (2=mu, 2=parity, Y, X/2).
Generation and file I/O run on the host in NumPy (bit-exact with
qmg_tpu for the same ``QMGRandom`` stream); observables take tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .lattice import Lattice2D, DIR_XP1, DIR_YP1, eo_pack
from .cshift import cshift_pull

__all__ = ["phases_to_links", "unit_gauge_u1", "rand_gauge_u1",
           "gauss_gauge_u1", "get_plaquette_u1", "read_phase_u1",
           "read_gauge_u1"]


def _gauge_lat(lat: Lattice2D) -> Lattice2D:
    return lat if lat.nc == 1 else lat.with_nc(1)


def read_phase_u1(lat: Lattice2D, path: str) -> np.ndarray:
    """Load a reference-format phase file (one phase per line, x outer,
    y, mu inner) -> (2, 2, Y, Xh) real array."""
    lat = _gauge_lat(lat)
    vals = np.loadtxt(path).reshape(lat.x_len, lat.y_len, 2)
    grid = np.transpose(vals, (2, 1, 0))  # (mu, y, x)
    return np.stack([eo_pack(grid[mu], lat) for mu in range(2)])


def read_gauge_u1(lat: Lattice2D, path: str) -> np.ndarray:
    """Load phases and compactify -> (2, 2, Y, Xh) complex128 links."""
    return np.exp(1j * read_phase_u1(lat, path))


def phases_to_links(phases) -> torch.Tensor:
    """Compactify phases into U(1) links."""
    return torch.polar(torch.ones_like(torch.as_tensor(phases)),
                       torch.as_tensor(phases))


def unit_gauge_u1(lat: Lattice2D, *, dtype=torch.complex128,
                  device="cpu") -> torch.Tensor:
    lat = _gauge_lat(lat)
    return torch.ones((2, 2, lat.y_len, lat.xh), dtype=dtype, device=device)


def rand_gauge_u1(lat: Lattice2D, rng) -> np.ndarray:
    """Hot start: uniform phases in (-pi, pi)."""
    lat = _gauge_lat(lat)
    ph = rng.uniform((2, 2, lat.y_len, lat.xh), -np.pi, np.pi)
    return np.exp(1j * ph)


def gauss_gauge_u1(lat: Lattice2D, rng, beta: float) -> np.ndarray:
    """Gaussian phases with variance 1/beta."""
    lat = _gauge_lat(lat)
    beta = abs(beta)
    if beta == 0:
        return rand_gauge_u1(lat, rng)
    ph = rng.gaussian_real((2, 2, lat.y_len, lat.xh), 1.0 / np.sqrt(beta))
    return np.exp(1j * ph)


def get_plaquette_u1(gauge: torch.Tensor, lat: Lattice2D):
    """Volume-averaged plaquette U_x(s) U_y(s+x) conj(U_x(s+y) U_y(s))."""
    ux, uy = gauge[0], gauge[1]
    plaq = (ux * cshift_pull(uy, DIR_XP1)
            * torch.conj(cshift_pull(ux, DIR_YP1)) * torch.conj(uy))
    return plaq.sum() / _gauge_lat(lat).volume
