"""U(1) gauge fields (port of the generation/observable subset of
qmg_tpu/u1.py and of its non-compact heatbath).

Gauge fields are eo-packed complex arrays (2=mu, 2=parity, Y, X/2), phase
fields the same shape with a real dtype. Generation, file I/O and the
heatbath run on the host in NumPy or C++ (bit-exact with qmg_tpu for the
same ``QMGRandom`` stream); observables take tensors.

The heatbath sweep is site-sequential (each link's staple reads links
updated earlier in the sweep), so it stays on the host:
``heatbath_noncompact_update(..., sweep="native")`` runs the C++ sweep of
``csrc/heatbath.cpp`` (built at first use with the host compiler, through
``cuda_build``), ``sweep="numpy"`` its plain version. A failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .lattice import Lattice2D, DIR_XP1, DIR_YP1, eo_pack, eo_unpack
from .cshift import cshift_pull
from .cuda_build import build_library

__all__ = ["phases_to_links", "unit_gauge_u1", "rand_gauge_u1",
           "gauss_gauge_u1", "get_plaquette_u1", "read_phase_u1",
           "read_gauge_u1", "get_noncompact_action_u1",
           "heatbath_noncompact_update", "heatbath_sweeps_native",
           "build_heatbath"]

HEATBATH_SOURCE = "heatbath.cpp"
SWEEPS = ("native", "numpy")
_LIB = {}


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


def get_noncompact_action_u1(phases, beta: float, lat: Lattice2D):
    """0.5 beta sum_s (dA)^2 of (2, 2, Y, Xh) phases (a tensor or an
    array), dA = A_x(s) + A_y(s+x) - A_x(s+y) - A_y(s)."""
    del lat
    phases = torch.as_tensor(phases)
    ax, ay = phases[0], phases[1]
    f = ax + cshift_pull(ay, DIR_XP1) - cshift_pull(ax, DIR_YP1) - ay
    return 0.5 * beta * torch.sum(f * f)


def _heatbath_sweeps_numpy(ph, beta: float, n_update: int, rng):
    """The plain sweep: ph (mu, Y, X) phases on the full grid, updated in
    place, one ``rng.normal_scalar`` a link (x links, x outer and y inner,
    then y links)."""
    width = np.sqrt(0.5 / beta)
    yl, xl = ph.shape[1], ph.shape[2]
    for _ in range(n_update):
        for x in range(xl):
            xp = (x + 1) % xl
            for y in range(yl):
                yp, ym = (y + 1) % yl, (y - 1) % yl
                staple = (ph[1, y, xp] - ph[0, yp, x] - ph[1, y, x]
                          - ph[1, ym, xp] - ph[0, ym, x] + ph[1, ym, x])
                ph[0, y, x] = rng.normal_scalar(width) - 0.5 * staple
        for x in range(xl):
            xp, xm = (x + 1) % xl, (x - 1) % xl
            for y in range(yl):
                yp = (y + 1) % yl
                staple = (ph[0, yp, x] - ph[1, y, xp] - ph[0, y, x]
                          - ph[0, yp, xm] - ph[1, y, xm] + ph[0, y, xm])
                ph[1, y, x] = rng.normal_scalar(width) - 0.5 * staple
    return ph


def build_heatbath() -> float:
    """Build (at first use) and load the C++ sweep; returns build
    seconds."""
    if "lib" in _LIB:
        return 0.0
    lib, seconds = build_library(HEATBATH_SOURCE)
    fn = lib.heatbath_sweeps
    fn.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                   ctypes.c_int, ctypes.c_double, ctypes.c_int,
                   ctypes.c_uint64]
    fn.restype = None
    _LIB["lib"] = lib
    return seconds


def heatbath_sweeps_native(ph: np.ndarray, beta: float, n_update: int,
                           rng) -> np.ndarray:
    """The C++ sweep on (2, Y, X) float64 phases, updated and returned.
    Draws one 64-bit seed from ``rng``'s stream for the call (the draw
    qmg_tpu.native.heatbath_sweeps makes), so the two packages evolve the
    same configuration from the same ``QMGRandom``."""
    build_heatbath()
    ph = np.ascontiguousarray(ph, dtype=np.float64)
    if ph.ndim != 3 or ph.shape[0] != 2:
        raise ValueError(f"phases must be (2, Y, X), got {ph.shape}")
    seed = int(rng.gen.integers(0, 2**63 - 1))
    _LIB["lib"].heatbath_sweeps(
        ph.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ph.shape[1],
        ph.shape[2], float(beta), int(n_update), seed)
    return ph


def heatbath_noncompact_update(phases, lat: Lattice2D, beta: float,
                               n_update: int, rng, sweep: str = "native"
                               ) -> np.ndarray:
    """``n_update`` heatbath updates of (2, 2, Y, Xh) eo-packed real
    phases (reference heatbath_noncompact_update, u1/u1_utils.h:607-757).
    ``sweep`` is "native" (the C++ sweep) or "numpy" (its plain version);
    they draw from ``rng`` differently (one seed a call against one normal
    a link), as qmg_tpu's two paths do. Returns the updated phases."""
    if sweep not in SWEEPS:
        raise ValueError(f"sweep must be one of {SWEEPS}, got {sweep!r}")
    lat = _gauge_lat(lat)
    ph = np.stack([eo_unpack(np.asarray(phases[mu]), lat)
                   for mu in range(2)])  # (mu, Y, X)
    if sweep == "native":
        ph = heatbath_sweeps_native(ph, beta, n_update, rng)
    else:
        ph = _heatbath_sweeps_numpy(ph, beta, n_update, rng)
    return np.stack([eo_pack(ph[mu], lat) for mu in range(2)])
