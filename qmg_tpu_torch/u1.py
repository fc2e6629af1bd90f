"""U(1) gauge fields (port of qmg_tpu/u1.py: config I/O, field generation,
gauge transforms, APE smearing, observables, Lorenz gauge fixing,
instantons and the non-compact heatbath).

Gauge fields are eo-packed complex arrays (2=mu, 2=parity, Y, X/2), phase
fields the same shape with a real dtype. Generation, file I/O, the Lorenz
fix (a NumPy FFT solve), the instantons and the heatbath run on the host
in NumPy or C++ (bit-exact with qmg_tpu for the same ``QMGRandom``
stream): they take arrays, or a tensor that they move to the host once,
and return NumPy arrays. Observables, gauge transforms and APE smearing
take tensors and run on their device.

The heatbath sweep is site-sequential (each link's staple reads links
updated earlier in the sweep), so it stays on the host:
``heatbath_noncompact_update(..., sweep="native")`` runs the C++ sweep of
``csrc/heatbath.cpp`` (built at first use with the host compiler, through
``cuda_build``), ``sweep="numpy"`` its plain version. Two streams drive
it: a ``QMGRandom`` (the C++ sweep seeds its own ``std::mt19937_64`` with
one draw from the stream), or a ``StdMT19937`` (the C++ sweep continues
the object's own libstdc++ stream and writes its state back, so it gives
the plain sweep's bits). A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .lattice import (Lattice2D, DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1,
                      eo_pack, eo_unpack)
from .cshift import cshift_pull
from .cuda_build import build_library
from .rng import QMGRandom, StdMT19937

__all__ = ["phases_to_links", "unit_gauge_u1", "rand_gauge_u1",
           "gauss_gauge_u1", "rand_trans_u1", "apply_gauge_trans_u1",
           "apply_ape_smear_u1", "get_plaquette_u1", "get_topo_u1",
           "read_phase_u1", "read_gauge_u1", "write_phase_u1",
           "write_gauge_u1", "get_noncompact_action_u1",
           "lorentz_gauge_fix_u1", "create_instanton_u1",
           "create_noncompact_instanton_u1", "heatbath_noncompact_update",
           "heatbath_sweeps_native", "heatbath_sweeps_std",
           "build_heatbath"]

HEATBATH_SOURCE = "heatbath.cpp"
SWEEPS = ("native", "numpy")
_LIB = {}


def _gauge_lat(lat: Lattice2D) -> Lattice2D:
    return lat if lat.nc == 1 else lat.with_nc(1)


def _host(field) -> np.ndarray:
    """A tensor (moved to the host) or an array, as a NumPy array."""
    if isinstance(field, torch.Tensor):
        return field.detach().cpu().numpy()
    return np.asarray(field)


def _grids(field, lat: Lattice2D) -> np.ndarray:
    """(2, 2, Y, Xh) eo-packed links or phases -> (mu, Y, X) full grids."""
    field = _host(field)
    return np.stack([eo_unpack(field[mu], lat) for mu in range(2)])


def _packed(grids: np.ndarray, lat: Lattice2D) -> np.ndarray:
    return np.stack([eo_pack(grids[mu], lat) for mu in range(2)])


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


def write_phase_u1(phases, lat: Lattice2D, path: str):
    """Write (2, 2, Y, Xh) phases in the format ``read_phase_u1`` reads
    (x outer, y, mu inner, one ``%.20f`` a line)."""
    lat = _gauge_lat(lat)
    vals = np.transpose(_grids(phases, lat), (2, 1, 0)).reshape(-1)
    with open(path, "w") as f:
        for v in vals:
            f.write(f"{v:.20f}\n")


def write_gauge_u1(gauge, lat: Lattice2D, path: str):
    """Write the phases of (2, 2, Y, Xh) links (``write_phase_u1``)."""
    write_phase_u1(np.angle(_host(gauge)), lat, path)


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


def rand_trans_u1(lat: Lattice2D, rng) -> np.ndarray:
    """A random per-site gauge transform g(x), (2, Y, Xh) complex128:
    uniform phases in (-pi, pi) from ``rng``."""
    lat = _gauge_lat(lat)
    ph = rng.uniform((2, lat.y_len, lat.xh), -np.pi, np.pi)
    return np.exp(1j * ph)


def apply_gauge_trans_u1(gauge, trans) -> torch.Tensor:
    """u_mu(x) -> g(x) u_mu(x) conj(g(x + mu)) on ``gauge``'s device (a
    tensor or an array; an array goes to the CPU)."""
    gauge = torch.as_tensor(gauge)
    trans = torch.as_tensor(trans, device=gauge.device)
    ux = trans * gauge[0] * torch.conj(cshift_pull(trans, DIR_XP1))
    uy = trans * gauge[1] * torch.conj(cshift_pull(trans, DIR_YP1))
    return torch.stack([ux, uy])


def _plaquette_field(gauge: torch.Tensor) -> torch.Tensor:
    """Per-site plaquette U_x(s) U_y(s+x) conj(U_x(s+y)) conj(U_y(s))."""
    ux, uy = gauge[0], gauge[1]
    return (ux * cshift_pull(uy, DIR_XP1)
            * torch.conj(cshift_pull(ux, DIR_YP1)) * torch.conj(uy))


def get_plaquette_u1(gauge: torch.Tensor, lat: Lattice2D):
    """Volume-averaged plaquette U_x(s) U_y(s+x) conj(U_x(s+y) U_y(s))."""
    return _plaquette_field(gauge).sum() / _gauge_lat(lat).volume


def get_topo_u1(gauge, lat: Lattice2D):
    """Topological charge sum_s arg(plaq(s)) / 2 pi (a 0-dim tensor on
    ``gauge``'s device)."""
    del lat
    return torch.angle(_plaquette_field(torch.as_tensor(gauge))).sum() \
        * 0.5 / np.pi


def apply_ape_smear_u1(gauge, lat: Lattice2D, alpha: float, n_iter: int
                       ) -> torch.Tensor:
    """``n_iter`` APE steps with staple weight ``alpha``, each
    re-unitarized by exp(i arg), on ``gauge``'s device."""
    del lat
    u = torch.as_tensor(gauge)
    for _ in range(n_iter):
        ux, uy = u[0], u[1]
        # x staples
        up_x = (uy * cshift_pull(ux, DIR_YP1)
                * torch.conj(cshift_pull(uy, DIR_XP1)))
        uy_ym = cshift_pull(uy, DIR_YM1)  # U_y(s-y)
        dn_x = (torch.conj(uy_ym) * cshift_pull(ux, DIR_YM1)
                * cshift_pull(uy_ym, DIR_XP1))
        new_x = ux + alpha * (up_x + dn_x)
        # y staples
        rt_y = (ux * cshift_pull(uy, DIR_XP1)
                * torch.conj(cshift_pull(ux, DIR_YP1)))
        ux_xm = cshift_pull(ux, DIR_XM1)  # U_x(s-x)
        lf_y = (torch.conj(ux_xm) * cshift_pull(uy, DIR_XM1)
                * cshift_pull(ux_xm, DIR_YP1))
        new_y = uy + alpha * (rt_y + lf_y)
        u = phases_to_links(torch.angle(torch.stack([new_x, new_y])))
    return u


def get_noncompact_action_u1(phases, beta: float, lat: Lattice2D):
    """0.5 beta sum_s (dA)^2 of (2, 2, Y, Xh) phases (a tensor or an
    array), dA = A_x(s) + A_y(s+x) - A_x(s+y) - A_y(s)."""
    del lat
    phases = torch.as_tensor(phases)
    ax, ay = phases[0], phases[1]
    f = ax + cshift_pull(ay, DIR_XP1) - cshift_pull(ax, DIR_YP1) - ay
    return 0.5 * beta * torch.sum(f * f)


def _backward_divergence(theta_grids):
    """sum_mu [theta_mu(x) - theta_mu(x - mu)] on (2, Y, X) grids."""
    tx, ty = theta_grids
    return (tx - np.roll(tx, 1, axis=1)) + (ty - np.roll(ty, 1, axis=0))


def lorentz_gauge_fix_u1(gauge, lat: Lattice2D, tol: float = 1e-10,
                         max_iter: int = 100):
    """Lorenz (Landau) gauge, sum_mu [theta_mu(x) - theta_mu(x - mu)] = 0
    at every site, on the host: returns (fixed (2, 2, Y, Xh) links, final
    max |divergence|). Each pass solves Lap lambda = div theta exactly by
    FFT (zero mode projected) and applies g = exp(i lambda); the
    principal-branch phases re-wrap after a large transform, so it
    repeats until max |div| < ``tol``."""
    glat = _gauge_lat(lat)
    g = _host(gauge)
    yl, xl = glat.y_len, glat.x_len
    ky = np.arange(yl)
    kx = np.arange(xl)
    lap = -4.0 * (np.sin(np.pi * ky / yl)[:, None] ** 2
                  + np.sin(np.pi * kx / xl)[None, :] ** 2)
    lap[0, 0] = 1.0  # zero mode: projected out below
    resid = np.inf
    for _ in range(max_iter):
        div = _backward_divergence(_grids(np.angle(g), glat))
        resid = float(np.max(np.abs(div)))
        if resid < tol:
            break
        lam_hat = np.fft.fft2(div) / lap
        lam_hat[0, 0] = 0.0
        lam = np.real(np.fft.ifft2(lam_hat))
        trans = eo_pack(np.exp(1j * lam), glat)
        g = apply_gauge_trans_u1(g, trans).numpy()
    return g, resid


def _instanton_coords(lat: Lattice2D):
    """(y, x) full-grid coordinate arrays, shape (Y, X)."""
    return np.meshgrid(np.arange(lat.y_len), np.arange(lat.x_len),
                       indexing="ij")


def create_instanton_u1(gauge, lat: Lattice2D, q: float, x0: int, y0: int
                        ) -> np.ndarray:
    """Multiply a charge-``q`` instanton centred at (x0, y0) into
    (2, 2, Y, Xh) links, on the host."""
    lat = _gauge_lat(lat)
    xl, yl = lat.x_len, lat.y_len
    g = _grids(gauge, lat)
    y, x = _instanton_coords(lat)
    rx = x - xl // 2 + 0.5
    ry = y - yl // 2 + 0.5
    xt = (x - xl // 2 + x0 + 3 * xl) % xl
    yt = (y - yl // 2 + y0 + 3 * yl) % yl
    r2 = rx * rx + ry * ry
    g[0, yt, xt] *= np.exp(1j * q * ry / r2)
    g[1, yt, xt] *= np.exp(-1j * q * rx / r2)
    return _packed(g, lat)


def create_noncompact_instanton_u1(phases, lat: Lattice2D, q: float
                                   ) -> np.ndarray:
    """Add a charge-``q`` flux (in the non-compact convention, topological
    charge q / 2) to (2, 2, Y, Xh) phases, on the host."""
    lat = _gauge_lat(lat)
    xl, yl = lat.x_len, lat.y_len
    g = _grids(phases, lat)
    y, x = _instanton_coords(lat)
    g[0] += -q * np.pi * y / (xl * yl)
    g[1, yl - 1] += q * np.pi * x[yl - 1] / xl
    return _packed(g, lat)


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
    """Build (at first use) and load the C++ sweeps; returns build
    seconds."""
    if "lib" in _LIB:
        return 0.0
    lib, seconds = build_library(HEATBATH_SOURCE)
    fn = lib.heatbath_sweeps
    fn.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                   ctypes.c_int, ctypes.c_double, ctypes.c_int,
                   ctypes.c_uint64]
    fn.restype = None
    fn = lib.heatbath_sweeps_std
    fn.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                   ctypes.c_int, ctypes.c_double, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_uint32),   # mt19937 state (624)
                   ctypes.POINTER(ctypes.c_int32),    # its index
                   ctypes.POINTER(ctypes.c_double),   # cached normal
                   ctypes.POINTER(ctypes.c_int32)]    # whether one is cached
    fn.restype = None
    _LIB["lib"] = lib
    return seconds


def _sweep_phases(ph: np.ndarray) -> np.ndarray:
    ph = np.ascontiguousarray(ph, dtype=np.float64)
    if ph.ndim != 3 or ph.shape[0] != 2:
        raise ValueError(f"phases must be (2, Y, X), got {ph.shape}")
    return ph


def heatbath_sweeps_native(ph: np.ndarray, beta: float, n_update: int,
                           rng) -> np.ndarray:
    """The C++ sweep on (2, Y, X) float64 phases, updated and returned.
    Draws one 64-bit seed from ``rng``'s stream for the call (the draw
    qmg_tpu.native.heatbath_sweeps makes), so the two packages evolve the
    same configuration from the same ``QMGRandom``."""
    build_heatbath()
    ph = _sweep_phases(ph)
    seed = int(rng.gen.integers(0, 2**63 - 1))
    _LIB["lib"].heatbath_sweeps(
        ph.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ph.shape[1],
        ph.shape[2], float(beta), int(n_update), seed)
    return ph


def heatbath_sweeps_std(ph: np.ndarray, beta: float, n_update: int,
                        std_rng: StdMT19937) -> np.ndarray:
    """The C++ sweep on (2, Y, X) float64 phases, continuing
    ``std_rng``'s own stream: its 624-word state, index and cached normal
    go to the C++ engine and come back after the sweep, so the phases and
    the stream are those of the plain sweep with the same object."""
    build_heatbath()
    ph = _sweep_phases(ph)
    mt = np.ascontiguousarray(std_rng._mt.astype(np.uint32))
    idx = np.array([std_rng._idx], dtype=np.int32)
    cached = std_rng._saved_normal is not None
    saved = np.array([std_rng._saved_normal if cached else 0.0])
    has = np.array([cached], dtype=np.int32)
    _LIB["lib"].heatbath_sweeps_std(
        ph.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ph.shape[1],
        ph.shape[2], float(beta), int(n_update),
        mt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        saved.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        has.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    std_rng._mt = mt.astype(np.uint64)
    std_rng._idx = int(idx[0])
    std_rng._saved_normal = float(saved[0]) if has[0] else None
    return ph


def heatbath_noncompact_update(phases, lat: Lattice2D, beta: float,
                               n_update: int, rng, sweep: str = "native"
                               ) -> np.ndarray:
    """``n_update`` heatbath updates of (2, 2, Y, Xh) eo-packed real
    phases (reference heatbath_noncompact_update, u1/u1_utils.h:607-757).
    ``sweep`` is "native" (the C++ sweep) or "numpy" (its plain version).
    ``rng`` is a ``QMGRandom``, whose two sweeps draw differently (one
    seed a call against one normal a link), as qmg_tpu's two paths do, or
    a ``StdMT19937`` (the libstdc++ stream), which both sweeps continue
    link by link to the same bits. Returns the updated phases."""
    if sweep not in SWEEPS:
        raise ValueError(f"sweep must be one of {SWEEPS}, got {sweep!r}")
    if not isinstance(rng, (QMGRandom, StdMT19937)):
        raise TypeError("rng must be a QMGRandom or a StdMT19937, got "
                        f"{type(rng).__name__}")
    lat = _gauge_lat(lat)
    ph = _grids(phases, lat)  # (mu, Y, X)
    if sweep == "numpy":
        ph = _heatbath_sweeps_numpy(ph, beta, n_update, rng)
    elif isinstance(rng, StdMT19937):
        ph = heatbath_sweeps_std(ph, beta, n_update, rng)
    else:
        ph = heatbath_sweeps_native(ph, beta, n_update, rng)
    return _packed(ph, lat)
