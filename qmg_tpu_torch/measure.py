"""Physics measurements: propagators -> folded pion correlator ->
effective masses and the cosh fit (port of qmg_tpu/measure.py; the
reference's tests n15/n16/n20 measurement stream).

The correlator arithmetic runs on the host in NumPy float64, as
qmg_tpu's does; ``point_source`` and ``pion_correlator`` take and give
tensors on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .lattice import Lattice2D
from .reductions import norm2sq_timeslice

__all__ = ["point_source", "fold_correlator", "pion_correlator",
           "effective_mass", "effective_mass_acosh", "effective_mass_cosh",
           "fit_cosh_mass"]


def point_source(lat: Lattice2D, x: int, y: int, color: int, *,
                 dtype=torch.complex128, device="cpu") -> torch.Tensor:
    """A unit source at site (x, y), colour ``color``: (2, Y, Xh, nc)."""
    if not (0 <= x < lat.x_len and 0 <= y < lat.y_len
            and 0 <= color < lat.nc):
        raise ValueError(f"point source ({x},{y},c={color}) outside "
                         f"{lat.x_len}x{lat.y_len} nc={lat.nc}")
    src = torch.zeros(lat.cv_shape(), dtype=dtype, device=device)
    if lat.volume == 1:
        p, xh = 0, 0
    else:
        p, xh = (x + y) % 2, (x // 2) % lat.xh
    src[p, y, xh, color] = 1.0
    return src


def fold_correlator(corr) -> np.ndarray:
    """Symmetrize about the midpoint: c[j] = c[Y-j] = (c[j]+c[Y-j])/2
    (reference n15:141-146)."""
    c = np.array(corr, dtype=np.float64)
    ylen = len(c)
    for j in range(1, ylen // 2):
        t = 0.5 * (c[j] + c[ylen - j])
        c[j] = c[ylen - j] = t
    return c


def pion_correlator(solve, lat: Lattice2D, sources) -> np.ndarray:
    """Sum of the folded per-timeslice |prop|^2 over ``sources``;
    ``solve(src) -> prop`` is any inverter."""
    total = np.zeros(lat.y_len)
    for src in sources:
        corr = norm2sq_timeslice(solve(src)).detach().cpu().numpy()
        total += fold_correlator(corr)
    return total


def effective_mass(corr) -> np.ndarray:
    """Naive log effective mass m_eff(t) = log(c[t]/c[t+1])."""
    c = np.asarray(corr)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(c[:-1] / c[1:])


def effective_mass_acosh(corr) -> np.ndarray:
    """acosh effective mass m(t) = acosh((c[t+1]+c[t-1])/(2 c[t])), NaN
    where the ratio is below 1 and at both ends (reference n15
    wilson_u1.cpp:223-229)."""
    c = np.asarray(corr, dtype=np.float64)
    out = np.full(len(c), np.nan)
    with np.errstate(invalid="ignore"):
        for t in range(1, len(c) - 1):
            r = (c[t + 1] + c[t - 1]) / (2.0 * c[t])
            if r >= 1.0:
                out[t] = np.arccosh(r)
    return out


def effective_mass_cosh(corr) -> np.ndarray:
    """cosh effective mass: m(t) solving c[t+1]/c[t] =
    cosh(m(T/2-t-1))/cosh(m(T/2-t)) (periodic correlator), by 200 steps of
    bisection on [1e-8, 10]; NaN where no root is bracketed."""
    c = np.asarray(corr, dtype=np.float64)
    T = len(c)
    out = np.full(T - 1, np.nan)
    for t in range(T - 1):
        ratio = c[t + 1] / c[t]
        if not np.isfinite(ratio) or ratio <= 0:
            continue

        def f(m):
            return (np.cosh(m * (T / 2 - (t + 1)))
                    / np.cosh(m * (T / 2 - t))) - ratio

        lo, hi = 1e-8, 10.0
        if f(lo) * f(hi) > 0:
            continue
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if f(lo) * f(mid) <= 0:
                hi = mid
            else:
                lo = mid
        out[t] = 0.5 * (lo + hi)
    return out


def fit_cosh_mass(corrs, lo: int, hi: int):
    """Jackknifed weighted cosh fit of the pion mass over t in [lo, hi).

    ``corrs`` (n_configs, T): per-configuration folded correlators. Fits
    C(t) = A cosh(m (t - T/2)) by weighted least squares (scipy's
    ``curve_fit``; weights from the per-config scatter of the mean) with
    single-elimination jackknife errors on m. Returns (m, m_err, A)."""
    from scipy.optimize import curve_fit

    corrs = np.asarray(corrs, dtype=np.float64)
    n, T = corrs.shape
    ts = np.arange(lo, hi, dtype=np.float64)
    sig = corrs[:, lo:hi].std(axis=0, ddof=1) / np.sqrt(n)
    sig = np.where(sig > 0, sig, np.nanmax(sig) if np.nanmax(sig) > 0
                   else 1.0)

    def model(t, A, m):
        return A * np.cosh(m * (t - T / 2.0))

    def one_fit(c):
        c = c[lo:hi]
        # acosh seed from the window midpoint
        mid = len(c) // 2
        r = ((c[mid + 1] + c[mid - 1]) / (2.0 * c[mid])
             if 0 < mid < len(c) - 1 else 1.1)
        m0 = float(np.arccosh(r)) if r > 1.0 else 0.1
        A0 = c[mid] / np.cosh(m0 * (ts[mid] - T / 2.0))
        popt, _ = curve_fit(model, ts, c, p0=[A0, m0], sigma=sig,
                            absolute_sigma=True, maxfev=20000)
        return abs(popt[1]), popt[0]

    m_full, A_full = one_fit(corrs.mean(axis=0))
    jk = np.array([one_fit(np.delete(corrs, i, axis=0).mean(axis=0))[0]
                   for i in range(n)])
    m_err = float(np.sqrt((n - 1) * np.var(jk)))
    return float(m_full), m_err, float(A_full)
