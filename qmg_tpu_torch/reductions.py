"""Timeslice reductions and wall sources (port of qmg_tpu/reductions.py,
the counterpart of the reference's reductions/reductions.h:24-162).

On the (2, Y, Xh, nc) eo layout a timeslice (fixed y) reduction is a sum
over the (parity, xh, colour) axes. The reductions take tensors and keep
any leading batch axes: ``(*batch, 2, Y, Xh, nc) -> (*batch, Y)``. The
wall sources are drawn on the host with the shared ``QMGRandom`` stream,
in qmg_tpu's order, and returned as NumPy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .lattice import Lattice2D

__all__ = ["norm2sq_timeslice", "redot_timeslice", "dot_timeslice",
           "gaussian_wall_source", "gaussian_wall_source_real"]

_SITE_AXES = (-4, -2, -1)   # parity, xh, colour


def norm2sq_timeslice(cv):
    """Per-y |cv|^2 sums -> (..., Y) real."""
    return torch.sum(cv.abs() ** 2, dim=_SITE_AXES)


def redot_timeslice(cv1, cv2):
    """Per-y Re<cv1, cv2> -> (..., Y) real."""
    return torch.sum(torch.real(torch.conj(cv1) * cv2), dim=_SITE_AXES)


def dot_timeslice(cv1, cv2):
    """Per-y <cv1, cv2> -> (..., Y) complex."""
    return torch.sum(torch.conj(cv1) * cv2, dim=_SITE_AXES)


def gaussian_wall_source(lat: Lattice2D, timeslice: int, color: int, rng,
                         deviation: float = 1.0, mean: float = 0.0
                         ) -> np.ndarray:
    """A real gaussian source on one timeslice and colour in complex128
    storage (the reference's std::complex<T> overload): (2, Xh) draws in
    flat eo order into the real part, the imaginary part 0."""
    if timeslice >= lat.y_len:
        raise ValueError("timeslice must be < Ny")
    if color >= lat.nc:
        raise ValueError("color must be < Nc")
    src = np.zeros(lat.cv_shape(), dtype=np.complex128)
    src[:, timeslice, :, color] = rng.gaussian_real((2, lat.xh),
                                                    deviation) + mean
    return src


def gaussian_wall_source_real(lat: Lattice2D, timeslice: int, color: int,
                              rng, deviation: float = 1.0,
                              mean: float = 0.0) -> np.ndarray:
    """The same draws in float64 storage (the reference's T* overload)."""
    return np.real(gaussian_wall_source(
        lat, timeslice, color, rng, deviation=deviation, mean=mean)
    ).astype(np.float64)
