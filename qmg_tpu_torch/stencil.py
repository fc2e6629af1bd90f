"""Generic distance-1 stencil engine (port of the ORIGINAL path of
qmg_tpu/stencil.py).

Coefficients live in a ``StencilCoeffs`` record: clover (2, Y, Xh, nc, nc),
hopping (4, 2, Y, Xh, nc, nc) over directions {+x, +y, -x, -y}, and the
scalar mass / even-odd / dof shifts as Python complex numbers. The apply
is ``M x = clover x + sum_d hopping_d x(s + d) + shifts``. Every apply
accepts leading batch axes on ``x`` (``(*batch, 2, Y, Xh, nc)``), which is
how the Galerkin probe build runs all coarse colours at once.

``build_gather_apply`` is the same apply as an index gather plus one
stacked matvec (the solver's ``coarse_apply="gather"``). The derived
stencils (dagger, right block Jacobi, Schur) and the distance-2 pieces
are not ported yet; ``Stencil2D`` refuses those stencil types.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from .lattice import Lattice2D
from .cshift import cshift_pull, ALL_DIRS
from . import linalg


class StencilType(enum.IntEnum):
    """Matvec variants (same values as qmg_tpu.stencil.StencilType)."""
    ORIGINAL = 0
    DAGGER = 1
    RIGHT_JACOBI = 2
    RIGHT_SCHUR = 3
    M_MDAGGER = 4
    MDAGGER_M = 5
    RBJ_DAGGER = 6
    RBJ_M_MDAGGER = 7
    RBJ_MDAGGER_M = 8


class ChiralityState(enum.IntEnum):
    NO = 0
    YES = 1
    UNKNOWN = 2


class DefaultChirality(enum.IntEnum):
    NONE = 0
    GAMMA_5 = 1
    SIGMA_1 = 2


@dataclasses.dataclass
class StencilCoeffs:
    """One coefficient set of a distance-1 stencil. ``clover`` or
    ``hopping`` may be None when the piece does not exist."""
    lat: Lattice2D
    clover: Optional[torch.Tensor]
    hopping: Optional[torch.Tensor]
    shift: complex
    eo_shift: complex
    dof_shift: complex
    _stacked: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    def stacked(self) -> torch.Tensor:
        """[clover, hopping_+x, +y, -x, -y] as one (5, 2, Y, Xh, nc, nc)
        tensor (clover omitted when absent), built once."""
        if self._stacked is None:
            parts = [self.hopping]
            if self.clover is not None:
                parts = [self.clover[None]] + parts
            self._stacked = torch.cat(parts)
        return self._stacked


def _round_scalar(v, dtype) -> complex:
    """A shift as the coefficient dtype holds it (complex64 rounds)."""
    np_dtype = np.complex64 if dtype == torch.complex64 else np.complex128
    return complex(np_dtype(v))


def make_coeffs(lat: Lattice2D, clover=None, hopping=None, shift=0.0,
                eo_shift=0.0, dof_shift=0.0,
                dtype=torch.complex128) -> StencilCoeffs:
    return StencilCoeffs(lat=lat, clover=clover, hopping=hopping,
                         shift=_round_scalar(shift, dtype),
                         eo_shift=_round_scalar(eo_shift, dtype),
                         dof_shift=_round_scalar(dof_shift, dtype))


def _batch_dims(x) -> int:
    return x.ndim - 4


def apply_clover(coeffs: StencilCoeffs, x):
    """clover * x on the full lattice."""
    if coeffs.clover is None:
        return torch.zeros_like(x)
    return linalg.site_matvec(coeffs.clover, x)


def apply_hopping(coeffs: StencilCoeffs, x, direction: Optional[int] = None):
    """Hopping term on both parities; with ``direction``, only that term
    (the Galerkin probe build uses one direction at a time)."""
    if coeffs.hopping is None or coeffs.lat.volume == 1:
        return torch.zeros_like(x)
    nb = _batch_dims(x)
    dirs = ALL_DIRS if direction is None else (direction,)
    out = torch.zeros_like(x)
    for d in dirs:
        out = out + linalg.site_matvec(coeffs.hopping[d],
                                       cshift_pull(x, d, nb))
    return out


def apply_shift(coeffs: StencilCoeffs, x):
    """Mass / even-odd / dof shifts."""
    lat = coeffs.lat
    nc = lat.nc
    nb = _batch_dims(x)
    half = nc // 2
    if lat.volume == 1:
        # The single site lives at parity 0.
        s = coeffs.shift + coeffs.eo_shift
        if nc % 2 == 0:
            d = coeffs.dof_shift
            out = torch.cat([(s + d) * x[..., :half],
                             (s - d) * x[..., half:]], dim=-1)
        else:
            out = s * x
        if x.shape[nb] == 2:
            out = out.clone()
            out.select(nb, 1).zero_()
        return out
    even = (coeffs.shift + coeffs.eo_shift) * x.select(nb, 0)
    odd = (coeffs.shift - coeffs.eo_shift) * x.select(nb, 1)
    out = torch.stack([even, odd], dim=nb)
    if nc % 2 == 0 and coeffs.dof_shift != 0:
        d = coeffs.dof_shift
        out = torch.cat([out[..., :half] + d * x[..., :half],
                         out[..., half:] - d * x[..., half:]], dim=-1)
    return out


def apply_M(coeffs: StencilCoeffs, x):
    """Full operator M x: clover and hopping as one stacked site matvec
    over [x, x(s+x), x(s+y), x(s-x), x(s-y)], plus the shifts."""
    if coeffs.hopping is not None and coeffs.lat.volume > 1:
        nb = _batch_dims(x)
        nbrs = [cshift_pull(x, d, nb) for d in ALL_DIRS]
        if coeffs.clover is not None:
            nbrs = [x] + nbrs
        out = linalg.stacked_site_matvec(coeffs.stacked(), torch.stack(nbrs))
        return out + apply_shift(coeffs, x)
    return apply_clover(coeffs, x) + apply_hopping(coeffs, x) \
        + apply_shift(coeffs, x)


def build_gather_apply(coeffs: StencilCoeffs):
    """The apply as one index gather plus one stacked matvec (port of
    qmg_tpu.stencil.build_gather_apply, the ``coarse_apply="gather"``
    formulation): the neighbour table is ``cshift_pull`` of the site ids,
    built once. Returns apply(x) for an unbatched field, or None where
    qmg_tpu's has none (no clover or hopping, or volume 1)."""
    lat = coeffs.lat
    if coeffs.hopping is None or coeffs.clover is None or lat.volume <= 1:
        return None
    site_ids = torch.arange(lat.volume).reshape(2, lat.y_len, lat.xh)
    nbr_idx = torch.stack([site_ids.reshape(-1)] + [
        cshift_pull(site_ids, d).reshape(-1) for d in ALL_DIRS]).to(
            coeffs.hopping.device)                      # (5, volume)
    mats = coeffs.stacked().reshape(5, lat.volume, lat.nc, lat.nc)

    def apply_fn(x):
        xg = x.reshape(lat.volume, lat.nc)[nbr_idx]     # (5, volume, nc)
        out = linalg.stacked_site_matvec(mats, xg).reshape(x.shape)
        return out + apply_shift(coeffs, x)

    return apply_fn


def mass_pattern(coeffs: StencilCoeffs):
    """Per-site diagonal mass matrix with the eo/dof sign structure."""
    lat = coeffs.lat
    nc = lat.nc
    dtype = (coeffs.clover if coeffs.clover is not None
             else coeffs.hopping).dtype
    device = (coeffs.clover if coeffs.clover is not None
              else coeffs.hopping).device
    diag_even = np.full((nc,), coeffs.shift + coeffs.eo_shift)
    diag_odd = np.full((nc,), coeffs.shift - coeffs.eo_shift)
    if nc % 2 == 0:
        sgn = np.concatenate([np.ones(nc // 2), -np.ones(nc // 2)])
        diag_even = diag_even + coeffs.dof_shift * sgn
        diag_odd = diag_odd + coeffs.dof_shift * sgn
    if lat.volume == 1:
        diag_odd = diag_even
    pat = torch.as_tensor(np.stack([np.diag(diag_even), np.diag(diag_odd)]),
                          dtype=dtype, device=device)
    return pat[:, None, None].expand(lat.cm_shape()).clone()


class Stencil2D:
    """An original coefficient set with the uniform apply/prepare/
    reconstruct dispatch. ``apply_override``, when set, replaces the
    ORIGINAL apply (the solver installs the CUDA kernels and the gather
    apply here); it must compute the full ``apply_M``."""

    def __init__(self, coeffs: StencilCoeffs):
        self.coeffs = coeffs
        self.apply_override = None

    @property
    def lat(self) -> Lattice2D:
        return self.coeffs.lat

    @staticmethod
    def _check_type(stype) -> StencilType:
        t = StencilType(stype)
        if t != StencilType.ORIGINAL:
            raise NotImplementedError(
                f"stencil type {t.name} is not ported yet (ORIGINAL only)")
        return t

    def apply_M(self, x, stype: StencilType = StencilType.ORIGINAL):
        self._check_type(stype)
        if self.apply_override is not None:
            return self.apply_override(x)
        return apply_M(self.coeffs, x)

    def prepare_M(self, b, stype: StencilType = StencilType.ORIGINAL):
        self._check_type(stype)
        return b

    def reconstruct_M(self, y, b, stype: StencilType = StencilType.ORIGINAL):
        self._check_type(stype)
        return y

    def get_apply_function(self, stype: StencilType = StencilType.ORIGINAL):
        t = self._check_type(stype)
        return lambda x: self.apply_M(x, t)

    def solve_size_shape(self, stype: StencilType = StencilType.ORIGINAL):
        self._check_type(stype)
        return self.lat.cv_shape()

    # --- chirality interface; operators override ---
    def chiral_projection(self, x, is_up: bool):
        raise NotImplementedError

    def chiral_projection_both(self, x):
        """(up, down) chiral projections."""
        return (self.chiral_projection(x, True),
                self.chiral_projection(x, False))
