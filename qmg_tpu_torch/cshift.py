"""Periodic nearest-neighbour pull-shifts on eo-packed fields
(port of the distance-1 part of qmg_tpu/cshift.py).

``cshift_pull(field, D)[site] = field[site + D]`` with periodic wrap. The
destination parity-q half is read from the parity-(1-q) half:

  * +-y: a roll along Y with a parity swap;
  * +-x: within each destination row either a direct copy or a roll by
    one packed column, chosen by the row parity (eo packing halves the
    x stride).

Fields are ``(*batch, 2, Y, Xh, dof...)``; ``batch_dims`` says how many
leading axes precede the parity axis.
"""

from __future__ import annotations

import torch

from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1

__all__ = ["cshift_pull", "ALL_DIRS", "DIR_XP1", "DIR_YP1", "DIR_XM1",
           "DIR_YM1"]

ALL_DIRS = (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1)


def _pull_x_half(src, q: int, sign: int, y_axis: int):
    """Pull along +-x from the parity-(1-q) half ``src`` (Y at ``y_axis``,
    Xh at ``y_axis + 1``) into parity-q slots.

    Destination x = 2*xh + (y+q)%2. For +x the source column is xh when
    y%2 == q, else xh+1; for -x it is xh when y%2 != q, else xh-1.
    """
    y_len = src.shape[y_axis]
    direct_par = q if sign > 0 else 1 - q
    rows = torch.arange(y_len, device=src.device) % 2 == direct_par
    direct = rows.reshape((y_len,) + (1,) * (src.ndim - y_axis - 1))
    rolled = torch.roll(src, -sign, dims=y_axis + 1)
    return torch.where(direct, src, rolled)


def cshift_pull(field, direction: int, batch_dims: int = 0):
    """Full-lattice pull-shift: out[site] = field[site + direction]."""
    p_ax = batch_dims
    if direction in (DIR_YP1, DIR_YM1):
        swapped = torch.flip(field, dims=(p_ax,))
        return torch.roll(swapped, -1 if direction == DIR_YP1 else 1,
                          dims=p_ax + 1)
    if direction in (DIR_XP1, DIR_XM1):
        sign = 1 if direction == DIR_XP1 else -1
        src0 = field.select(p_ax, 0)
        src1 = field.select(p_ax, 1)
        return torch.stack([_pull_x_half(src1, 0, sign, p_ax),
                            _pull_x_half(src0, 1, sign, p_ax)], dim=p_ax)
    raise ValueError(f"unsupported cshift direction {direction}")
