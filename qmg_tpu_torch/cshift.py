"""Periodic pull-shifts on eo-packed fields (port of qmg_tpu/cshift.py).

``cshift_pull(field, D)[site] = field[site + D]`` with periodic wrap.

Distance-1 shifts read the destination parity-q half from the
parity-(1-q) half:

  * +-y: a roll along Y with a parity swap;
  * +-x: within each destination row either a direct copy or a roll by
    one packed column, chosen by the row parity (eo packing halves the
    x stride).

The distance-2 shifts (+-2x, +-2y) and the corners (+-x+-y) preserve
parity: +-2x is a roll by one packed column, +-2y a roll by two rows, and
a corner is two distance-1 pulls. Codes 4..11 extend lattice.py's 0..3;
``TWOLINK_DIRS[i]`` / ``CORNER_DIRS[i]`` is the pull of coefficient slot
i ({+2X, +2Y, -2X, -2Y} and {+X+Y, -X+Y, -X-Y, +X-Y}).

``cshift_pull_half`` pulls one parity half without the other: the
even-odd (Schur) operators act on half fields.

Fields are ``(*batch, 2, Y, Xh, dof...)`` (half fields ``(*batch, Y, Xh,
dof...)``); ``batch_dims`` says how many leading axes precede the parity
(half: the Y) axis.
"""

from __future__ import annotations

import torch

from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1

__all__ = [
    "cshift_pull", "cshift_pull_half", "ALL_DIRS", "DIR_XP1", "DIR_YP1",
    "DIR_XM1", "DIR_YM1", "DIR_XP2", "DIR_YP2", "DIR_XM2", "DIR_YM2",
    "DIR_XP1YP1", "DIR_XM1YP1", "DIR_XM1YM1", "DIR_XP1YM1",
    "TWOLINK_DIRS", "CORNER_DIRS",
]

ALL_DIRS = (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1)

DIR_XP2 = 4
DIR_YP2 = 5
DIR_XM2 = 6
DIR_YM2 = 7
DIR_XP1YP1 = 8
DIR_XM1YP1 = 9
DIR_XM1YM1 = 10
DIR_XP1YM1 = 11

TWOLINK_DIRS = (DIR_XP2, DIR_YP2, DIR_XM2, DIR_YM2)
CORNER_DIRS = (DIR_XP1YP1, DIR_XM1YP1, DIR_XM1YM1, DIR_XP1YM1)

# Corner pull = composition of two distance-1 pulls:
# (pull_D1 . pull_D2)(f)[s] = pull_D2(f)[s + D1] = f[s + D1 + D2].
_CORNER_PARTS = {
    DIR_XP1YP1: (DIR_XP1, DIR_YP1),
    DIR_XM1YP1: (DIR_XM1, DIR_YP1),
    DIR_XM1YM1: (DIR_XM1, DIR_YM1),
    DIR_XP1YM1: (DIR_XP1, DIR_YM1),
}


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
    # Same-parity families (distance 2, corners).
    if direction in (DIR_XP2, DIR_XM2):
        return torch.roll(field, -1 if direction == DIR_XP2 else 1,
                          dims=p_ax + 2)
    if direction in (DIR_YP2, DIR_YM2):
        return torch.roll(field, -2 if direction == DIR_YP2 else 2,
                          dims=p_ax + 1)
    if direction in _CORNER_PARTS:
        d1, d2 = _CORNER_PARTS[direction]
        return cshift_pull(cshift_pull(field, d2, batch_dims), d1,
                           batch_dims)
    raise ValueError(f"unsupported cshift direction {direction}")


def cshift_pull_half(src_half, src_parity: int, direction: int,
                     batch_dims: int = 0):
    """Half-lattice pull-shift: ``src_half`` (*batch, Y, Xh, dof...) lives
    on parity ``src_parity``; returns out[dest] = src[dest + direction]
    aligned to the destination parity's packed slots: parity
    ``1 - src_parity`` for the distance-1 directions, ``src_parity`` for
    the parity-preserving distance-2 and corner directions.

    The x moves mask rows by parity: distance-1 pulls by the destination
    parity, corners by the source parity (the destination row's packing
    offset (y + p) % 2 decides whether +-x crosses a packed column)."""
    y_ax = batch_dims
    q = 1 - src_parity
    if direction in (DIR_YP1, DIR_YM1):
        return torch.roll(src_half, -1 if direction == DIR_YP1 else 1,
                          dims=y_ax)
    if direction in (DIR_XP1, DIR_XM1):
        return _pull_x_half(src_half, q, 1 if direction == DIR_XP1 else -1,
                            y_ax)
    if direction in (DIR_XP2, DIR_XM2):
        return torch.roll(src_half, -1 if direction == DIR_XP2 else 1,
                          dims=y_ax + 1)
    if direction in (DIR_YP2, DIR_YM2):
        return torch.roll(src_half, -2 if direction == DIR_YP2 else 2,
                          dims=y_ax)
    if direction in _CORNER_PARTS:
        dx, dy = _CORNER_PARTS[direction]
        rolled = torch.roll(src_half, -1 if dy == DIR_YP1 else 1, dims=y_ax)
        return _pull_x_half(rolled, src_parity,
                            1 if dx == DIR_XP1 else -1, y_ax)
    raise ValueError(f"unsupported cshift direction {direction}")
