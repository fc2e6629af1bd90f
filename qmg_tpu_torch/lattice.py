"""Lattice geometry and even-odd index algebra (port of qmg_tpu/lattice.py).

A field with ``dof`` degrees of freedom per site is a tensor of shape
``(2, Y, X//2, dof...)`` (parity-major, eo-packed x), so
``field.reshape(-1)`` is the reference's flat eo ordering. Within row ``y``
at parity ``p`` the physical x of packed column ``xh`` is
``2*xh + (y + p) % 2``. Index conversions are host-side NumPy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Direction indices for gauge/hopping arrays: {+x, +y, -x, -y}.
DIR_XP1 = 0
DIR_YP1 = 1
DIR_XM1 = 2
DIR_YM1 = 3


@dataclasses.dataclass(frozen=True)
class Lattice2D:
    """Static metadata for a 2D even-odd lattice."""

    x_len: int
    y_len: int
    nc: int

    def __post_init__(self):
        if self.volume > 1 and self.x_len % 2 != 0:
            raise ValueError(
                f"even-odd layout requires even X (got {self.x_len})")

    @property
    def dims(self):
        return (self.x_len, self.y_len)

    @property
    def volume(self) -> int:
        return self.x_len * self.y_len

    @property
    def size_cv(self) -> int:
        return self.volume * self.nc

    @property
    def xh(self) -> int:
        """Packed x extent (X/2). For volume==1 lattices this is 1."""
        return max(self.x_len // 2, 1)

    def get_dim_mu(self, mu: int) -> int:
        return self.dims[mu] if 0 <= mu < 2 else -1

    def with_nc(self, nc: int) -> "Lattice2D":
        return Lattice2D(self.x_len, self.y_len, nc)

    def coord_to_pyx(self, x: int, y: int):
        """(x, y) -> (parity, y, xh) of that site in the eo layout."""
        if self.volume == 1:
            return 0, 0, 0
        return (x + y) % 2, y, (x // 2) % self.xh

    def cv_shape(self):
        """(2, Y, X/2, nc) color-vector field."""
        return (2, self.y_len, self.xh, self.nc)

    def cm_shape(self):
        """(2, Y, X/2, nc, nc) color-matrix field; [..., row, col]."""
        return (2, self.y_len, self.xh, self.nc, self.nc)

    def hopping_shape(self):
        """(4=dir, 2, Y, X/2, nc, nc), dir in {+x,+y,-x,-y}."""
        return (4, 2, self.y_len, self.xh, self.nc, self.nc)

    def x_coord_grid(self) -> np.ndarray:
        """(2, Y, X/2) int array of physical x coordinates per packed slot."""
        if self.volume == 1:
            return np.zeros((2, 1, 1), dtype=np.int64)
        p = np.arange(2)[:, None, None]
        y = np.arange(self.y_len)[None, :, None]
        xh = np.arange(self.xh)[None, None, :]
        return 2 * xh + (y + p) % 2

    def y_coord_grid(self) -> np.ndarray:
        """(2, Y, X/2) int array of y coordinates per packed slot."""
        y = np.arange(self.y_len)[None, :, None]
        return np.broadcast_to(y, (2, self.y_len, self.xh)).copy()


def eo_pack(grid: np.ndarray, lat: Lattice2D) -> np.ndarray:
    """Full-grid array (Y, X, dof...) -> eo layout (2, Y, X/2, dof...)."""
    grid = np.asarray(grid)
    return grid[lat.y_coord_grid(), lat.x_coord_grid()]


def eo_unpack(field: np.ndarray, lat: Lattice2D) -> np.ndarray:
    """eo-layout array (2, Y, X/2, dof...) -> full grid (Y, X, dof...)."""
    field = np.asarray(field)
    out = np.empty((lat.y_len, lat.x_len) + field.shape[3:],
                   dtype=field.dtype)
    out[lat.y_coord_grid(), lat.x_coord_grid()] = field
    return out
