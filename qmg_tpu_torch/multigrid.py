"""Multigrid hierarchy: the level stack (port of qmg_tpu/multigrid.py).

Parallel per-level lists of lattices, transfers and stencils.
"""

from __future__ import annotations

from typing import List, Optional

from .lattice import Lattice2D
from .stencil import Stencil2D
from .transfer import TransferMG
from .operators.coarse import CoarseOperator2D

# What a built coarse level coarsens: the fine stencil's original set or its
# right-block-Jacobi form.
PRECOND_ORIGINAL = 0
PRECOND_RIGHT_BLOCK_JACOBI = 1


class MultigridMG:
    def __init__(self, lat: Lattice2D, stencil: Stencil2D):
        self.lattice_list: List[Lattice2D] = [lat]
        self.stencil_list: List[Optional[Stencil2D]] = [stencil]
        self.transfer_list: List[TransferMG] = []

    def get_num_levels(self) -> int:
        return len(self.lattice_list)

    def get_lattice(self, i: int) -> Lattice2D:
        return self.lattice_list[i]

    def get_transfer(self, i: int) -> TransferMG:
        return self.transfer_list[i]

    def get_stencil(self, i: int) -> Optional[Stencil2D]:
        return self.stencil_list[i]

    def push_level(self, new_lat: Lattice2D, new_transfer: TransferMG,
                   build_stencil: bool = False, is_chiral: bool = False,
                   stencil: Optional[Stencil2D] = None,
                   build_stencil_from: int = PRECOND_ORIGINAL,
                   build_extra: int = CoarseOperator2D.BUILD_ORIGINAL):
        """Append a level. With ``build_stencil`` the Galerkin coarse
        operator of the current coarsest stencil is built, from its
        original set or (``PRECOND_RIGHT_BLOCK_JACOBI``) its rbjacobi
        form, with the ``build_extra`` derived sets; a prebuilt
        ``stencil`` is adopted as is."""
        self.lattice_list.append(new_lat)
        self.transfer_list.append(new_transfer)
        if stencil is None and build_stencil:
            stencil = CoarseOperator2D(
                new_lat, self.stencil_list[-1], new_transfer,
                is_chiral=is_chiral,
                use_rbjacobi=build_stencil_from == PRECOND_RIGHT_BLOCK_JACOBI,
                build_extra=build_extra)
        self.stencil_list.append(stencil)
