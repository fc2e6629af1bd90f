"""Multigrid hierarchy: the level stack (port of qmg_tpu/multigrid.py).

Parallel per-level lists of lattices, transfers, stencils, whether each
stencil belongs to the hierarchy (built or adopted by it), and the raw
(doubled, not yet block-orthonormalized) null vectors each transfer was
made from. Levels are pushed, popped, or replaced in place
(``update_level``, the adaptive setup's step).
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
        self.is_stencil_managed: List[bool] = [False]
        self.global_null_vectors: list = []

    def get_num_levels(self) -> int:
        return len(self.lattice_list)

    def get_lattice(self, i: int) -> Lattice2D:
        return self.lattice_list[i]

    def get_transfer(self, i: int) -> TransferMG:
        return self.transfer_list[i]

    def get_stencil(self, i: int) -> Optional[Stencil2D]:
        return self.stencil_list[i]

    def get_global_null_vectors(self, i: int):
        """The raw null vectors level ``i``'s transfer was made from, or
        None."""
        return self.global_null_vectors[i]

    def _coarse_stencil(self, fine: Stencil2D, new_lat, new_transfer,
                        build_stencil, is_chiral, stencil,
                        build_stencil_from, build_extra):
        if stencil is None and build_stencil:
            stencil = CoarseOperator2D(
                new_lat, fine, new_transfer, is_chiral=is_chiral,
                use_rbjacobi=build_stencil_from == PRECOND_RIGHT_BLOCK_JACOBI,
                build_extra=build_extra)
        return stencil

    def push_level(self, new_lat: Lattice2D, new_transfer: TransferMG,
                   build_stencil: bool = False, is_chiral: bool = False,
                   stencil: Optional[Stencil2D] = None,
                   build_stencil_from: int = PRECOND_ORIGINAL,
                   build_extra: int = CoarseOperator2D.BUILD_ORIGINAL,
                   nvecs=None):
        """Append a level. With ``build_stencil`` the Galerkin coarse
        operator of the current coarsest stencil is built, from its
        original set or (``PRECOND_RIGHT_BLOCK_JACOBI``) its rbjacobi
        form, with the ``build_extra`` derived sets; a prebuilt
        ``stencil`` is adopted as is. ``nvecs`` are the raw null vectors
        of ``new_transfer``, kept for ``get_global_null_vectors``."""
        stencil = self._coarse_stencil(
            self.stencil_list[-1], new_lat, new_transfer, build_stencil,
            is_chiral, stencil, build_stencil_from, build_extra)
        self.lattice_list.append(new_lat)
        self.transfer_list.append(new_transfer)
        self.stencil_list.append(stencil)
        self.is_stencil_managed.append(stencil is not None)
        self.global_null_vectors.append(nvecs)

    def pop_level(self):
        """Drop the coarsest level."""
        if self.get_num_levels() == 1:
            raise ValueError("cannot pop the only level")
        self.lattice_list.pop()
        self.transfer_list.pop()
        self.stencil_list.pop()
        self.is_stencil_managed.pop()
        self.global_null_vectors.pop()

    def update_level(self, level: int, new_lat: Lattice2D,
                     new_transfer: TransferMG, build_stencil: bool = False,
                     is_chiral: bool = False,
                     stencil: Optional[Stencil2D] = None,
                     build_stencil_from: int = PRECOND_ORIGINAL,
                     build_extra: int = CoarseOperator2D.BUILD_ORIGINAL,
                     nvecs=None):
        """Replace coarse level ``level`` (>= 1) in place: its lattice, the
        transfer that reaches it, and its stencil, built as ``push_level``
        builds one from the (unchanged) level above. The levels below keep
        their old stencils until they are updated too."""
        if level < 1 or level >= self.get_num_levels():
            raise ValueError(f"cannot update level {level}")
        self.lattice_list[level] = new_lat
        self.transfer_list[level - 1] = new_transfer
        stencil = self._coarse_stencil(
            self.stencil_list[level - 1], new_lat, new_transfer,
            build_stencil, is_chiral, stencil, build_stencil_from,
            build_extra)
        self.stencil_list[level] = stencil
        self.is_stencil_managed[level] = stencil is not None
        self.global_null_vectors[level - 1] = nvecs
