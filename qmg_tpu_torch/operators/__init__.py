"""Physics operators: stencil constructors from gauge links (port of
qmg_tpu/operators)."""

from .laplace import FreeLaplace2D, GaugedLaplace2D  # noqa: F401
from .staggered import Staggered2D  # noqa: F401
from .wilson import Wilson2D  # noqa: F401
from .coarse import CoarseOperator2D, build_coarse_coeffs  # noqa: F401
from .dwf import Dwf2D, create_dwf_ls  # noqa: F401

__all__ = ["FreeLaplace2D", "GaugedLaplace2D", "Staggered2D", "Wilson2D",
           "CoarseOperator2D", "build_coarse_coeffs", "Dwf2D",
           "create_dwf_ls"]
