from .wilson import Wilson2D  # noqa: F401
from .coarse import CoarseOperator2D  # noqa: F401

__all__ = ["Wilson2D", "CoarseOperator2D"]
