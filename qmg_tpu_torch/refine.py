"""Mixed-precision iterative refinement: a complex128 tolerance from a
complex64 solve (port of qmg_tpu/refine.py).

Defect correction around a reduced-precision solver:

    x = 0
    repeat:  r = b - A x        # complex128
             d = solve(r)       # complex64
             x = x + d          # complex128
    until ||r|| <= tol ||b||

Each pass gains the inner solver's digits (about five for a complex64
K-cycle at tol 1e-5), so two or three passes reach 1e-10. The residual
and the update run in torch on the operator's device: ``apply`` is the
exact complex128 operator, for a stencil the plain ``stencil.apply_M``
of its coefficients promoted with ``StencilCoeffs.to``. (qmg_tpu takes
the residual to NumPy on the host because the TPU has no complex128.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = ["refine_solve", "RefineResult"]


@dataclasses.dataclass
class RefineResult:
    x: torch.Tensor             # complex128 solution, on b's device
    converged: bool
    outer_iters: int            # defect-correction passes
    inner_iters: int            # summed inner-solve iterations
    rel_resid: float            # true complex128 relative residual
    history: list               # relative residual before each pass + final


def refine_solve(apply: Callable, inner_solve: Callable, b: torch.Tensor,
                 tol: float = 1e-10, max_outer: int = 12,
                 x0: Optional[torch.Tensor] = None) -> RefineResult:
    """Defect correction to ``tol``. ``apply(x)`` is the complex128
    operator; ``inner_solve(r) -> (d, iters)`` is an approximate A^-1 in
    any precision, given the complex128 residual scaled to unit norm.
    Stops with ``converged=False`` after ``max_outer`` passes or as soon
    as a pass fails to lower the residual (the inner solver is at its
    floor)."""
    b = b.to(torch.complex128)
    bnorm = float(torch.linalg.vector_norm(b))
    if bnorm == 0.0:
        return RefineResult(torch.zeros_like(b), True, 0, 0, 0.0, [0.0])
    x = (torch.zeros_like(b) if x0 is None
         else x0.to(device=b.device, dtype=torch.complex128).clone())
    history = []
    inner_total = 0
    outer = 0
    prev = float("inf")
    while True:
        r = b - apply(x)
        rnorm = float(torch.linalg.vector_norm(r))
        rel = rnorm / bnorm
        history.append(rel)
        if rel <= tol:
            return RefineResult(x, True, outer, inner_total, rel, history)
        if outer >= max_outer or rel >= prev:
            return RefineResult(x, False, outer, inner_total, rel, history)
        prev = rel
        d, iters = inner_solve(r / rnorm)
        inner_total += int(iters)
        x = x + rnorm * d.to(torch.complex128)
        outer += 1
