"""Dense operator materialization (port of ``densify`` from
qmg_tpu/eig.py; the eigensolvers are not ported yet)."""

from __future__ import annotations

import numpy as np
import torch


def densify(matvec, shape, *, dtype, device, batch: int = 256
            ) -> np.ndarray:
    """Materialize the operator matrix (host complex128): column j is
    matvec(e_j), applied to the basis ``batch`` columns at a time."""
    n = int(np.prod(shape))
    cols = []
    for start in range(0, n, batch):
        m = min(batch, n - start)
        basis = torch.zeros((m, n), dtype=dtype, device=device)
        basis[torch.arange(m, device=device),
              torch.arange(start, start + m, device=device)] = 1.0
        out = matvec(basis.reshape((m,) + tuple(shape)))
        cols.append(out.reshape(m, n).cpu().numpy())
    return np.concatenate(cols).astype(np.complex128).T
