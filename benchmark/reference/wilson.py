"""The 2D Wilson-Dirac operator on a U(1) gauge field, in complex128, on
the full grid: the plain reference that judges a solve's answer.

    M psi(s) = (m + 2r) psi(s)
               - 1/2 sum_mu [ (r - gamma_mu) U_mu(s) psi(s + mu)
                            + (r + gamma_mu) conj(U_mu(s - mu)) psi(s - mu) ]

with gamma_x = sigma_1, gamma_y = sigma_2, periodic boundaries, r the
Wilson coefficient. Fields come in the even-odd packed layout that the
benchmark's inputs use, ``(2, Y, X/2, 2)`` (parity, row, packed column,
spin), where site (x, y) has parity (x + y) % 2 and packed column x // 2;
the gauge field is ``(2, 2, Y, X/2)`` (direction x / y, then the same
packing). Nothing here reads what the program built: only the gauge
field, the right-hand side and the program's answer.
"""

from __future__ import annotations

import torch

SIGMA = {
    "x": ((0, 1), (1, 0)),
    "y": ((0, -1j), (1j, 0)),
}


def unpack(field: torch.Tensor) -> torch.Tensor:
    """(2, Y, X/2, ...) even-odd packed -> (Y, X, ...) full grid."""
    _, y_len, xh = field.shape[:3]
    y = torch.arange(y_len, device=field.device)[:, None]
    x = torch.arange(2 * xh, device=field.device)[None, :]
    return field[(x + y) % 2, y, x // 2]


def pack(grid: torch.Tensor) -> torch.Tensor:
    """(Y, X, ...) full grid -> (2, Y, X/2, ...) even-odd packed."""
    y_len, x_len = grid.shape[:2]
    p = torch.arange(2, device=grid.device)[:, None, None]
    y = torch.arange(y_len, device=grid.device)[None, :, None]
    xh = torch.arange(x_len // 2, device=grid.device)[None, None, :]
    return grid[y, 2 * xh + (y + p) % 2]


def _spin(mat, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(mat, dtype=like.dtype, device=like.device)


def wilson_apply(gauge_grid: torch.Tensor, psi: torch.Tensor, mass: float,
                 r: float = 1.0) -> torch.Tensor:
    """M psi on the full grid: ``gauge_grid`` (2, Y, X) links (U_x, U_y),
    ``psi`` (Y, X, 2), both of one complex dtype (complex128 to judge)."""
    eye = _spin(((1, 0), (0, 1)), psi)
    out = (mass + 2.0 * r) * psi
    for mu, axis in (("x", 1), ("y", 0)):
        u = gauge_grid[0 if mu == "x" else 1]
        gamma = _spin(SIGMA[mu], psi)
        fwd = u[..., None] * torch.roll(psi, -1, dims=axis)
        bwd = torch.roll(torch.conj(u)[..., None] * psi, 1, dims=axis)
        out = out - 0.5 * (fwd @ (r * eye - gamma).T
                           + bwd @ (r * eye + gamma).T)
    return out


def true_residual(gauge: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  mass: float, r: float = 1.0) -> float:
    """||b - M x|| / ||b|| in complex128, all three in the packed layout."""
    gauge_grid = torch.stack([unpack(gauge[0]), unpack(gauge[1])]).to(
        torch.complex128)
    b_grid = unpack(b).to(torch.complex128)
    res = b_grid - wilson_apply(gauge_grid, unpack(x).to(torch.complex128),
                                mass, r)
    return float(torch.linalg.vector_norm(res)
                 / torch.linalg.vector_norm(b_grid))
