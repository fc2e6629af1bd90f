"""Eigensolvers: dense full spectrum and thick-restart Arnoldi (port of
qmg_tpu/eig.py).

  * ``densify`` materializes an operator by applying it to the basis, and
    ``dense_eigensystem`` takes its spectrum with LAPACK (``numpy.linalg.
    eig``) on the host in complex128: the oracle, and the route of the
    coarsest deflation (``StatefulMultigridMG.deflate_coarsest``), whose
    operators are at most 4096-dimensional.
  * ``arnoldi_eigensystem`` (partial spectrum) and
    ``shift_invert_eigensystem`` (eigenvalues nearest a shift, through any
    approximate solve) run a Krylov-Schur Arnoldi: the ncv-step
    factorization on the field's device (``make_arnoldi_sweep``), the small
    (ncv + 1, ncv) Hessenberg matrix brought to the host once a restart,
    where its eigensystem and the thick restart are computed in
    complex128 NumPy.

Selectors mirror ARPACK's: ``SMALLEST_REAL``, ``SMALLEST_MAGNITUDE``,
``LARGEST_REAL``, ``LARGEST_MAGNITUDE``. Eigenvalues come back as NumPy
arrays; eigenvectors as NumPy arrays from the dense path and as tensors on
the device from the Arnoldi path.
"""

from __future__ import annotations

import numpy as np
import torch

from .linalg import pin_full_precision

SMALLEST_REAL = "SR"
SMALLEST_MAGNITUDE = "SM"
LARGEST_REAL = "LR"
LARGEST_MAGNITUDE = "LM"

# Up to this dimension ``arnoldi_eigensystem`` takes the dense spectrum.
_DENSE_CUTOFF = 4096


def densify(matvec, shape, *, dtype, device, batch: int = 256
            ) -> np.ndarray:
    """Materialize the operator matrix (host complex128): column j is
    matvec(e_j), applied to the basis ``batch`` columns at a time."""
    pin_full_precision()
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


def dense_eigensystem(matvec, shape, *, dtype=torch.complex128, device):
    """Full spectrum: (evals (n,), evecs (n, *shape)), host complex128,
    sorted by ascending real part."""
    mat = densify(matvec, shape, dtype=dtype, device=device)
    evals, evecs = np.linalg.eig(mat)
    order = np.argsort(evals.real)
    return evals[order], evecs[:, order].T.reshape((-1,) + tuple(shape))


def _select(evals, which, nev):
    if which == SMALLEST_REAL:
        order = np.argsort(evals.real)
    elif which == LARGEST_REAL:
        order = np.argsort(-evals.real)
    elif which == SMALLEST_MAGNITUDE:
        order = np.argsort(np.abs(evals))
    elif which == LARGEST_MAGNITUDE:
        order = np.argsort(-np.abs(evals))
    else:
        raise ValueError(f"unknown selector {which}")
    return order[:nev]


def make_arnoldi_sweep(matvec, ncv: int):
    """The device half of the Krylov-Schur Arnoldi, three functions on
    the basis V (ncv + 1, *shape) and the Hessenberg matrix H (ncv + 1,
    ncv), both tensors on the field's device:

      * ``sweep(V, H, k0)`` extends the factorization A V = V H + f e^T
        from step k0 to ncv by classical Gram-Schmidt applied twice;
      * ``rotate(V, Q)`` is the thick restart's basis update: rows
        [Q V[:ncv], V[ncv], 0, ...] for Q (k, ncv);
      * ``ritz(V, S)`` the normalized Ritz vectors S V[:ncv]."""
    ncv = int(ncv)

    def sweep(V, H, k0: int):
        for j in range(k0, ncv):
            w = matvec(V[j])
            basis = V[:j + 1].reshape(j + 1, -1)
            wf = w.reshape(-1)
            h1 = basis.conj() @ wf
            wf = wf - h1 @ basis
            h2 = basis.conj() @ wf
            wf = wf - h2 @ basis
            beta = torch.linalg.vector_norm(wf)
            H[:j + 1, j] = h1 + h2
            H[j + 1, j] = beta
            safe = torch.where(beta > 0, beta, 1.0)
            V[j + 1] = (wf / safe).reshape(w.shape)
        return V, H

    def rotate(V, Q):
        k = Q.shape[0]
        out = torch.zeros_like(V)
        out[:k] = torch.tensordot(Q, V[:ncv], dims=1)
        out[k] = V[ncv]
        return out

    def ritz(V, S):
        vecs = torch.tensordot(S, V[:ncv], dims=1)
        nrm = torch.linalg.vector_norm(vecs.reshape(vecs.shape[0], -1),
                                       dim=1)
        return vecs / nrm.reshape((-1,) + (1,) * (vecs.ndim - 1))

    return sweep, rotate, ritz


def _krylov_schur(op, shape, nev, which, ncv, max_restarts, tol, seed,
                  dtype, device):
    """Thick-restart (Krylov-Schur) Arnoldi shared by
    ``arnoldi_eigensystem`` and ``shift_invert_eigensystem``. Returns
    (Ritz values (nev,) NumPy, Ritz vectors (nev, *shape) on the
    device)."""
    pin_full_precision()
    sweep, rotate, ritz = make_arnoldi_sweep(op, ncv)
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    v0 = v0 / np.sqrt(np.sum(np.abs(v0) ** 2))
    V = torch.zeros((ncv + 1,) + tuple(shape), dtype=dtype, device=device)
    V[0] = torch.as_tensor(v0).to(device=device, dtype=dtype)
    H = torch.zeros((ncv + 1, ncv), dtype=dtype, device=device)

    def host_H(H):
        return H.cpu().numpy().astype(np.complex128)

    def to_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dtype)

    V, H = sweep(V, H, 0)
    for _ in range(max_restarts):
        Hh = host_H(H)
        Hm = Hh[:ncv, :ncv]
        evals, S = np.linalg.eig(Hm)
        sel = _select(evals, which, nev)
        resid = np.abs(Hh[ncv, ncv - 1]) * np.abs(S[ncv - 1, sel])
        if np.all(resid < tol * np.maximum(np.abs(evals[sel]), 1e-30)):
            break
        # Thick restart: keep the nev wanted Ritz vectors. From
        # A V = V H + f e_k^T with f = V[ncv] H[ncv, ncv-1]:
        # A (V Q) = (V Q)(Q^H H Q) + f (e_k^T Q).
        Q = np.linalg.qr(S[:, sel])[0]
        newH = np.zeros_like(Hh)
        newH[:nev, :nev] = Q.conj().T @ Hm @ Q
        newH[nev, :nev] = Hh[ncv, ncv - 1] * Q[ncv - 1, :]
        V = rotate(V, to_dev(Q.T))
        H = to_dev(newH)
        V, H = sweep(V, H, nev)

    evals, S = np.linalg.eig(host_H(H)[:ncv, :ncv])
    sel = _select(evals, which, nev)
    return evals[sel], ritz(V, to_dev(S[:, sel].T))


def shift_invert_eigensystem(solve, shape, nev: int, sigma=0.0,
                             ncv: int = None, max_restarts: int = 200,
                             tol: float = 1e-8, seed: int = 7, *,
                             dtype=torch.complex128, device, matvec=None):
    """The eigenpairs of M nearest ``sigma`` by shift-invert Arnoldi: the
    Krylov-Schur iteration on ``solve(v)`` (an approximate
    (M - sigma)^-1 v; any Krylov or MG solve) selects the largest Ritz
    values theta, which map back to lambda = sigma + 1 / theta. With
    ``matvec`` (M itself) the eigenvalues are refined as Rayleigh
    quotients of the returned vectors, which frees their accuracy from the
    inner solve's tolerance. Returns (evals (nev,), evecs (nev, *shape))
    in order of distance from ``sigma``."""
    n = int(np.prod(shape))
    ncv = ncv or min(max(3 * nev, 20), n)
    thetas, vecs = _krylov_schur(solve, shape, nev, LARGEST_MAGNITUDE, ncv,
                                 max_restarts, tol, seed, dtype, device)
    lam = complex(sigma) + 1.0 / thetas
    if matvec is not None:
        lam = np.array([complex(torch.sum(vecs[i].conj() * matvec(vecs[i])))
                        for i in range(len(lam))])
    order = np.argsort(np.abs(lam - complex(sigma)))
    return lam[order], vecs[torch.as_tensor(order, device=vecs.device)]


def arnoldi_eigensystem(matvec, shape, nev: int, which=SMALLEST_MAGNITUDE,
                        ncv: int = None, max_restarts: int = 200,
                        tol: float = 1e-8, seed: int = 7, *,
                        dtype=torch.complex128, device):
    """``nev`` eigenpairs selected by ``which``: by the dense spectrum up
    to ``_DENSE_CUTOFF`` dimensions, else by the Krylov-Schur Arnoldi.
    Returns (evals (nev,), evecs (nev, *shape))."""
    n = int(np.prod(shape))
    if n <= _DENSE_CUTOFF:
        evals, evecs = dense_eigensystem(matvec, shape, dtype=dtype,
                                         device=device)
        sel = _select(evals, which, nev)
        return evals[sel], evecs[sel]
    ncv = ncv or min(max(3 * nev, 20), n)
    return _krylov_schur(matvec, shape, nev, which, ncv, max_restarts, tol,
                         seed, dtype, device)
