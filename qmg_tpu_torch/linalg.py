"""Vector and per-site matrix primitives (port of qmg_tpu/linalg.py).

Fields are complex tensors of any shape; "cv" fields are (2, Y, Xh, nc)
and "cm" fields (2, Y, Xh, nc, nc) with [..., row, col]. Reductions
return 0-dim tensors on the field's device, so solver loops sync with the
host only where they test convergence. The ``*_lanes`` reductions are the
Krylov solvers': over every axis but a leading rhs axis, one result per
lane, ``(B,)``.
"""

from __future__ import annotations

import torch

__all__ = ["vdot", "norm2sq", "vdot_lanes", "norm2sq_lanes", "reductions",
           "lane_reductions",
           "norm", "diffnorm2sq", "norminf", "normalize",
           "orthogonal",
           "site_matvec", "stacked_site_matvec", "site_matmul",
           "site_conjtrans", "site_inv", "site_inv_qr", "identity_like",
           "pin_full_precision"]


def pin_full_precision():
    """Keep float32 products in full float32 (no TF32) on the card: a
    reduced-precision pass costs digits the Krylov trajectories and the
    eigensolves need."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def vdot(a, b):
    """<a, b> = sum conj(a) * b over all elements."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def norm2sq(a):
    """||a||^2 as a real 0-dim tensor."""
    return vdot(a, a).real


def vdot_lanes(a, b, reduce=None):
    """<a[k], b[k]> per lane k of a leading rhs axis -> (B,) complex.
    ``reduce`` sums the partial products over the ranks that share the
    fields (``reductions``)."""
    out = torch.linalg.vecdot(a.reshape(a.shape[0], -1),
                              b.reshape(b.shape[0], -1))
    return out if reduce is None else reduce(out)


def norm2sq_lanes(a, reduce=None):
    """||a[k]||^2 per lane k of a leading rhs axis -> (B,) real."""
    return vdot_lanes(a, a, reduce).real


def reductions(reduce=None):
    """(vdot, norm2sq, sum) for a Krylov solve on fields that are one
    rank's block of a lattice cut over ranks: ``reduce`` sums a tensor of
    partial results over the ranks in place and returns it
    (``parallel.Mesh.all_sum``). Without it, the plain functions. A solve
    takes the reduction as an argument because only its own level is cut:
    the coarse solves nested in its preconditioner run whole on every rank
    and must not be summed."""
    if reduce is None:
        return vdot, norm2sq, lambda t: t
    return (lambda a, b: reduce(vdot(a, b)),
            lambda a: reduce(vdot(a, a)).real, reduce)


def lane_reductions(reduce=None):
    """``reductions`` on a leading rhs axis: (vdot_lanes, norm2sq_lanes,
    sum), each lane's partial results summed over the ranks by
    ``reduce``."""
    if reduce is None:
        return vdot_lanes, norm2sq_lanes, lambda t: t
    return (lambda a, b: vdot_lanes(a, b, reduce),
            lambda a: norm2sq_lanes(a, reduce), reduce)


def norm(a):
    return torch.sqrt(norm2sq(a))


def diffnorm2sq(a, b):
    """||a - b||^2 as a real 0-dim tensor."""
    return norm2sq(a - b)


def norminf(a):
    """max |a| over all elements."""
    return a.abs().max()


def normalize(a, reduce=None):
    """a / ||a||; ``reduce`` as in ``reductions``."""
    _, nrm2, _ = reductions(reduce)
    return a / torch.sqrt(nrm2(a))


def orthogonal(a, b, reduce=None):
    """a - <b, a>/<b, b> * b; ``reduce`` as in ``reductions``."""
    dot, nrm2, _ = reductions(reduce)
    return a - (dot(b, a) / nrm2(b)) * b


def site_matvec(mat, vec):
    """Per-site y = A x: (..., nc, nc) x (..., nc) -> (..., nc); leading
    axes broadcast (a batch of fields against one matrix field)."""
    return (mat * vec.unsqueeze(-2)).sum(-1)


def stacked_site_matvec(mats, nbrs):
    """out[..., i] = sum_{s, j} mats[s, ..., i, j] nbrs[s, ..., j]; ``nbrs``
    may carry extra leading batch axes after the stacking axis."""
    n_batch = nbrs.ndim - mats.ndim + 1
    mats = mats.reshape(mats.shape[:1] + (1,) * n_batch + mats.shape[1:])
    return (mats * nbrs.unsqueeze(-2)).sum(dim=(0, -1))


def site_matmul(a, b):
    """Per-site C = A B."""
    return a @ b


def site_conjtrans(mat):
    """Per-site conjugate transpose (materialized, not a conj view)."""
    return mat.transpose(-1, -2).conj_physical()


def site_inv(mat):
    """Per-site inverse of square matrices (batched LU)."""
    return torch.linalg.inv(mat)


def site_inv_qr(mat):
    """Per-site inverse through batched Householder QR, R^-1 Q^H: the
    rbjacobi block inverse, which stays well conditioned where a closed
    form or a plain LU is not (the nc = 8 coarse blocks).

    ``torch.geqrf`` factors the whole batch in one call (batched cuBLAS on
    the card); Q^H is then the product of its n reflectors
    H_i^H = 1 - conj(tau_i) v_i v_i^H applied to the identity here, a loop
    over the n columns on the whole batch at once. (``torch.linalg.qr``
    forms Q with one cuSOLVER call per matrix on the card, seconds for the
    2 x 512 x 256 blocks of a 512^2 lattice.)"""
    a, tau = torch.geqrf(mat)
    n = mat.shape[-1]
    rows = torch.arange(n, device=mat.device)
    qh = identity_like(mat)
    for i in range(n):
        # v_i: 0 above row i, 1 at row i, geqrf's column i below it.
        v = torch.where(rows > i, a[..., :, i],
                        (rows == i).to(mat.dtype))
        vh_qh = (v.conj().unsqueeze(-1) * qh).sum(-2)
        qh = qh - (tau[..., i].conj()[..., None, None]
                   * v.unsqueeze(-1) * vh_qh.unsqueeze(-2))
    return torch.linalg.solve_triangular(a.triu(), qh, upper=True)


def identity_like(mat_field):
    """Per-site identity matrices with the shape/dtype of a cm field."""
    n = mat_field.shape[-1]
    eye = torch.eye(n, dtype=mat_field.dtype, device=mat_field.device)
    return eye.expand(mat_field.shape).clone()
