"""Vector and per-site matrix primitives (port of qmg_tpu/linalg.py).

Fields are complex tensors of any shape; "cv" fields are (2, Y, Xh, nc)
and "cm" fields (2, Y, Xh, nc, nc) with [..., row, col]. Reductions
return 0-dim tensors on the field's device, so solver loops sync with the
host only where they test convergence. The ``*_lanes`` reductions are the
Krylov solvers': over every axis but a leading rhs axis, one result per
lane, ``(B,)``.

The per-site contraction at the bottom of every plain stencil apply,
``stacked_site_matvec``, reads its matrices in the product's layout
(``stack_terms``), for each site one (nc, T nc) matrix whose row i holds
row i of each of the T stacked terms; below 8 colours the terms stay on a
leading axis. On large lattices of 8 colours or more it is one batched
matrix product over the sites; ``CONTRACTIONS`` counts the calls by
route.
"""

from __future__ import annotations

import collections
import math

import torch

__all__ = ["vdot", "norm2sq", "vdot_lanes", "norm2sq_lanes", "reductions",
           "lane_reductions",
           "norm", "diffnorm2sq", "norminf", "normalize",
           "orthogonal",
           "site_matvec", "stacked_site_matvec", "stack_terms",
           "unstack_terms", "CONTRACTIONS", "site_matmul",
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


# Site contractions by route since the process started ("product": one
# batched matrix product over the sites; "broadcast": the elementwise
# product and a sum), counted at every call.
CONTRACTIONS = collections.Counter()

# Where the product route pays (H100 timings of the contraction alone,
# scripts/time_site_contraction.py; PERF.md section 5). It takes a
# contraction of at least PRODUCT_MIN_NC colours on at least
# PRODUCT_MIN_SITES sites. Fewer sites leave the contraction bound by the
# host's launches, which the broadcast form issues as fast (the 32^2 and
# 8^2 levels); from 64^2 sites on the product is 1.6-4x faster at nc 8,
# where the broadcast form writes and reads back a product nc times the
# neighbours' size. Below 8 colours the per-site matrices are too small
# for the batched product (2x slower than the broadcast form at nc 2),
# and both the product's layout and the stack next to a narrow colour
# axis slow the broadcast form, so such sets keep the terms on a leading
# axis.
PRODUCT_MIN_SITES = 4096
PRODUCT_MIN_NC = 8


def stack_terms(mats):
    """T per-site matrices, (T, *sites, nc, nc) or a sequence of T
    (*sites, nc, nc), in the layout ``stacked_site_matvec`` reads for
    their colour count: from ``PRODUCT_MIN_NC`` colours on the product's
    layout (*sites, nc, T nc), whose row i of a site holds [mats[0][s, i,
    :], ..., mats[T - 1][s, i, :]]; below it (T, *sites, nc, nc), a tensor
    as it is."""
    if mats[0].shape[-1] < PRODUCT_MIN_NC:
        return mats if torch.is_tensor(mats) else torch.stack(list(mats))
    return torch.stack(list(mats), dim=-2).flatten(-2)


def unstack_terms(stacked, terms: int):
    """``stack_terms`` undone, as a view: (T, *sites, nc, nc)."""
    nc = stacked.shape[-2]
    if nc < PRODUCT_MIN_NC:
        return stacked
    return torch.movedim(stacked.unflatten(-1, (terms, nc)), -2, 0)


def stacked_site_matvec(mats, pulls):
    """out[*b, s, i] = sum_{t, j} mats_t[s, i, j] pulls[t][*b, s, j]:
    ``mats`` the T terms as ``stack_terms`` lays them out, ``pulls`` the T
    fields (*batch, *sites, nc) with any leading batch axes; returns
    (*batch, *sites, nc).

    In the product's layout the fields are stacked next to the colour
    axis, (nrhs, sites, T nc). The product route (``PRODUCT_MIN_SITES``
    and more) is then one ``torch.bmm`` with the sites as its batch axis:
    each site's (nc, T nc) matrix times its (T nc, nrhs) neighbours,
    written through ``out=`` straight into the field layout (strided
    operands, no copy). The broadcast route sums the elementwise product
    [nrhs, sites, nc, T nc] over its last axis, or, below
    ``PRODUCT_MIN_NC`` colours, stacks the fields on a leading term axis
    and sums [T, nrhs, sites, nc, nc]."""
    terms, nc = len(pulls), pulls[0].shape[-1]
    product_layout = nc >= PRODUCT_MIN_NC
    sites = mats.shape[:-2] if product_layout else mats.shape[1:-2]
    batch = pulls[0].shape[:pulls[0].ndim - len(sites) - 1]
    n_sites, nrhs = math.prod(sites), math.prod(batch)
    dtype = torch.promote_types(mats.dtype, pulls[0].dtype)
    # The fields are stacked flattened to 2-D or 3-D: on the card a stack
    # of inputs beyond 5-D copies them one at a time.
    if product_layout:
        a = mats.reshape(n_sites, nc, terms * nc).to(dtype)
        b = (pulls[0].reshape(nrhs, n_sites, nc) if terms == 1 else
             torch.stack([p.reshape(-1, nc) for p in pulls], dim=-2)
             .reshape(nrhs, n_sites, terms * nc)).to(dtype)
        if n_sites >= PRODUCT_MIN_SITES:
            CONTRACTIONS["product"] += 1
            out = torch.empty((nrhs, n_sites, nc), dtype=dtype,
                              device=a.device)
            torch.bmm(a, b.permute(1, 2, 0), out=out.permute(1, 2, 0))
        else:
            CONTRACTIONS["broadcast"] += 1
            out = (a * b.unsqueeze(-2)).sum(-1)
    else:
        CONTRACTIONS["broadcast"] += 1
        a = mats.reshape(terms, n_sites, nc, nc)
        b = (pulls[0].reshape(1, nrhs, n_sites, nc) if terms == 1 else
             torch.stack([p.reshape(nrhs, n_sites, nc) for p in pulls]))
        out = (a.unsqueeze(1) * b.unsqueeze(-2)).sum(dim=(0, -1))
    return out.reshape(batch + sites + (nc,))


def site_matvec(mat, vec):
    """Per-site y = A x: (*sites, nc, nc) x (*batch, *sites, nc) ->
    (*batch, *sites, nc); leading batch axes of ``vec`` share the matrix
    field. A one-term ``stacked_site_matvec``."""
    one = mat if mat.shape[-1] >= PRODUCT_MIN_NC else mat.unsqueeze(0)
    return stacked_site_matvec(one, [vec])


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
