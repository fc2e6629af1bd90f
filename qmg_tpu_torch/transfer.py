"""Aggregation-based transfer operators (port of qmg_tpu/transfer.py).

A fine field (2, Y, Xh, nc) is reordered into blocked form
(2c, B, Yc, Xhc), B = By*Bx*nc fine dof per coarse site, with the b axis
in the middle (the same layout as qmg_tpu's ``_nvb``, so state dicts
exchange it unchanged). Then

    restrict_f2c: coarse[s, v] = sum_b conj(NV[v, s, b]) fine[s, b]
    prolong_c2f:  fine[s, b]  = sum_v NV[v, s, b] coarse[s, v]

Fields may carry leading batch axes (``(*batch, 2, Y, Xh, nc)``). An
asymmetric pair restricts with its own vectors RV in place of NV.

``ShardedTransferMG`` is level 0's transfer on the blocks of a mesh
(``parallel.Mesh``): each block of the fine field is restricted with its
block of the null vectors and only the coarse slabs are joined (in
process) or gathered (distributed), so no fine field ever crosses ranks.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .lattice import Lattice2D
from .parallel import shard_field, unshard_field


class DoublingType(enum.IntEnum):
    """How chiral doubling of the null vectors was done."""
    NONE = 0
    PROJECTION = 1
    OPERATOR = 2


def _block_permutation(fine_lat: Lattice2D, coarse_lat: Lattice2D):
    """Flat gather indices mapping the fine eo layout to the blocked one.

    Returns (perm, inv_perm, B): perm has shape (2c, B, Yc, Xhc) with
    values indexing the flattened fine cv field; within each block the b
    axis ascends in fine flat index.
    """
    bx = fine_lat.x_len // coarse_lat.x_len
    by = fine_lat.y_len // coarse_lat.y_len
    if bx * coarse_lat.x_len != fine_lat.x_len or \
       by * coarse_lat.y_len != fine_lat.y_len:
        raise ValueError("fine dims must divide evenly by coarse dims")
    nc = fine_lat.nc
    B = bx * by * nc
    xg, yg, cg = np.meshgrid(np.arange(fine_lat.x_len),
                             np.arange(fine_lat.y_len), np.arange(nc),
                             indexing="ij")
    p = (xg + yg) % 2
    flat = ((p * (fine_lat.volume // 2)
             + yg * fine_lat.xh + (xg // 2) % fine_lat.xh) * nc + cg)
    cxg, cyg = xg // bx, yg // by
    if coarse_lat.volume == 1:
        cflat = np.zeros_like(cxg)
    else:
        cflat = (((cxg + cyg) % 2) * (coarse_lat.volume // 2)
                 + cyg * coarse_lat.xh + (cxg // 2) % coarse_lat.xh)
    order = np.lexsort((flat.ravel(), cflat.ravel()))
    perm = flat.ravel()[order].reshape(coarse_lat.volume, B)
    cshape = ((1, 1, 1, B) if coarse_lat.volume == 1
              else (2, coarse_lat.y_len, coarse_lat.xh, B))
    perm = np.moveaxis(perm.reshape(cshape), -1, 1)
    inv_perm = np.empty(fine_lat.size_cv, dtype=np.int64)
    inv_perm[perm.ravel()] = np.arange(fine_lat.size_cv)
    return perm, inv_perm, B


class TransferMG:
    """Transfer between a fine and a coarse lattice from null vectors
    ``(nvec, 2, Y, Xh, nc)`` (nvec = coarse nc), block-orthonormalized
    twice as the reference does, the first pass's decomposition kept with
    ``save_decomp``. With ``restrict_null_vectors`` the pair is
    asymmetric: prolongation by P and restriction by R != P^dagger, the
    two block-bi-orthonormalized (<r_i, p_j> = delta_ij per block) and the
    first pass's L / U factors kept with ``save_decomp``. For a block of
    a larger lattice, ``coarse_row0`` is as in ``from_blocked``."""

    def __init__(self, fine_lat: Lattice2D, coarse_lat: Lattice2D,
                 null_vectors, do_block_ortho: bool = True,
                 save_decomp: bool = False,
                 doubling: DoublingType = DoublingType.NONE,
                 restrict_null_vectors=None, coarse_row0: int = 0):
        self.fine_lat = fine_lat
        self.coarse_lat = coarse_lat
        self.doubling = DoublingType(doubling)
        if null_vectors.shape[0] != coarse_lat.nc:
            raise ValueError(f"need {coarse_lat.nc} null vectors, got "
                             f"{null_vectors.shape[0]}")
        self._init_geometry(null_vectors.device, coarse_row0)
        self.block_cholesky = self.block_L = self.block_U = None
        nvb = self._to_blocked(null_vectors)
        rnvb = None
        if restrict_null_vectors is None:
            if do_block_ortho:
                nvb, chol = _block_orthonormalize(nvb)
                if save_decomp:
                    self.block_cholesky = chol
                nvb, _ = _block_orthonormalize(nvb)
        else:
            rnvb = self._to_blocked(restrict_null_vectors)
            if do_block_ortho:
                nvb, rnvb, lower, upper = _block_bi_orthonormalize(nvb, rnvb)
                if save_decomp:
                    self.block_L, self.block_U = lower, upper
                nvb, rnvb, _, _ = _block_bi_orthonormalize(nvb, rnvb)
        self._set_nvb(nvb, rnvb)

    @classmethod
    def from_blocked(cls, fine_lat: Lattice2D, coarse_lat: Lattice2D, nvb,
                     doubling: DoublingType = DoublingType.PROJECTION,
                     coarse_row0: int = 0, rnvb=None, block_cholesky=None,
                     block_L=None, block_U=None) -> "TransferMG":
        """A transfer from already block-orthonormal blocked null vectors
        (nvec, 2c, B, Yc, Xhc), e.g. the ``nvb{l}`` entry of a state dict,
        with, for an asymmetric pair, the blocked restriction vectors
        ``rnvb``, and the saved decompositions. For a block of a larger
        lattice, ``coarse_row0`` is the row of the whole coarse lattice at
        which the block's coarse rows start: the coarse parity of a site
        follows the whole lattice's row."""
        t = cls.__new__(cls)
        t.fine_lat, t.coarse_lat = fine_lat, coarse_lat
        t.doubling = DoublingType(doubling)
        t.block_cholesky, t.block_L, t.block_U = (block_cholesky, block_L,
                                                  block_U)
        t._init_geometry(nvb.device, coarse_row0)
        t._set_nvb(nvb, rnvb)
        return t

    def _set_nvb(self, nvb, rnvb=None):
        for v in (nvb, rnvb):
            if v is not None and not bool(
                    torch.isfinite(torch.view_as_real(v)).all()):
                raise ValueError(
                    "block orthonormalization produced non-finite null "
                    "vectors - the per-block Gram matrix is singular (null "
                    "vectors are linearly dependent within a block)")
        self._nvb = nvb
        self._restrict_nvb = rnvb
        self._restrict_conj = torch.conj(
            nvb if rnvb is None else rnvb).resolve_conj()

    def _init_geometry(self, device, coarse_row0: int = 0):
        fl, cl = self.fine_lat, self.coarse_lat
        by = fl.y_len // cl.y_len
        bx = fl.x_len // cl.x_len
        if by * cl.y_len != fl.y_len or bx * cl.x_len != fl.x_len:
            raise ValueError("fine dims must divide evenly by coarse dims")
        self._by, self._bx = by, bx
        self.block_dof = by * bx * fl.nc
        self._coarse_is_point = cl.volume == 1
        self._use_reshape = bx % 2 == 0 or self._coarse_is_point
        if not self._use_reshape:
            perm, inv_perm, _ = _block_permutation(fl, cl)
            self._perm = torch.as_tensor(perm, device=device)
            self._inv_perm = torch.as_tensor(inv_perm, device=device)
        rows = torch.arange(coarse_row0, coarse_row0 + cl.y_len,
                            device=device)
        self._row_odd = (rows % 2 == 1).reshape(cl.y_len, 1, 1)

    # --- layout plumbing ---
    def _to_blocked(self, fine):
        """(*batch, 2, Y, Xh, nc) -> (*batch, 2c, B, Yc, Xhc)."""
        lead = fine.shape[:-4]
        nb = len(lead)
        if not self._use_reshape:
            return fine.reshape(lead + (-1,))[..., self._perm]
        cl = self.coarse_lat
        by, bxh = self._by, max(self._bx // 2, 1)
        yc, xc = cl.y_len, cl.x_len
        nc = self.fine_lat.nc
        z = fine.reshape(lead + (2, yc, by, xc, bxh, nc))
        z = z.permute(*range(nb), nb + 1, nb + 3, nb, nb + 2, nb + 4, nb + 5)
        z = z.reshape(lead + (yc, xc, 2 * by * bxh * nc))
        if self._coarse_is_point:
            return z.reshape(lead + (1, -1, 1, 1))
        zp = z.reshape(lead + (yc, cl.xh, 2, -1))
        even = torch.where(self._row_odd, zp[..., 1, :], zp[..., 0, :])
        odd = torch.where(self._row_odd, zp[..., 0, :], zp[..., 1, :])
        return torch.movedim(torch.stack([even, odd], dim=nb), -1, nb + 1)

    def _from_blocked(self, blocked):
        """(*batch, 2c, B, Yc, Xhc) -> (*batch, 2, Y, Xh, nc)."""
        lead = blocked.shape[:-4]
        nb = len(lead)
        cv = self.fine_lat.cv_shape()
        if not self._use_reshape:
            flat = blocked.reshape(lead + (-1,))[..., self._inv_perm]
            return flat.reshape(lead + cv)
        cl = self.coarse_lat
        by, bxh = self._by, max(self._bx // 2, 1)
        yc, xc = cl.y_len, cl.x_len
        nc = self.fine_lat.nc
        if self._coarse_is_point:
            z = blocked.reshape(lead + (1, 1, -1))
        else:
            zb = torch.movedim(blocked, nb + 1, -1)   # (*, 2c, Yc, Xhc, B)
            z0, z1 = zb.select(nb, 0), zb.select(nb, 1)
            k0 = torch.where(self._row_odd, z1, z0)
            k1 = torch.where(self._row_odd, z0, z1)
            z = torch.stack([k0, k1], dim=-2).reshape(lead + (yc, xc, -1))
        z = z.reshape(lead + (yc, xc, 2, by, bxh, nc))
        z = z.permute(*range(nb), nb + 2, nb, nb + 3, nb + 1, nb + 4, nb + 5)
        return z.reshape(lead + cv)

    # --- public transfer ops ---
    def restrict_f2c(self, fine):
        """coarse = conj(NV) . fine per block (conj(RV) for an asymmetric
        pair)."""
        fb = self._to_blocked(fine)
        coarse = torch.einsum("vcbyx,...cbyx->...cyxv", self._restrict_conj, fb)
        if self._coarse_is_point:
            # Blocked layout is (1, ...); the coarse field (2, 1, 1, nvec)
            # holds its single site at parity 0.
            nb = fine.ndim - 4
            pad = torch.zeros_like(coarse)
            return torch.cat([coarse, pad], dim=nb)
        return coarse

    def prolong_c2f(self, coarse):
        """fine = NV . coarse per block."""
        if self._coarse_is_point:
            coarse = coarse.narrow(coarse.ndim - 4, 0, 1)
        fb = torch.einsum("vcbyx,...cyxv->...cbyx", self._nvb, coarse)
        return self._from_blocked(fb)

    def get_doubling(self) -> DoublingType:
        return self.doubling

    def is_symmetric(self) -> bool:
        return self._restrict_nvb is None

    def has_decompositions(self) -> bool:
        if self.is_symmetric():
            return self.block_cholesky is not None
        return self.block_L is not None and self.block_U is not None

    @property
    def null_vectors(self):
        """Block-orthonormalized null vectors, (nvec, 2, Y, Xh, nc)."""
        return self._from_blocked(self._nvb)

    @property
    def restrict_null_vectors(self):
        """The restriction vectors of an asymmetric pair, or None."""
        if self._restrict_nvb is None:
            return None
        return self._from_blocked(self._restrict_nvb)


def block_lattices(fine_lat: Lattice2D, coarse_lat: Lattice2D, mesh):
    """(fine, coarse) lattices of one block of a mesh, refused where the
    coarse sites of a block would not pack even-odd as the whole
    lattice's: aggregation blocks must lie inside mesh blocks
    (``parallel.validate_mg_sharding``), and a mesh cut in x must leave
    every block an even number of coarse columns."""
    ny, nx = mesh.shape
    if (fine_lat.y_len % ny or fine_lat.xh % nx or coarse_lat.y_len % ny
            or coarse_lat.x_len % nx
            or (nx > 1 and (coarse_lat.x_len // nx) % 2)):
        raise ValueError(
            f"fine lattice {fine_lat} and coarse lattice {coarse_lat} "
            f"do not cut into the mesh {mesh.shape} with whole "
            "even-odd packed coarse blocks")
    return (Lattice2D(fine_lat.x_len // nx, fine_lat.y_len // ny,
                      fine_lat.nc),
            Lattice2D(coarse_lat.x_len // nx, coarse_lat.y_len // ny,
                      coarse_lat.nc))


class ShardedTransferMG:
    """Level 0's transfer on the blocks a process holds, from each held
    block's blocked null vectors (``nvb`` cut along Yc and Xhc; one tensor
    or a list in mesh order). ``restrict_f2c`` restricts each block of a
    fine field with its own vectors and returns the whole coarse field
    (the slabs joined in process, gathered over the ranks of a distributed
    mesh); ``prolong_c2f`` takes the whole coarse field and prolongs each
    block's slab. Fine fields are whole on an in-process mesh and the
    rank's block on a distributed one (``block_lattices`` says what must
    tile)."""

    def __init__(self, fine_lat: Lattice2D, coarse_lat: Lattice2D, nvb_loc,
                 mesh, doubling: DoublingType = DoublingType.PROJECTION):
        self.fine_lat, self.coarse_lat, self.mesh = fine_lat, coarse_lat, mesh
        fine_blk, coarse_blk = block_lattices(fine_lat, coarse_lat, mesh)
        if torch.is_tensor(nvb_loc):
            nvb_loc = [nvb_loc]
        if len(nvb_loc) != len(mesh.blocks):
            raise ValueError(f"need the null vectors of {len(mesh.blocks)} "
                             f"blocks, got {len(nvb_loc)}")
        self.locals = [TransferMG.from_blocked(
            fine_blk, coarse_blk, nvb, doubling,
            coarse_row0=iy * coarse_blk.y_len)
            for (iy, _), nvb in zip(mesh.blocks, nvb_loc)]

    def _blocks(self, field, y_dim):
        return [field] if self.mesh.distributed else shard_field(
            field, self.mesh, y_dim)

    def restrict_f2c(self, fine):
        y_dim = fine.ndim - 3
        return unshard_field([t.restrict_f2c(b) for t, b in
                              zip(self.locals, self._blocks(fine, y_dim))],
                             self.mesh, y_dim)

    def prolong_c2f(self, coarse):
        y_dim = coarse.ndim - 3
        fine = [t.prolong_c2f(slab) for t, slab in
                zip(self.locals, shard_field(coarse, self.mesh, y_dim))]
        return fine[0] if self.mesh.distributed else unshard_field(
            fine, self.mesh, y_dim)

    def whole(self) -> TransferMG:
        """The transfer of the whole lattice (in-process: every block is
        held)."""
        if self.mesh.distributed:
            raise ValueError("a distributed mesh holds one block: there is "
                             "no whole transfer to make")
        nvb = unshard_field([t._nvb for t in self.locals], self.mesh, 3)
        return TransferMG.from_blocked(self.fine_lat, self.coarse_lat, nvb,
                                       self.get_doubling())

    def get_doubling(self) -> DoublingType:
        return self.locals[0].doubling

    def is_symmetric(self) -> bool:
        return True


# Block (bi-)orthonormalization over the blocked layout: each vector is a
# (2c, B, Yc, Xhc) slice, contracted over B; the decompositions are
# site-major (2c, Yc, Xhc, nvec, nvec), [..., row, col], the layout the
# coarse sigma-1 build takes.

def _bdot(a, b):
    """Per-block <a, b> over the b axis of a (2c, B, Yc, Xhc) slice."""
    return torch.sum(torch.conj(a) * b, dim=1)


def _bsmul(g, v):
    """Per-site scalar (2c, Yc, Xhc) times blocked (2c, B, Yc, Xhc)."""
    return g[:, None] * v


def _decomp_shape(vb):
    return (vb.shape[1],) + tuple(vb.shape[3:]) + (vb.shape[0],) * 2


def _block_orthonormalize(nvb):
    """Classical Gram-Schmidt within each block. Returns (orthonormalized
    nvb, R) with R[..., j, i] = <v_j, v_i> for j < i and R[..., i, i] the
    block norm: the upper-triangular factor of orig = ortho R."""
    vs = [nvb[i] for i in range(nvb.shape[0])]
    chol = torch.zeros(_decomp_shape(nvb), dtype=nvb.dtype,
                       device=nvb.device)
    for i in range(len(vs)):
        for j in range(i):
            g = _bdot(vs[j], vs[i])
            chol[..., j, i] = g
            vs[i] = vs[i] - _bsmul(g, vs[j])
        nrm = torch.sqrt(_bdot(vs[i], vs[i]).real)
        chol[..., i, i] = nrm.to(nvb.dtype)
        vs[i] = vs[i] / nrm[:, None]
    return torch.stack(vs), chol


def _block_bi_orthonormalize(pvb, rvb):
    """Bi-orthonormalization of prolongation / restriction pairs within
    each block (qmg_tpu's ``_block_bi_orthonormalize``). Returns (pvb,
    rvb, L, U): U[..., j, i] = <r_j, p_i> above the diagonal and |d|^1/2 on
    it, L[..., i, j] = conj(<p_j, r_i>) below the diagonal and
    |d|^1/2 e^{i arg d} on it, with d = <r_i, p_i> after the projections:
    P_orig = P U and R_orig = R L^dagger. The diagonal normalization keeps
    the phase of d on r."""
    ps = [pvb[i] for i in range(pvb.shape[0])]
    rs = [rvb[i] for i in range(rvb.shape[0])]
    lower = torch.zeros(_decomp_shape(pvb), dtype=pvb.dtype,
                        device=pvb.device)
    upper = torch.zeros_like(lower)
    for i in range(len(ps)):
        for j in range(i):
            u = _bdot(rs[j], ps[i])
            upper[..., j, i] = u
            ps[i] = ps[i] - _bsmul(u, ps[j])
            lt = _bdot(ps[j], rs[i])
            lower[..., i, j] = torch.conj(lt)
            rs[i] = rs[i] - _bsmul(lt, rs[j])
        d = _bdot(rs[i], ps[i])
        f = torch.exp(1j * torch.angle(d)) / torch.sqrt(torch.abs(d))
        rs[i] = _bsmul(f, rs[i])
        lower[..., i, i] = torch.conj(1.0 / f)
        f2 = 1.0 / torch.sqrt(torch.abs(d))
        ps[i] = ps[i] * f2[:, None]
        upper[..., i, i] = (1.0 / f2).to(upper.dtype)
    return torch.stack(ps), torch.stack(rs), lower, upper
