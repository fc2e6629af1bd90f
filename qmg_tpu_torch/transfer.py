"""Aggregation-based transfer operators (port of qmg_tpu/transfer.py,
symmetric R = P^dagger case).

A fine field (2, Y, Xh, nc) is reordered into blocked form
(2c, B, Yc, Xhc), B = By*Bx*nc fine dof per coarse site, with the b axis
in the middle (the same layout as qmg_tpu's ``_nvb``, so state dicts
exchange it unchanged). Then

    restrict_f2c: coarse[s, v] = sum_b conj(NV[v, s, b]) fine[s, b]
    prolong_c2f:  fine[s, b]  = sum_v NV[v, s, b] coarse[s, v]

Fields may carry leading batch axes (``(*batch, 2, Y, Xh, nc)``).

``ShardedTransferMG`` is level 0's transfer on a distributed mesh
(``parallel.Mesh``): each rank restricts its block of the fine field with
its block of the null vectors and only the coarse slab is gathered, so no
fine field ever crosses ranks.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .lattice import Lattice2D


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
    twice as the reference does."""

    def __init__(self, fine_lat: Lattice2D, coarse_lat: Lattice2D,
                 null_vectors, doubling: DoublingType = DoublingType.NONE):
        self.fine_lat = fine_lat
        self.coarse_lat = coarse_lat
        self.doubling = DoublingType(doubling)
        if null_vectors.shape[0] != coarse_lat.nc:
            raise ValueError(f"need {coarse_lat.nc} null vectors, got "
                             f"{null_vectors.shape[0]}")
        self._init_geometry(null_vectors.device)
        nvb = _block_orthonormalize(self._to_blocked(null_vectors))
        self._set_nvb(_block_orthonormalize(nvb))

    @classmethod
    def from_blocked(cls, fine_lat: Lattice2D, coarse_lat: Lattice2D, nvb,
                     doubling: DoublingType = DoublingType.PROJECTION,
                     coarse_row0: int = 0) -> "TransferMG":
        """A transfer from already block-orthonormal blocked null vectors
        (nvec, 2c, B, Yc, Xhc), e.g. the ``nvb{l}`` entry of a state dict.
        For a block of a larger lattice, ``coarse_row0`` is the row of the
        whole coarse lattice at which the block's coarse rows start: the
        coarse parity of a site follows the whole lattice's row."""
        t = cls.__new__(cls)
        t.fine_lat, t.coarse_lat = fine_lat, coarse_lat
        t.doubling = DoublingType(doubling)
        t._init_geometry(nvb.device, coarse_row0)
        t._set_nvb(nvb)
        return t

    def _set_nvb(self, nvb):
        if not bool(torch.isfinite(torch.view_as_real(nvb)).all()):
            raise ValueError(
                "block orthonormalization produced non-finite null "
                "vectors - the per-block Gram matrix is singular (null "
                "vectors are linearly dependent within a block)")
        self._nvb = nvb
        self._nvb_conj = torch.conj(nvb).resolve_conj()

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
        """coarse = conj(NV) . fine per block."""
        fb = self._to_blocked(fine)
        coarse = torch.einsum("vcbyx,...cbyx->...cyxv", self._nvb_conj, fb)
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

    @property
    def null_vectors(self):
        """Block-orthonormalized null vectors, (nvec, 2, Y, Xh, nc)."""
        return self._from_blocked(self._nvb)


class ShardedTransferMG:
    """Level 0's transfer on a distributed mesh, from the rank's block of
    the blocked null vectors (``nvb`` cut along Yc and Xhc).
    ``restrict_f2c`` takes the rank's block of a fine field and returns
    the whole coarse field (the local restriction, then a gather of the
    coarse slabs); ``prolong_c2f`` takes the whole coarse field and
    returns the rank's block of the fine one. Aggregation blocks must lie
    inside mesh blocks (``parallel.validate_mg_sharding``), and a mesh
    cut in x must leave every block an even number of coarse columns,
    so that a block's coarse sites pack even-odd as the whole lattice's.
    """

    def __init__(self, fine_lat: Lattice2D, coarse_lat: Lattice2D, nvb_loc,
                 mesh, doubling: DoublingType = DoublingType.PROJECTION):
        self.fine_lat, self.coarse_lat, self.mesh = fine_lat, coarse_lat, mesh
        ny, nx = mesh.shape
        (iy, _), = mesh.blocks
        if (fine_lat.y_len % ny or fine_lat.xh % nx or coarse_lat.y_len % ny
                or coarse_lat.x_len % nx
                or (nx > 1 and (coarse_lat.x_len // nx) % 2)):
            raise ValueError(
                f"fine lattice {fine_lat} and coarse lattice {coarse_lat} "
                f"do not cut into the mesh {mesh.shape} with whole "
                "even-odd packed coarse blocks")
        self._yc_loc = coarse_lat.y_len // ny
        self._xhc_loc = coarse_lat.xh // nx
        self.local = TransferMG.from_blocked(
            Lattice2D(fine_lat.x_len // nx, fine_lat.y_len // ny,
                      fine_lat.nc),
            Lattice2D(coarse_lat.x_len // nx, self._yc_loc, coarse_lat.nc),
            nvb_loc, doubling, coarse_row0=iy * self._yc_loc)

    def restrict_f2c(self, fine_loc):
        return self.mesh.gather(self.local.restrict_f2c(fine_loc),
                                y_dim=fine_loc.ndim - 3)

    def prolong_c2f(self, coarse):
        (iy, ix), = self.mesh.blocks
        y_dim = coarse.ndim - 3
        slab = coarse.narrow(y_dim, iy * self._yc_loc, self._yc_loc) \
            .narrow(y_dim + 1, ix * self._xhc_loc, self._xhc_loc)
        return self.local.prolong_c2f(slab)

    def get_doubling(self) -> DoublingType:
        return self.local.doubling


def _bdot(a, b):
    """Per-block <a, b> over the b axis of a (2c, B, Yc, Xhc) slice."""
    return torch.sum(torch.conj(a) * b, dim=1)


def _block_orthonormalize(nvb):
    """Classical Gram-Schmidt within each block (the reference's
    restrict/prolong orthonormalization; qmg_tpu also keeps the R factor
    for the coarse sigma-1 build, which is not ported)."""
    vs = [nvb[i] for i in range(nvb.shape[0])]
    for i in range(len(vs)):
        for j in range(i):
            vs[i] = vs[i] - _bdot(vs[j], vs[i])[:, None] * vs[j]
        nrm = torch.sqrt(_bdot(vs[i], vs[i]).real)
        vs[i] = vs[i] / nrm[:, None]
    return torch.stack(vs)
