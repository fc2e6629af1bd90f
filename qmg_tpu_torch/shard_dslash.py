"""The stencil apply on a lattice cut into blocks, with halo exchange (port
of qmg_tpu/shard_dslash.py).

Every function works on the blocks a process holds (``parallel.Mesh``):
all of them, as views of whole fields, on an in-process mesh; the rank's
own on a distributed one, where the edges travel through
``Mesh.ring_recv``. The local arithmetic is the unsharded apply's.

  * ``make_sharded_dslash(coeffs, mesh)``: any distance-1 stencil on a
    (ny, nx) mesh, exact (the arithmetic of ``stencil.apply_M`` site by
    site), on fields with any leading batch axes (the probe batch of the
    Galerkin build, the rhs axis of a batched solve);
  * ``make_sharded_wilson(coeffs, mesh, mass)``: the rank-1 Wilson kernel
    on the y-slabs of a (ny, 1) mesh, one launch of
    ``wilson_kernel.wilson_r1_halo_apply`` per slab with the neighbouring
    slabs' edge rows as its halos; with ``nrhs``, on a leading rhs axis,
    one launch per slab for all fields.

Both take the whole lattice's coefficients and fields on an in-process
mesh, and the rank's block of each (``parallel.shard_coeffs``,
``shard_field``) on a distributed one.

``cshift_pull_sharded`` and ``cshift_pull_half_sharded`` are every pull of
``cshift`` on blocks: distance 1, distance 2 (+-2y with a two-row halo)
and the corners (two distance-1 pulls). ``mesh_pulls(mesh)`` wraps them
as a ``stencil.Pulls`` on fields that are whole (in-process: cut into
block views, pulled with the neighbours' edges, joined) or the rank's
block (distributed): a stencil with these pulls applies, prepares,
reconstructs and builds its derived sets block by block.
"""

from __future__ import annotations

import torch

from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from .cshift import (ALL_DIRS, DIR_XP2, DIR_XM2, DIR_YP2, DIR_YM2,
                     _CORNER_PARTS)
from .stencil import StencilCoeffs, Pulls, apply_clover, apply_shift
from .parallel import Mesh, shard_coeffs, shard_field, unshard_field
from .wilson_kernel import bind_halo, bind_halo_slabs, wilson_phases
from . import linalg

__all__ = ["halo_roll", "cshift_pull_sharded", "cshift_pull_half_sharded",
           "mesh_pulls", "make_sharded_dslash", "make_sharded_wilson"]


def halo_roll(blocks, shift: int, dim: int, axis: str, mesh: Mesh):
    """Periodic roll by ``shift`` (+-1, or +-2 with a two-slice halo) of
    the whole field's axis that the blocks' axis ``dim`` is cut along: a
    roll inside each block, its wrapped slices replaced by the ring
    neighbour's edge."""
    n = abs(shift)
    if n not in (1, 2):
        raise ValueError("only distance-1 and distance-2 shifts")
    rolled = [torch.roll(b, shift, dims=dim) for b in blocks]
    if (mesh.ny if axis == "y" else mesh.nx) == 1:
        return rolled
    size = blocks[0].shape[dim]
    if size < n:
        raise ValueError(f"a block {size} wide along {axis} cannot give a "
                         f"halo of {n}")
    # shift < 0 pulls from +axis: the last n slots take the next block's
    # first n slices; shift > 0 the first n slots the previous block's
    # last n.
    give, take = (0, size - n) if shift < 0 else (size - n, 0)
    recv = mesh.ring_recv([b.narrow(dim, give, n) for b in blocks], axis,
                          1 if shift < 0 else -1)
    for r, edge in zip(rolled, recv):
        r.narrow(dim, take, n).copy_(edge)
    return rolled


def _pull_x_half_sharded(srcs, q: int, sign: int, y_axis: int, mesh: Mesh):
    """``cshift._pull_x_half`` on blocks: the packed-x roll crosses the
    block boundary in x. The row-parity mask is the block's own, which is
    the lattice's because Y_loc is even."""
    rolled = halo_roll(srcs, -sign, y_axis + 1, "x", mesh)
    direct_par = q if sign > 0 else 1 - q
    out = []
    for src, rol in zip(srcs, rolled):
        y_loc = src.shape[y_axis]
        rows = torch.arange(y_loc, device=src.device) % 2 == direct_par
        direct = rows.reshape((y_loc,) + (1,) * (src.ndim - y_axis - 1))
        out.append(torch.where(direct, src, rol))
    return out


def cshift_pull_sharded(blocks, direction: int, mesh: Mesh,
                        batch_dims: int = 0):
    """``cshift.cshift_pull`` on the held (*batch, 2, Y_loc, Xh_loc,
    dof...) blocks of a field, with halo exchange on the wrapped rows and
    columns."""
    p_ax = batch_dims
    if direction in (DIR_YP1, DIR_YM1):
        swapped = [torch.flip(b, dims=(p_ax,)) for b in blocks]
        return halo_roll(swapped, -1 if direction == DIR_YP1 else 1,
                         p_ax + 1, "y", mesh)
    if direction in (DIR_XP1, DIR_XM1):
        sign = 1 if direction == DIR_XP1 else -1
        even = _pull_x_half_sharded([b.select(p_ax, 1) for b in blocks], 0,
                                    sign, p_ax, mesh)
        odd = _pull_x_half_sharded([b.select(p_ax, 0) for b in blocks], 1,
                                   sign, p_ax, mesh)
        return [torch.stack(pair, dim=p_ax) for pair in zip(even, odd)]
    if direction in (DIR_XP2, DIR_XM2):
        return halo_roll(blocks, -1 if direction == DIR_XP2 else 1,
                         p_ax + 2, "x", mesh)
    if direction in (DIR_YP2, DIR_YM2):
        return halo_roll(blocks, -2 if direction == DIR_YP2 else 2,
                         p_ax + 1, "y", mesh)
    if direction in _CORNER_PARTS:
        d1, d2 = _CORNER_PARTS[direction]
        return cshift_pull_sharded(
            cshift_pull_sharded(blocks, d2, mesh, batch_dims), d1, mesh,
            batch_dims)
    raise ValueError(f"unsupported direction {direction}")


def cshift_pull_half_sharded(blocks, src_parity: int, direction: int,
                             mesh: Mesh, batch_dims: int = 0):
    """``cshift.cshift_pull_half`` on the held (*batch, Y_loc, Xh_loc,
    dof...) blocks of a half field on parity ``src_parity``: the
    distance-1 pulls, the distance-2 ones (+-2y with a two-row halo) and
    the corners, with halo exchange."""
    y_ax = batch_dims
    if direction in (DIR_YP1, DIR_YM1):
        return halo_roll(blocks, -1 if direction == DIR_YP1 else 1, y_ax,
                         "y", mesh)
    if direction in (DIR_XP1, DIR_XM1):
        return _pull_x_half_sharded(blocks, 1 - src_parity,
                                    1 if direction == DIR_XP1 else -1, y_ax,
                                    mesh)
    if direction in (DIR_XP2, DIR_XM2):
        return halo_roll(blocks, -1 if direction == DIR_XP2 else 1,
                         y_ax + 1, "x", mesh)
    if direction in (DIR_YP2, DIR_YM2):
        return halo_roll(blocks, -2 if direction == DIR_YP2 else 2, y_ax,
                         "y", mesh)
    if direction in _CORNER_PARTS:
        dx, dy = _CORNER_PARTS[direction]
        rolled = halo_roll(blocks, -1 if dy == DIR_YP1 else 1, y_ax, "y",
                           mesh)
        return _pull_x_half_sharded(rolled, src_parity,
                                    1 if dx == DIR_XP1 else -1, y_ax, mesh)
    raise ValueError(f"unsupported direction {direction}")


def mesh_pulls(mesh: Mesh) -> Pulls:
    """The pulls of ``stencil.Pulls`` on a mesh's fields: whole fields on
    an in-process mesh (cut into block views, each pulled with its
    neighbours' edges, joined), the rank's block on a distributed one."""
    def full(field, direction, batch_dims=0):
        y_dim = batch_dims + 1
        return _whole(cshift_pull_sharded(_blocks_of(field, mesh, y_dim),
                                          direction, mesh, batch_dims),
                      mesh, y_dim)

    def half(src, src_parity, direction, batch_dims=0):
        return _whole(cshift_pull_half_sharded(
            _blocks_of(src, mesh, batch_dims), src_parity, direction, mesh,
            batch_dims), mesh, batch_dims)

    return Pulls(full, half)


def _local_coeffs(coeffs: StencilCoeffs, mesh: Mesh):
    """The blocks' coefficient sets after the tiling refusals. A
    distributed mesh is handed the rank's block, which only has to keep
    an even row count."""
    lat = coeffs.lat
    if mesh.distributed:
        y_loc, local = lat.y_len, [coeffs]
    else:
        if lat.y_len % mesh.ny or lat.xh % mesh.nx:
            raise ValueError(f"lattice ({lat.y_len}, {lat.xh}) does not "
                             f"tile the mesh {mesh.shape}")
        y_loc, local = lat.y_len // mesh.ny, None
    if y_loc % 2:
        raise ValueError("Y_loc must be even so local row parity equals "
                         "global row parity")
    return local if local is not None else shard_coeffs(coeffs, mesh)


def _blocks_of(x, mesh: Mesh, y_dim: int = 1):
    return [x] if mesh.distributed else shard_field(x, mesh, y_dim)


def _whole(outs, mesh: Mesh, y_dim: int = 1):
    return outs[0] if mesh.distributed else unshard_field(outs, mesh, y_dim)


def make_sharded_dslash(coeffs: StencilCoeffs, mesh: Mesh):
    """Returns x -> M x with explicit halo exchange, for any distance-1
    stencil. Per block it is ``stencil.apply_M``'s arithmetic on the
    sharded pulls: one stacked site matvec over [x, x(s+x), x(s+y),
    x(s-x), x(s-y)], plus the shifts (diagonal and parity-local, so a
    block with an even row count applies them as the whole lattice
    does)."""
    local = _local_coeffs(coeffs, mesh)

    def apply_fn(x):
        nb = x.ndim - 4
        blocks = _blocks_of(x, mesh, nb + 1)
        if coeffs.hopping is None:
            return _whole([apply_clover(c, b) + apply_shift(c, b)
                           for c, b in zip(local, blocks)], mesh, nb + 1)
        pulls = [cshift_pull_sharded(blocks, d, mesh, nb) for d in ALL_DIRS]
        outs = []
        for i, (c, b) in enumerate(zip(local, blocks)):
            nbrs = [p[i] for p in pulls]
            if c.clover is not None:
                nbrs = [b] + nbrs
            outs.append(linalg.stacked_site_matvec(c.stacked(), nbrs)
                        + apply_shift(c, b))
        return _whole(outs, mesh, nb + 1)

    return apply_fn


def make_sharded_wilson(coeffs: StencilCoeffs, mesh: Mesh, mass: float,
                        w: float = 1.0, nrhs: int | None = None):
    """The rank-1 Wilson kernel on y-slabs (the counterpart of qmg_tpu's
    ``make_sharded_pallas_wilson``): returns x -> M x for complex64 x,
    one ``wilson_r1_halo_apply`` per held slab. With ``nrhs`` x carries a
    leading rhs axis (nrhs, 2, Y, Xh, 2) and each launch applies every
    field, whose edge rows travel together: one exchange a side. A
    slab's halos are the last row of the slab below and the first row of
    the slab above, both parities: rows of the whole field in place on an
    in-process mesh (``wilson_kernel.bind_halo_slabs``: nothing is
    copied, each slab writes its rows of one output field, and the
    wrapper's checks are made once, not per launch), the receive buffers
    of two ring exchanges on a distributed one
    (``wilson_kernel.bind_halo``: the checks of the rank's phases and
    shapes made once, those of x and the two buffers per call). With one
    slab they are the slab's own last and first rows.

    Requires an x-unsharded (ny, 1) mesh, as qmg_tpu does: the kernel
    wraps +-x inside the slab. qmg_tpu also asks for a local row count
    that is a multiple of 8, its halo window's DMA granule; the stencil
    reaches one row, so the halo here is one row and Y_loc only has to be
    even (row parity). ``w`` must be 1 (rank-1 projectors)."""
    lat = coeffs.lat
    if mesh.nx != 1:
        raise ValueError(
            "sharded wilson needs an x-unsharded mesh (ny, 1): the kernel "
            "wraps +-x inside the slab; shard y only")
    if lat.nc != 2 or coeffs.hopping is None:
        raise ValueError("sharded wilson needs a Wilson fine operator "
                         f"(nc=2), got nc={lat.nc}")
    if w != 1.0:
        raise ValueError(f"sharded wilson runs the rank-1 kernel and needs "
                         f"w == 1, got w={w}")
    ny = 1 if mesh.distributed else mesh.ny
    if lat.y_len % ny:
        raise ValueError(f"Y={lat.y_len} does not tile {ny} y-shards")
    y_loc = lat.y_len // ny
    if y_loc % 2:
        raise ValueError(
            f"local row count {y_loc} must be even so local row parity "
            "equals global row parity; use fewer y-shards")
    phase = wilson_phases(coeffs.hopping, w)
    alpha = 2.0 * w + float(mass)

    if mesh.distributed:
        # One rank is its own neighbour: ring_recv hands its edges back.
        kernel = bind_halo(phase, alpha, own_halos=mesh.ny == 1, nrhs=nrhs)

        def apply_fn(x):
            (top,) = mesh.ring_recv([x.select(-3, -1)], "y", -1)
            (bot,) = mesh.ring_recv([x.select(-3, 0)], "y", +1)
            return kernel(x, top, bot)
        return apply_fn

    return bind_halo_slabs(phase, mesh.ny, alpha, nrhs)
