"""The stencil apply on a lattice cut into blocks, with halo exchange (port
of qmg_tpu/shard_dslash.py).

Every function works on the blocks a process holds (``parallel.Mesh``):
all of them, as views of whole fields, on an in-process mesh; the rank's
own on a distributed one, where the edges travel through
``Mesh.ring_recv``. The local arithmetic is the unsharded apply's.

  * ``make_sharded_dslash(coeffs, mesh)``: any distance-1 stencil on a
    (ny, nx) mesh, exact (the arithmetic of ``stencil.apply_M`` site by
    site);
  * ``make_sharded_wilson(coeffs, mesh, mass)``: the rank-1 Wilson kernel
    on the y-slabs of a (ny, 1) mesh, one launch of
    ``wilson_kernel.wilson_r1_halo_apply`` per slab with the neighbouring
    slabs' edge rows as its halos.

Both take the whole lattice's coefficients and fields on an in-process
mesh, and the rank's block of each (``parallel.shard_coeffs``,
``shard_field``) on a distributed one.
"""

from __future__ import annotations

import torch

from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from .cshift import ALL_DIRS
from .stencil import StencilCoeffs, apply_clover, apply_shift
from .parallel import Mesh, shard_coeffs, shard_field, unshard_field
from .wilson_kernel import bind_halo, bind_halo_slabs, wilson_phases
from . import linalg

__all__ = ["halo_roll", "cshift_pull_sharded", "make_sharded_dslash",
           "make_sharded_wilson"]


def halo_roll(blocks, shift: int, dim: int, axis: str, mesh: Mesh):
    """Periodic roll by ``shift`` (+1 or -1) of the whole field's axis
    that the blocks' axis ``dim`` is cut along: a roll inside each block,
    its wrapped slice replaced by the ring neighbour's edge."""
    if shift not in (1, -1):
        raise ValueError("only distance-1 shifts")
    rolled = [torch.roll(b, shift, dims=dim) for b in blocks]
    if (mesh.ny if axis == "y" else mesh.nx) == 1:
        return rolled
    size = blocks[0].shape[dim]
    # shift -1 pulls from +axis: the last slot takes the next block's
    # first slice; shift +1 the first slot the previous block's last.
    give, take = (0, size - 1) if shift == -1 else (size - 1, 0)
    recv = mesh.ring_recv([b.narrow(dim, give, 1) for b in blocks], axis,
                          -shift)
    for r, edge in zip(rolled, recv):
        r.narrow(dim, take, 1).copy_(edge)
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


def cshift_pull_sharded(blocks, direction: int, mesh: Mesh):
    """``cshift.cshift_pull`` on the held (2, Y_loc, Xh_loc, dof...) blocks
    of a field, with halo exchange on the wrapped rows and columns."""
    if direction in (DIR_YP1, DIR_YM1):
        swapped = [torch.flip(b, dims=(0,)) for b in blocks]
        return halo_roll(swapped, -1 if direction == DIR_YP1 else 1, 1, "y",
                         mesh)
    if direction in (DIR_XP1, DIR_XM1):
        sign = 1 if direction == DIR_XP1 else -1
        even = _pull_x_half_sharded([b[1] for b in blocks], 0, sign, 0, mesh)
        odd = _pull_x_half_sharded([b[0] for b in blocks], 1, sign, 0, mesh)
        return [torch.stack(pair) for pair in zip(even, odd)]
    raise ValueError(f"unsupported direction {direction}")


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


def _blocks_of(x, mesh: Mesh):
    return [x] if mesh.distributed else shard_field(x, mesh)


def _whole(outs, mesh: Mesh):
    return outs[0] if mesh.distributed else unshard_field(outs, mesh)


def make_sharded_dslash(coeffs: StencilCoeffs, mesh: Mesh):
    """Returns x -> M x with explicit halo exchange, for any distance-1
    stencil. Per block it is ``stencil.apply_M``'s arithmetic on the
    sharded pulls: one stacked site matvec over [x, x(s+x), x(s+y),
    x(s-x), x(s-y)], plus the shifts (diagonal and parity-local, so a
    block with an even row count applies them as the whole lattice
    does)."""
    local = _local_coeffs(coeffs, mesh)

    def apply_fn(x):
        blocks = _blocks_of(x, mesh)
        if coeffs.hopping is None:
            return _whole([apply_clover(c, b) + apply_shift(c, b)
                           for c, b in zip(local, blocks)], mesh)
        pulls = [cshift_pull_sharded(blocks, d, mesh) for d in ALL_DIRS]
        outs = []
        for i, (c, b) in enumerate(zip(local, blocks)):
            nbrs = [p[i] for p in pulls]
            if c.clover is not None:
                nbrs = [b] + nbrs
            outs.append(linalg.stacked_site_matvec(c.stacked(),
                                                   torch.stack(nbrs))
                        + apply_shift(c, b))
        return _whole(outs, mesh)

    return apply_fn


def make_sharded_wilson(coeffs: StencilCoeffs, mesh: Mesh, mass: float,
                        w: float = 1.0):
    """The rank-1 Wilson kernel on y-slabs (the counterpart of qmg_tpu's
    ``make_sharded_pallas_wilson``): returns x -> M x for complex64 x,
    one ``wilson_r1_halo_apply`` per held slab. A slab's halos are the
    last row of the slab below and the first row of the slab above, both
    parities: rows of the whole field in place on an in-process mesh
    (``wilson_kernel.bind_halo_slabs``: nothing is copied, each slab
    writes its rows of one output field, and the wrapper's checks are
    made once, not per launch), the receive buffers of two ring
    exchanges on a distributed one (``wilson_kernel.bind_halo``: the
    checks of the rank's phases and shapes made once, those of x and the
    two buffers per call). With one slab they are the slab's own last and
    first rows.

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
        kernel = bind_halo(phase, alpha, own_halos=mesh.ny == 1)

        def apply_fn(x):
            (top,) = mesh.ring_recv([x[:, -1]], "y", -1)
            (bot,) = mesh.ring_recv([x[:, 0]], "y", +1)
            return kernel(x, top, bot)
        return apply_fn

    return bind_halo_slabs(phase, mesh.ny, alpha)
