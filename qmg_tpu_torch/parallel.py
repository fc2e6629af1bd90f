"""Domain decomposition of the fine lattice over a (ny, nx) mesh (port of
qmg_tpu/parallel.py).

The lattice's (Y, Xh) axes are cut into ny x nx blocks. A ``Mesh`` holds
them in one of two ways, and the sharded functions of ``shard_dslash`` and
``transfer`` are written once over both:

  * in-process (``group=None``): one process holds every block. Fields
    stay whole tensors; ``shard_field`` cuts them into views, a halo is a
    neighbouring block's edge, and nothing is sent. It is what one device
    runs at ny * nx > 1.
  * distributed (``group`` = a ``torch.distributed`` group of ny * nx
    ranks, rank = iy * nx + ix): each rank holds its block only. Halos
    move with ``batch_isend_irecv``, sums over the lattice are
    ``all_reduce``, and the coarse slab a rank restricts is
    ``all_gather``ed, so that every rank holds the whole coarse levels.
    The group's backend must match the tensors: ``nccl`` for CUDA,
    ``gloo`` for the CPU. With one block along an axis nothing is sent
    along it.

Blocks are lists in mesh order (iy major): all ny * nx of them in-process,
the rank's own one distributed. Local extents must keep Y_loc even, so
that a block's row parity is the lattice's, and hold whole aggregation
blocks of the transfer (``validate_mg_sharding``).

Only level 0 is sharded. qmg_tpu's ``replicate_coarse_levels`` pins the
coarse levels' arrays as replicated placements of one SPMD program; here
every rank simply holds those arrays whole, so there is no placement to
make and no counterpart of that function. What SPMD guarantees, that the
copies are one array, every rank has to hold to itself: it builds or
loads its coarse levels, and a sharded coarse solve diverges if they
differ in one bit. ``check_replicated`` compares every rank's float64
digest of each such array and raises on the first that differs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .lattice import Lattice2D
from .spans import span
from .stencil import StencilCoeffs

__all__ = ["Mesh", "make_mesh", "shard_field", "unshard_field",
           "shard_coeffs", "shardable_dims", "validate_mg_sharding",
           "validate_level_sharding", "replication_crossover",
           "check_replicated"]


class Mesh:
    """A (ny, nx) mesh of lattice blocks, in-process or distributed.

    ``sent`` counts the bytes this process handed to each collective
    ("halo", "sum", "gather", and "digest" for ``check_replicated``); an
    in-process mesh sends nothing. Under a profiler each collective is a
    span ``qmg.mesh.<kind>`` (``spans``); on an in-process mesh each halo
    exchange that a distributed one would launch is one too.
    """

    def __init__(self, ny: int, nx: int = 1, group=None):
        if ny < 1 or nx < 1:
            raise ValueError(f"mesh shape ({ny}, {nx}) must be positive")
        self.ny, self.nx, self.group = int(ny), int(nx), group
        self.sent = {"halo": 0, "sum": 0, "gather": 0, "digest": 0}
        if group is None:
            self.blocks = [(iy, ix) for iy in range(ny) for ix in range(nx)]
            return
        import torch.distributed as dist
        if dist.get_world_size(group) != ny * nx:
            raise ValueError(f"mesh ({ny}, {nx}) needs {ny * nx} ranks, the "
                             f"group has {dist.get_world_size(group)}")
        self.blocks = [divmod(dist.get_rank(group), nx)]

    @property
    def shape(self):
        return (self.ny, self.nx)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def __repr__(self):
        kind = "distributed" if self.distributed else "in-process"
        return f"Mesh({self.ny}, {self.nx}, {kind})"

    # --- the three communication primitives ---

    def ring_recv(self, edges, axis: str, offset: int):
        """Ring halo exchange along ``axis`` ("y" or "x"): for each held
        block, the edge that the block ``offset`` (+1 or -1) places further
        along the axis offers in ``edges`` (one per held block, periodic).
        With one block along the axis a block is its own neighbour and
        ``edges`` comes back as it is."""
        n = self.ny if axis == "y" else self.nx
        if n == 1:
            return list(edges)

        def neighbour(iy, ix, step):
            return (((iy + step) % n, ix) if axis == "y"
                    else (iy, (ix + step) % n))

        if not self.distributed:
            with span("qmg.mesh.halo"):
                return [edges[iy * self.nx + ix] for iy, ix in
                        (neighbour(*blk, offset) for blk in self.blocks)]
        import torch.distributed as dist
        (edge,), (blk,) = edges, self.blocks

        def peer(step):
            iy, ix = neighbour(*blk, step)
            return dist.get_global_rank(self.group, iy * self.nx + ix)

        with span("qmg.mesh.halo"):
            send = edge.contiguous()
            recv = torch.empty_like(send)
            ops = [dist.P2POp(dist.isend, _as_real(send), peer(-offset),
                              self.group),
                   dist.P2POp(dist.irecv, _as_real(recv), peer(offset),
                              self.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.sent["halo"] += send.numel() * send.element_size()
        return [recv]

    def all_sum(self, t):
        """Sum of ``t`` over the mesh's ranks (in place); ``t`` itself on
        an in-process mesh, whose reductions already see whole fields."""
        if not self.distributed:
            return t
        import torch.distributed as dist
        with span("qmg.mesh.sum"):
            dist.all_reduce(_as_real(t), group=self.group)
        self.sent["sum"] += t.numel() * t.element_size()
        return t

    def gather(self, slab, y_dim: int = 1):
        """The whole field from every rank's ``slab`` (cut along ``y_dim``
        and the axis after it), on every rank."""
        if not self.distributed:
            raise ValueError("an in-process mesh holds whole fields: "
                             "nothing to gather")
        import torch.distributed as dist
        with span("qmg.mesh.gather"):
            slab = slab.contiguous()
            parts = [torch.empty_like(slab)
                     for _ in range(self.ny * self.nx)]
            dist.all_gather([_as_real(p) for p in parts], _as_real(slab),
                            group=self.group)
            self.sent["gather"] += slab.numel() * slab.element_size()
            return _join(parts, self.shape, y_dim)


def _as_real(t):
    """The collectives' view of a tensor: complex as (..., 2) reals."""
    return torch.view_as_real(t) if t.is_complex() else t


def _join(parts, shape, y_dim: int):
    ny, nx = shape
    rows = [torch.cat(parts[iy * nx:(iy + 1) * nx], dim=y_dim + 1)
            if nx > 1 else parts[iy] for iy in range(ny)]
    return torch.cat(rows, dim=y_dim) if ny > 1 else rows[0]


def make_mesh(n_shards: int, shape=None, group=None) -> Mesh:
    """A mesh of ``n_shards`` blocks. Without a shape the count is factored
    as close to square as possible, with more blocks along y."""
    if shape is None:
        ny = int(np.floor(np.sqrt(n_shards)))
        while n_shards % ny:
            ny -= 1
        shape = (max(ny, n_shards // ny), min(ny, n_shards // ny))
    if shape[0] * shape[1] != n_shards:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold "
                         f"{n_shards} blocks")
    return Mesh(shape[0], shape[1], group)


def _extents(mesh: Mesh, y_len: int, xh: int):
    if y_len % mesh.ny or xh % mesh.nx:
        raise ValueError(f"lattice ({y_len}, {xh}) does not tile the mesh "
                         f"{mesh.shape}")
    return y_len // mesh.ny, xh // mesh.nx


def shard_field(field, mesh: Mesh, y_dim: int = 1):
    """The blocks of a whole field that this process holds, as views, in
    mesh order: ``field``'s axes ``y_dim`` and ``y_dim + 1`` are (Y, Xh)."""
    y_loc, xh_loc = _extents(mesh, field.shape[y_dim],
                             field.shape[y_dim + 1])
    return [field.narrow(y_dim, iy * y_loc, y_loc)
            .narrow(y_dim + 1, ix * xh_loc, xh_loc)
            for iy, ix in mesh.blocks]


def unshard_field(blocks, mesh: Mesh, y_dim: int = 1):
    """The whole field from the held blocks: a concatenation in-process,
    an ``all_gather`` on a distributed mesh."""
    if mesh.distributed:
        (block,) = blocks
        return mesh.gather(block, y_dim)
    return _join(list(blocks), mesh.shape, y_dim)


def shard_coeffs(coeffs: StencilCoeffs, mesh: Mesh):
    """The coefficient sets of the held blocks: clover and hopping are cut
    with the lattice, the scalar shifts stay whole."""
    lat = coeffs.lat
    y_loc, xh_loc = _extents(mesh, lat.y_len, lat.xh)
    local = Lattice2D(2 * xh_loc, y_loc, lat.nc)
    none = [None] * len(mesh.blocks)
    clovers = (none if coeffs.clover is None
               else shard_field(coeffs.clover, mesh, 1))
    hoppings = (none if coeffs.hopping is None
                else shard_field(coeffs.hopping, mesh, 2))
    return [dataclasses.replace(coeffs, lat=local, clover=c, hopping=h,
                                _stacked=None)
            for c, h in zip(clovers, hoppings)]


def shardable_dims(lat: Lattice2D, mesh: Mesh) -> bool:
    """Whether (Y, Xh) divide the mesh shape."""
    return lat.y_len % mesh.ny == 0 and lat.xh % mesh.nx == 0


def validate_mg_sharding(mg, mesh: Mesh, level: int = 0) -> None:
    """Check that the hierarchy can shard at ``level`` over ``mesh``
    (``validate_level_sharding`` of its lattice and the next one). Raises
    ValueError otherwise."""
    coarse = (mg.get_lattice(level + 1)
              if level < mg.get_num_levels() - 1 else None)
    validate_level_sharding(mg.get_lattice(level), coarse, mesh, level)


def validate_level_sharding(lat: Lattice2D, coarse, mesh: Mesh,
                            level: int = 0) -> None:
    """Check that the lattice ``lat`` of ``level`` can shard over
    ``mesh``: it tiles the mesh with an even local row count, and the
    transfer to ``coarse`` (the next lattice, or None) has aggregation
    blocks that align with the block boundaries, so that every block
    holds whole aggregates. Raises ValueError otherwise."""
    my, mx = mesh.shape
    if lat.y_len % my or lat.xh % mx:
        raise ValueError(
            f"level-{level} lattice ({lat.y_len}, {lat.xh}) does not tile "
            f"the mesh {mesh.shape}")
    if (lat.y_len // my) % 2:
        raise ValueError("Y_loc must be even so local row parity equals "
                         "global row parity")
    if coarse is not None:
        by = lat.y_len // coarse.y_len
        bx = lat.x_len // coarse.x_len
        if bx % 2:
            raise ValueError(
                f"x blocking {bx} must be even: an odd block splits the "
                "eo-packed x axis across parities")
        y_loc, xh_loc = lat.y_len // my, lat.xh // mx
        if y_loc % by or xh_loc % (bx // 2):
            raise ValueError(
                f"MG blocking ({by} x {bx}) does not align with the shard "
                f"grid: local extents ({y_loc}, {xh_loc}) must hold whole "
                "blocks so restrict/prolong stay shard-local")


def replication_crossover(mg, mesh: Mesh) -> int:
    """First level whose lattice no longer tiles the mesh: from there
    down, levels cannot be cut and are held whole."""
    my, mx = mesh.shape
    for lvl in range(mg.get_num_levels()):
        lat = mg.get_lattice(lvl)
        if lat.y_len % my or lat.xh % mx or (lat.y_len // my) % 2:
            return lvl
    return mg.get_num_levels()


def _digest(t) -> torch.Tensor:
    """A float64 digest of a tensor, on its device: the plain, the
    weighted and the squared sums of its real components, the weights
    an irrational-step cosine of the position, so that two tensors that
    differ anywhere differ here too but for a coincidence."""
    v = (torch.view_as_real(t) if t.is_complex() else t)
    v = v.to(torch.float64).reshape(-1)
    w = torch.cos(torch.arange(v.numel(), dtype=torch.float64,
                               device=v.device) * 0.7548776662466927)
    return torch.stack([v.sum(), (v * w).sum(), (v * v).sum()])


def check_replicated(mesh: Mesh, arrays: dict) -> int:
    """Check that every rank of a distributed ``mesh`` holds the same
    ``arrays`` (name -> tensor, the same names on every rank): each
    rank's digests (``_digest``) are all-gathered and compared, and the
    first array whose digests differ raises a ValueError that names it,
    on every rank alike. The gathered bytes go to ``mesh.sent["digest"]``.
    An in-process mesh holds one copy and checks nothing. Returns the
    number of arrays checked."""
    if not mesh.distributed or not arrays:
        return 0
    import torch.distributed as dist
    names = sorted(arrays)
    with span("qmg.mesh.digest"):
        mine = torch.stack([_digest(arrays[n]) for n in names])
        parts = [torch.empty_like(mine) for _ in range(mesh.ny * mesh.nx)]
        dist.all_gather(parts, mine, group=mesh.group)
    mesh.sent["digest"] += mine.numel() * mine.element_size()
    for i, name in enumerate(names):
        rows = torch.stack([p[i] for p in parts])
        if not bool((rows == rows[0]).all()):
            raise ValueError(
                f"the ranks hold different copies of {name}: every rank "
                "must hold bit-identical coarse levels (digests "
                f"{rows.cpu().tolist()})")
    return len(names)
