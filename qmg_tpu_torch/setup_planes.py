"""The per-configuration setup from explicit gaussian seeds (port of the
interface of qmg_tpu/setup_planes.py).

A measurement stream rebuilds the hierarchy for every gauge configuration.
qmg_tpu traces that setup into jitted stages with float32 "planes" at
their boundaries, because its TPU backend has no eager complex arithmetic;
in PyTorch the eager setup (``setup.build_kcycle_hierarchy``) already runs
on the device, so what is ported here is the interface:

  * ``gauss_seed_planes(lat, cfg, rng)`` draws the null-vector gaussians on
    the host ahead of the setup, in the reference's order (per level, per
    vector), as complex128 stacks;
  * ``make_kcycle_setup_planes(lat, cfg, mass, w, device=...)`` returns
    ``setup_fn(gauge, *seeds)``, which builds the Wilson operator and the
    hierarchy (with the dense coarsest inverse when ``cfg.coarsest_direct``)
    on the device from those seeds and returns it. With ``deflate_low`` /
    ``deflate_high`` it ends with the deflation stage: the coarsest normal
    operator densified on the device, its spectrum on the host in
    complex128, the lowest / highest eigenpairs by real part kept,
    normalized, on the device (``StatefulMultigridMG.deflate_coarsest``).

Drawn ahead, the seeds are the numbers that ``build_kcycle_hierarchy(...,
rng)`` would draw level by level from the same stream, so both builds give
the same hierarchy. The TPU-only options (``per_level_jit``,
``channels_first``, ``matmul_precision``) have no counterpart and are
refused.

``mesh`` (a ``parallel.Mesh``) cuts level 0 into blocks for the whole
setup, as qmg_tpu's ``make_kcycle_setup_planes(mesh=)`` does, with one
code path over the mesh's held blocks (``shard_dslash.mesh_pulls``): each
block's Wilson coefficients from its own rows of the host gauge and the
one row and column its -y and -x hops read; the null vectors solved on
the blocks (the level-0 stencil takes the mesh's pulls, the solvers'
inner products are summed over the ranks); chiral doubling and block
orthonormalization inside each block (aggregates lie inside blocks); the
Galerkin probes prolonged onto the blocks, each piece applied with the
halos of the probe batch, the responses restricted and joined (gathered
over the ranks) into the whole level 1 on every rank; the n19 derived
sets of level 0 built on the blocks with one- and two-row halos. Levels
>= 1, the dense inverse and the deflation stage run as they are, on
every rank, which the digest check of ``parallel.check_replicated`` then
holds to one copy. Unlike qmg_tpu, no level below 0 is cut; the state is
the same. A distributed mesh returns the rank's hierarchy (what
``solve.state_from_numpy(shard_state(...)[rank], cfg, mesh=mesh)`` builds
from the whole one), an in-process mesh the whole hierarchy.

The n22 adaptive setup has the same form:

  * ``adaptive_seed_planes(lat, acfg, rng)`` draws (init_seeds,
    pass_seeds) in the order the eager flow consumes them: the initial
    levels fine to coarse, then for each pass and each level i the
    rebuilds of levels i + 1 ... n_refine - 1;
  * ``make_adaptive_setup_planes(lat, acfg, mass, w, ...)`` returns
    ``setup_fn(gauge, init_seeds, pass_seeds)``, which runs
    ``setup.build_adaptive_hierarchy``, ``adaptive_pass`` x n_setup and
    ``finalize_adaptive`` on the device (then, with ``coarsest_direct``,
    ``prepare_direct_coarsest``, qmg_tpu's ``cdinv`` stage) and returns the
    hierarchy. Every stage is timed (``setup_fn.stages``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .lattice import Lattice2D
from .operators.wilson import Wilson2D, wilson_coeff_arrays
from .setup import (KCycleConfig, build_kcycle_hierarchy, AdaptiveConfig,
                    build_adaptive_hierarchy, adaptive_pass,
                    finalize_adaptive, check_pass_seeds,
                    generate_null_vectors, chiral_double, push_kcycle_levels,
                    pin_full_precision)
from .stencil import StencilType, WHOLE
from .stateful import _NORMAL_TYPES, StatefulMultigridMG, DSLASH_NULLVEC
from .transfer import (TransferMG, ShardedTransferMG, DoublingType,
                       block_lattices)
from .multigrid import PRECOND_ORIGINAL, PRECOND_RIGHT_BLOCK_JACOBI
from .parallel import (Mesh, shard_field, unshard_field, check_replicated,
                       validate_level_sharding)
from .shard_dslash import mesh_pulls

__all__ = ["gauss_seed_planes", "make_kcycle_setup_planes",
           "adaptive_seed_planes", "make_adaptive_setup_planes"]

TPU_ONLY = ("per_level_jit", "channels_first", "matmul_precision")
# The largest coarsest level whose dense inverse a setup builds, qmg_tpu's
# limit: the inverse is probed, densified and inverted on the host, and
# the dimension grows 16x for each level the hierarchy stops short.
MAX_DIRECT_DIM = 4096


def _refuse(options: dict, fname: str):
    """qmg_tpu's options that the eager setup has no use for."""
    for name in options:
        if name in TPU_ONLY:
            raise ValueError(f"{name} is a TPU workaround of qmg_tpu's "
                             "traced setup; the eager setup on the device "
                             "takes no such option")
        raise TypeError(f"{fname}() got an unexpected keyword argument "
                        f"{name!r}")


def check_setup_mesh(lat0: Lattice2D, cfg, mesh: Mesh):
    """The refusals of a mesh for the setup, qmg_tpu's: level 0 must tile
    the mesh with an even local row count and hold whole aggregation
    blocks of an even x blocking (``parallel.validate_level_sharding``:
    "does not tile", "does not align"), and every block an even number of
    coarse columns (``transfer.block_lattices``)."""
    coarse = cfg.coarse_lattices(lat0)[0]
    validate_level_sharding(lat0, coarse, mesh)
    block_lattices(lat0, coarse, mesh)


def _check_direct(lat0: Lattice2D, cfg, direct: bool) -> int:
    """The coarsest level's dimension, refused for a dense inverse above
    ``MAX_DIRECT_DIM``."""
    n_coarsest = int(np.prod(cfg.coarse_lattices(lat0)[-1].cv_shape()))
    if direct and n_coarsest > MAX_DIRECT_DIM:
        raise ValueError(
            f"coarsest dimension {n_coarsest} too large for the dense "
            f"direct inverse (at most {MAX_DIRECT_DIM}, qmg_tpu's limit) - "
            "use a deeper hierarchy (larger n_refine) or "
            "coarsest_direct=False")
    return n_coarsest


def gauss_seed_planes(lat0: Lattice2D, cfg: KCycleConfig, rng):
    """The null-vector gaussians of every refinement level, drawn from
    ``rng`` per level and per vector: a list of ``cfg.n_refine``
    complex128 arrays (coarse_dof / 2, *cv_shape of the level's fine
    lattice)."""
    lats = [lat0] + cfg.coarse_lattices(lat0)
    n_half = cfg.coarse_dof // 2
    return [np.stack([rng.gaussian_cv(lats[i - 1]) for _ in range(n_half)])
            for i in range(1, cfg.n_refine + 1)]


def make_kcycle_setup_planes(lat0: Lattice2D, cfg: KCycleConfig, mass,
                             w: float = 1.0, *, dtype=torch.complex64,
                             device="cuda", deflate_low: int = 0,
                             deflate_high: int = 0, mesh: Mesh | None = None,
                             **options):
    """Returns ``setup_fn(gauge, *seeds) -> StatefulMultigridMG``: the n13
    setup of a Wilson operator (mass ``mass``, Wilson coefficient ``w``,
    ``dtype``) on ``device`` from a (2, 2, Y, Xh) U(1) gauge field (an
    array or a tensor) and one seed stack per level
    (``gauss_seed_planes``), then, with ``deflate_low`` / ``deflate_high``,
    the deflation stage (which needs a normal ``cfg.coarsest_stencil_app``
    and a coarsest level of at most ``MAX_DIRECT_DIM`` dimensions). With
    ``mesh`` level 0 is cut into the mesh's blocks (the module's
    docstring; ``check_setup_mesh`` says what it refuses); the inputs stay
    the whole host arrays. Each call leaves ``setup_fn.seconds``, the
    setup's wall time with the device synchronized. qmg_tpu's options
    that this setup has no use for raise ``ValueError``."""
    _refuse(options, "make_kcycle_setup_planes")
    if lat0.nc != 2:
        raise ValueError("make_kcycle_setup_planes builds the Wilson n13 "
                         f"flow; fine nc must be 2, got {lat0.nc}")
    if mesh is not None:
        check_setup_mesh(lat0, cfg, mesh)
    n_coarsest = _check_direct(lat0, cfg, cfg.coarsest_direct)
    if deflate_low or deflate_high:
        if StencilType(cfg.coarsest_stencil_app) not in _NORMAL_TYPES:
            raise ValueError(
                "deflation requires a NORMAL coarsest stencil app - set "
                "coarsest_stencil_app to MDAGGER_M / M_MDAGGER")
        if n_coarsest > MAX_DIRECT_DIM:
            raise ValueError(
                f"coarsest dimension {n_coarsest} too large for the densify-"
                f"based deflation stage (at most {MAX_DIRECT_DIM}) - deepen "
                "the hierarchy")

    def setup_fn(gauge, *seeds):
        if len(seeds) != cfg.n_refine:
            raise ValueError(f"need {cfg.n_refine} gauss seed arrays, got "
                             f"{len(seeds)}")
        t0 = _synced_clock(device)
        if mesh is None:
            op = Wilson2D(lat0, mass, gauge, w, dtype=dtype, device=device)
            mg = build_kcycle_hierarchy(lat0, op, cfg, seeds=list(seeds))
        else:
            mg = _sharded_hierarchy(lat0, cfg, mass, w, gauge, seeds, dtype,
                                    device, mesh)
        if deflate_low or deflate_high:
            mg.deflate_coarsest(deflate_low, deflate_high)
        if mesh is not None:
            check_replicated(mesh, mg.replicated_arrays())
        setup_fn.seconds = _synced_clock(device) - t0
        return mg

    setup_fn.seconds = None
    return setup_fn


def _sharded_hierarchy(lat0: Lattice2D, cfg: KCycleConfig, mass, w, gauge,
                       seeds, dtype, device, mesh: Mesh):
    """``build_kcycle_hierarchy`` with level 0 cut over ``mesh`` (the
    module's docstring), up to the dense inverse."""
    pin_full_precision()
    lat1 = cfg.coarse_lattices(lat0)[0]
    reduce = mesh.all_sum if mesh.distributed else None
    # Level 0 on the held blocks: a distributed rank's block operator, the
    # whole one (joined from its blocks) in process, both with the mesh's
    # pulls.
    arrays = [wilson_coeff_arrays(lat0, gauge, w, dtype=dtype, device=device,
                                  block=(mesh.ny, mesh.nx, iy, ix))
              for iy, ix in mesh.blocks]
    fine_blk, coarse_blk = block_lattices(lat0, lat1, mesh)
    if mesh.distributed:
        (clover, hopping), = arrays
        held = fine_blk
    else:
        clover = unshard_field([c for c, _ in arrays], mesh, 1)
        hopping = unshard_field([h for _, h in arrays], mesh, 2)
        held = lat0
    op = Wilson2D.from_arrays(held, mass, clover, hopping, w)
    op.pulls = mesh_pulls(mesh)
    mg = StatefulMultigridMG(lat0, op, cfg.coarsest_solve())
    # Level 1: null vectors on the blocks, doubled and block-orthonormalized
    # inside each block, then the Galerkin build (push_level) through the
    # blocks' transfer.
    gaussians = torch.as_tensor(seeds[0])
    if mesh.distributed:
        (gaussians,) = shard_field(gaussians, mesh, 2)
    vecs, ops = generate_null_vectors(
        op, cfg.coarse_dof // 2, max_iter=cfg.nullvec_max_iter,
        tol=cfg.nullvec_tol, gaussians=gaussians, stype=cfg.nullvec_stype,
        solver=cfg.nullvec_solver, reduce=reduce)
    mg.add_tracker_count(DSLASH_NULLVEC, ops, 0)
    raw = chiral_double(op, vecs, reduce)
    raws = [raw] if mesh.distributed else shard_field(raw, mesh, 2)
    nvbs = [TransferMG(fine_blk, coarse_blk, r,
                       doubling=DoublingType.PROJECTION,
                       coarse_row0=iy * coarse_blk.y_len)._nvb
            for (iy, _), r in zip(mesh.blocks, raws)]
    transfer = ShardedTransferMG(lat0, lat1, nvbs, mesh)
    mg.push_level(lat1, transfer, cfg.level_solve(), build_stencil=True,
                  is_chiral=True,
                  build_stencil_from=(PRECOND_RIGHT_BLOCK_JACOBI
                                      if cfg.precond_coarsen_rbjacobi
                                      else PRECOND_ORIGINAL),
                  build_extra=cfg.build_extra, nvecs=raw)
    # The derived sets level 0 solves with, built on the blocks.
    op.prebuild_derived(cfg.fine_stencil_app)
    push_kcycle_levels(mg, cfg, 2, seeds=list(seeds))
    if not mesh.distributed:
        whole = transfer.whole()
        mg.transfer_list[0] = whole
        mg.get_stencil(1).in_transfer = whole
        op.pulls = WHOLE
    if cfg.coarsest_direct:
        mg.prepare_direct_coarsest()
    return mg


def adaptive_seed_planes(lat0: Lattice2D, acfg: AdaptiveConfig, rng):
    """The adaptive setup's gaussians, drawn from ``rng`` in the order the
    eager flow consumes them: (init_seeds, pass_seeds), ``init_seeds[i]``
    a complex128 (coarse_dof / 2, *cv_shape) array of level i's lattice,
    ``pass_seeds[m][i]`` the list of rebuild stacks for levels i + 1 ...
    n_refine - 1 of pass m."""
    lats = [lat0] + acfg.coarse_lattices(lat0)
    n_half = acfg.coarse_dof // 2

    def draw(lat):
        return np.stack([rng.gaussian_cv(lat) for _ in range(n_half)])

    init = [draw(lats[i]) for i in range(acfg.n_refine)]
    passes = [[[draw(lats[jj]) for jj in range(i + 1, acfg.n_refine)]
               for i in range(acfg.n_refine)]
              for _ in range(acfg.n_setup)]
    return init, passes


def make_adaptive_setup_planes(lat0: Lattice2D, acfg: AdaptiveConfig, mass,
                               w: float = 1.0, *, dtype=torch.complex64,
                               device="cuda", coarsest_direct: bool = False,
                               **options):
    """Returns ``setup_fn(gauge, init_seeds, pass_seeds) ->
    StatefulMultigridMG``: the n22 adaptive setup of a Wilson operator
    (mass ``mass``, Wilson coefficient ``w``, ``dtype``) on ``device`` from
    a (2, 2, Y, Xh) U(1) gauge field and the seeds of
    ``adaptive_seed_planes``: the initial levels, ``acfg.n_setup`` adaptive
    passes, ``finalize_adaptive`` and, with ``coarsest_direct``, the dense
    coarsest inverse. The hierarchy solves with ``acfg``'s solve-phase
    parameters.

    Each call leaves ``setup_fn.stages``: (label, seconds) for the fine
    operator ("operator"), each initial level ("init L{i}"), each pass's
    level updates ("pass {m} L{i}") and rebuilds ("pass {m} rebuild
    L{jj}"), the dense inverse ("cdinv"), the device synchronized at each
    boundary. Non-finite test vectors stop the setup at the transfer built
    from them (``TransferMG`` refuses non-finite null vectors; the stages
    before it are in ``setup_fn.stages``). ``matmul_precision`` (TPU-only)
    is refused."""
    _refuse(options, "make_adaptive_setup_planes")
    if lat0.nc != 2:
        raise ValueError("make_adaptive_setup_planes builds the Wilson n22 "
                         f"flow; fine nc must be 2, got {lat0.nc}")
    _check_direct(lat0, acfg, coarsest_direct)

    def setup_fn(gauge, init_seeds, pass_seeds):
        if len(init_seeds) != acfg.n_refine:
            raise ValueError(f"need {acfg.n_refine} init seed arrays, got "
                             f"{len(init_seeds)}")
        if len(pass_seeds) != acfg.n_setup:
            raise ValueError(f"need {acfg.n_setup} pass seed groups, got "
                             f"{len(pass_seeds)}")
        for seeds in pass_seeds:
            check_pass_seeds(seeds, acfg.n_refine)
        stages = setup_fn.stages = []
        last = _synced_clock(device)

        def stage(label):
            nonlocal last
            now = _synced_clock(device)
            stages.append((label, now - last))
            last = now

        op = Wilson2D(lat0, mass, gauge, w, dtype=dtype, device=device)
        stage("operator")
        mg, tvs = build_adaptive_hierarchy(
            lat0, op, acfg, seeds=list(init_seeds),
            on_stage=lambda kind, i: stage(f"init L{i}"))
        for m, seeds in enumerate(pass_seeds):
            adaptive_pass(mg, tvs, acfg, seeds=seeds,
                          on_stage=lambda kind, i, m=m: stage(
                              f"pass {m} L{i}" if kind == "pass"
                              else f"pass {m} rebuild L{i}"))
        finalize_adaptive(mg, acfg)
        if coarsest_direct:
            mg.prepare_direct_coarsest()
            stage("cdinv")
        return mg

    setup_fn.stages = []
    return setup_fn


def _synced_clock(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()

