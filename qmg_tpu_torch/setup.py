"""MG setup: null-vector generation and the K-cycle hierarchy build (port
of qmg_tpu/setup.py's n13 and n19 flows).

  * ``generate_null_vectors``: gaussian -> orthogonalize -> residual
    equation M e = -M g with BiCGstab(l) (or restarted GCR, the n19
    variant, on the rbjacobi operator) -> v = g + e -> re-orthogonalize.
    The gaussians are drawn on the host from the shared ``QMGRandom``
    stream, or given (``setup_planes.gauss_seed_planes`` draws them ahead
    in the same order), and moved to the operator's device and dtype.
  * ``chiral_double``: split each vector into +-chirality halves and
    normalize (ups first, then downs).
  * ``build_kcycle_hierarchy``: per refinement level, generate vectors on
    the current coarsest stencil, double them, build a TransferMG, and
    push the Galerkin coarse level with its solve config. The n19 Schur
    configuration (``KCycleConfig(**SCHUR_CONFIG)``) coarsens the
    rbjacobi operator and solves RIGHT_SCHUR on every level.
    ``free_null_vectors`` takes the geometric per-spin constants instead
    of solves (the free-field leg); ``structure_only`` builds the shapes
    alone (zero null vectors, identity clover, zero hopping), a scaffold
    for a state loaded later.
  * the n22 adaptive (alpha-MG) setup: ``build_adaptive_hierarchy`` gives
    every level Richardson-smoothed gaussian test vectors generated on
    its own operator (``build_coarse_by_restrict``); each
    ``adaptive_pass`` smooths the test vectors with the current K-cycle,
    replaces the level below (``update_level``) and rebuilds every
    coarser one; ``finalize_adaptive`` folds the setup's work into the
    NULLVEC counters and restores the solve-phase parameters. Every
    rebuilt transfer carries ``DoublingType.PROJECTION``, qmg_tpu's
    deliberate divergence from the reference (PARITY.md), without which
    levels below the second would be singular. The setup's own K-cycles
    take the plain applies.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .lattice import Lattice2D
from .stencil import Stencil2D, StencilType
from .transfer import TransferMG, DoublingType
from .stateful import (StatefulMultigridMG, LevelSolveMG, CoarsestSolveMG,
                       DSLASH_NULLVEC, zero_carry)
from .multigrid import PRECOND_ORIGINAL, PRECOND_RIGHT_BLOCK_JACOBI
from .operators.coarse import CoarseOperator2D
from . import solvers
from .linalg import (normalize, orthogonal, pin_full_precision,
                     identity_like)
from .stencil import make_coeffs


def _gaussian_source(rng, gaussians, n: int, lat: Lattice2D, ref):
    """draw(k) -> the k-th of ``n`` gaussian fields of ``lat`` on ``ref``'s
    device and dtype: drawn from ``rng`` at the call, or row k of the given
    (n, *cv_shape) ``gaussians`` (an array or a tensor; exactly one of the
    two)."""
    if (rng is None) == (gaussians is None):
        raise ValueError("give exactly one of rng and gaussians")
    if gaussians is not None and tuple(gaussians.shape) != (
            (n,) + lat.cv_shape()):
        raise ValueError(f"gaussians must be {(n,) + lat.cv_shape()}, "
                         f"got {tuple(gaussians.shape)}")

    def draw(k):
        g = rng.gaussian_cv(lat) if gaussians is None else gaussians[k]
        return torch.as_tensor(g).to(device=ref.device, dtype=ref.dtype)
    return draw


def generate_null_vectors(stencil: Stencil2D, n_vec: int, rng=None,
                          max_iter: int = 500, tol: float = 5e-5, *,
                          gaussians=None,
                          stype: StencilType = StencilType.ORIGINAL,
                          solver: str = "bicgstab_l", reduce=None):
    """Algebraic near-null vectors via the residual equation on the
    ``stype`` operator (a full-field type), solved with BiCGstab(6)
    (``solver="bicgstab_l"``) or GCR restarted every 64 iterations
    (``"gcr_restart"``), from gaussians drawn from ``rng`` or the given
    ``gaussians`` (n_vec, *cv_shape) (an array or a tensor; exactly one of
    the two). Returns (vectors (n_vec, *cv_shape), total operator
    applications). A stencil that holds one rank's block of a lattice
    cut over ranks (``Stencil2D.pulls`` a mesh's) solves on that block,
    its inner products summed over the ranks by ``reduce``
    (``parallel.Mesh.all_sum``)."""
    if solver not in ("bicgstab_l", "gcr_restart"):
        raise ValueError(f"unknown null-vector solver {solver}")
    lat = stencil.lat
    draw = _gaussian_source(rng, gaussians, n_vec, lat, stencil.coeffs.ref)
    matvec = stencil.get_apply_function(stype)
    vecs = []
    total_ops = 0
    for i in range(n_vec):
        g = draw(i)
        for v in vecs:
            g = orthogonal(g, v, reduce)
        rhs = -matvec(g)
        total_ops += 1
        if solver == "bicgstab_l":
            res = solvers.bicgstab_l(matvec, rhs, max_iter=max_iter,
                                     tol=tol, l=6, reduce=reduce)
        else:
            res = solvers.gcr_restart(matvec, rhs, max_iter=max_iter,
                                      tol=tol, restart_freq=64,
                                      reduce=reduce)
        total_ops += res.ops_count
        v = g + res.x
        for w in vecs:
            v = orthogonal(v, w, reduce)
        vecs.append(v)
    return torch.stack(vecs), total_ops


def chiral_double(stencil: Stencil2D, vectors, reduce=None):
    """n vectors -> 2n: chiral ups first, then downs, each normalized (on
    a rank's block, its norms summed over the ranks by ``reduce``)."""
    ups, downs = [], []
    for i in range(vectors.shape[0]):
        up, down = stencil.chiral_projection_both(vectors[i])
        ups.append(normalize(up, reduce))
        downs.append(normalize(down, reduce))
    return torch.stack(ups + downs)


@dataclasses.dataclass
class KCycleConfig:
    """The n13 parameter block (qmg_tpu's fields and defaults;
    ``SCHUR_CONFIG`` holds the n19 values of the stencil-type fields)."""
    x_block: int = 4
    y_block: int = 4
    coarse_dof: int = 8          # after doubling
    n_refine: int = 2
    # outer solve
    tol: float = 1e-10
    max_iter: int = 1000
    restart_freq: int = 32
    # intermediate (K-cycle Krylov)
    inner_tol: float = 0.2
    inner_max_iter: int = 1000
    inner_restart_freq: int = 32
    # smoothers
    n_pre_smooth: int = 2
    pre_smooth_tol: float = 1e-15
    n_post_smooth: int = 2
    post_smooth_tol: float = 1e-15
    # coarsest
    coarsest_tol: float = 0.2
    coarsest_max_iter: int = 1000
    coarsest_restart_freq: int = 32
    # null vector generation
    nullvec_max_iter: int = 500
    nullvec_tol: float = 5e-5
    nullvec_solver: str = "bicgstab_l"
    nullvec_stype: StencilType = StencilType.ORIGINAL
    fine_stencil_app: StencilType = StencilType.ORIGINAL
    coarsest_stencil_app: StencilType = StencilType.ORIGINAL
    # what each coarse level coarsens (the rbjacobi operator on the n19
    # path) and which of its derived sets it builds at once
    # (CoarseOperator2D.BUILD_*)
    precond_coarsen_rbjacobi: bool = False
    build_extra: int = 0
    # the geometric null vectors (constant per spin component) instead of
    # solves; needs coarse_dof <= the fine nc
    free_null_vectors: bool = False
    # solve the coarsest level with a dense inverse
    coarsest_direct: bool = False
    # if > 0, every intermediate K-cycle Krylov solve runs exactly this
    # many GCR iterations instead of stopping at inner_tol (flexible GCR
    # tolerates any inner variation); with a direct coarsest no loop below
    # the outer one has a stopping test
    inner_fixed_iters: int = 0

    def level_solve(self) -> LevelSolveMG:
        fixed = self.inner_fixed_iters > 0
        return LevelSolveMG(
            fine_stencil_app=self.fine_stencil_app,
            intermediate_tol=self.inner_tol,
            intermediate_iters=(self.inner_fixed_iters if fixed
                                else self.inner_max_iter),
            intermediate_restart_freq=self.inner_restart_freq,
            pre_tol=self.pre_smooth_tol, pre_iters=self.n_pre_smooth,
            post_tol=self.post_smooth_tol, post_iters=self.n_post_smooth,
            fixed_trips=fixed)

    def coarsest_solve(self) -> CoarsestSolveMG:
        return CoarsestSolveMG(
            coarsest_stencil_app=self.coarsest_stencil_app,
            coarsest_tol=self.coarsest_tol,
            coarsest_iters=self.coarsest_max_iter,
            coarsest_restart_freq=self.coarsest_restart_freq)

    def coarse_lattices(self, lat0: Lattice2D):
        return _coarse_lattices(self, lat0)


def _coarse_lattices(cfg, lat0: Lattice2D):
    """The coarse lattices of the hierarchy ``cfg`` describes, finest
    first."""
    lats, x, y = [], lat0.x_len, lat0.y_len
    for _ in range(cfg.n_refine):
        x //= cfg.x_block
        y //= cfg.y_block
        lats.append(Lattice2D(x, y, cfg.coarse_dof))
    return lats


# The n19 configuration (qmg_tpu's tests/test_n19_schur_kcycle.py and
# bench.py --outer schur): null vectors on the rbjacobi operator by
# restarted GCR, every coarse level the Galerkin coarsening of the rbjacobi
# operator with its own rbjacobi form built, RIGHT_SCHUR on every level.
SCHUR_CONFIG = dict(
    fine_stencil_app=StencilType.RIGHT_SCHUR,
    coarsest_stencil_app=StencilType.RIGHT_SCHUR,
    nullvec_stype=StencilType.RIGHT_JACOBI,
    nullvec_solver="gcr_restart",
    precond_coarsen_rbjacobi=True,
    build_extra=CoarseOperator2D.BUILD_RBJACOBI)


def _free_null_vectors(lat: Lattice2D, coarse_dof: int, ref):
    """The per-spin constants: vector c is 1 on spin component c mod nc."""
    if coarse_dof > lat.nc:
        raise ValueError(
            f"free_null_vectors gives only {lat.nc} independent per-spin "
            f"constants on {lat}; coarse_dof={coarse_dof} would duplicate "
            "vectors and make the block Gram matrix singular (use "
            "coarse_dof = n_spin)")
    nv = torch.zeros((coarse_dof,) + lat.cv_shape(), dtype=ref.dtype,
                     device=ref.device)
    for c in range(coarse_dof):
        nv[c, ..., c % lat.nc] = 1.0
    return nv


def _scaffold_level(lat_prev: Lattice2D, lat_i: Lattice2D,
                    cfg: "KCycleConfig", ref):
    """A level of the right shapes and no content: zero blocked null
    vectors, identity clover, zero hopping."""
    # Blocked (nvec, 2c, B, Yc, Xhc); a volume-1 coarse lattice has one
    # parity slot.
    blocked = (cfg.coarse_dof, 1 if lat_i.volume == 1 else 2,
               lat_prev.volume // lat_i.volume * lat_prev.nc,
               lat_i.y_len, lat_i.xh)
    t = TransferMG.from_blocked(
        lat_prev, lat_i, torch.zeros(blocked, dtype=ref.dtype,
                                     device=ref.device))
    clover = identity_like(torch.zeros(lat_i.cm_shape(), dtype=ref.dtype,
                                       device=ref.device))
    hopping = torch.zeros((4,) + lat_i.cm_shape(), dtype=ref.dtype,
                          device=ref.device)
    st = CoarseOperator2D.from_coeffs(
        make_coeffs(lat_i, clover=clover, hopping=hopping, dtype=ref.dtype),
        t, is_chiral=True, use_rbjacobi=cfg.precond_coarsen_rbjacobi)
    return t, st


def _no_stage(label: str):
    return contextlib.nullcontext()


def build_kcycle_hierarchy(lat0: Lattice2D, fine_op: Stencil2D,
                           cfg: KCycleConfig, rng=None, *, seeds=None,
                           structure_only: bool = False, stage=_no_stage
                           ) -> StatefulMultigridMG:
    """Construct the K-cycle hierarchy (n13; n19 with ``SCHUR_CONFIG``) on
    the fine operator's device. The
    null vectors' gaussians come from ``rng`` (drawn level by level as the
    build goes) or from ``seeds``, one (coarse_dof / 2, *cv_shape) stack
    per refinement level (``setup_planes.gauss_seed_planes``); with
    ``cfg.free_null_vectors`` or ``structure_only`` nothing is drawn and
    neither is given. ``structure_only`` builds the levels' shapes with no
    content (zero null vectors, identity clover, zero hopping) and no
    dense inverse, a scaffold that preconditions nothing. ``stage(label)``
    is entered around each stage of the build (``push_kcycle_levels``'s,
    then "cdinv", the dense inverse)."""
    draws = not (cfg.free_null_vectors or structure_only)
    if draws and (rng is None) == (seeds is None):
        raise ValueError("give exactly one of rng and seeds")
    if not draws and (rng is not None or seeds is not None):
        raise ValueError("free_null_vectors and structure_only draw no "
                         "gaussians: give neither rng nor seeds")
    if seeds is not None and len(seeds) != cfg.n_refine:
        raise ValueError(f"need {cfg.n_refine} gauss seed stacks, got "
                         f"{len(seeds)}")
    pin_full_precision()
    mg = StatefulMultigridMG(lat0, fine_op, cfg.coarsest_solve())
    push_kcycle_levels(mg, cfg, 1, rng, seeds, structure_only, stage)
    if structure_only:
        return mg
    if cfg.coarsest_direct:
        with stage("cdinv"):
            mg.prepare_direct_coarsest()
    return mg


def push_kcycle_levels(mg: StatefulMultigridMG, cfg: KCycleConfig,
                       first: int, rng=None, seeds=None,
                       structure_only: bool = False, stage=_no_stage):
    """Push ``build_kcycle_hierarchy``'s levels ``first`` ...
    ``cfg.n_refine`` onto ``mg``, which holds the levels above them.
    ``stage(label)`` is entered around each level i's stages: "L{i}
    nullvec" (the null vectors on level i - 1 and their doubling), "L{i}
    transfer" and "L{i} coarse" (the Galerkin build and the derived sets it
    asks for)."""
    lats = [mg.get_lattice(0)] + cfg.coarse_lattices(mg.get_lattice(0))
    ref = mg.get_stencil(first - 1).coeffs.ref
    lat_prev = lats[first - 1]
    for i, lat_i in enumerate(lats[first:], start=first):
        if structure_only:
            transfer, coarse = _scaffold_level(lat_prev, lat_i, cfg, ref)
            mg.push_level(lat_i, transfer, cfg.level_solve(),
                          stencil=coarse)
            lat_prev = lat_i
            continue
        stencil = mg.get_stencil(i - 1)
        with stage(f"L{i} nullvec"):
            if cfg.free_null_vectors:
                raw = _free_null_vectors(lat_prev, cfg.coarse_dof, ref)
            else:
                vecs, ops = generate_null_vectors(
                    stencil, cfg.coarse_dof // 2, rng,
                    max_iter=cfg.nullvec_max_iter, tol=cfg.nullvec_tol,
                    gaussians=None if seeds is None else seeds[i - 1],
                    stype=cfg.nullvec_stype, solver=cfg.nullvec_solver)
                mg.add_tracker_count(DSLASH_NULLVEC, ops, i - 1)
                raw = chiral_double(stencil, vecs)
        with stage(f"L{i} transfer"):
            transfer = TransferMG(lat_prev, lat_i, raw,
                                  doubling=DoublingType.PROJECTION)
        with stage(f"L{i} coarse"):
            mg.push_level(lat_i, transfer, cfg.level_solve(),
                          build_stencil=True, is_chiral=True,
                          build_stencil_from=(PRECOND_RIGHT_BLOCK_JACOBI
                                              if cfg.precond_coarsen_rbjacobi
                                              else PRECOND_ORIGINAL),
                          build_extra=cfg.build_extra, nvecs=raw)
        lat_prev = lat_i


# ---------------------------------------------------------------------------
# The n22 adaptive setup.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdaptiveConfig:
    """The n22 adaptive (alpha-MG) parameter block (qmg_tpu's fields and
    defaults)."""
    n_refine: int = 2
    coarse_dof: int = 8          # after doubling
    x_block: int = 4
    y_block: int = 4
    n_setup: int = 1             # adaptive passes
    # the setup's level solves (the K-cycles that smooth test vectors)
    setup_inner_tol: float = 1e-10
    setup_inner_iters: int = 8
    setup_inner_restart: int = 1024
    # smoothers, the same in setup and solve
    n_pre_smooth: int = 2
    pre_smooth_tol: float = 1e-15
    n_post_smooth: int = 2
    post_smooth_tol: float = 1e-15
    # Richardson smoothing of the gaussian test vectors
    richardson_iters: int = 10
    richardson_omega: float = 0.33
    richardson_blocksize: int = 250
    # K-cycle smoothing of the test vectors in each pass
    kcycle_smooth_iters: int = 10
    kcycle_smooth_tol: float = 1e-10
    # the solve's level solves, restored by finalize_adaptive
    inner_tol: float = 0.2
    inner_max_iter: int = 1000
    inner_restart_freq: int = 32
    coarsest_tol: float = 0.2
    coarsest_max_iter: int = 1000
    coarsest_restart_freq: int = 32

    def coarse_lattices(self, lat0: Lattice2D):
        return _coarse_lattices(self, lat0)


def _setup_level_solve(acfg: AdaptiveConfig) -> LevelSolveMG:
    return LevelSolveMG(
        intermediate_tol=acfg.setup_inner_tol,
        intermediate_iters=acfg.setup_inner_iters,
        intermediate_restart_freq=acfg.setup_inner_restart,
        pre_tol=acfg.pre_smooth_tol, pre_iters=acfg.n_pre_smooth,
        post_tol=acfg.post_smooth_tol, post_iters=acfg.n_post_smooth)


def _rebuild(mg: StatefulMultigridMG, fine_level: int, lat_c: Lattice2D,
             tvs, level_solve: LevelSolveMG, fresh_build: bool):
    """Chiral-double level ``fine_level``'s test vectors, build the
    transfer (PROJECTION doubling) and push, or update in place, the
    Galerkin level below."""
    raw = chiral_double(mg.get_stencil(fine_level), tvs)
    transfer = TransferMG(mg.get_lattice(fine_level), lat_c, raw,
                          doubling=DoublingType.PROJECTION)
    kw = dict(build_stencil=True, is_chiral=True, nvecs=raw)
    if fresh_build:
        mg.push_level(lat_c, transfer, level_solve, **kw)
    else:
        mg.update_level(fine_level + 1, lat_c, transfer, level_solve, **kw)
    return transfer


def build_coarse_by_restrict(mg: StatefulMultigridMG, test_vectors: dict,
                             fine_level: int, coarse_lat: Lattice2D,
                             level_solve: LevelSolveMG, fresh_build: bool,
                             rng, acfg: AdaptiveConfig, *, gaussians=None
                             ) -> TransferMG:
    """Build (``fresh_build``: push) or rebuild (update in place) the level
    below ``fine_level`` from Richardson-smoothed gaussian test vectors on
    ``fine_level``'s own operator: for each of coarse_dof / 2 gaussians
    (from ``rng``, or the given (coarse_dof / 2, *cv_shape) ``gaussians``),
    Richardson(omega, iterations, blocksize of ``acfg``), orthogonalize
    against the previous ones, normalize; then chiral doubling and the
    transfer. The vectors go to ``test_vectors[fine_level]`` as one
    (coarse_dof / 2, *cv_shape) tensor, the Richardson applies to the
    level's NULLVEC count."""
    n_half = coarse_lat.nc // 2
    st = mg.get_stencil(fine_level)
    draw = _gaussian_source(rng, gaussians, n_half,
                            mg.get_lattice(fine_level), st.coeffs.ref)
    matvec = st.get_apply_function()
    tvs = []
    for k in range(n_half):
        res = solvers.richardson(matvec, draw(k),
                                 max_iter=acfg.richardson_iters,
                                 tol=1e-10, omega=acfg.richardson_omega,
                                 blocksize=acfg.richardson_blocksize)
        mg.add_tracker_count(DSLASH_NULLVEC, res.ops_count, fine_level)
        v = res.x
        for w in tvs:
            v = orthogonal(v, w)
        tvs.append(normalize(v))
    test_vectors[fine_level] = torch.stack(tvs)
    return _rebuild(mg, fine_level, coarse_lat, test_vectors[fine_level],
                    level_solve, fresh_build)


def build_adaptive_hierarchy(lat0: Lattice2D, fine_op: Stencil2D,
                             acfg: AdaptiveConfig, rng=None, *, seeds=None,
                             on_stage=None):
    """The n22 initial setup on the fine operator's device: level by level,
    fine to coarse, ``build_coarse_by_restrict`` on the level's own
    operator, with the setup's level solves. The gaussians come from
    ``rng`` or from ``seeds``, one stack per level (the first list of
    ``setup_planes.adaptive_seed_planes``). ``on_stage("init", i)`` is
    called after level i + 1 is built. Returns (mg, test_vectors) for
    ``adaptive_pass``."""
    if (rng is None) == (seeds is None):
        raise ValueError("give exactly one of rng and seeds")
    if seeds is not None and len(seeds) != acfg.n_refine:
        raise ValueError(f"need {acfg.n_refine} init seed stacks, got "
                         f"{len(seeds)}")
    pin_full_precision()
    mg = StatefulMultigridMG(lat0, fine_op, CoarsestSolveMG(
        coarsest_tol=acfg.coarsest_tol,
        coarsest_iters=acfg.coarsest_max_iter,
        coarsest_restart_freq=acfg.coarsest_restart_freq))
    test_vectors = {}
    for i, lat_i in enumerate(acfg.coarse_lattices(lat0)):
        build_coarse_by_restrict(
            mg, test_vectors, i, lat_i, _setup_level_solve(acfg), True, rng,
            acfg, gaussians=None if seeds is None else seeds[i])
        if on_stage is not None:
            on_stage("init", i)
    return mg, test_vectors


def check_pass_seeds(seeds, n_refine: int):
    """One pass's seeds hold n_refine - 1 - i rebuild stacks at level i."""
    if [len(s) for s in seeds] != [n_refine - 1 - i
                                   for i in range(n_refine)]:
        raise ValueError("a pass needs n_refine - 1 - i rebuild seed stacks "
                         f"at each level i, got {[len(s) for s in seeds]}")


def adaptive_pass(mg: StatefulMultigridMG, test_vectors: dict,
                  acfg: AdaptiveConfig, rng=None, *, seeds=None,
                  on_stage=None):
    """One adaptive pass. For each level i, fine to coarse: smooth each
    test vector with the current K-cycle at level i (flexible GCR,
    ``kcycle_smooth_iters`` iterations at ``kcycle_smooth_tol``; below
    level 0 the right-hand side is the restriction of the finer level's
    test vector), orthonormalize, chiral-double, replace level i + 1
    (``update_level``), then rebuild every coarser level with
    ``build_coarse_by_restrict``. Its gaussians come from ``rng`` or from
    ``seeds``: for each level i the stacks of levels i + 1 ...
    n_refine - 1 (one pass's entry of ``adaptive_seed_planes``' second
    list). ``on_stage("pass", i)`` follows level i's update and
    ``on_stage("rebuild", jj)`` each rebuild."""
    n_refine = mg.get_num_levels() - 1
    if (rng is None) == (seeds is None):
        raise ValueError("give exactly one of rng and seeds")
    if seeds is not None:
        check_pass_seeds(seeds, n_refine)
    pin_full_precision()
    for i in range(n_refine):
        st = mg.get_stencil(i)
        lat_c = mg.get_lattice(i + 1)
        matvec = st.get_apply_function()
        precond = mg.make_preconditioner(i)
        tvs = []
        for j in range(lat_c.nc // 2):
            rhs = (test_vectors[0][j] if i == 0 else
                   mg.get_transfer(i - 1).restrict_f2c(
                       test_vectors[i - 1][j]))
            res, _ = solvers.gcr_var_precond(
                matvec, rhs, precond, max_iter=acfg.kcycle_smooth_iters,
                tol=acfg.kcycle_smooth_tol,
                precond_carry=zero_carry(mg.get_num_levels()))
            mg.add_tracker_count(DSLASH_NULLVEC, res.ops_count + 1, i)
            v = res.x
            for w in tvs:
                v = orthogonal(v, w)
            tvs.append(normalize(v))
        test_vectors[i] = torch.stack(tvs)
        _rebuild(mg, i, lat_c, test_vectors[i], mg.get_level_solve(i),
                 False)
        if on_stage is not None:
            on_stage("pass", i)
        for jj in range(i + 1, n_refine):
            build_coarse_by_restrict(
                mg, test_vectors, jj, mg.get_lattice(jj + 1),
                mg.get_level_solve(jj), False, rng, acfg,
                gaussians=None if seeds is None else seeds[i][jj - i - 1])
            if on_stage is not None:
                on_stage("rebuild", jj)


def finalize_adaptive(mg: StatefulMultigridMG, acfg: AdaptiveConfig):
    """The end of the setup: every level's counts folded into NULLVEC,
    and the solve-phase intermediate solves restored."""
    for i in range(mg.get_num_levels()):
        mg.shift_all_to_nullvec(i)
    for i in range(mg.get_num_levels() - 1):
        mg.level_solve_list[i] = dataclasses.replace(
            mg.get_level_solve(i), intermediate_tol=acfg.inner_tol,
            intermediate_iters=acfg.inner_max_iter,
            intermediate_restart_freq=acfg.inner_restart_freq)
