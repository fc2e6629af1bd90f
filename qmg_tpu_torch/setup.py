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
"""

from __future__ import annotations

import dataclasses

import torch

from .lattice import Lattice2D
from .stencil import Stencil2D, StencilType
from .transfer import TransferMG, DoublingType
from .stateful import (StatefulMultigridMG, LevelSolveMG, CoarsestSolveMG,
                       DSLASH_NULLVEC)
from .multigrid import PRECOND_ORIGINAL, PRECOND_RIGHT_BLOCK_JACOBI
from .operators.coarse import CoarseOperator2D
from . import solvers
from .linalg import normalize, orthogonal, pin_full_precision


def generate_null_vectors(stencil: Stencil2D, n_vec: int, rng=None,
                          max_iter: int = 500, tol: float = 5e-5, *,
                          gaussians=None,
                          stype: StencilType = StencilType.ORIGINAL,
                          solver: str = "bicgstab_l"):
    """Algebraic near-null vectors via the residual equation on the
    ``stype`` operator (a full-field type), solved with BiCGstab(6)
    (``solver="bicgstab_l"``) or GCR restarted every 64 iterations
    (``"gcr_restart"``), from gaussians drawn from ``rng`` or the given
    ``gaussians`` (n_vec, *cv_shape) (an array or a tensor; exactly one of
    the two). Returns (vectors (n_vec, *cv_shape), total operator
    applications)."""
    if (rng is None) == (gaussians is None):
        raise ValueError("give exactly one of rng and gaussians")
    if solver not in ("bicgstab_l", "gcr_restart"):
        raise ValueError(f"unknown null-vector solver {solver}")
    lat = stencil.lat
    ref = stencil.coeffs.ref
    if gaussians is not None and tuple(gaussians.shape) != (
            (n_vec,) + lat.cv_shape()):
        raise ValueError(f"gaussians must be {(n_vec,) + lat.cv_shape()}, "
                         f"got {tuple(gaussians.shape)}")
    matvec = stencil.get_apply_function(stype)
    vecs = []
    total_ops = 0
    for i in range(n_vec):
        g = torch.as_tensor(rng.gaussian_cv(lat) if gaussians is None
                            else gaussians[i]).to(device=ref.device,
                                                  dtype=ref.dtype)
        for v in vecs:
            g = orthogonal(g, v)
        rhs = -matvec(g)
        total_ops += 1
        if solver == "bicgstab_l":
            res = solvers.bicgstab_l(matvec, rhs, max_iter=max_iter,
                                     tol=tol, l=6)
        else:
            res = solvers.gcr_restart(matvec, rhs, max_iter=max_iter,
                                      tol=tol, restart_freq=64)
        total_ops += res.ops_count
        v = g + res.x
        for w in vecs:
            v = orthogonal(v, w)
        vecs.append(v)
    return torch.stack(vecs), total_ops


def chiral_double(stencil: Stencil2D, vectors):
    """n vectors -> 2n: chiral ups first, then downs, each normalized."""
    ups, downs = [], []
    for i in range(vectors.shape[0]):
        up, down = stencil.chiral_projection_both(vectors[i])
        ups.append(normalize(up))
        downs.append(normalize(down))
    return torch.stack(ups + downs)


@dataclasses.dataclass
class KCycleConfig:
    """The n13 parameter block (same fields and defaults as qmg_tpu's;
    ``SCHUR_CONFIG`` holds the n19 values of the stencil-type fields)."""
    x_block: int = 4
    y_block: int = 4
    coarse_dof: int = 8          # after doubling
    n_refine: int = 2
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
        """The coarse lattices of the hierarchy, finest first."""
        lats, x, y = [], lat0.x_len, lat0.y_len
        for _ in range(self.n_refine):
            x //= self.x_block
            y //= self.y_block
            lats.append(Lattice2D(x, y, self.coarse_dof))
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


def build_kcycle_hierarchy(lat0: Lattice2D, fine_op: Stencil2D,
                           cfg: KCycleConfig, rng=None, *, seeds=None
                           ) -> StatefulMultigridMG:
    """Construct the K-cycle hierarchy (n13; n19 with ``SCHUR_CONFIG``) on
    the fine operator's device. The
    null vectors' gaussians come from ``rng`` (drawn level by level as the
    build goes) or from ``seeds``, one (coarse_dof / 2, *cv_shape) stack
    per refinement level (``setup_planes.gauss_seed_planes``)."""
    if (rng is None) == (seeds is None):
        raise ValueError("give exactly one of rng and seeds")
    if seeds is not None and len(seeds) != cfg.n_refine:
        raise ValueError(f"need {cfg.n_refine} gauss seed stacks, got "
                         f"{len(seeds)}")
    pin_full_precision()
    mg = StatefulMultigridMG(lat0, fine_op, cfg.coarsest_solve())
    lat_prev = lat0
    for i, lat_i in enumerate(cfg.coarse_lattices(lat0), start=1):
        stencil = mg.get_stencil(i - 1)
        vecs, ops = generate_null_vectors(
            stencil, cfg.coarse_dof // 2, rng,
            max_iter=cfg.nullvec_max_iter, tol=cfg.nullvec_tol,
            gaussians=None if seeds is None else seeds[i - 1],
            stype=cfg.nullvec_stype, solver=cfg.nullvec_solver)
        mg.add_tracker_count(DSLASH_NULLVEC, ops, i - 1)
        raw = chiral_double(stencil, vecs)
        transfer = TransferMG(lat_prev, lat_i, raw,
                              doubling=DoublingType.PROJECTION)
        mg.push_level(lat_i, transfer, cfg.level_solve(), build_stencil=True,
                      is_chiral=True,
                      build_stencil_from=(PRECOND_RIGHT_BLOCK_JACOBI
                                          if cfg.precond_coarsen_rbjacobi
                                          else PRECOND_ORIGINAL),
                      build_extra=cfg.build_extra)
        lat_prev = lat_i
    if cfg.coarsest_direct:
        mg.prepare_direct_coarsest()
    return mg
