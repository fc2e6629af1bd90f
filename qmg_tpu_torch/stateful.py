"""Stateful multigrid: per-level solve configs, operator counters, the
direct coarsest solve and the recursive K-cycle preconditioner (port of
qmg_tpu/stateful.py).

Each level solves with its ``fine_stencil_app``: ORIGINAL, RIGHT_JACOBI
or RIGHT_SCHUR. A RIGHT_SCHUR level's fields are even halves (Y, Xh, nc):
the K-cycle restricts [r, 0] and keeps the even half of the prolonged
correction. A level's smoothers are MinRes(relax 0.85) on its operator,
or with ``pre_cgne`` / ``post_cgne`` MinRes on M M^dag followed by M^dag.

The coarsest solves with its ``coarsest_stencil_app``: the dense inverse
(``prepare_direct_coarsest``), restarted GCR, or on a normal operator
(M M^dag, M^dag M and their rbjacobi forms) CG from the deflation initial
guess: the projection of the right-hand side onto the eigenpairs that
``deflate_coarsest`` keeps, optionally with ``normal_shift`` added to the
operator. ``restart_freq = -1`` selects the unrestarted solvers (GCR or
CG at the coarsest, flexible GCR on the intermediate levels).

``make_preconditioner(level)`` returns precond(rhs, carry) -> (lhs, carry).
The carry holds the per-level operator counters as host integers:
``counts`` (n_levels, 4) by {NULLVEC, KRYLOV, PRESMOOTH, POSTSMOOTH} and
Krylov iteration counts ``iters`` (n_levels,). The hierarchy's own
``tracker`` is such a carry, summed over its solves and setup, and read
through qmg_tpu's tracker API (``get_tracker_count``,
``query_average_iterations``, ``shift_all_to_nullvec``, ...).

``push_level``, ``pop_level`` and ``update_level`` change the hierarchy:
the trackers follow the levels (an updated level keeps its counts), and a
change of the coarsest level drops its dense inverse and its deflation
pairs, which belong to the old coarsest operator. Every change, and
``prepare_direct_coarsest`` and ``deflate_coarsest``, bumps ``version``;
a solver made by ``solve.make_solver`` refuses to run once it moved.
``solve`` is qmg_tpu's ``StatefulMultigridMG.solve`` over
``solve.make_solver`` with plain applies.

There is one K-cycle: ``make_preconditioner(level).lanes`` is
precond(rhs, carry, lanes) on a batch of fields with a leading rhs axis
(B, ...), each lane with its own carry (``zero_batched_carry``: counts (B,
n_levels, 4), iters (B, n_levels)) and only the active ``lanes`` counted,
or on one field without the axis (a carry of one lane); every level type,
coarsest solve and smoother takes both. The single-field precond(rhs,
carry) is its one-field case.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .lattice import Lattice2D
from .stencil import Stencil2D, StencilType
from .multigrid import MultigridMG
from . import solvers
from .linalg import norm2sq, norm2sq_lanes
from . import eig

DSLASH_NULLVEC = 0
DSLASH_KRYLOV = 1
DSLASH_PRESMOOTH = 2
DSLASH_POSTSMOOTH = 3


# The stencil types a non-coarsest level may solve with.
LEVEL_TYPES = (StencilType.ORIGINAL, StencilType.RIGHT_JACOBI,
               StencilType.RIGHT_SCHUR)
# The coarsest types solved by CG, and the only ones deflation takes.
_NORMAL_TYPES = (StencilType.M_MDAGGER, StencilType.MDAGGER_M,
                 StencilType.RBJ_M_MDAGGER, StencilType.RBJ_MDAGGER_M)


@dataclasses.dataclass
class LevelSolveMG:
    """Solve config for a non-coarsest level: its smoothers and the
    intermediate Krylov solve that reaches it from the level above apply
    ``fine_stencil_app``."""
    fine_stencil_app: StencilType = StencilType.ORIGINAL
    intermediate_tol: float = 1e-20
    intermediate_iters: int = 1000
    intermediate_restart_freq: int = 32
    pre_tol: float = 1e-20
    pre_iters: int = 2
    post_tol: float = 1e-20
    post_iters: int = 2
    pre_cgne: bool = False
    post_cgne: bool = False
    # Fixed-schedule mode: the intermediate Krylov solve runs exactly
    # intermediate_iters trips (its tolerance reported, not tested), so
    # no loop of the level waits on a read-back of a stopping test.
    fixed_trips: bool = False

    def __post_init__(self):
        if StencilType(self.fine_stencil_app) not in LEVEL_TYPES:
            raise ValueError(
                "LevelSolveMG.fine_stencil_app must be original, right "
                "jacobi, or schur")


@dataclasses.dataclass
class CoarsestSolveMG:
    """Coarsest-level solve config. The coarsest solves
    ``coarsest_stencil_app`` by GCR, or a normal one by CG: there, while
    ``deflate`` is set, from the projection onto the eigenpairs that
    ``deflate_coarsest`` kept, and with ``normal_shift`` times the identity
    added to the operator. ``direct`` switches to the dense inverse
    prepared by ``prepare_direct_coarsest``."""
    coarsest_stencil_app: StencilType = StencilType.ORIGINAL
    coarsest_tol: float = 1e-20
    coarsest_iters: int = 1000
    coarsest_restart_freq: int = 32
    deflate: bool = True
    normal_shift: float = 0.0
    direct: bool = False


def zero_carry(n_levels: int):
    return {"counts": np.zeros((n_levels, 4), dtype=np.int64),
            "iters": np.zeros((n_levels,), dtype=np.int64)}


def zero_batched_carry(nrhs: int, n_levels: int):
    """One carry per lane: counts (nrhs, n_levels, 4), iters (nrhs,
    n_levels)."""
    return {"counts": np.zeros((nrhs, n_levels, 4), dtype=np.int64),
            "iters": np.zeros((nrhs, n_levels), dtype=np.int64)}


def _live(lanes, laned: bool):
    """The lanes of a carry to count: one field's lane 0 (a scalar index),
    every lane (a slice), or the mask of the active ones."""
    if not laned:
        return 0
    return slice(None) if lanes.dev is None else lanes.host


class StatefulMultigridMG(MultigridMG):
    """MultigridMG + solve state and counters."""

    def __init__(self, lat: Lattice2D, stencil: Stencil2D,
                 coarsest_solve: CoarsestSolveMG):
        super().__init__(lat, stencil)
        self.coarsest_solve = coarsest_solve
        self.level_solve_list = []
        self.tracker = zero_carry(1)
        self.coarsest_dinv = None
        self.coarsest_evals = None    # (k,) deflation eigenvalues
        self.coarsest_evecs = None    # (k, *cv_shape), normalized
        self.version = 0

    # --- level management ---
    def _coarsest_changed(self):
        self.coarsest_dinv = None
        self.coarsest_evals = self.coarsest_evecs = None

    def push_level(self, new_lat, new_transfer, level_solve=None, **kw):
        super().push_level(new_lat, new_transfer, **kw)
        self.level_solve_list.append(level_solve)
        grown = zero_carry(self.get_num_levels())
        grown["counts"][:-1] = self.tracker["counts"]
        grown["iters"][:-1] = self.tracker["iters"]
        self.tracker = grown
        self._coarsest_changed()
        self.version += 1

    def pop_level(self):
        super().pop_level()
        self.level_solve_list.pop()
        self.tracker = {k: v[:-1].copy() for k, v in self.tracker.items()}
        self._coarsest_changed()
        self.version += 1

    def update_level(self, level, new_lat, new_transfer, level_solve=None,
                     **kw):
        """Replace coarse level ``level`` in place; its tracker counts
        stay."""
        super().update_level(level, new_lat, new_transfer, **kw)
        self.level_solve_list[level - 1] = level_solve
        if level == self.get_num_levels() - 1:
            self._coarsest_changed()
        self.version += 1

    def get_level_solve(self, i: int) -> LevelSolveMG:
        ls = self.level_solve_list[i]
        if ls is None:
            raise ValueError(f"level solve for level {i} does not exist")
        return ls

    def get_coarsest_solve(self) -> CoarsestSolveMG:
        return self.coarsest_solve

    # --- counters ---
    def add_tracker_count(self, dtype: int, accum: int, level: int):
        self.tracker["counts"][level, dtype] += int(accum)

    def add_iterations_count(self, accum: int, level: int):
        self.tracker["iters"][level] += int(accum)

    def shift_all_to_nullvec(self, level: int):
        """Fold the level's KRYLOV, PRESMOOTH and POSTSMOOTH counts into
        NULLVEC (the end of a setup) and clear its iterations."""
        counts = self.tracker["counts"][level]
        counts[DSLASH_NULLVEC] += counts[DSLASH_KRYLOV:].sum()
        counts[DSLASH_KRYLOV:] = 0
        self.tracker["iters"][level] = 0

    def get_tracker_count(self, dtype: int, level: int) -> int:
        return int(self.tracker["counts"][level, dtype])

    def get_total_count(self, level: int) -> int:
        return int(self.tracker["counts"][level].sum())

    def get_iterations_count(self, level: int) -> int:
        return int(self.tracker["iters"][level])

    def query_average_iterations(self):
        """Level 0's Krylov iterations, then for each coarser level its
        iterations per iteration of the level above (0 where that has
        none)."""
        iters = self.tracker["iters"]
        return [float(iters[0])] + [
            float(iters[i]) / float(iters[i - 1]) if iters[i - 1] else 0.0
            for i in range(1, self.get_num_levels())]

    def reset_tracker(self, level: int = -1):
        """Zero the counts of ``level``, or of every level (-1)."""
        rows = slice(None) if level == -1 else level
        self.tracker["counts"][rows] = 0
        self.tracker["iters"][rows] = 0

    def absorb_carry(self, carry):
        """Add a carry (or a batched one, summed over its lanes) to the
        trackers."""
        counts, iters = carry["counts"], carry["iters"]
        if counts.ndim == 3:
            counts, iters = counts.sum(axis=0), iters.sum(axis=0)
        self.tracker["counts"] += counts
        self.tracker["iters"] += iters

    def solve(self, b, tol: float = 1e-10, max_iter: int = 1000,
              restart_freq: int = 32,
              outer_type: StencilType = StencilType.ORIGINAL, x0=None,
              track: bool = True, verbose=False):
        """qmg_tpu's ``StatefulMultigridMG.solve``: outer flexible GCR on
        level 0's ``outer_type`` operator around the K-cycle, plain applies
        on every level, from ``x0``; ``b``, ``x0`` and the result's ``x``
        are the ``outer_type`` system's own vectors (the even half for
        RIGHT_SCHUR). With ``track`` the counts go to the trackers.
        ``verbose`` prints as qmg_tpu's does (``solve.make_solver``'s
        solve). A new ``solve.make_solver`` serves every call, so no solver
        outlives a change of the hierarchy or of its solve configs.
        Returns the ``solvers.SolveResult``."""
        from .solve import make_solver
        res, _ = make_solver(self, tol=tol, max_iter=max_iter,
                             restart_freq=restart_freq, fine_kernel=None,
                             outer_type=outer_type, prepared=True)(
            b, x0=x0, track=track, verbose=verbose)
        return res

    # --- coarsest deflation ---
    def deflate_coarsest(self, num_low: int, num_high: int):
        """Keep the ``num_low`` lowest and ``num_high`` highest eigenpairs
        (by real part) of the coarsest normal operator: densified on its
        device, its spectrum by LAPACK on the host in complex128, the
        vectors normalized and kept on the device."""
        cs = self.coarsest_solve
        if StencilType(cs.coarsest_stencil_app) not in _NORMAL_TYPES:
            raise ValueError("cannot deflate coarsest operator unless it's "
                             "a normal op solve")
        if num_low + num_high == 0:
            return
        st = self.get_stencil(self.get_num_levels() - 1)
        ref = st.coeffs.ref
        evals, evecs = eig.dense_eigensystem(
            st.get_apply_function(cs.coarsest_stencil_app),
            st.lat.cv_shape(), dtype=ref.dtype, device=ref.device)
        idx = np.argsort(np.real(evals))
        sel = list(idx[:num_low]) + list(idx[len(idx) - num_high:])
        vecs = evecs[sel]
        nrms = np.sqrt(np.sum(np.abs(vecs) ** 2,
                              axis=tuple(range(1, vecs.ndim)),
                              keepdims=True))
        self.coarsest_evals = torch.as_tensor(evals[sel]).to(
            device=ref.device, dtype=ref.dtype)
        self.coarsest_evecs = torch.as_tensor(vecs / nrms).to(
            device=ref.device, dtype=ref.dtype)
        self.version += 1

    # --- direct coarsest solve ---
    def prepare_direct_coarsest(self):
        """Materialize and invert the coarsest operator of the configured
        ``coarsest_stencil_app`` (host complex128), enabling a one-matvec
        coarsest solve."""
        st = self.get_stencil(self.get_num_levels() - 1)
        stype = StencilType(self.coarsest_solve.coarsest_stencil_app)
        ref = st.coeffs.ref
        # A RIGHT_SCHUR coarsest is densified on its even half: the
        # K-cycle applies the inverse to prepare_M's output.
        mat = eig.densify(st.get_apply_function(stype),
                          st.solve_size_shape(stype), dtype=ref.dtype,
                          device=ref.device)
        if not np.isfinite(mat).all():
            raise ValueError(
                "coarsest operator contains non-finite entries - the "
                "hierarchy setup produced a degenerate coarse level")
        # Volume-1 coarse lattices carry an identically zero parity-1
        # padding slot; give it an identity block so the inverse exists.
        dead = (np.abs(mat).sum(axis=1) == 0) & (np.abs(mat).sum(axis=0)
                                                 == 0)
        if dead.any():
            mat[dead, dead] = 1.0
        try:
            dinv = np.linalg.inv(mat)
        except np.linalg.LinAlgError:
            dinv = np.linalg.pinv(mat)
        self.coarsest_dinv = torch.as_tensor(dinv).to(device=ref.device,
                                                      dtype=ref.dtype)
        self.coarsest_solve.direct = True
        self.version += 1

    # ------------------------------------------------------------------
    # The K-cycle preconditioner.
    # ------------------------------------------------------------------

    def make_preconditioner(self, level: int = 0, reduce=None,
                            verbose=False):
        """precond(rhs, carry) -> (lhs, carry): one K-cycle at ``level`` on
        one field, ``carry`` from ``zero_carry``. It is the one-field case
        of ``precond.lanes``, the K-cycle itself: precond.lanes(rhs, carry,
        lanes) -> (lhs, carry) on a batch with a leading rhs axis (B, ...)
        or on one field (a field of the level's rank has no rhs axis),
        ``carry`` from ``zero_batched_carry`` and ``lanes``
        (``solvers.Lanes``) the lanes that the calling solve still
        iterates; only those are counted.

        One K-cycle: presmoothing, restrict, the coarse solve (direct
        inverse, GCR or on a normal operator deflated CG at the coarsest,
        flexible GCR around the next K-cycle above it), prolong,
        postsmoothing. Every step is the same on each lane: the smoothers
        and Krylov solves are ``solvers``' lane ones (a per-lane inner
        tolerance, converged lanes frozen), the direct coarsest is one
        product of the dense inverse with the B columns, and the deflation
        guess projects each lane's column.

        ``reduce`` sums inner products over the ranks that share this
        level's fields (``linalg.lane_reductions``). It reaches this
        level's smoothers only: the levels below are held whole by every
        rank (the transfer returns the whole coarse field), and their
        solves take no reduction.

        ``verbose`` (a bool, a prefix or a ``solvers.VerboseMG``) makes
        the coarse solve print as qmg_tpu's does, one lane only: at the
        caller's precond_verbosity, at least SUMMARY when the caller prints
        at all, after the prefix ``"  " * (level + 1) + "[QMG-MG-SOLVE-INFO]:
        Level {level + 1} "``; the next K-cycle gets the coarse solve's
        struct. The restarted CG coarsest prints nothing, as in qmg_tpu."""
        kcycle = self._kcycle(level, reduce, verbose)

        def precond(rhs, carry):
            lane = {name: counts[None] for name, counts in carry.items()}
            lhs, _ = kcycle(rhs, lane, solvers.all_lanes(lane["iters"]))
            return lhs, carry

        precond.lanes = kcycle
        return precond

    def _kcycle(self, level: int, reduce=None, verbose=False):
        """The K-cycle on a leading rhs axis (``make_preconditioner``)."""
        n_levels = self.get_num_levels()
        if n_levels == 1:
            return lambda rhs, carry, lanes: (rhs, carry)

        fine_stencil = self.get_stencil(level)
        coarse_stencil = self.get_stencil(level + 1)
        transfer = self.get_transfer(level)
        level_solve = self.get_level_solve(level)
        fine_type = StencilType(level_solve.fine_stencil_app)
        fine_schur = fine_type == StencilType.RIGHT_SCHUR
        apply_fine = fine_stencil.get_apply_function(fine_type)
        # A field of this level has ``rank`` dims; one more is a batch's
        # rhs axis.
        rank = len(fine_stencil.solve_size_shape(fine_type))

        coarsest = level == n_levels - 2
        coarse_fixed = False
        if not coarsest:
            nxt = self.get_level_solve(level + 1)
            coarse_type = StencilType(nxt.fine_stencil_app)
            coarse_max_iter = nxt.intermediate_iters
            coarse_tol = nxt.intermediate_tol
            coarse_restart = nxt.intermediate_restart_freq
            coarse_fixed = nxt.fixed_trips
        else:
            cs = self.coarsest_solve
            coarse_type = StencilType(cs.coarsest_stencil_app)
            coarse_max_iter = cs.coarsest_iters
            coarse_tol = cs.coarsest_tol
            coarse_restart = cs.coarsest_restart_freq
        apply_coarse = coarse_stencil.get_apply_function(coarse_type)
        coarsest_normal = coarsest and coarse_type in _NORMAL_TYPES
        # restart_freq = -1: unrestarted, the store holds every direction.
        coarse_store = (max(int(coarse_max_iter), 1) if coarse_restart == -1
                        else coarse_restart)
        # The coarse solve's print struct (reference verb2,
        # stateful_multigrid.h:761-776).
        v = solvers._as_verbose(verbose)
        vprefix = None
        if (v.verbosity, v.precond_verbosity) != (solvers.Verbosity.NONE,
                                                  solvers.Verbosity.NONE):
            lvl_v = max(v.precond_verbosity, solvers.Verbosity.SUMMARY)
            vprefix = solvers.VerboseMG(
                lvl_v, lvl_v if lvl_v >= solvers.Verbosity.DETAIL
                else solvers.Verbosity.SUMMARY,
                "  " * (level + 1)
                + f"[QMG-MG-SOLVE-INFO]: Level {level + 1} ")
        if not coarsest:
            inner_precond = self._kcycle(level + 1, verbose=vprefix)
        # The CGNE smoother: MinRes on M M^dag, then M^dag.
        cgne = {StencilType.ORIGINAL: (StencilType.M_MDAGGER,
                                       StencilType.DAGGER),
                StencilType.RIGHT_JACOBI: (StencilType.RBJ_M_MDAGGER,
                                           StencilType.RBJ_DAGGER)
                }.get(fine_type)

        def smoother(rhs, n_iters, s_tol, use_cgne, dslash_type, carry,
                     lanes, laned):
            kw = dict(max_iter=n_iters, tol=s_tol, omega=0.85, active=lanes,
                      reduce=reduce, laned=laned)
            if use_cgne and cgne is not None:
                res = solvers._minres(
                    fine_stencil.get_apply_function(cgne[0]), rhs, **kw)
                z = fine_stencil.apply_M(res.x, cgne[1])
                ops = 2 * res.ops_count + 1
            else:
                res = solvers._minres(apply_fine, rhs, **kw)
                z, ops = res.x, res.ops_count
            live = _live(lanes, laned)
            carry["counts"][live, level, dslash_type] += ops[live]
            return z, carry

        def deflation_guess(r_prep, nrhs):
            """Each lane's projection onto the kept eigenpairs, or None."""
            if not (coarsest_normal and self.coarsest_solve.deflate
                    and self.coarsest_evecs is not None):
                return None
            vecs = self.coarsest_evecs.reshape(
                self.coarsest_evecs.shape[0], -1)
            cols = r_prep.reshape(nrhs, -1)
            coef = (cols @ vecs.conj().T) / self.coarsest_evals
            return (coef @ vecs).reshape(r_prep.shape)

        def coarsest_solve(r_prep, inner_tol, lanes, laned, nrhs):
            """The iterative coarsest solve, from the deflation guess."""
            cs = self.coarsest_solve
            mv = apply_coarse
            if coarsest_normal and cs.normal_shift != 0.0:
                def mv(x):
                    return apply_coarse(x) + cs.normal_shift * x
            kw = dict(x0=deflation_guess(r_prep, nrhs),
                      max_iter=coarse_max_iter, tol=inner_tol, active=lanes,
                      laned=laned)
            if coarsest_normal:
                if coarse_restart == -1:
                    return solvers._cg(mv, r_prep, verbose=vprefix, **kw)
                return solvers._cg_restart(mv, r_prep,
                                           restart_freq=coarse_restart, **kw)
            res, _ = solvers._gcr(mv, r_prep, restart_len=coarse_store,
                                  verbose=vprefix, **kw)
            return res

        def precond(rhs, carry, lanes):
            laned = rhs.ndim > rank
            nb, nrhs = int(laned), rhs.shape[0] if laned else 1
            live = _live(lanes, laned)
            # --- presmooth ---
            if level_solve.pre_iters > 0:
                z1, carry = smoother(rhs, level_solve.pre_iters,
                                     level_solve.pre_tol,
                                     level_solve.pre_cgne, DSLASH_PRESMOOTH,
                                     carry, lanes, laned)
                r1 = rhs - apply_fine(z1)
                carry["counts"][live, level, DSLASH_PRESMOOTH] += 1
            else:
                z1 = rhs
                r1 = rhs

            # --- restrict + prepare, a tolerance per lane (a Schur
            # level's field is the even half: restrict [r1, 0]) ---
            full = (torch.stack([r1, torch.zeros_like(r1)], dim=nb)
                    if fine_schur else r1)
            r_coarse = transfer.restrict_f2c(full)
            norms = norm2sq_lanes if laned else norm2sq
            rnorm = torch.sqrt(norms(r_coarse))
            r_coarse_prep = coarse_stencil.prepare_M(r_coarse, coarse_type)
            rnorm_prep = torch.sqrt(norms(r_coarse_prep))
            inner_tol = coarse_tol * rnorm / rnorm_prep

            # --- coarse solve ---
            if (coarsest and self.coarsest_solve.direct
                    and self.coarsest_dinv is not None):
                dinv = self.coarsest_dinv.to(r_coarse_prep.dtype)
                e_coarse = ((r_coarse_prep.reshape(nrhs, -1) @ dinv.T)
                            if laned else dinv @ r_coarse_prep.reshape(-1)
                            ).reshape(r_coarse_prep.shape)
                sub_iters = sub_ops = np.ones(nrhs, dtype=np.int64)
            elif coarsest:
                res = coarsest_solve(r_coarse_prep, inner_tol, lanes, laned,
                                     nrhs)
                e_coarse = res.x
                sub_iters, sub_ops = res.iters, res.ops_count
            else:
                res, carry = solvers._gcr(
                    apply_coarse, r_coarse_prep, None, coarse_max_iter,
                    inner_tol, coarse_store, precond=inner_precond,
                    precond_carry=carry, active=lanes,
                    fixed_trips=coarse_fixed, verbose=vprefix, laned=laned)
                e_coarse = res.x
                sub_iters, sub_ops = res.iters, res.ops_count
            carry["counts"][live, level + 1, DSLASH_KRYLOV] += sub_ops[live]
            carry["iters"][live, level + 1] += sub_iters[live]

            # --- reconstruct + prolong (keep the even half on a Schur
            # level) ---
            e_rec = coarse_stencil.reconstruct_M(e_coarse, r_coarse,
                                                 coarse_type)
            z2 = transfer.prolong_c2f(e_rec)
            lhs = z1 + (z2.select(nb, 0) if fine_schur else z2)

            # --- postsmooth ---
            if level_solve.post_iters > 0:
                r2 = rhs - apply_fine(lhs)
                z3, carry = smoother(r2, level_solve.post_iters,
                                     level_solve.post_tol,
                                     level_solve.post_cgne,
                                     DSLASH_POSTSMOOTH, carry, lanes, laned)
                lhs = lhs + z3
                carry["counts"][live, level, DSLASH_POSTSMOOTH] += 1
            return lhs, carry

        return precond

    def prebuild_derived_stencils(self,
                                  outer_type=StencilType.ORIGINAL):
        """Build now every derived set (rbjacobi B^-1, fused Schur, ...)
        that a solve with outer operator ``outer_type`` and the configured
        level types will apply, so that no Krylov step builds one."""
        n_levels = self.get_num_levels()
        self.get_stencil(0).prebuild_derived(outer_type)
        for lvl in range(n_levels - 1):
            ls = self.get_level_solve(lvl)
            st = self.get_stencil(lvl)
            st.prebuild_derived(ls.fine_stencil_app)
            if ls.pre_cgne or ls.post_cgne:
                # The CGNE smoother's M M^dag.
                ft = StencilType(ls.fine_stencil_app)
                if ft == StencilType.ORIGINAL:
                    st.prebuild_derived(StencilType.M_MDAGGER)
                elif ft == StencilType.RIGHT_JACOBI:
                    st.prebuild_derived(StencilType.RBJ_M_MDAGGER)
        self.get_stencil(n_levels - 1).prebuild_derived(
            self.coarsest_solve.coarsest_stencil_app)

    def replicated_arrays(self) -> dict:
        """The arrays that every rank of a mesh holds whole, by their
        state-dict names: the coarse levels' coefficients and the derived
        sets built so far, the transfers between coarse levels, the dense
        inverse and the deflation pairs (``parallel.check_replicated``)."""
        out = {}
        for lvl in range(1, self.get_num_levels()):
            st = self.get_stencil(lvl)
            c = st.coeffs
            for name, arr in (("clover", c.clover), ("hopping", c.hopping)):
                if arr is not None:
                    out[f"{name}{lvl}"] = arr
            if st.built_rbjacobi:
                out[f"rbjcinv{lvl}"] = st.rbjacobi.cinv
                if st.rbjacobi.coeffs.hopping is not None:
                    out[f"rbjh{lvl}"] = st.rbjacobi.coeffs.hopping
            if st.built_rbj_schur_fused:
                out[f"schurf{lvl}"] = st._rbj_schur_fused.mats
            if lvl < self.get_num_levels() - 1:
                out[f"nvb{lvl}"] = self.get_transfer(lvl)._nvb
        for name in ("coarsest_dinv", "coarsest_evals", "coarsest_evecs"):
            if getattr(self, name) is not None:
                out[name] = getattr(self, name)
        return out

    def level_types(self):
        """The stencil type each level solves with, finest first."""
        return ([StencilType(self.get_level_solve(lvl).fine_stencil_app)
                 for lvl in range(self.get_num_levels() - 1)]
                + [StencilType(self.coarsest_solve.coarsest_stencil_app)])
