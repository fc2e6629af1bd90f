"""Krylov solvers as Python loops on device tensors (port of
qmg_tpu/solvers.py: CG and its restarted form, GCR unrestarted and
restarted, flexible GCR unrestarted and restarted, BiCGstab, BiCGstab(l),
MinRes, Richardson and TFQMR).

Conventions, as in qmg_tpu:

  * matvec is a callable x -> A x on tensors of a fixed shape;
  * convergence is ||r|| < tol ||b||; ``tol`` may be a float or a 0-dim
    tensor (the K-cycle's rescaled inner tolerance);
  * results carry the iteration count, the final ||r||^2, a convergence
    flag and ops_count, the number of operator applications;
  * flexible solvers take precond(r, carry) -> (z, carry);
  * ``reduce`` (GCR and MinRes) is for fields that are one rank's block of
    a lattice cut over ranks: it sums partial inner products over the
    ranks (``linalg.reductions``). Every stopping test and breakdown guard
    then branches on a summed value, so all ranks leave a loop at the same
    iteration.

Scalars (inner products, step lengths) stay 0-dim device tensors; a loop
reads one back to the host only for its stopping test. The breakdown
guards are those of qmg_tpu, so both packages follow the same
trajectories. ``fixed_trips`` (GCR) runs exactly ``max_iter`` trips with
no stopping test and no read-back; ``converged`` still reports the
tolerance test.

``verbose`` (CG and the GCR family) prints as qmg_tpu's solvers do: a
``Verbosity`` level for the solve and one for its preconditioner's solves
(``VerboseMG``), DETAIL a line an iteration (``iter {k} relres {r}``),
SUMMARY one at the end (``{name} summary: {k} iters, relres {r}``), each
after the struct's prefix. A verbose solve reads its squared residual
back as a value where a silent one reads back the stopping test's flag,
and tests it on the host, so its prints cost no read-back an iteration
and its iterates are the silent solve's; it reads ||b||^2 and the target
once. Only a fixed-trip GCR, which reads nothing back, reads each
residual it prints.

The batched solvers (``*_batched``) take fields with a leading rhs axis
(B, 2, Y, Xh, nc) and give each lane k the trajectory of the same solver
on field k alone, as qmg_tpu's vmap over its while loops does: a lane that
has converged is frozen exactly (``torch.where`` on its solution,
residual and norm), each lane keeps its own iteration and operator count,
and the loop runs while any lane is active. One read-back per iteration
brings the lanes' stopping tests to the host together (``Lanes``); the
per-lane reductions (``linalg.vdot_lanes``) never mix lanes. Active lanes
started together and never restart, so they share one restart counter. A
batched preconditioner takes ``precond(r, carry, lanes)`` and counts only
the lanes that are active.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import NamedTuple

import numpy as np
import torch

from .linalg import vdot, norm2sq, vdot_lanes, norm2sq_lanes, reductions

__all__ = ["SolveResult", "Verbosity", "VerboseMG", "cg", "cg_restart", "gcr",
           "gcr_restart", "gcr_var_precond", "gcr_var_precond_restart",
           "bicgstab", "bicgstab_l", "minres", "richardson", "tfqmr", "Lanes",
           "BatchedSolveResult", "all_lanes", "gcr_restart_batched",
           "gcr_var_precond_restart_batched", "minres_batched",
           "GCR_STORE_LIMIT_BYTES"]

# The largest GCR direction store (2 x R x n values) a solve allocates,
# qmg_tpu's limit: unrestarted GCR (restart_freq = -1) keeps max_iter
# directions, which at the default cap of 1000 on a large lattice would be
# tens of GiB; the guard refuses it before any allocation.
GCR_STORE_LIMIT_BYTES = 8 * 1024 ** 3


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    res_sq: torch.Tensor      # real 0-dim
    converged: torch.Tensor   # bool 0-dim
    ops_count: int            # operator applications


class Verbosity(enum.IntEnum):
    """Print levels (quantum-linalg's inversion_verbose_struct): NONE
    prints nothing, SUMMARY one line per completed solve, DETAIL also a
    line per iteration."""
    NONE = 0
    SUMMARY = 1
    DETAIL = 2


@dataclasses.dataclass
class VerboseMG:
    """A solve's own print level, an independent one for its
    preconditioner's solves, and the line prefix (the K-cycle indents two
    spaces a level and tags '[QMG-MG-SOLVE-INFO]: Level N ')."""
    verbosity: Verbosity = Verbosity.NONE
    precond_verbosity: Verbosity = Verbosity.NONE
    prefix: str = ""


def _as_verbose(verbose) -> VerboseMG:
    """None / False -> NONE; True -> DETAIL for the solve and its
    preconditioner; a string -> DETAIL with that prefix; a VerboseMG
    passes through."""
    if isinstance(verbose, VerboseMG):
        return verbose
    if verbose is None or verbose is False:
        return VerboseMG()
    if verbose is True:
        return VerboseMG(Verbosity.DETAIL, Verbosity.DETAIL)
    return VerboseMG(Verbosity.DETAIL, Verbosity.NONE, str(verbose))


def _verbose_print(verbose, k: int, rsq: float, bsq: float):
    """The DETAIL line of iteration ``k`` (host floats)."""
    v = _as_verbose(verbose)
    if v.verbosity >= Verbosity.DETAIL:
        print(f"{v.prefix}iter {k} relres {math.sqrt(rsq / bsq):.6e}")


def _verbose_summary(verbose, name: str, iters: int, rsq: float,
                     bsq: float):
    """The SUMMARY line of a completed solve (host floats)."""
    v = _as_verbose(verbose)
    if v.verbosity >= Verbosity.SUMMARY:
        print(f"{v.prefix}{name} summary: {iters} iters, relres "
              f"{math.sqrt(rsq / bsq):.6e}")


def _target(tol, bsq):
    return tol ** 2 * bsq


def _keep_going(rsq, target) -> bool:
    """isfinite(rsq) and rsq > target, read back to the host."""
    return bool(torch.isfinite(rsq) & (rsq > target))


class _Monitor:
    """A loop's stopping test and its prints. Silent, the test is
    ``_keep_going``. Verbose, it reads the squared residual back as a
    value (once per tensor), tests it on the host against the target read
    once, and the prints reuse that value."""

    def __init__(self, verbose, bsq, target):
        self.verbose = _as_verbose(verbose)
        self.on = self.verbose.verbosity > Verbosity.NONE
        self.target = target
        if self.on:
            self.bsq, self.target = float(bsq), float(target)
        self._last = self._host = None

    def _read(self, rsq) -> float:
        if rsq is not self._last:
            self._last, self._host = rsq, float(rsq)
        return self._host

    def keep_going(self, rsq) -> bool:
        if not self.on:
            return _keep_going(rsq, self.target)
        r = self._read(rsq)
        return math.isfinite(r) and r > self.target

    def iteration(self, k: int, rsq):
        if self.verbose.verbosity >= Verbosity.DETAIL:
            _verbose_print(self.verbose, k, self._read(rsq), self.bsq)

    def summary(self, name: str, k: int, rsq):
        if self.on:
            _verbose_summary(self.verbose, name, k, self._read(rsq),
                             self.bsq)


# ---------------------------------------------------------------------------
# Conjugate gradient (Hermitian positive definite operators: the normal
# operators of the deflated coarsest).
# ---------------------------------------------------------------------------

def cg(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
       verbose=None) -> SolveResult:
    x = torch.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = _target(tol, bsq)
    mon = _Monitor(verbose, bsq, target)
    r = b - matvec(x)
    p = r
    rsq = norm2sq(r)
    k = 0
    while k < max_iter and mon.keep_going(rsq):
        ap = matvec(p)
        # Breakdown guard: a stalled solve's <p, Ap> can underflow to 0;
        # the iteration then becomes a no-op.
        den = vdot(p, ap).real
        pos = den > 0
        alpha = torch.where(pos, rsq / torch.where(pos, den, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rsq_new = norm2sq(r)
        p = r + (rsq_new / rsq) * p
        rsq = rsq_new
        k += 1
        mon.iteration(k, rsq)
    mon.summary("cg", k, rsq)
    return SolveResult(x, k, rsq, rsq <= target, k + 1)


def cg_restart(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
               restart_freq: int = 32, verbose=None) -> SolveResult:
    """CG restarted every ``restart_freq`` iterations from the true
    residual. ``verbose`` goes to each restart cycle's ``cg`` (qmg_tpu's
    cg_restart takes none)."""
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(tol, norm2sq(b))
    rsq = norm2sq(b - matvec(x))
    k, ops = 0, 1
    while k < max_iter and bool(rsq > target):
        res = cg(matvec, b, x0=x, max_iter=restart_freq, tol=tol,
                 verbose=verbose)
        x, rsq = res.x, res.res_sq
        k += res.iters
        ops += res.ops_count
    return SolveResult(x, k, rsq, rsq <= target, ops)


# ---------------------------------------------------------------------------
# GCR, plain and flexible (variable preconditioner), unrestarted and
# restarted: one implementation.
# ---------------------------------------------------------------------------

def _store_rows(restart_len: int, max_iter: int) -> int:
    """Rows of a GCR direction store: a solve stores at most one direction
    an iteration, and with ``max_iter <= restart_len`` it never restarts,
    so it never needs more than ``max_iter`` (qmg_tpu allocates
    ``restart_len``: the adaptive setup's 8-iteration level solves with a
    restart length of 1024)."""
    return max(min(int(restart_len), int(max_iter)), 1)


def _check_store(R: int, b: torch.Tensor):
    """Refuse a direction store of ``R`` copies of ``b`` (two stores)
    above ``GCR_STORE_LIMIT_BYTES``."""
    n = b.numel()
    store_bytes = 2 * R * n * b.element_size()
    if store_bytes > GCR_STORE_LIMIT_BYTES:
        raise ValueError(
            f"GCR direction store (2 x {R} x {n} {b.dtype} = "
            f"{store_bytes / 2**30:.1f} GiB) exceeds the "
            f"{GCR_STORE_LIMIT_BYTES / 2**30:.1f} GiB limit - use the "
            "restarted variant (restart_freq > 0) at this problem size, or "
            "raise solvers.GCR_STORE_LIMIT_BYTES")


def _gcr_impl(matvec, b, x0, max_iter: int, tol, restart_len: int,
              precond=None, precond_carry=None, reduce=None,
              fixed_trips: bool = False, verbose=None):
    vdot, norm2sq, total = reductions(reduce)
    shape = b.shape
    n = b.numel()
    R = _store_rows(restart_len, max_iter)
    _check_store(R, b)
    x = torch.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = _target(tol, bsq)
    mon = _Monitor(verbose, bsq, target)
    rdt = bsq.dtype
    tiny = torch.finfo(rdt).tiny
    if precond is None:
        def precond(r, carry):
            return r, carry

    r = b - matvec(x)
    ops = 1
    ps = torch.zeros((R, n), dtype=b.dtype, device=b.device)
    aps = torch.zeros_like(ps)
    apsq = torch.ones((R,), dtype=rdt, device=b.device)
    rsq = norm2sq(r)
    j = k = 0
    carry = precond_carry
    while k < max_iter and (fixed_trips or mon.keep_going(rsq)):
        if j >= R:
            # Restart: recompute the true residual, clear the store.
            r = b - matvec(x)
            ops += 1
            ps.zero_()
            aps.zero_()
            apsq.fill_(1.0)
            j = 0
        z, carry = precond(r, carry)
        ap = matvec(z).reshape(n)
        z = z.reshape(n)
        ops += 1
        if j > 0:
            # Orthogonalize (z, Az) against the stored directions.
            betas = total(aps[:j].conj() @ ap) / apsq[:j]
            ap = ap - betas @ aps[:j]
            z = z - betas @ ps[:j]
        apsq_new = norm2sq(ap)
        # Breakdown guard: a stalled solve's orthogonalized direction can
        # underflow to 0; the iteration then becomes a no-op.
        broke = ~(apsq_new > tiny)
        alpha = torch.where(broke, 0.0,
                            vdot(ap, r) / torch.where(broke, 1.0, apsq_new))
        x = x + alpha * z.reshape(shape)
        r = r - alpha * ap.reshape(shape)
        rsq = norm2sq(r)
        ps[j] = z
        aps[j] = ap
        apsq[j] = torch.where(broke, 1.0, apsq_new)
        j += 1
        k += 1
        mon.iteration(k, rsq)
    mon.summary("gcr", k, rsq)
    return SolveResult(x, k, rsq, rsq <= target, ops), carry


def gcr(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
        verbose=None) -> SolveResult:
    """Unrestarted GCR: keeps up to ``max_iter`` directions."""
    res, _ = _gcr_impl(matvec, b, x0, max_iter, tol,
                       restart_len=max(int(max_iter), 1), verbose=verbose)
    return res


def gcr_restart(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
                restart_freq: int = 32, reduce=None,
                verbose=None) -> SolveResult:
    res, _ = _gcr_impl(matvec, b, x0, max_iter, tol,
                       restart_len=int(restart_freq), reduce=reduce,
                       verbose=verbose)
    return res


def gcr_var_precond(matvec, b, precond, x0=None, max_iter: int = 1000,
                    tol=1e-8, precond_carry=None, fixed_trips: bool = False,
                    verbose=None):
    """Unrestarted flexible GCR (``restart_freq = -1`` in a K-cycle)."""
    return _gcr_impl(matvec, b, x0, max_iter, tol,
                     restart_len=max(int(max_iter), 1), precond=precond,
                     precond_carry=precond_carry, fixed_trips=fixed_trips,
                     verbose=verbose)


def gcr_var_precond_restart(matvec, b, precond, x0=None,
                            max_iter: int = 1000, tol=1e-8,
                            restart_freq: int = 32, precond_carry=None,
                            reduce=None, fixed_trips: bool = False,
                            verbose=None):
    """Restarted flexible GCR: the outer solver of the K-cycle stack."""
    return _gcr_impl(matvec, b, x0, max_iter, tol,
                     restart_len=int(restart_freq), precond=precond,
                     precond_carry=precond_carry, reduce=reduce,
                     fixed_trips=fixed_trips, verbose=verbose)


# ---------------------------------------------------------------------------
# Batched (multi-RHS) GCR and MinRes: a leading rhs axis, per-lane
# trajectories.
# ---------------------------------------------------------------------------

class Lanes(NamedTuple):
    """Which lanes of a batch are active: a (B,) bool tensor on the
    fields' device and the same mask on the host (NumPy)."""
    dev: torch.Tensor
    host: np.ndarray


class BatchedSolveResult(NamedTuple):
    x: torch.Tensor           # (B, ...)
    iters: np.ndarray         # (B,) int64, per lane
    res_sq: torch.Tensor      # (B,) real
    converged: torch.Tensor   # (B,) bool
    ops_count: np.ndarray     # (B,) int64, operator applications per lane


def all_lanes(b) -> Lanes:
    """Every lane of the batch ``b`` active."""
    n = b.shape[0]
    return Lanes(torch.ones(n, dtype=torch.bool, device=b.device),
                 np.ones(n, dtype=bool))


def _lanes(keep) -> Lanes:
    """A device mask and its one read-back."""
    return Lanes(keep, keep.cpu().numpy())


def _per_lane(mask, like):
    """A (B,) tensor shaped to broadcast over the fields ``like``."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def _masked(lanes, masked: bool, new, old):
    """``new`` on the active lanes and ``old`` on the others; ``new``
    alone where nothing is masked or every lane is active."""
    if not masked or lanes.host.all():
        return new
    return torch.where(_per_lane(lanes.dev, new), new, old)


def _gcr_batched(matvec, b, max_iter: int, tol, restart_len: int,
                 precond=None, precond_carry=None, active: Lanes = None,
                 fixed_trips: bool = False, trace=None):
    """``_gcr_impl`` on a leading rhs axis. ``tol`` is a float or a (B,)
    tensor (the K-cycle's per-lane inner tolerance); ``active`` the lanes
    that take part (the caller's active lanes; all by default): the
    others are frozen from the start. With ``fixed_trips`` every lane
    runs ``max_iter`` trips unmasked, as the trip-counted loop does under
    qmg_tpu's vmap. ``trace(k, iters, rsq, true_rsq, bsq)``, when given,
    is called at every restart and once at the end with the per-lane
    iteration counts and squared recursive residuals; ``true_rsq`` is
    the squared true residual at a restart, None at the end."""
    nrhs = b.shape[0]
    n = b[0].numel()
    R = _store_rows(restart_len, max_iter)
    _check_store(R, b)
    active = all_lanes(b) if active is None else active
    x = torch.zeros_like(b)
    bsq = norm2sq_lanes(b)
    target = _target(tol, bsq)
    rdt = bsq.dtype
    tiny = torch.finfo(rdt).tiny
    if precond is None:
        def precond(r, carry, lanes):
            return r, carry

    r = b - matvec(x)
    ops = np.ones(nrhs, dtype=np.int64)
    iters = np.zeros(nrhs, dtype=np.int64)
    ps = torch.zeros((nrhs, R, n), dtype=b.dtype, device=b.device)
    aps = torch.zeros_like(ps)
    apsq = torch.ones((nrhs, R), dtype=rdt, device=b.device)
    rsq = norm2sq_lanes(r)
    if fixed_trips:
        lanes = active
    else:
        lanes = _lanes(active.dev & torch.isfinite(rsq) & (rsq > target))
    j = k = 0
    carry = precond_carry
    while k < max_iter and (fixed_trips or lanes.host.any()):
        if j >= R:
            # Restart: the true residual, a cleared store. Active lanes
            # started together, so they restart together.
            r = _masked(lanes, not fixed_trips, b - matvec(x), r)
            ops += lanes.host
            if trace is not None:
                trace(k, iters.copy(), rsq, norm2sq_lanes(r), bsq)
            ps.zero_()
            aps.zero_()
            apsq.fill_(1.0)
            j = 0
        z, carry = precond(r, carry, lanes)
        ap = matvec(z).reshape(nrhs, n)
        z = z.reshape(nrhs, n)
        if j > 0:
            # Orthogonalize each lane's (z, Az) against its stored
            # directions: (B, j) coefficients from batched products.
            betas = (aps[:, :j].conj() @ ap.unsqueeze(-1)).squeeze(-1) \
                / apsq[:, :j]
            ap = ap - (betas.unsqueeze(1) @ aps[:, :j]).squeeze(1)
            z = z - (betas.unsqueeze(1) @ ps[:, :j]).squeeze(1)
        apsq_new = norm2sq_lanes(ap)
        broke = ~(apsq_new > tiny)
        alpha = torch.where(
            broke, 0.0,
            vdot_lanes(ap, r) / torch.where(broke, 1.0, apsq_new))
        step = _per_lane(alpha, z)
        x = _masked(lanes, not fixed_trips,
                    x + (step * z).reshape(b.shape), x)
        r = _masked(lanes, not fixed_trips,
                    r - (step * ap).reshape(b.shape), r)
        rsq = _masked(lanes, not fixed_trips, norm2sq_lanes(r), rsq)
        ps[:, j] = z
        aps[:, j] = ap
        apsq[:, j] = torch.where(broke, 1.0, apsq_new)
        j += 1
        k += 1
        ops += lanes.host
        iters += lanes.host
        if not fixed_trips:
            lanes = _lanes(lanes.dev & torch.isfinite(rsq) & (rsq > target))
    if trace is not None:
        trace(k, iters.copy(), rsq, None, bsq)
    return BatchedSolveResult(x, iters, rsq, rsq <= target, ops), carry


def gcr_restart_batched(matvec, b, max_iter: int = 1000, tol=1e-8,
                        restart_freq: int = 32, active: Lanes = None
                        ) -> BatchedSolveResult:
    """Restarted GCR on a leading rhs axis (the iterative coarsest)."""
    res, _ = _gcr_batched(matvec, b, max_iter, tol, int(restart_freq),
                          active=active)
    return res


def gcr_var_precond_restart_batched(matvec, b, precond, max_iter: int = 1000,
                                    tol=1e-8, restart_freq: int = 32,
                                    precond_carry=None, active: Lanes = None,
                                    fixed_trips: bool = False, trace=None):
    """Restarted flexible GCR on a leading rhs axis: the outer and inner
    solver of the batched K-cycle. ``precond(r, carry, lanes)``; ``trace``
    as ``_gcr_batched`` takes it."""
    return _gcr_batched(matvec, b, max_iter, tol, int(restart_freq),
                        precond=precond, precond_carry=precond_carry,
                        active=active, fixed_trips=fixed_trips, trace=trace)


# ---------------------------------------------------------------------------
# BiCGstab, and BiCGstab(l) after Sleijpen-Fokkema (null-vector
# generation).
# ---------------------------------------------------------------------------

def bicgstab(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8
             ) -> SolveResult:
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(tol, norm2sq(b))
    r = b - matvec(x)
    rtilde = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    rsq = norm2sq(r)
    k, ops = 0, 1
    while k < max_iter and _keep_going(rsq, target):
        rho_new = vdot(rtilde, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = matvec(p)
        alpha = rho_new / vdot(rtilde, v)
        s = r - alpha * v
        t = matvec(s)
        omega = vdot(t, s) / norm2sq(t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        rsq = norm2sq(r)
        k += 1
        ops += 2
    return SolveResult(x, k, rsq, rsq <= target, ops)


def bicgstab_l(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
               l: int = 6) -> SolveResult:
    """``max_iter`` counts l-cycles x l; each l-cycle costs 2l matvecs."""
    x = torch.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = _target(tol, bsq)
    r0 = b - matvec(x)
    rtilde = r0
    max_cycles = max(int(max_iter) // max(l, 1), 1)
    rs = torch.zeros((l + 1,) + b.shape, dtype=b.dtype, device=b.device)
    rs[0] = r0
    us = torch.zeros_like(rs)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho0, alpha, omega = one, torch.zeros_like(one), one
    rsq = norm2sq(r0)
    k, ops = 0, 1
    while k < max_cycles and _keep_going(rsq, target):
        rho0 = -omega * rho0
        # --- BiCG part ---
        for j in range(l):
            rho1 = vdot(rtilde, rs[j])
            beta = alpha * rho1 / rho0
            rho0 = rho1
            us[:j + 1] = rs[:j + 1] - beta * us[:j + 1]
            us[j + 1] = matvec(us[j])
            alpha = rho0 / vdot(rtilde, us[j + 1])
            rs[:j + 1] = rs[:j + 1] - alpha * us[1:j + 2]
            rs[j + 1] = matvec(rs[j])
            x = x + alpha * us[0]
        ops += 2 * l
        # --- MR part: modified Gram-Schmidt on r_1..r_l ---
        tau = [[None] * (l + 1) for _ in range(l + 1)]
        sigma = [None] * (l + 1)
        gamma_p = [None] * (l + 1)
        for j in range(1, l + 1):
            for i in range(1, j):
                t_ij = vdot(rs[i], rs[j]) / sigma[i]
                tau[i][j] = t_ij
                rs[j] = rs[j] - t_ij * rs[i]
            sigma[j] = norm2sq(rs[j])
            gamma_p[j] = vdot(rs[j], rs[0]) / sigma[j]
        gamma = [None] * (l + 1)
        gamma[l] = gamma_p[l]
        for j in range(l - 1, 0, -1):
            acc = gamma_p[j]
            for i in range(j + 1, l + 1):
                acc = acc - tau[j][i] * gamma[i]
            gamma[j] = acc
        gamma_pp = [None] * (l + 1)
        for j in range(1, l):
            acc = gamma[j + 1]
            for i in range(j + 1, l):
                acc = acc + tau[j][i] * gamma[i + 1]
            gamma_pp[j] = acc
        x = x + gamma[1] * rs[0]
        rs[0] = rs[0] - gamma_p[l] * rs[l]
        us[0] = us[0] - gamma[l] * us[l]
        for j in range(1, l):
            us[0] = us[0] - gamma[j] * us[j]
            x = x + gamma_pp[j] * rs[j]
            rs[0] = rs[0] - gamma_p[j] * rs[j]
        omega = gamma[l]
        rsq = norm2sq(rs[0])
        k += 1
    return SolveResult(x, k * l, rsq, rsq <= target, ops)


# ---------------------------------------------------------------------------
# MinRes with relaxation (the K-cycle smoother).
# ---------------------------------------------------------------------------

def _fixed_minres(max_iter: int, tol) -> bool:
    """The K-cycle's MinRes(2) with a never-met tolerance runs a fixed
    number of steps without reading the residual back."""
    return (max_iter <= 4 and not isinstance(tol, torch.Tensor)
            and tol <= 1e-14)


def minres(matvec, b, x0=None, max_iter: int = 2, tol=1e-15,
           omega: float = 1.0, reduce=None) -> SolveResult:
    vdot, norm2sq, _ = reductions(reduce)
    x = torch.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = _target(tol, bsq)
    r = b - matvec(x)
    rsq = norm2sq(r)
    k, ops = 0, 1
    fixed = _fixed_minres(max_iter, tol)
    while k < max_iter and (fixed or bool(rsq > target)):
        ar = matvec(r)
        arsq = norm2sq(ar)
        pos = arsq > 0
        alpha = torch.where(pos, vdot(ar, r) / torch.where(pos, arsq, 1.0),
                            0.0)
        x = x + omega * alpha * r
        r = r - omega * alpha * ar
        rsq = norm2sq(r)
        k += 1
        ops += 1
    return SolveResult(x, k, rsq, rsq <= target, ops)


def richardson(matvec, b, x0=None, max_iter: int = 10, tol=1e-10,
               omega: float = 0.33, blocksize: int = 250) -> SolveResult:
    """Relaxed Richardson x += omega (b - A x), the true residual
    recomputed every ``blocksize`` iterations."""
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(tol, norm2sq(b))
    r = b - matvec(x)
    rsq = norm2sq(r)
    k = 0
    while k < max_iter and bool(rsq > target):
        x = x + omega * r
        if (k + 1) % blocksize == 0:
            r = b - matvec(x)
        else:
            r = r - omega * matvec(r)
        rsq = norm2sq(r)
        k += 1
    return SolveResult(x, k, rsq, rsq <= target, k + 1)


def tfqmr(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8
          ) -> SolveResult:
    """TFQMR (Freund; Saad, Algorithm 7.4), two operator applications an
    iteration. Stops on the quasi-residual tau, which bounds ||r|| up to
    sqrt(2k + 1); ``res_sq`` is tau^2."""
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(tol, norm2sq(b))
    r0 = b - matvec(x)
    rtilde = w = u = r0
    au = matvec(u)
    v = au
    d = torch.zeros_like(b)
    tau = torch.sqrt(norm2sq(r0))
    theta = torch.zeros_like(tau)
    eta = torch.zeros((), dtype=b.dtype, device=b.device)
    rho = vdot(rtilde, r0)

    def half_step(x, w, u, au, d, tau, theta, eta, alpha):
        w = w - alpha * au
        d = u + (theta * theta * eta / alpha) * d
        theta = torch.sqrt(norm2sq(w)) / tau
        c = 1.0 / torch.sqrt(1.0 + theta * theta)
        tau = tau * theta * c
        eta = c * c * alpha
        return x + eta * d, w, d, tau, theta, eta

    k, ops = 0, 2
    while k < max_iter and bool(tau * tau > target):
        alpha = rho / vdot(rtilde, v)
        u2 = u - alpha * v
        x, w, d, tau, theta, eta = half_step(x, w, u, au, d, tau, theta,
                                             eta, alpha)
        au2 = matvec(u2)
        x, w, d, tau, theta, eta = half_step(x, w, u2, au2, d, tau, theta,
                                             eta, alpha)
        rho_new = vdot(rtilde, w)
        beta = rho_new / rho
        u = w + beta * u2
        au = matvec(u)
        v = au + beta * (au2 + beta * v)
        rho = rho_new
        k += 1
        ops += 2
    return SolveResult(x, k, tau * tau, tau * tau <= target, ops)


def minres_batched(matvec, b, max_iter: int = 2, tol=1e-15,
                   omega: float = 1.0, active: Lanes = None
                   ) -> BatchedSolveResult:
    """``minres`` on a leading rhs axis. The fixed smoother (max_iter <= 4
    and a never-met float tolerance) runs its steps on every lane
    unmasked, as the sequential one runs them without a test (the caller
    drops what inactive lanes compute); otherwise converged lanes freeze
    as in ``_gcr_batched``."""
    nrhs = b.shape[0]
    active = all_lanes(b) if active is None else active
    x = torch.zeros_like(b)
    target = _target(tol, norm2sq_lanes(b))
    r = b - matvec(x)
    rsq = norm2sq_lanes(r)
    ops = np.ones(nrhs, dtype=np.int64)
    iters = np.zeros(nrhs, dtype=np.int64)
    fixed = _fixed_minres(max_iter, tol)
    lanes = active if fixed else _lanes(active.dev & (rsq > target))
    k = 0
    while k < max_iter and (fixed or lanes.host.any()):
        ar = matvec(r)
        arsq = norm2sq_lanes(ar)
        pos = arsq > 0
        alpha = torch.where(pos, vdot_lanes(ar, r)
                            / torch.where(pos, arsq, 1.0), 0.0)
        step = _per_lane(omega * alpha, r)
        x = _masked(lanes, not fixed, x + step * r, x)
        r = _masked(lanes, not fixed, r - step * ar, r)
        rsq = _masked(lanes, not fixed, norm2sq_lanes(r), rsq)
        k += 1
        ops += lanes.host
        iters += lanes.host
        if not fixed:
            lanes = _lanes(lanes.dev & (rsq > target))
    return BatchedSolveResult(x, iters, rsq, rsq <= target, ops)
