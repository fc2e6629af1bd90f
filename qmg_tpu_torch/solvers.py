"""Krylov solvers as Python loops on device tensors (port of
qmg_tpu/solvers.py: CG and its restarted form, GCR unrestarted and
restarted, flexible GCR unrestarted and restarted, BiCGstab, BiCGstab(l),
MinRes, Richardson and TFQMR).

Conventions, as in qmg_tpu:

  * matvec is a callable x -> A x on tensors of a fixed shape;
  * convergence is ||r|| < tol ||b||; ``tol`` may be a float, a 0-dim
    tensor or a per-lane (B,) one (the K-cycle's rescaled inner
    tolerance);
  * results carry the iteration count, the final ||r||^2, a convergence
    flag and ops_count, the number of operator applications;
  * flexible solvers take precond(r, carry) -> (z, carry);
  * ``reduce`` (GCR, MinRes and BiCGstab(l)) is for fields that are one
    rank's block of a lattice cut over ranks: it sums partial inner
    products over the ranks (``linalg.lane_reductions``). Every stopping
    test and breakdown guard then branches on a summed value, so all ranks
    leave a loop at the same iteration.

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

Every read of a device value by the host goes through one helper,
``_host``: it counts the read in ``READBACKS`` under the solver's name
(``gcr``, ``minres``, ``cg``, ...) and, under a profiler, opens the span
``qmg.readback`` (``spans``) over the host's wait for the device.

Every solve on the K-cycle's path (CG, GCR in all its forms, MinRes) has
one body, run on a batch with a leading rhs axis (B, ...) or on one field
without it. On a batch each lane k follows the trajectory of the same
solver on field k alone, as qmg_tpu's vmap over its while loops does: a
converged lane is frozen exactly (``torch.where``), each lane keeps its
own counts, the loop runs while any lane is active, and one read-back an
iteration brings the lanes' stopping tests to the host (``Lanes``). Active
lanes started together, so they restart together. A flexible solve takes
``precond(r, carry, lanes)``. The single-field API (``cg``,
``gcr_var_precond_restart``, ...) is the one-field case: the field's own
shapes and 0-dim scalars, no mask, integer counts. The ``*_batched`` names
take the rhs axis; ``verbose`` prints one lane only.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import math
from typing import NamedTuple

import numpy as np
import torch

from .linalg import vdot, norm2sq, reductions, lane_reductions
from .spans import span

__all__ = ["SolveResult", "Verbosity", "VerboseMG", "cg", "cg_restart", "gcr",
           "gcr_restart", "gcr_var_precond", "gcr_var_precond_restart",
           "bicgstab", "bicgstab_l", "minres", "richardson", "tfqmr", "Lanes",
           "BatchedSolveResult", "all_lanes", "gcr_restart_batched",
           "gcr_var_precond_restart_batched", "minres_batched",
           "GCR_STORE_LIMIT_BYTES", "READBACKS"]

# The largest GCR direction store (2 x R x n values) a solve allocates,
# qmg_tpu's limit: unrestarted GCR (restart_freq = -1) keeps max_iter
# directions, which at the default cap of 1000 on a large lattice would be
# tens of GiB; the guard refuses it before any allocation.
GCR_STORE_LIMIT_BYTES = 8 * 1024 ** 3

# Host read-backs of device values by solver name, since the process
# started: each one waits for the device to finish the work queued before
# it.
READBACKS = collections.Counter()


def _host(solver: str, t: torch.Tensor) -> np.ndarray:
    """The tensor ``t`` on the host, one read-back counted for
    ``solver``."""
    READBACKS[solver] += 1
    with span("qmg.readback"):
        return t.cpu().numpy()


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


def _keep_going(solver: str, rsq, target) -> bool:
    """isfinite(rsq) and rsq > target, read back to the host."""
    return bool(_host(solver, torch.isfinite(rsq) & (rsq > target)))


class _Monitor:
    """A loop's stopping test and its prints. Silent, the test is one
    read-back of the lanes' device flags. Verbose (one lane), it reads the
    squared residual back as a value (once per tensor), tests it on the
    host against the target read once, and the prints reuse that value."""

    def __init__(self, solver: str, verbose, bsq, target):
        self.solver = solver
        self.verbose = _as_verbose(verbose)
        self.on = self.verbose.verbosity > Verbosity.NONE
        self.target = target
        if self.on and bsq.numel() > 1:
            raise ValueError("verbose prints one solve: a batched solve "
                             "(nrhs > 1) prints nothing, as qmg_tpu's "
                             "vmapped solve does")
        if self.on:
            self.bsq = _host(solver, bsq).item()
            self.target = _host(solver, target).item()
        self._last = self._value = None

    def _read(self, rsq) -> float:
        if rsq is not self._last:
            self._last, self._value = rsq, _host(self.solver, rsq).item()
        return self._value

    def still(self, lanes, rsq):
        """The lanes of ``lanes`` whose residual is finite and above the
        target, None where none is."""
        if not self.on:
            return _still(self.solver, lanes,
                          torch.isfinite(rsq) & (rsq > self.target))
        r = self._read(rsq)
        # One lane: it goes on as it was, or the loop ends here.
        return lanes if math.isfinite(r) and r > self.target else None

    def iteration(self, k: int, rsq):
        if self.verbose.verbosity >= Verbosity.DETAIL:
            _verbose_print(self.verbose, k, self._read(rsq), self.bsq)

    def summary(self, name: str, k: int, rsq):
        if self.on:
            _verbose_summary(self.verbose, name, k, self._read(rsq),
                             self.bsq)


# ---------------------------------------------------------------------------
# The rhs axis. Every Krylov solve on the K-cycle's path has one body, run
# on a batch with a leading rhs axis (B, ...) (``laned``) or on one field
# without it: the single solve, with its own shapes and 0-dim scalars.
# ---------------------------------------------------------------------------

class Lanes(NamedTuple):
    """Which lanes of a batch are active: a (B,) bool tensor on the
    fields' device and the same mask on the host (NumPy). ``dev`` is None
    where every lane is active, so that no mask is applied there."""
    dev: torch.Tensor | None
    host: np.ndarray


class BatchedSolveResult(NamedTuple):
    x: torch.Tensor           # (B, ...)
    iters: np.ndarray         # (B,) int64, per lane
    res_sq: torch.Tensor      # (B,) real (0-dim for one field)
    converged: torch.Tensor   # (B,) bool (0-dim for one field)
    ops_count: np.ndarray     # (B,) int64, operator applications per lane


def all_lanes(b) -> Lanes:
    """Every lane of the batch ``b`` active."""
    return Lanes(None, np.ones(b.shape[0], dtype=bool))


# One lane active, built once (its host mask is read, never written).
_ONE = Lanes(None, np.ones(1, dtype=bool))
_ONE.host.flags.writeable = False


def _axis(b, laned: bool, reduce, active):
    """(nrhs, its reductions (vdot, norm2sq, sum), its lanes) of a solve
    on ``b``: the lane reductions on a batch, the single field's 0-dim
    ones on one field."""
    if not laned:
        return 1, reductions(reduce), _ONE if active is None else active
    return (b.shape[0], lane_reductions(reduce),
            all_lanes(b) if active is None else active)


def _still(solver: str, lanes: Lanes, keep) -> Lanes | None:
    """The lanes of ``lanes`` where the device flags ``keep`` hold, by one
    read-back (one field: the flag that a single solve's stopping test
    reads), or None where none does."""
    if lanes.dev is not None:
        keep = keep & lanes.dev
    host = _host(solver, keep)
    if keep.ndim == 0:
        return _ONE if host else None
    if not host.any():
        return None
    return Lanes(None if host.all() else keep, host)


def _per_lane(mask, like):
    """A (B,) tensor shaped to broadcast over the fields ``like`` (one
    field's 0-dim one broadcasts as it is)."""
    if mask.ndim == 0:
        return mask
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def _masked(lanes, masked: bool, new, old):
    """``new`` on the active lanes and ``old`` on the others; ``new``
    alone where nothing is masked or every lane is active."""
    if not masked or lanes.dev is None:
        return new
    return torch.where(_per_lane(lanes.dev, new), new, old)


def _result(x, iters, rsq, target, ops) -> BatchedSolveResult:
    return BatchedSolveResult(x, iters, rsq, rsq <= target, ops)


def _single(res: BatchedSolveResult) -> SolveResult:
    """A solve of one field (no rhs axis) as the single-field result."""
    return SolveResult(res.x, int(res.iters[0]), res.res_sq, res.converged,
                       int(res.ops_count[0]))


# ---------------------------------------------------------------------------
# Conjugate gradient (Hermitian positive definite operators: the normal
# operators of the deflated coarsest).
# ---------------------------------------------------------------------------

def _cg(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
        active: Lanes = None, verbose=None, laned: bool = True
        ) -> BatchedSolveResult:
    """CG, on a batch (``laned``, ``tol`` a float or a (B,) tensor) or one
    field."""
    nrhs, (vdot, norm2sq, _), lanes = _axis(b, laned, None, active)
    x = torch.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = _target(tol, bsq)
    mon = _Monitor("cg", verbose, bsq, target)
    r = b - matvec(x)
    p = r
    rsq = norm2sq(r)
    missed = np.zeros(nrhs, dtype=np.int64)     # trips each lane sat out
    k = 0
    while k < max_iter:
        lanes = mon.still(lanes, rsq)
        if lanes is None:
            break
        if lanes.dev is not None:
            missed += ~lanes.host
        ap = matvec(p)
        # Breakdown guard: a stalled solve's <p, Ap> can underflow to 0;
        # the iteration then becomes a no-op.
        den = vdot(p, ap).real
        pos = den > 0
        alpha = _per_lane(torch.where(pos, rsq / torch.where(pos, den, 1.0),
                                      0.0), p)
        x = _masked(lanes, True, x + alpha * p, x)
        r_new = r - alpha * ap
        rsq_new = norm2sq(r_new)
        p = _masked(lanes, True, r_new + _per_lane(rsq_new / rsq, p) * p, p)
        r = _masked(lanes, True, r_new, r)
        rsq = _masked(lanes, True, rsq_new, rsq)
        k += 1
        mon.iteration(k, rsq)
    mon.summary("cg", k, rsq)
    iters = k - missed
    return _result(x, iters, rsq, target, iters + 1)


def cg(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
       verbose=None) -> SolveResult:
    return _single(_cg(matvec, b, x0, max_iter, tol, verbose=verbose,
                       laned=False))


def _cg_restart(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
                restart_freq: int = 32, active: Lanes = None, verbose=None,
                laned: bool = True) -> BatchedSolveResult:
    """CG restarted every ``restart_freq`` iterations from the true
    residual: a lane stops once its residual meets the tolerance or its
    iterations reach ``max_iter``. ``verbose`` goes to each restart
    cycle's CG (qmg_tpu's cg_restart takes none)."""
    nrhs, (_, norm2sq, _), lanes = _axis(b, laned, None, active)
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(tol, norm2sq(b))
    rsq = norm2sq(b - matvec(x))
    iters = np.zeros(nrhs, dtype=np.int64)
    ops = np.ones(nrhs, dtype=np.int64)
    while True:
        spent = lanes.host & (iters >= max_iter)
        if spent.any():
            left = lanes.host & ~spent
            lanes = Lanes(None if left.all() else
                          torch.as_tensor(left, device=b.device), left)
        if not lanes.host.any():
            break
        lanes = _still("cg", lanes, rsq > target)
        if lanes is None:
            break
        res = _cg(matvec, b, x0=x, max_iter=restart_freq, tol=tol,
                  active=lanes, verbose=verbose, laned=laned)
        x = _masked(lanes, True, res.x, x)
        rsq = _masked(lanes, True, res.res_sq, rsq)
        iters += np.where(lanes.host, res.iters, 0)
        ops += np.where(lanes.host, res.ops_count, 0)
    return _result(x, iters, rsq, target, ops)


def cg_restart(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
               restart_freq: int = 32, verbose=None) -> SolveResult:
    return _single(_cg_restart(matvec, b, x0, max_iter, tol, restart_freq,
                               verbose=verbose, laned=False))


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


def _orthogonalize(ps, aps, apsq, j: int, z, ap, total):
    """(z, Az) orthogonalized against the ``j`` stored directions: on one
    field (1-D vectors, (R, n) stores) matrix-vector products, on a batch
    ((B, n) vectors, (B, R, n) stores) each lane's by batched products."""
    if ap.ndim == 1:
        betas = total(aps[:j].conj() @ ap) / apsq[:j]
        return z - betas @ ps[:j], ap - betas @ aps[:j]
    ps, aps = ps[:, :j], aps[:, :j]
    betas = total((aps.conj() @ ap.unsqueeze(-1)).squeeze(-1)) / apsq[:, :j]
    return (z - (betas.unsqueeze(1) @ ps).squeeze(1),
            ap - (betas.unsqueeze(1) @ aps).squeeze(1))


def _gcr(matvec, b, x0, max_iter: int, tol, restart_len: int, precond=None,
         precond_carry=None, active: Lanes = None, fixed_trips: bool = False,
         reduce=None, verbose=None, trace=None, laned: bool = True):
    """GCR on a batch with a leading rhs axis (B, ...) (``laned``) or on
    one field, flexible with ``precond(r, carry, lanes)``. ``tol`` is a
    float or a 0-dim or (B,) tensor (the K-cycle's per-lane inner
    tolerance); ``active`` the lanes that take part (all by default): the
    others are frozen from the start. With ``fixed_trips`` every lane runs
    ``max_iter`` trips unmasked, as the trip-counted loop does under
    qmg_tpu's vmap. ``verbose`` prints one lane only.
    ``trace(k, iters, rsq, true_rsq, bsq)``, when given, is called at every
    restart and once at the end with the per-lane iteration counts and
    squared recursive residuals; ``true_rsq`` is the squared true residual
    at a restart, None at the end. Returns (BatchedSolveResult, carry)."""
    nrhs, (vdot, norm2sq, total), lanes = _axis(b, laned, reduce, active)
    n = b.numel() // nrhs
    R = _store_rows(restart_len, max_iter)
    _check_store(R, b)
    x = torch.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = _target(tol, bsq)
    mon = _Monitor("gcr", verbose, bsq, target)
    rdt = bsq.dtype
    tiny = torch.finfo(rdt).tiny
    if precond is None:
        def precond(r, carry, lanes):
            return r, carry

    r = b - matvec(x)
    missed = np.zeros(nrhs, dtype=np.int64)     # trips each lane sat out
    restarts = np.zeros(nrhs, dtype=np.int64)
    # One field keeps the single solve's 1-D vectors and (R, n) stores.
    lead = (nrhs,) if laned else ()
    flat = lead + (n,)
    ps = torch.zeros(lead + (R, n), dtype=b.dtype, device=b.device)
    aps = torch.zeros_like(ps)
    apsq = torch.ones(lead + (R,), dtype=rdt, device=b.device)
    rsq = norm2sq(r)
    masked = not fixed_trips
    j = k = 0
    carry = precond_carry
    while k < max_iter:
        if masked:
            lanes = mon.still(lanes, rsq)
            if lanes is None:
                break
        if j >= R:
            # Restart: the true residual, a cleared store. Active lanes
            # started together, so they restart together.
            r = _masked(lanes, masked, b - matvec(x), r)
            restarts += lanes.host
            if trace is not None:
                trace(k, k - missed, rsq, norm2sq(r), bsq)
            ps.zero_()
            aps.zero_()
            apsq.fill_(1.0)
            j = 0
        if lanes.dev is not None:
            missed += ~lanes.host
        z, carry = precond(r, carry, lanes)
        ap = matvec(z).reshape(flat)
        z = z.reshape(flat)
        if j > 0:
            z, ap = _orthogonalize(ps, aps, apsq, j, z, ap, total)
        apsq_new = norm2sq(ap)
        # Breakdown guard: a stalled solve's orthogonalized direction can
        # underflow to 0; the iteration then becomes a no-op.
        broke = ~(apsq_new > tiny)
        alpha = torch.where(broke, 0.0,
                            vdot(ap, r) / torch.where(broke, 1.0, apsq_new))
        step = _per_lane(alpha, z)
        x = _masked(lanes, masked, x + (step * z).reshape(b.shape), x)
        r = _masked(lanes, masked, r - (step * ap).reshape(b.shape), r)
        rsq = _masked(lanes, masked, norm2sq(r), rsq)
        row = (slice(None), j) if laned else j
        ps[row] = z
        aps[row] = ap
        apsq[row] = torch.where(broke, 1.0, apsq_new)
        j += 1
        k += 1
        mon.iteration(k, rsq)
    mon.summary("gcr", k, rsq)
    iters = k - missed
    if trace is not None:
        trace(k, iters, rsq, None, bsq)
    return _result(x, iters, rsq, target, iters + restarts + 1), carry


def _single_precond(precond):
    """A single-field precond(r, carry) in the lane form."""
    return lambda r, carry, lanes: precond(r, carry)


def gcr(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
        verbose=None) -> SolveResult:
    """Unrestarted GCR: keeps up to ``max_iter`` directions."""
    res, _ = _gcr(matvec, b, x0, max_iter, tol,
                  restart_len=max(int(max_iter), 1), verbose=verbose,
                  laned=False)
    return _single(res)


def gcr_restart(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
                restart_freq: int = 32, reduce=None,
                verbose=None) -> SolveResult:
    res, _ = _gcr(matvec, b, x0, max_iter, tol,
                  restart_len=int(restart_freq), reduce=reduce,
                  verbose=verbose, laned=False)
    return _single(res)


def gcr_var_precond(matvec, b, precond, x0=None, max_iter: int = 1000,
                    tol=1e-8, precond_carry=None, fixed_trips: bool = False,
                    verbose=None):
    """Unrestarted flexible GCR (``restart_freq = -1`` in a K-cycle)."""
    res, carry = _gcr(matvec, b, x0, max_iter, tol,
                      restart_len=max(int(max_iter), 1),
                      precond=_single_precond(precond),
                      precond_carry=precond_carry, fixed_trips=fixed_trips,
                      verbose=verbose, laned=False)
    return _single(res), carry


def gcr_var_precond_restart(matvec, b, precond, x0=None,
                            max_iter: int = 1000, tol=1e-8,
                            restart_freq: int = 32, precond_carry=None,
                            reduce=None, fixed_trips: bool = False,
                            verbose=None):
    """Restarted flexible GCR: the outer solver of the K-cycle stack."""
    res, carry = _gcr(matvec, b, x0, max_iter, tol,
                      restart_len=int(restart_freq),
                      precond=_single_precond(precond),
                      precond_carry=precond_carry, reduce=reduce,
                      fixed_trips=fixed_trips, verbose=verbose, laned=False)
    return _single(res), carry


def gcr_restart_batched(matvec, b, max_iter: int = 1000, tol=1e-8,
                        restart_freq: int = 32, active: Lanes = None
                        ) -> BatchedSolveResult:
    """Restarted GCR on a leading rhs axis (the iterative coarsest)."""
    res, _ = _gcr(matvec, b, None, max_iter, tol, int(restart_freq),
                  active=active)
    return res


def gcr_var_precond_restart_batched(matvec, b, precond, max_iter: int = 1000,
                                    tol=1e-8, restart_freq: int = 32,
                                    precond_carry=None, active: Lanes = None,
                                    fixed_trips: bool = False, trace=None):
    """Restarted flexible GCR on a leading rhs axis: the outer and inner
    solver of the K-cycle, ``precond(r, carry, lanes)``; ``trace`` as
    ``_gcr`` takes it. Returns (BatchedSolveResult, carry)."""
    return _gcr(matvec, b, None, max_iter, tol, int(restart_freq),
                precond=precond, precond_carry=precond_carry, active=active,
                fixed_trips=fixed_trips, trace=trace)


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
    while k < max_iter and _keep_going("bicgstab", rsq, target):
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
               l: int = 6, reduce=None) -> SolveResult:
    """``max_iter`` counts l-cycles x l; each l-cycle costs 2l matvecs.
    ``reduce`` as in ``_gcr``: every inner product is summed over the
    ranks, so all of them take the same steps."""
    vdot, norm2sq, _ = reductions(reduce)
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
    while k < max_cycles and _keep_going("bicgstab_l", rsq, target):
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


def _minres(matvec, b, x0=None, max_iter: int = 2, tol=1e-15,
            omega: float = 1.0, active: Lanes = None, reduce=None,
            laned: bool = True) -> BatchedSolveResult:
    """MinRes on a batch (``laned``) or one field. The fixed smoother
    (max_iter <= 4 and a never-met float tolerance) runs its steps on
    every lane unmasked, with no stopping test (the caller drops what
    inactive lanes compute); otherwise converged lanes freeze as in
    ``_gcr``."""
    nrhs, (vdot, norm2sq, _), lanes = _axis(b, laned, reduce, active)
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(tol, norm2sq(b))
    r = b - matvec(x)
    rsq = norm2sq(r)
    fixed = _fixed_minres(max_iter, tol)
    missed = np.zeros(nrhs, dtype=np.int64)     # steps each lane sat out
    k = 0
    while k < max_iter:
        if not fixed:
            lanes = _still("minres", lanes, rsq > target)
            if lanes is None:
                break
        if lanes.dev is not None:
            missed += ~lanes.host
        ar = matvec(r)
        arsq = norm2sq(ar)
        pos = arsq > 0
        alpha = torch.where(pos, vdot(ar, r) / torch.where(pos, arsq, 1.0),
                            0.0)
        step = _per_lane(omega * alpha, r)
        x = _masked(lanes, not fixed, x + step * r, x)
        r = _masked(lanes, not fixed, r - step * ar, r)
        rsq = _masked(lanes, not fixed, norm2sq(r), rsq)
        k += 1
    iters = k - missed
    return _result(x, iters, rsq, target, iters + 1)


def minres(matvec, b, x0=None, max_iter: int = 2, tol=1e-15,
           omega: float = 1.0, reduce=None) -> SolveResult:
    return _single(_minres(matvec, b, x0, max_iter, tol, omega,
                           reduce=reduce, laned=False))


def minres_batched(matvec, b, max_iter: int = 2, tol=1e-15,
                   omega: float = 1.0, active: Lanes = None
                   ) -> BatchedSolveResult:
    """MinRes on a leading rhs axis."""
    return _minres(matvec, b, None, max_iter, tol, omega, active)


def richardson(matvec, b, x0=None, max_iter: int = 10, tol=1e-10,
               omega: float = 0.33, blocksize: int = 250) -> SolveResult:
    """Relaxed Richardson x += omega (b - A x), the true residual
    recomputed every ``blocksize`` iterations."""
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(tol, norm2sq(b))
    r = b - matvec(x)
    rsq = norm2sq(r)
    k = 0
    while k < max_iter and bool(_host("richardson", rsq > target)):
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
    while k < max_iter and bool(_host("tfqmr", tau * tau > target)):
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
