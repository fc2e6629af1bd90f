"""The MG-preconditioned solve and the state exchange with qmg_tpu (port
of qmg_tpu/tpu_compat.py's ``make_planes_solver``, ``mg_state_planes`` and
``derived_state_planes``, without their real-plane jit boundaries).

``make_solver`` runs outer restarted flexible GCR around the K-cycle. The
outer matvec is the exact plain apply; the CUDA kernels (and the gather
apply) are installed only as the levels' ORIGINAL ``apply_override``
inside the preconditioner, where flexible GCR absorbs their float32 (or
bf16 coefficient) rounding. ``outer_type=StencilType.RIGHT_SCHUR`` solves
the n19 formulation: the even-half Schur complement of the rbjacobi
operator, b prepared and x reconstructed inside the solve; no kernel
takes part, as no Schur apply takes an override. Every formulation, the
batched solve and the deflated coarsest also run with level 0 cut over a
``parallel.Mesh``.

``make_batched_solver``, ``make_fixed_batched_solver`` and
``make_calibrated_batched_solver`` (the counterparts of qmg_tpu's
``make_batched_planes_solver`` family) solve nrhs right-hand sides in one
batched K-cycle: every field carries a leading rhs axis, each lane follows
its own sequential trajectory (``solvers``' lane solvers), and the rhs
axis goes through the kernels (K1 on level 0, K6 on the small coarse
levels), one launch for all lanes. There is one solve: ``make_solver``'s
is the batched solve's one-field case (no rhs axis: the single solve's
own shapes and scalars), so every formulation, coarsest solve and
smoother that a single solve takes, a batch takes too.

Under a profiler each solve is the span ``qmg.solve``, and its outer
matvec ``qmg.apply.L0.{type}`` (``spans``; the K-cycle opens the others).

``state_to_numpy`` / ``state_from_numpy`` carry a hierarchy across the two
packages in the key format of ``qmg_tpu.tpu_compat.mg_state_planes``:
``clover{l}``, ``hopping{l}``, ``shifts{l}`` (shift, eo_shift, dof_shift),
``nvb{l}`` (blocked null vectors), ``cdinv`` (dense coarsest inverse),
``cevals`` / ``cevecs`` (the coarsest deflation's eigenpairs), and, for the
levels that solve with a derived operator, qmg_tpu's
``derived_state_planes`` keys ``rbjcinv{l}`` (B^-1), ``rbjh{l}`` /
``rbjt{l}`` / ``rbjc{l}`` (rbjacobi hopping / twolink / corner) and
``schurf{l}`` (the 9 fused Schur matrices), each a real (..., 2) =
(real, imag) NumPy array.

``make_refined_solver`` meets a double-precision tolerance with a
complex64 hierarchy: complex128 defect correction on the device
(``refine.py``) around ``make_solver``'s solve.
"""

from __future__ import annotations

import numpy as np
import torch

from .lattice import Lattice2D
from .stencil import (Stencil2D, StencilType, RBJacobiSet, SchurFused,
                      make_coeffs, apply_M, build_gather_apply)
from . import linalg
from .operators.wilson import Wilson2D
from .operators.coarse import CoarseOperator2D
from .transfer import TransferMG, ShardedTransferMG, DoublingType
from .stateful import (StatefulMultigridMG, zero_carry, zero_batched_carry,
                       DSLASH_KRYLOV, _NORMAL_TYPES, _apply_span)
from .spans import span, spanned
from .refine import refine_solve
from .setup import KCycleConfig, pin_full_precision
from .wilson_kernel import (wilson_r1_apply, wilson_r1_rhs_apply,
                            wilson_phase_apply, wilson_phases, bind_wilson)
from .dslash_kernel import (SUPPORTED_NC, stencil_channels,
                            stencil_channels_split, x_to_split, x_from_split,
                            small_fits, bind_apply, dslash_apply,
                            dslash_split_apply,
                            dslash_small_interleaved_apply,
                            dslash_small_rhs_apply)
from .parallel import Mesh, validate_mg_sharding, check_replicated
from .shard_dslash import (make_sharded_dslash, make_sharded_wilson,
                           mesh_pulls)
from . import solvers

__all__ = ["make_solver", "make_batched_solver", "make_fixed_batched_solver",
           "make_calibrated_batched_solver", "make_refined_solver",
           "component_chain", "state_to_numpy", "state_from_numpy",
           "shard_state"]


FINE_KERNELS = ("wilson-r1", "wilson-phase", "matrix", "matrix-split",
                "small")
WILSON_KERNELS = ("wilson-r1", "wilson-phase")
MATRIX_KERNELS = ("matrix", "matrix-split", "small")
COARSE_APPLIES = ("plain", "gather", "small")
# "none": the identity in place of the K-cycle (plain restarted FGCR).
PRECOND_MODES = ("mg", "none")
# The parts of a solve that ``component_chain`` times.
COMPONENTS = ("fine", "transfer", "smooth2", "precond")
# What the batched solvers take; the other kinds have no rhs axis yet.
BATCHED_FINE_KERNELS = ("wilson-r1", None)
BATCHED_COARSE_APPLIES = ("plain", "small")


def _wilson_apply(fine: Stencil2D, kind: str, mesh: Mesh | None = None,
                  nrhs: int | None = None):
    """Level 0's apply through a Wilson kernel: "wilson-r1" (rank-1, w = 1
    only; on a mesh the slab kernel of ``make_sharded_wilson``) or
    "wilson-phase" (any w), its checks made here, once
    (``wilson_kernel.bind_wilson``). The kernels ignore the clover array
    and assume 2w I, so anything but a Wilson operator is refused. With
    ``nrhs`` the apply takes (nrhs, *cv_shape) fields through the rank-1
    kernel's rhs entry (on a mesh, the slab kernel's)."""
    _check_wilson(fine, kind)
    w = fine.wilson_coeff
    mass = float(np.real(fine.coeffs.shift))
    if mesh is not None:
        kernel = make_sharded_wilson(fine.coeffs, mesh, mass, w, nrhs)
        return lambda v: kernel(v.to(torch.complex64).contiguous()).to(
            v.dtype)
    phase = wilson_phases(fine.coeffs.hopping, w)
    alpha = 2.0 * w + mass
    if nrhs is not None:
        kernel = bind_wilson(wilson_r1_rhs_apply, phase,
                             (nrhs,) + fine.lat.cv_shape(), alpha)
    elif kind == "wilson-r1":
        kernel = bind_wilson(wilson_r1_apply, phase, fine.lat.cv_shape(),
                             alpha)
    else:
        kernel = bind_wilson(wilson_phase_apply, phase, fine.lat.cv_shape(),
                             w, alpha)
    return lambda v: kernel(v.to(torch.complex64).contiguous()).to(v.dtype)


def _check_wilson(fine: Stencil2D, kind: str):
    """The Wilson kernels take a Wilson operator, the rank-1 ones at w = 1
    only."""
    if not isinstance(fine, Wilson2D) or fine.lat.nc != 2:
        raise ValueError(f"fine_kernel={kind!r} needs the fine operator to "
                         "be Wilson2D (nc=2)")
    if kind == "wilson-r1" and fine.wilson_coeff != 1.0:
        raise ValueError("fine_kernel='wilson-r1' needs the fine operator "
                         "to be Wilson2D with wilson_coeff=1, got "
                         f"{fine.wilson_coeff}: use 'wilson-phase'")


def _matrix_apply(coeffs, kind: str, coeff_dtype=None,
                  nrhs: int | None = None):
    """An apply through one generic stencil kernel (K4 "matrix", K5
    "matrix-split", K6 "small"), its channels built and its checks made
    here, once. K4 and K6 take the fields as they are (K6 through its
    interleaved entry, or with ``nrhs`` its rhs entry on (nrhs, *cv_shape)
    fields); K5 is applied in its own split layout, between two layout
    copies."""
    lat = coeffs.lat
    if lat.nc not in SUPPORTED_NC:
        raise ValueError(f"the stencil kernels take nc in {SUPPORTED_NC}, "
                         f"not {lat.nc}")
    if kind == "matrix-split":
        fn = bind_apply(dslash_split_apply,
                        stencil_channels_split(coeffs, coeff_dtype),
                        (2, 2, lat.y_len // 2, lat.xh, lat.nc))
        return lambda v: x_from_split(fn(
            x_to_split(v.to(torch.complex64)))).to(v.dtype)
    if kind == "small" and not small_fits(lat.nc, lat.y_len, lat.xh,
                                          coeff_dtype):
        raise ValueError(f"the small-lattice kernel does not take {lat}")
    if nrhs is not None:
        fn = bind_apply(dslash_small_rhs_apply,
                        stencil_channels(coeffs, coeff_dtype),
                        (nrhs,) + lat.cv_shape())
        return lambda v: fn(v.to(torch.complex64).contiguous()).to(v.dtype)
    wrapper = (dslash_apply if kind == "matrix"
               else dslash_small_interleaved_apply)
    fn = bind_apply(wrapper, stencil_channels(coeffs, coeff_dtype),
                    lat.cv_shape())
    return lambda v: fn(v.to(torch.complex64).contiguous()).to(v.dtype)


def _coarse_apply(st: Stencil2D, coarse_apply: str, nrhs: int | None = None):
    """(apply override or None, its name) for one coarse level. Levels
    without hopping, of volume 1, or that the small kernel does not take
    keep the plain apply (tpu_compat.py:504-530). With ``nrhs`` the
    override takes (nrhs, *cv_shape) fields (gather has no rhs form)."""
    c = st.coeffs
    if coarse_apply == "gather":
        fn = build_gather_apply(c)
        return fn, ("gather" if fn is not None else "plain")
    if coarse_apply == "small" and _takes_small(st):
        return _matrix_apply(c, "small", nrhs=nrhs), "small"
    return None, "plain"


def _takes_small(st: Stencil2D) -> bool:
    """Whether ``coarse_apply="small"`` installs K6 on this level."""
    return (st.coeffs.hopping is not None and st.lat.volume > 1
            and small_fits(st.lat.nc, st.lat.y_len, st.lat.xh))


def _overrides(stencils, nrhs, fine_kernel, coarse_apply, coeff_dtype,
               mesh):
    """(the levels' apply overrides, their names) for one field (``nrhs``
    None) or a batch (nrhs, *cv_shape): a single-field kernel (or the
    gather apply, or the sharded apply on a mesh), at nrhs = 1 handed lane
    0's view; above it the rhs entries of K1 (K7 on a mesh) and K6, one
    launch for all lanes (the callers refuse the kinds that have none)."""
    fine = stencils[0]
    rhs = nrhs if nrhs and nrhs > 1 else None
    fns, names = [None], [fine_kernel or "plain"]
    if fine_kernel in WILSON_KERNELS:
        fns[0] = _wilson_apply(fine, fine_kernel, mesh, rhs)
    elif fine_kernel is not None:
        fns[0] = _matrix_apply(fine.coeffs, fine_kernel, coeff_dtype)
    elif mesh is not None:
        fns[0] = make_sharded_dslash(fine.coeffs, mesh)
    if mesh is not None:
        names[0] += f" on {mesh.ny}x{mesh.nx} blocks"
    for st in stencils[1:]:
        fn, name = _coarse_apply(st, coarse_apply, rhs)
        fns.append(fn)
        names.append(name)
    if nrhs == 1:
        fns = [fn if fn is None else (lambda v, fn=fn: fn(v[0])[None])
               for fn in fns]
    return fns, names


def _hierarchy_guard(mg: StatefulMultigridMG):
    """A check that ``mg`` has not changed since the call: a solver holds
    the stencils, transfers and overrides of the levels it was made on."""
    version = mg.version

    def check():
        if mg.version != version:
            raise RuntimeError(
                "the hierarchy changed since this solver was made "
                "(push_level, pop_level, update_level, "
                "prepare_direct_coarsest or deflate_coarsest): make a new "
                "solver")
    return check


def _outer_verbose(v: solvers.VerboseMG):
    """The outer solve's print struct: the caller's, its prefix
    "[QMG-MG-SOLVE-INFO]: Level 0 " unless it gave one; None when the
    outer solve is silent."""
    if not v.verbosity:
        return None
    return solvers.VerboseMG(v.verbosity, v.precond_verbosity,
                             v.prefix or "[QMG-MG-SOLVE-INFO]: Level 0 ")


def make_solver(mg: StatefulMultigridMG, tol: float = 1e-8,
                max_iter: int = 400, restart_freq: int = 32,
                fine_kernel: str | None = "wilson-r1",
                coarse_apply: str = "plain", coeff_dtype=None,
                mesh: Mesh | None = None,
                outer_type: StencilType = StencilType.ORIGINAL,
                prepared: bool = False, precond_mode: str = "mg",
                fixed_outer_iters: int | None = None):
    """Returns solve(b, x0=None, track=True, verbose=None) ->
    (SolveResult, carry): outer FGCR on the fine operator, from ``x0``
    (zero by default), preconditioned by one K-cycle per iteration. It is
    ``make_batched_solver``'s solve on one field without the rhs axis,
    with every option of the single solve. ``carry`` holds this
    solve's per-level operator and iteration counts (outer ones included);
    with ``track`` they are also added to ``mg.tracker``. ``verbose`` (a
    bool, a prefix or a ``solvers.VerboseMG``) prints qmg_tpu's lines: the
    outer solve's at its verbosity, the K-cycle's per level
    (``StatefulMultigridMG.make_preconditioner``). A solve refuses to run
    once the hierarchy changed (``mg.version``).

    ``outer_type`` is the outer operator, level 0's ``fine_stencil_app``:
    ORIGINAL, RIGHT_JACOBI or RIGHT_SCHUR (the n19 configuration). The
    caller passes the full b and gets the full x back in ``res.x``:
    ``prepare_M`` and ``reconstruct_M`` run inside ``solve``, and
    ``res.res_sq`` is the residual of the prepared system; with
    ``prepared=True`` b, x0 and ``res.x`` are that system's own vectors
    instead (qmg_tpu's ``StatefulMultigridMG.solve``), and without it an
    ``x0`` needs the ORIGINAL outer type. The derived
    sets that the solve applies are built here, once. No kernel and no
    gather apply replaces a derived apply, so with a derived outer type
    ``fine_kernel`` must be None, and ``coarse_apply`` must be "plain"
    where a coarse level solves with a derived type.

    ``fine_kernel`` routes level 0's apply inside the K-cycle through a
    CUDA kernel: "wilson-r1" (the rank-1 Wilson kernel, w = 1 only),
    "wilson-phase" (the Wilson kernel for any w), "matrix" (K4),
    "matrix-split" (K5) or "small" (K6); None keeps the plain apply.
    ``coeff_dtype=torch.bfloat16`` streams the matrix kernels'
    coefficients in bf16 (refused for the other kinds). ``coarse_apply``
    is the coarse levels' apply: "plain" (alias "jnp"), "gather"
    (``stencil.build_gather_apply``) or "small" (K6 where it fits); it
    replaces only ORIGINAL applies, so a normal-operator coarsest (the CG
    coarsest, deflated or not) keeps its plain composition.
    ``solve.level_applies`` names the apply each level takes. The
    overrides exist only inside a solve: setup, the Galerkin build and
    the outer matvec keep the exact plain apply.

    ``mesh`` (``parallel.Mesh``) cuts level 0 into blocks: its ORIGINAL
    apply inside the K-cycle is ``make_sharded_wilson`` ("wilson-r1", a
    (ny, 1) mesh) or the plain ``make_sharded_dslash`` (None), the outer
    matvec the exact ``make_sharded_dslash``; the other kernels are
    refused. A derived outer type (the Schur apply on even halves, its
    prepare and reconstruct) is applied block by block with the mesh's
    pulls (``shard_dslash.mesh_pulls``: one- and two-row halos). On an
    in-process mesh ``b`` and the solution are whole fields and all else
    is the unsharded code. On a distributed mesh they are the rank's
    blocks, ``mg`` is one that ``state_from_numpy(..., mesh=mesh)`` or the
    sharded setup built, level 0's inner products are summed over the
    ranks and every rank holds the coarse levels whole (the coarsest's
    dense inverse or deflation pairs too).

    ``precond_mode="none"`` puts the identity in place of the K-cycle: the
    solve is plain restarted FGCR on the fine operator. ``fixed_outer_iters``
    runs exactly that many outer trips with no stopping test; ``tol`` still
    sets the target that ``res.converged`` reports against. They are
    qmg_tpu's ``make_planes_solver`` options of the same names.
    """
    lanes = _lane_solver(mg, tol, max_iter, restart_freq, fine_kernel,
                         coarse_apply, coeff_dtype, mesh, outer_type,
                         prepared, fixed_outer_iters,
                         precond_mode=precond_mode)

    def solve(b, x0=None, track: bool = True, verbose=None):
        res, carry = lanes(b, x0=x0, track=track, verbose=verbose,
                           laned=False)
        return (solvers._single(res),
                {name: counts[0] for name, counts in carry.items()})

    solve.level_applies = lanes.level_applies
    return solve


def _kernel_options(fine_kernel, coarse_apply, coeff_dtype, mesh):
    """The checks of the kernel options; returns ``coarse_apply`` with
    "jnp" read as "plain"."""
    if fine_kernel not in FINE_KERNELS + (None,):
        raise ValueError(f"unknown fine_kernel {fine_kernel!r}")
    if mesh is not None and fine_kernel not in ("wilson-r1", None):
        raise ValueError(
            "mesh requires fine_kernel='wilson-r1' (the sharded kernel, "
            "shard_dslash.make_sharded_wilson) or None (the plain sharded "
            f"apply), got {fine_kernel!r}: the other kernels are "
            "single-device")
    coarse_apply = "plain" if coarse_apply == "jnp" else coarse_apply
    if coarse_apply not in COARSE_APPLIES:
        raise ValueError(f"unknown coarse_apply {coarse_apply!r}")
    if coeff_dtype not in (None, torch.bfloat16):
        raise ValueError(f"coeff_dtype must be None or torch.bfloat16, "
                         f"got {coeff_dtype}")
    if coeff_dtype is not None and fine_kernel not in MATRIX_KERNELS:
        raise ValueError("coeff_dtype applies to the matrix kernels "
                         f"{MATRIX_KERNELS}, not fine_kernel="
                         f"{fine_kernel!r}")
    return coarse_apply


def _lane_solver(mg: StatefulMultigridMG, tol, max_iter, restart_freq,
                 fine_kernel, coarse_apply, coeff_dtype, mesh, outer_type,
                 prepared, fixed_outer_iters=None, trace=None,
                 precond_mode="mg"):
    """The solve of ``make_solver`` and ``make_batched_solver``:
    solve(B, x0=None, track=True, verbose=None, laned=True) ->
    (BatchedSolveResult, carry) on a batch with a leading rhs axis, or
    with ``laned=False`` on one field (the batch's one-field case: a carry
    of one lane, x the field's). ``precond_mode="none"`` solves with the
    identity in place of the K-cycle."""
    if precond_mode not in PRECOND_MODES:
        raise ValueError(f"unknown precond_mode {precond_mode!r} "
                         f"(expected one of {PRECOND_MODES})")
    coarse_apply = _kernel_options(fine_kernel, coarse_apply, coeff_dtype,
                                   mesh)
    outer_type = StencilType(outer_type)
    n_levels = mg.get_num_levels()
    types = mg.level_types()
    if n_levels > 1 and outer_type != types[0]:
        raise ValueError(f"outer_type {outer_type.name} must be level 0's "
                         f"fine_stencil_app, {types[0].name}")
    if outer_type != StencilType.ORIGINAL and fine_kernel is not None:
        raise ValueError(
            f"outer_type {outer_type.name} takes fine_kernel=None: the "
            "kernels replace only the ORIGINAL apply, and no derived (Schur "
            "/ rbjacobi) apply takes an override")
    if coarse_apply != "plain" and (
            any(t != StencilType.ORIGINAL for t in types[1:-1])
            or types[-1] not in (StencilType.ORIGINAL,) + _NORMAL_TYPES):
        raise ValueError(
            f"coarse_apply={coarse_apply!r} on coarse levels that solve with "
            f"{sorted({t.name for t in types[1:]})}: the gather apply and "
            "K6 replace only the ORIGINAL apply, and no derived (Schur / "
            "rbjacobi) apply takes an override; use 'plain'")
    pin_full_precision()
    with span("qmg.setup.prebuild"):
        mg.prebuild_derived_stencils(outer_type)
    unchanged = _hierarchy_guard(mg)
    fine = mg.get_stencil(0)
    stencils = [mg.get_stencil(lvl) for lvl in range(n_levels)]
    reduce, pulls = None, fine.pulls
    if mesh is not None:
        if mesh.distributed != isinstance(mg.get_transfer(0),
                                          ShardedTransferMG):
            raise ValueError(
                "a distributed mesh needs a hierarchy built by "
                "state_from_numpy(..., mesh=mesh) or the sharded setup, and "
                "an in-process mesh a whole one")
        validate_mg_sharding(mg, mesh)
        reduce = mesh.all_sum if mesh.distributed else None
        # A distributed rank's stencil holds the mesh's pulls; the whole
        # stencil of an in-process mesh takes them inside a solve.
        pulls = fine.pulls if mesh.distributed else mesh_pulls(mesh)
    kernels = (fine_kernel, coarse_apply, coeff_dtype, mesh)
    one_field, applies = _overrides(stencils, None, *kernels)
    bound = {None: one_field}     # nrhs (None: one field) -> overrides
    applies = [name if t == StencilType.ORIGINAL else t.name.lower()
               for name, t in zip(applies, types)]
    if mesh is not None and types[0] != StencilType.ORIGINAL:
        applies[0] += f" on {mesh.ny}x{mesh.nx} blocks"

    if outer_type != StencilType.ORIGINAL:
        matvec = fine.get_apply_function(outer_type)
    elif mesh is None:
        def matvec(v):
            return apply_M(fine.coeffs, v)
    else:
        matvec = make_sharded_dslash(fine.coeffs, mesh)
    matvec = spanned(_apply_span(0, outer_type), matvec)

    transformed = outer_type != StencilType.ORIGINAL and not prepared
    fixed = fixed_outer_iters is not None

    def solve(b, x0=None, track: bool = True, verbose=None,
              laned: bool = True):
        with span("qmg.solve"):
            return run(b, x0, track, verbose, laned)

    def run(b, x0, track, verbose, laned):
        unchanged()
        if x0 is not None and transformed:
            raise ValueError(f"x0 with outer_type {outer_type.name} needs "
                             "prepared=True (x0 of the prepared system)")
        nrhs = b.shape[0] if laned else None
        if nrhs not in bound:
            bound[nrhs] = _overrides(stencils, nrhs, *kernels)[0]
        carry = zero_batched_carry(nrhs or 1, n_levels)
        saved_pulls = fine.pulls
        try:
            fine.pulls = pulls
            rhs = fine.prepare_M(b, outer_type) if transformed else b
            for st, fn in zip(stencils, bound[nrhs]):
                st.apply_override = fn
            v = solvers._as_verbose(verbose)
            precond = (None if precond_mode == "none" else
                       mg.make_preconditioner(0, reduce=reduce,
                                              verbose=v).lanes)
            res, carry = solvers._gcr(
                matvec, rhs, x0,
                int(fixed_outer_iters) if fixed else max_iter, tol,
                int(restart_freq), precond=precond, precond_carry=carry,
                fixed_trips=fixed, reduce=reduce, verbose=_outer_verbose(v),
                trace=trace, laned=laned)
            if transformed:
                res = res._replace(x=fine.reconstruct_M(res.x, b,
                                                        outer_type))
        finally:
            for st in stencils:
                st.apply_override = None
            fine.pulls = saved_pulls
        carry["counts"][:, 0, DSLASH_KRYLOV] += res.ops_count
        carry["iters"][:, 0] += res.iters
        if track:
            mg.absorb_carry(carry)
        return res, carry

    solve.level_applies = applies
    return solve


def make_batched_solver(mg: StatefulMultigridMG, tol: float = 1e-8,
                        max_iter: int = 400, restart_freq: int = 32,
                        fine_kernel: str | None = "wilson-r1",
                        coarse_apply: str = "plain", mesh: Mesh | None = None,
                        outer_type: StencilType = StencilType.ORIGINAL,
                        fixed_outer_iters: int | None = None, trace=None):
    """Returns solve(B) -> (BatchedSolveResult, carry) for right-hand sides
    B (nrhs, 2, Y, Xh, nc): outer FGCR around one
    K-cycle per iteration, every lane the arithmetic of ``make_solver``'s
    solve of that field alone (qmg_tpu's vmap of its solve: converged
    lanes frozen, per-lane iteration and operator counts, the loop running
    while any lane is active). ``make_solver`` is this solve at nrhs = 1,
    so the batch takes what a single solve takes: ``outer_type``
    RIGHT_SCHUR (b prepared and x reconstructed per lane, the derived sets
    built once), the normal-operator (CG, deflated) coarsest and the CGNE
    smoother. In complex64 the batch's products may round differently
    from a single field's, which can move a lane's count where the solve
    stalls near the precision floor (ROADMAP, Queue 3 F5). ``carry`` holds
    per-lane counts (nrhs, n_levels, 4) and iterations (nrhs, n_levels),
    outer ones included; their sum over the lanes goes to ``mg.tracker``.

    The rhs axis goes through the kernels: ``fine_kernel="wilson-r1"``
    applies level 0 inside the K-cycle with the rank-1 kernel's rhs entry
    (``wilson_r1_rhs_apply``, one launch for all lanes; on a mesh the
    slab kernel's, one launch a slab and one halo exchange a side for all
    lanes), and
    ``coarse_apply="small"`` the coarse levels that fit it with K6's
    (``dslash_small_rhs_apply``), each bound once per solver and nrhs; at
    nrhs = 1 they take their single-field entries. ``None`` and "plain"
    keep the plain apply, which takes the rhs axis as it is; the outer
    matvec is always the exact plain apply. The other kernels and the
    gather apply are refused: they have no rhs axis, as qmg_tpu refuses
    its Pallas kernels in a batched solve. ``mesh`` cuts level 0 as in
    ``make_solver``, with the slab kernel (``fine_kernel="wilson-r1"``)
    or the plain sharded apply (None); B is then whole on an in-process
    mesh and the rank's blocks on a distributed one. ``fixed_outer_iters``
    runs exactly that many outer trips on every lane with no stopping test
    (``make_fixed_batched_solver``). ``trace`` goes to the outer solve
    (``solvers.gcr_var_precond_restart_batched``): called at each restart
    and at the end with every lane's iterations and residuals."""
    if fine_kernel not in BATCHED_FINE_KERNELS:
        raise ValueError(
            f"batched solves take fine_kernel in {BATCHED_FINE_KERNELS}, got "
            f"{fine_kernel!r}: the other fine kernels have no rhs axis yet "
            "(ROADMAP Queue 2 item 5: an rhs axis for K2, K4 and K5)")
    coarse_apply = "plain" if coarse_apply == "jnp" else coarse_apply
    if coarse_apply not in BATCHED_COARSE_APPLIES:
        raise ValueError(
            f"batched solves take coarse_apply in {BATCHED_COARSE_APPLIES}, "
            f"got {coarse_apply!r}: the gather apply has no rhs axis")
    lanes = _lane_solver(mg, tol, max_iter, restart_freq, fine_kernel,
                         coarse_apply, None, mesh, outer_type, False,
                         fixed_outer_iters, trace)
    cv_shape = tuple(mg.get_stencil(0).lat.cv_shape())

    def solve(b):
        if b.ndim != 5 or tuple(b.shape[1:]) != cv_shape:
            raise ValueError(f"right-hand sides must be (nrhs, "
                             f"{', '.join(map(str, cv_shape))}), "
                             f"got {tuple(b.shape)}")
        return lanes(b)

    solve.level_applies = lanes.level_applies
    return solve


def make_fixed_batched_solver(mg: StatefulMultigridMG, outer_iters: int,
                              allow_masked_inner: bool = False, **solver_kw):
    """``make_batched_solver`` with exactly ``outer_iters`` outer trips on
    every lane (qmg_tpu's ``make_fixed_batched_planes_solver``). By
    default the inner schedule must be trip-counted too - a direct
    coarsest and every intermediate level ``fixed_trips``
    (``KCycleConfig(inner_fixed_iters=k)``) - so that no loop waits on a
    stopping test; ``allow_masked_inner=True`` keeps the adaptive inner
    loops. ``res_sq`` reports the residual each lane reached."""
    if not allow_masked_inner:
        if not (mg.coarsest_solve.direct and mg.coarsest_dinv is not None):
            raise ValueError(
                "fixed-schedule batched solves need a direct coarsest "
                "(prepare_direct_coarsest / KCycleConfig("
                "coarsest_direct=True)): the iterative coarsest keeps a "
                "tolerance loop that re-introduces per-lane masking; or "
                "pass allow_masked_inner=True")
        for lvl in range(1, mg.get_num_levels() - 1):
            if not mg.get_level_solve(lvl).fixed_trips:
                raise ValueError(
                    f"level-{lvl} intermediate solve is not fixed_trips "
                    "- build the hierarchy with KCycleConfig("
                    "inner_fixed_iters=k), or pass "
                    "allow_masked_inner=True")
    return make_batched_solver(mg, fixed_outer_iters=int(outer_iters),
                               **solver_kw)


def make_calibrated_batched_solver(mg: StatefulMultigridMG, probe_b,
                                   margin: int = 1, **solver_kw):
    """A fixed-outer batched solver calibrated by one adaptive solve
    (qmg_tpu's ``make_calibrated_batched_planes_solver``): ``make_solver``
    solves the representative right-hand side ``probe_b`` once, and the
    batched solver runs its outer count + ``margin`` trips with the
    adaptive inner loops. Returns (solve, outer_iters). Callers check the
    per-lane ``res_sq`` against the tolerance."""
    probe, _ = make_solver(mg, **solver_kw)(probe_b)
    outer = int(probe.iters) + int(margin)
    return (make_fixed_batched_solver(mg, outer, allow_masked_inner=True,
                                      **solver_kw), outer)


def make_refined_solver(mg: StatefulMultigridMG, tol: float = 1e-10,
                        inner_tol: float = 1e-5, max_iter: int = 400,
                        restart_freq: int = 32, max_outer: int = 12,
                        **solver_kw):
    """The double-precision contract with a complex64 hierarchy (qmg_tpu's
    ``make_refined_planes_solver``): ``make_solver``'s solve to
    ``inner_tol`` is the correction step of complex128 defect correction
    (``refine.refine_solve``), whose true residual is taken against level
    0's coefficients promoted to complex128, on their device, until it is
    below ``tol``. ``solver_kw`` goes to ``make_solver`` (kernel options,
    ``outer_type``). Returns solve(b) -> ``refine.RefineResult`` with a
    complex128 solution on the hierarchy's device; ``b`` is a NumPy array
    or a tensor."""
    fine = mg.get_stencil(0)
    c128 = fine.coeffs.to(torch.complex128)
    inner_solve = make_solver(mg, tol=inner_tol, max_iter=max_iter,
                              restart_freq=restart_freq, **solver_kw)
    ref = fine.coeffs.ref

    def inner(r):
        res, _ = inner_solve(r.to(ref.dtype))
        return res.x, res.iters

    def solve(b, tol=tol, max_outer=max_outer):
        b = torch.as_tensor(b).to(device=ref.device)
        return refine_solve(lambda x: apply_M(c128, x), inner, b, tol=tol,
                            max_outer=max_outer)

    return solve


def component_chain(mg: StatefulMultigridMG, b, component: str, K: int, *,
                    level: int = 0, counts: dict | None = None,
                    **solver_kw) -> float:
    """K dependent steps of one part of a solve, the counterpart of
    qmg_tpu's ``tpu_compat._planes_component_chain`` (the primitive of
    ``python -m qmg_tpu_torch.attrib``): each step takes the last one's
    output, normalised as out / sqrt(|out|^2 + 1). Returns sum |out| of
    the last, a float that depends on every step (reading it waits for
    them all). ``b`` is a field of level ``level``. The parts, as qmg_tpu
    builds them on level 0:

      fine      the level's exact plain apply; with ``fine_kernel`` (level
                0 only) the kernel apply that the K-cycle binds;
      transfer  restrict to level + 1, then prolong back;
      smooth2   MinRes(2, 0.85) on the level's exact plain apply;
      precond   one K-cycle from this level (``make_preconditioner``),
                with the applies that a ``make_solver`` solver of
                ``solver_kw`` installs: ``fine_kernel`` (default
                "wilson-r1", as ``make_solver``'s), ``coarse_apply`` and
                ``coeff_dtype``.

    At ``level=l`` the same parts run with ``get_stencil(l)``, level l's
    transfer and ``make_preconditioner(l)``; the coarsest level has only
    ``fine`` and ``smooth2``. ``counts`` (a ``stateful.zero_carry`` dict)
    takes the K-cycles' per-level operator and iteration counts."""
    n_levels = mg.get_num_levels()
    if component not in COMPONENTS:
        raise ValueError(f"unknown component {component!r} (expected one "
                         f"of {COMPONENTS})")
    if not 0 <= level < n_levels:
        raise ValueError(f"level {level} not in a {n_levels}-level "
                         "hierarchy")
    if component in ("transfer", "precond") and level == n_levels - 1:
        raise ValueError(f"{component} needs a coarser level than {level}")
    takes = ({"fine_kernel", "coarse_apply", "coeff_dtype"}
             if component == "precond" else
             {"fine_kernel", "coeff_dtype"} if component == "fine"
             and level == 0 else set())
    if set(solver_kw) - takes:
        raise ValueError(f"{component} on level {level} takes no "
                         f"{sorted(set(solver_kw) - takes)}")
    st = mg.get_stencil(level)
    fine_kernel = solver_kw.get("fine_kernel",
                                "wilson-r1" if component == "precond"
                                else None)
    coeff_dtype = solver_kw.get("coeff_dtype")
    coarse_apply = _kernel_options(fine_kernel,
                                   solver_kw.get("coarse_apply", "plain"),
                                   coeff_dtype, None)
    pin_full_precision()

    def plain(v):
        return apply_M(st.coeffs, v)

    stencils = [mg.get_stencil(lvl) for lvl in range(n_levels)]
    overrides = [None] * n_levels
    if component == "fine":
        step = (_overrides(stencils[:1], None, fine_kernel, "plain",
                           coeff_dtype, None)[0][0]
                if fine_kernel is not None else plain)
    elif component == "transfer":
        t = mg.get_transfer(level)

        def step(v):
            return t.prolong_c2f(t.restrict_f2c(v))
    elif component == "smooth2":
        def step(v):
            return solvers.minres(plain, v, max_iter=2, tol=0.0,
                                  omega=0.85).x
    else:
        mg.prebuild_derived_stencils()
        overrides = _overrides(stencils, None, fine_kernel, coarse_apply,
                               coeff_dtype, None)[0]
        precond = mg.make_preconditioner(level)
        carry = zero_carry(n_levels) if counts is None else counts

        def step(v):
            return precond(v, carry)[0]

    v = b
    try:
        for st_l, fn in zip(stencils, overrides):
            st_l.apply_override = fn
        for _ in range(int(K)):
            out = step(v)
            v = out / torch.sqrt(linalg.norm2sq(out) + 1.0)
    finally:
        for st_l in stencils:
            st_l.apply_override = None
    return float(torch.sum(torch.abs(v)))


def _planes(t: torch.Tensor, dtype) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.stack([a.real, a.imag], axis=-1).astype(dtype)


def _complex(p: np.ndarray, dtype, device) -> torch.Tensor:
    p = np.asarray(p)
    return torch.complex(torch.as_tensor(p[..., 0]),
                         torch.as_tensor(p[..., 1])).to(device=device,
                                                        dtype=dtype)


_RBJ_TYPES = (StencilType.RIGHT_JACOBI, StencilType.RBJ_DAGGER,
              StencilType.RBJ_M_MDAGGER, StencilType.RBJ_MDAGGER_M)


def _derived_need(mg: StatefulMultigridMG, outer_type=None) -> dict:
    """level -> {"rbj"[, "fused"]}: the derived sets that the levels'
    stencil types (and ``outer_type`` on level 0) apply (qmg_tpu's
    ``tpu_compat._derived_need``)."""
    need = {}
    types = list(enumerate(mg.level_types()))
    if outer_type is not None:
        types.append((0, StencilType(outer_type)))
    for lvl, t in types:
        if t in _RBJ_TYPES:
            need.setdefault(lvl, set()).add("rbj")
        elif t == StencilType.RIGHT_SCHUR:
            need.setdefault(lvl, set()).update(("rbj", "fused"))
    return need


def state_to_numpy(mg: StatefulMultigridMG, dtype=np.float32,
                   outer_type=None) -> dict:
    """Every array of the hierarchy as real (..., 2) planes of ``dtype``,
    with the derived sets that the levels' types (and ``outer_type``)
    apply, built here where they are not yet. A distributed rank's
    hierarchy gives the rank's cut, the one ``shard_state`` makes."""
    state = {}
    for lvl in range(mg.get_num_levels()):
        c = mg.get_stencil(lvl).coeffs
        if c.clover is not None:
            state[f"clover{lvl}"] = _planes(c.clover, dtype)
        if c.hopping is not None:
            state[f"hopping{lvl}"] = _planes(c.hopping, dtype)
        shifts = np.array([c.shift, c.eo_shift, c.dof_shift])
        state[f"shifts{lvl}"] = np.stack(
            [shifts.real, shifts.imag], axis=-1).astype(dtype)
    for lvl in range(mg.get_num_levels() - 1):
        t = mg.get_transfer(lvl)
        if not t.is_symmetric():
            # The state dict (and so every hierarchy rebuilt from it, a
            # mesh's ShardedTransferMG among them) restricts with nvb^dagger.
            raise ValueError(
                f"level {lvl}'s transfer is asymmetric (it restricts with "
                "its own vectors, not P^dagger): the state dict carries only "
                "nvb; save the hierarchy with checkpoint.save_hierarchy")
        state[f"nvb{lvl}"] = _planes(
            t.locals[0]._nvb if isinstance(t, ShardedTransferMG) else t._nvb,
            dtype)
    if mg.coarsest_dinv is not None:
        state["cdinv"] = _planes(mg.coarsest_dinv, dtype)
    if mg.coarsest_evecs is not None:
        state["cevals"] = _planes(mg.coarsest_evals, dtype)
        state["cevecs"] = _planes(mg.coarsest_evecs, dtype)
    for lvl, kinds in _derived_need(mg, outer_type).items():
        st = mg.get_stencil(lvl)
        rbj = st.rbjacobi
        state[f"rbjcinv{lvl}"] = _planes(rbj.cinv, dtype)
        for name, arr in (("rbjh", rbj.coeffs.hopping),
                          ("rbjt", rbj.coeffs.twolink),
                          ("rbjc", rbj.coeffs.corner)):
            if arr is not None:
                state[f"{name}{lvl}"] = _planes(arr, dtype)
        if "fused" in kinds:
            st.prebuild_derived(StencilType.RIGHT_SCHUR)
            if st.built_rbj_schur_fused:
                state[f"schurf{lvl}"] = _planes(st._rbj_schur_fused.mats,
                                                dtype)
    return state


def _adopt_derived(st: Stencil2D, state: dict, lvl: int, dtype, device):
    """Install the derived sets of level ``lvl`` that ``state`` carries
    (qmg_tpu's ``_patch_hierarchy``), instead of re-deriving them."""
    if f"rbjcinv{lvl}" not in state:
        return
    cinv = _complex(state[f"rbjcinv{lvl}"], dtype, device)
    pieces = {name: (_complex(state[key], dtype, device) if key in state
                     else None)
              for name, key in (("hopping", f"rbjh{lvl}"),
                                ("twolink", f"rbjt{lvl}"),
                                ("corner", f"rbjc{lvl}"))}
    st._rbjacobi = RBJacobiSet(
        coeffs=st.coeffs.replace(clover=linalg.identity_like(cinv),
                                 shift=0j, eo_shift=0j, dof_shift=0j,
                                 **pieces),
        cinv=cinv)
    if f"schurf{lvl}" in state:
        st._rbj_schur_fused = SchurFused(stacked=linalg.stack_terms(
            _complex(state[f"schurf{lvl}"], dtype, device)))


def shard_state(state: dict, mesh: Mesh, b=None):
    """Cut a state dict (``state_to_numpy`` or qmg_tpu's
    ``mg_state_planes``) for a mesh, the counterpart of qmg_tpu's
    ``shard_planes_state``: level 0's ``clover0`` (2, Y, Xh, ...),
    ``hopping0`` (4, 2, Y, Xh, ...), blocked null vectors ``nvb0``
    (nvec, 2c, B, Yc, Xhc, 2) and derived sets (``rbjcinv0`` (2, Y, Xh,
    ...), ``rbjh0`` / ``rbjt0`` / ``rbjc0`` (4, 2, Y, Xh, ...), ``schurf0``
    (9, Y, Xh, ...)) are cut by block, everything else stays whole. Returns one state per block the process holds, in mesh order
    (all of them for an in-process mesh, the rank's for a distributed
    one), and with ``b`` (a whole (2, Y, Xh, nc[, 2]) right-hand side)
    also its blocks. ``state_from_numpy(cut, cfg, mesh=mesh)`` builds a
    rank's hierarchy from its cut."""
    y_dims = {"clover0": 1, "hopping0": 2, "nvb0": 3, "rbjcinv0": 1,
              "rbjh0": 2, "rbjt0": 2, "rbjc0": 2, "schurf0": 1}

    def cut(a, y_dim, iy, ix):
        y_loc, x_loc = a.shape[y_dim] // mesh.ny, a.shape[y_dim + 1] // mesh.nx
        if y_loc * mesh.ny != a.shape[y_dim] or \
                x_loc * mesh.nx != a.shape[y_dim + 1]:
            raise ValueError(f"an array of shape {a.shape} does not cut into "
                             f"the mesh {mesh.shape} along axes {y_dim}, "
                             f"{y_dim + 1}")
        index = [slice(None)] * a.ndim
        index[y_dim] = slice(iy * y_loc, (iy + 1) * y_loc)
        index[y_dim + 1] = slice(ix * x_loc, (ix + 1) * x_loc)
        return a[tuple(index)]

    states = [{k: cut(v, y_dims[k], iy, ix) if k in y_dims else v
               for k, v in state.items()} for iy, ix in mesh.blocks]
    if b is None:
        return states
    return states, [cut(b, 1, iy, ix) for iy, ix in mesh.blocks]


def state_from_numpy(state: dict, cfg: KCycleConfig, *, device="cuda",
                     dtype=None, mesh: Mesh | None = None
                     ) -> StatefulMultigridMG:
    """Rebuild a hierarchy from a state dict (``state_to_numpy`` or
    ``qmg_tpu.tpu_compat.mg_state_planes``) on ``device`` (the card unless
    the caller asks for another). ``cfg`` supplies the blocking and the
    per-level solve parameters; the deflation pairs (``cevals`` /
    ``cevecs``) are used when ``cfg.coarsest_stencil_app`` is a normal
    type. ``dtype`` defaults to
    complex64 for float32 planes and complex128 otherwise. Level 0 is
    adopted as a Wilson operator at the Wilson coefficient its clover
    holds (``Wilson2D.from_coeffs``; its structure is checked), so a
    hierarchy built at w != 1 loads too.

    With a distributed ``mesh``, ``state`` is the rank's cut from
    ``shard_state``: the hierarchy's lattices are the whole ones, level
    0's operator holds the rank's block of the coefficients and of the
    derived sets it carries (its ``lat`` is the block's, its ``pulls`` the
    mesh's), and level 0's transfer is a ``ShardedTransferMG``. The ranks'
    coarse levels are then checked to be one copy
    (``parallel.check_replicated``).

    The derived sets the state carries (``rbjcinv{l}`` ...) are adopted
    as they are, so a Schur hierarchy that qmg_tpu built solves on the
    sets it built; ``cfg`` supplies the levels' stencil types."""
    if mesh is not None and not mesh.distributed:
        raise ValueError("an in-process mesh takes the whole state: load it "
                         "without mesh= and pass the mesh to make_solver")
    if dtype is None:
        dtype = (torch.complex64 if state["clover0"].dtype == np.float32
                 else torch.complex128)

    def coeffs(lvl, lat):
        sh = np.asarray(state[f"shifts{lvl}"], np.float64)
        sh = sh[:, 0] + 1j * sh[:, 1]
        return make_coeffs(
            lat, clover=_complex(state[f"clover{lvl}"], dtype, device),
            hopping=_complex(state[f"hopping{lvl}"], dtype, device),
            shift=sh[0], eo_shift=sh[1], dof_shift=sh[2], dtype=dtype)

    _, y_len, xh, nc = state["clover0"].shape[:4]
    ny, nx = mesh.shape if mesh is not None else (1, 1)
    lat0 = Lattice2D(2 * xh * nx, y_len * ny, nc)
    fine = Wilson2D.from_coeffs(coeffs(0, Lattice2D(2 * xh, y_len, nc)))
    if mesh is not None:
        fine.pulls = mesh_pulls(mesh)
    _adopt_derived(fine, state, 0, dtype, device)
    mg = StatefulMultigridMG(lat0, fine, cfg.coarsest_solve())
    lat_prev = lat0
    for lvl, lat in enumerate(cfg.coarse_lattices(lat0), start=1):
        if state[f"clover{lvl}"].shape[:-1] != lat.cm_shape():
            raise ValueError(f"clover{lvl} does not match the lattice "
                             f"{lat} that cfg implies")
        nvb = _complex(state[f"nvb{lvl - 1}"], dtype, device)
        if lvl == 1 and mesh is not None:
            transfer = ShardedTransferMG(lat_prev, lat, nvb, mesh,
                                         doubling=DoublingType.PROJECTION)
        else:
            transfer = TransferMG.from_blocked(
                lat_prev, lat, nvb, doubling=DoublingType.PROJECTION)
        coarse = CoarseOperator2D.from_coeffs(
            coeffs(lvl, lat), transfer, is_chiral=True,
            use_rbjacobi=cfg.precond_coarsen_rbjacobi)
        _adopt_derived(coarse, state, lvl, dtype, device)
        mg.push_level(lat, transfer, cfg.level_solve(), stencil=coarse)
        lat_prev = lat
    if "cdinv" in state:
        mg.coarsest_dinv = _complex(state["cdinv"], dtype, device)
        mg.coarsest_solve.direct = True
    if "cevecs" in state:
        mg.coarsest_evals = _complex(state["cevals"], dtype, device)
        mg.coarsest_evecs = _complex(state["cevecs"], dtype, device)
    if mesh is not None:
        check_replicated(mesh, mg.replicated_arrays())
    return mg
