"""The MG-preconditioned solve and the state exchange with qmg_tpu (port
of the ORIGINAL path of qmg_tpu/tpu_compat.py's ``make_planes_solver`` and
``mg_state_planes``, without their real-plane jit boundaries).

``make_solver`` runs outer restarted flexible GCR around the K-cycle. The
outer matvec is the exact plain apply; the CUDA kernels (and the gather
apply) are installed only as the levels' ``apply_override`` inside the
preconditioner, where flexible GCR absorbs their float32 (or bf16
coefficient) rounding.

``state_to_numpy`` / ``state_from_numpy`` carry a hierarchy across the two
packages in the key format of ``qmg_tpu.tpu_compat.mg_state_planes``:
``clover{l}``, ``hopping{l}``, ``shifts{l}`` (shift, eo_shift, dof_shift),
``nvb{l}`` (blocked null vectors) and ``cdinv`` (dense coarsest inverse),
each a real (..., 2) = (real, imag) NumPy array.
"""

from __future__ import annotations

import numpy as np
import torch

from .lattice import Lattice2D
from .stencil import Stencil2D, make_coeffs, apply_M, build_gather_apply
from .operators.wilson import Wilson2D
from .operators.coarse import CoarseOperator2D
from .transfer import TransferMG, DoublingType
from .stateful import StatefulMultigridMG, zero_carry, DSLASH_KRYLOV
from .setup import KCycleConfig, pin_full_precision
from .wilson_kernel import (wilson_r1_apply, wilson_phase_apply,
                            wilson_phases)
from .dslash_kernel import (SUPPORTED_NC, stencil_channels,
                            stencil_channels_split, x_to_split, x_from_split,
                            small_fits, bind_apply, dslash_apply,
                            dslash_split_apply, dslash_small_apply)
from . import solvers

__all__ = ["make_solver", "state_to_numpy", "state_from_numpy"]


FINE_KERNELS = ("wilson-r1", "wilson-phase", "matrix", "matrix-split",
                "small")
WILSON_KERNELS = ("wilson-r1", "wilson-phase")
MATRIX_KERNELS = ("matrix", "matrix-split", "small")
COARSE_APPLIES = ("plain", "gather", "small")


def _wilson_apply(fine: Stencil2D, kind: str):
    """Level 0's apply through a Wilson kernel: "wilson-r1" (rank-1, w = 1
    only) or "wilson-phase" (any w). The kernels ignore the clover array
    and assume 2w I, so anything but a Wilson operator is refused."""
    if not isinstance(fine, Wilson2D) or fine.lat.nc != 2:
        raise ValueError(f"fine_kernel={kind!r} needs the fine operator to "
                         "be Wilson2D (nc=2)")
    w = fine.wilson_coeff
    if kind == "wilson-r1" and w != 1.0:
        raise ValueError("fine_kernel='wilson-r1' needs the fine operator "
                         f"to be Wilson2D with wilson_coeff=1, got {w}: use "
                         "'wilson-phase'")
    phase = wilson_phases(fine.coeffs.hopping, w)
    alpha = 2.0 * w + float(np.real(fine.coeffs.shift))
    if kind == "wilson-r1":
        def kernel(v):
            return wilson_r1_apply(phase, v, alpha)
    else:
        def kernel(v):
            return wilson_phase_apply(phase, v, w, alpha)

    return lambda v: kernel(v.to(torch.complex64).contiguous()).to(v.dtype)


def _matrix_apply(coeffs, kind: str, coeff_dtype=None):
    """An apply through one generic stencil kernel (K4 "matrix", K5
    "matrix-split", K6 "small"), its channels built and its checks made
    here, once."""
    lat = coeffs.lat
    if lat.nc not in SUPPORTED_NC:
        raise ValueError(f"the stencil kernels take nc in {SUPPORTED_NC}, "
                         f"not {lat.nc}")
    if kind == "matrix":
        fn = bind_apply(dslash_apply, stencil_channels(coeffs, coeff_dtype),
                        lat.cv_shape())
        return lambda v: fn(v.to(torch.complex64).contiguous()).to(v.dtype)
    if kind == "small" and not small_fits(lat.nc, lat.y_len, lat.xh,
                                          coeff_dtype):
        raise ValueError(f"the small-lattice kernel does not take {lat}")
    wrapper = (dslash_split_apply if kind == "matrix-split"
               else dslash_small_apply)
    fn = bind_apply(wrapper, stencil_channels_split(coeffs, coeff_dtype),
                    (2, 2, lat.y_len // 2, lat.xh, lat.nc))
    return lambda v: x_from_split(fn(
        x_to_split(v.to(torch.complex64)))).to(v.dtype)


def _coarse_apply(st: Stencil2D, coarse_apply: str):
    """(apply override or None, its name) for one coarse level. Levels
    without hopping, of volume 1, or that the small kernel does not take
    keep the plain apply (tpu_compat.py:504-530)."""
    c = st.coeffs
    if coarse_apply == "gather":
        fn = build_gather_apply(c)
        return fn, ("gather" if fn is not None else "plain")
    if (coarse_apply == "small" and c.hopping is not None
            and st.lat.volume > 1
            and small_fits(st.lat.nc, st.lat.y_len, st.lat.xh)):
        return _matrix_apply(c, "small"), "small"
    return None, "plain"


def make_solver(mg: StatefulMultigridMG, tol: float = 1e-8,
                max_iter: int = 400, restart_freq: int = 32,
                fine_kernel: str | None = "wilson-r1",
                coarse_apply: str = "plain", coeff_dtype=None):
    """Returns solve(b) -> (SolveResult, carry): outer FGCR on the fine
    operator, preconditioned by one K-cycle per iteration. ``carry`` holds
    this solve's per-level operator and iteration counts (outer ones
    included); they are also added to ``mg.tracker``.

    ``fine_kernel`` routes level 0's apply inside the K-cycle through a
    CUDA kernel: "wilson-r1" (the rank-1 Wilson kernel, w = 1 only),
    "wilson-phase" (the Wilson kernel for any w), "matrix" (K4),
    "matrix-split" (K5) or "small" (K6); None keeps the plain apply.
    ``coeff_dtype=torch.bfloat16`` streams the matrix kernels'
    coefficients in bf16 (refused for the other kinds). ``coarse_apply``
    is the coarse levels' apply: "plain" (alias "jnp"), "gather"
    (``stencil.build_gather_apply``) or "small" (K6 where it fits).
    ``solve.level_applies`` names the apply each level takes. The
    overrides exist only inside a solve: setup, the Galerkin build and
    the outer matvec keep the exact plain apply.
    """
    if fine_kernel not in FINE_KERNELS + (None,):
        raise ValueError(f"unknown fine_kernel {fine_kernel!r}")
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
    pin_full_precision()
    fine = mg.get_stencil(0)
    n_levels = mg.get_num_levels()
    stencils = [mg.get_stencil(lvl) for lvl in range(n_levels)]
    overrides, applies = [None], ["plain"]
    if fine_kernel in WILSON_KERNELS:
        overrides[0] = _wilson_apply(fine, fine_kernel)
    elif fine_kernel is not None:
        overrides[0] = _matrix_apply(fine.coeffs, fine_kernel, coeff_dtype)
    if fine_kernel is not None:
        applies[0] = fine_kernel
    for st in stencils[1:]:
        fn, name = _coarse_apply(st, coarse_apply)
        overrides.append(fn)
        applies.append(name)

    def matvec(v):
        return apply_M(fine.coeffs, v)

    def solve(b):
        carry = zero_carry(n_levels)
        try:
            for st, fn in zip(stencils, overrides):
                st.apply_override = fn
            precond = mg.make_preconditioner(0)
            res, carry = solvers.gcr_var_precond_restart(
                matvec, b, precond, max_iter=max_iter, tol=tol,
                restart_freq=restart_freq, precond_carry=carry)
        finally:
            for st in stencils:
                st.apply_override = None
        carry["counts"][0, DSLASH_KRYLOV] += res.ops_count
        carry["iters"][0] += res.iters
        mg.absorb_carry(carry)
        return res, carry

    solve.level_applies = applies
    return solve


def _planes(t: torch.Tensor, dtype) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.stack([a.real, a.imag], axis=-1).astype(dtype)


def _complex(p: np.ndarray, dtype, device) -> torch.Tensor:
    p = np.asarray(p)
    return torch.complex(torch.as_tensor(p[..., 0]),
                         torch.as_tensor(p[..., 1])).to(device=device,
                                                        dtype=dtype)


def state_to_numpy(mg: StatefulMultigridMG, dtype=np.float32) -> dict:
    """Every array of the hierarchy as real (..., 2) planes of ``dtype``."""
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
        state[f"nvb{lvl}"] = _planes(mg.get_transfer(lvl)._nvb, dtype)
    if mg.coarsest_dinv is not None:
        state["cdinv"] = _planes(mg.coarsest_dinv, dtype)
    return state


def state_from_numpy(state: dict, cfg: KCycleConfig, *, device="cpu",
                     dtype=None) -> StatefulMultigridMG:
    """Rebuild a hierarchy from a state dict (``state_to_numpy`` or
    ``qmg_tpu.tpu_compat.mg_state_planes``). ``cfg`` supplies the
    blocking and the per-level solve parameters. ``dtype`` defaults to
    complex64 for float32 planes and complex128 otherwise. Level 0 is
    adopted as a Wilson operator at the Wilson coefficient its clover
    holds (``Wilson2D.from_coeffs``; its structure is checked), so a
    hierarchy built at w != 1 loads too."""
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
    lat0 = Lattice2D(2 * xh, y_len, nc)
    fine = Wilson2D.from_coeffs(coeffs(0, lat0))
    mg = StatefulMultigridMG(lat0, fine, cfg.coarsest_solve())
    lat_prev = lat0
    for lvl, lat in enumerate(cfg.coarse_lattices(lat0), start=1):
        if state[f"clover{lvl}"].shape[:-1] != lat.cm_shape():
            raise ValueError(f"clover{lvl} does not match the lattice "
                             f"{lat} that cfg implies")
        transfer = TransferMG.from_blocked(
            lat_prev, lat, _complex(state[f"nvb{lvl - 1}"], dtype, device),
            doubling=DoublingType.PROJECTION)
        coarse = CoarseOperator2D.from_coeffs(coeffs(lvl, lat), transfer,
                                              is_chiral=True)
        mg.push_level(lat, transfer, cfg.level_solve(), stencil=coarse)
        lat_prev = lat
    if "cdinv" in state:
        mg.coarsest_dinv = _complex(state["cdinv"], dtype, device)
        mg.coarsest_solve.direct = True
    return mg
