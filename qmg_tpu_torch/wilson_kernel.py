"""The Wilson Dslash kernels of ``csrc/wilson.cu`` and their plain PyTorch
twins (port of qmg_tpu/pallas_wilson.py).

All take the per-direction phases ``phase_half`` = U_d/2 of a Wilson
operator (``wilson_phases``), complex64:

  * ``wilson_r1_apply(phase_half, x, alpha)``: the operator at w = 1 with
    rank-1 projectors (``_wilson_rank1_kernel``); x (2, Y, Xh, 2), phases
    (4, 2, Y, Xh), alpha = 2 + mass;
  * ``wilson_r1_rhs_apply(phase_half, x, alpha)``: the same kernel on an
    rhs axis, x (nrhs, 2, Y, Xh, 2) with one set of phases (the batched
    solve's level 0); field b of the output is bit for bit
    ``wilson_r1_apply`` on field b;
  * ``wilson_phase_apply(phase_half, x, w, alpha)``: the operator at any
    Wilson coefficient w (``_wilson_kernel``); the same layouts,
    alpha = 2w + mass;
  * ``wilson_split_apply(phase_split, x_split, alpha)``: the rank-1
    arithmetic in the row-parity-split layout (``_wilson_split_kernel``);
    x (2p, 2r, Yh, Xh, 2) as ``dslash_kernel.x_to_split`` makes it, phases
    (4, 2p, 2r, Yh, Xh) from ``wilson_phases_split``;
  * ``wilson_r1_halo_apply(phase_loc, x_loc, top, bot, alpha)``: the rank-1
    operator on a y-slab of a lattice cut into slabs
    (``_wilson_rank1_kernel`` with ``halo_frame=True``, which
    qmg_tpu/shard_dslash.py runs on each shard): ``top`` is the row below
    the slab and ``bot`` the row above it, each (2 parity, Xh, 2 spin);
    nothing wraps in y. The slab, its phases and the halos may be views of
    a whole field (rows y0 .. y0 + Y_loc of every parity). x, the halos
    and ``out`` may carry a leading rhs axis (nrhs, 2, Y_loc, Xh, 2) with
    one set of phases (the batched solve's level 0 on a mesh): one launch
    for all fields, field b bit for bit the slab kernel on field b.

On a CUDA tensor each wrapper launches its kernel, or raises; on a CPU
tensor it runs its ``*_plain`` twin, which repeats the kernel's
arithmetic. ``<wrapper>.launches`` counts kernel launches.

A wrapper checks everything on every call. Callers that apply one
operator many times (the solve, the benchmark chains) bind it instead:
``bind_wilson`` (the three whole-lattice kernels), ``bind_halo_slabs``
(the slab kernel on the slabs of a whole field in one process) and
``bind_halo`` (the slab kernel on one rank's slab), the last two on one
field or with ``nrhs`` on an rhs axis, make the checks of the fixed
arguments once and return an apply that checks x in one expression and
launches; the launches count on the wrapper as its own do.
"""

from __future__ import annotations

import ctypes

import torch

from .cshift import cshift_pull, ALL_DIRS
from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from .cuda_build import build_library
from .dslash_kernel import _rows_to_split, _split_pulls

__all__ = ["wilson_r1_apply", "wilson_r1_apply_plain", "wilson_r1_rhs_apply",
           "wilson_phase_apply",
           "wilson_phase_apply_plain", "wilson_split_apply",
           "wilson_split_apply_plain", "wilson_r1_halo_apply",
           "wilson_r1_halo_apply_plain", "bind_wilson", "bind_halo",
           "bind_halo_slabs", "wilson_phases",
           "wilson_phases_split", "build_wilson"]

SOURCE = "wilson.cu"
_LIB = {}


def build_wilson() -> float:
    """Build (at first use) and load the kernels; returns build seconds."""
    if "lib" in _LIB:
        return 0.0
    lib, seconds = build_library(SOURCE)
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, scalars in (("wilson_r1_launch", [c_float]),
                          ("wilson_r1_split_launch", [c_float]),
                          ("wilson_phase_launch", [c_float, c_float])):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, c_int, c_int, *scalars, ptr]
        fn.restype = c_int
        _LIB[name] = fn
    fn = lib.wilson_r1_rhs_launch
    fn.argtypes = [ptr, ptr, ptr, c_int, c_int, c_int, c_float, ptr]
    fn.restype = c_int
    _LIB["wilson_r1_rhs_launch"] = fn
    fn = lib.wilson_r1_halo_rhs_launch
    fn.argtypes = [ptr] * 5 + [c_int] * 10 + [c_float, ptr]
    fn.restype = c_int
    _LIB["wilson_r1_halo_rhs_launch"] = fn
    _LIB["lib"] = lib
    return seconds


def wilson_phases(hopping, w: float = 1.0):
    """U_d/2 per direction from built Wilson hopping matrices
    (H_d[0, 0] = -w U_d / 2): (4, 2, Y, Xh) complex64, contiguous."""
    if w == 0:
        raise ValueError("wilson_phases: the phases cannot be recovered "
                         "from H_d[0, 0] = -w U_d / 2 at w = 0")
    return (-hopping[..., 0, 0] / w).to(torch.complex64).contiguous()


def wilson_phases_split(phase_half):
    """Interleaved phases (4, 2, Y, Xh) -> split (4, 2p, 2r, Yh, Xh),
    contiguous; Y must be even."""
    return _rows_to_split(phase_half, 2)


# ---------------------------------------------------------------------------
# Plain twins.
# ---------------------------------------------------------------------------

def _rank1(phase, x, pulls, alpha: float):
    """The rank-1 kernels' arithmetic on the pulled neighbour spinors
    ``pulls`` = [+x, +y, -x, -y]: one complex multiply per direction on a
    pre-combined spinor."""
    vxp, vyp, vxm, vym = pulls
    t_xp = phase[DIR_XP1] * (vxp[..., 1] - vxp[..., 0])
    t_xm = phase[DIR_XM1] * -(vxm[..., 0] + vxm[..., 1])
    t_yp = phase[DIR_YP1] * -(vyp[..., 0] + 1j * vyp[..., 1])
    t_ym = phase[DIR_YM1] * -(vym[..., 0] - 1j * vym[..., 1])
    out0 = alpha * x[..., 0] + (t_xp + t_xm) + (t_yp + t_ym)
    out1 = alpha * x[..., 1] + (t_xm - t_xp) + 1j * (t_ym - t_yp)
    return torch.stack([out0, out1], dim=-1)


def wilson_r1_apply_plain(phase_half, x, alpha: float):
    """The rank-1 kernel's arithmetic in PyTorch; x may carry leading
    batch axes (``(*batch, 2, Y, Xh, 2)``), the phases broadcast over
    them."""
    nb = x.ndim - 4
    return _rank1(phase_half, x, [cshift_pull(x, d, nb) for d in ALL_DIRS],
                  alpha)


def wilson_split_apply_plain(phase_split, x_split, alpha: float):
    """The split rank-1 kernel's arithmetic in PyTorch: the same combines
    on the split layout's neighbour pulls."""
    return _rank1(phase_split, x_split, _split_pulls(x_split), alpha)


def wilson_r1_halo_apply_plain(phase_loc, x_loc, top, bot, alpha: float):
    """The slab kernel's arithmetic in PyTorch: the rank-1 combines on the
    slab's pulls, +-x inside the slab (its rows have the lattice's row
    parity, the slab holding an even number of rows) and +-y from the
    other parity's rows, the slab's edge rows reading ``bot`` (+y of the
    last row) and ``top`` (-y of the first). x (*batch, 2, Y_loc, Xh, 2)
    and the halos (*batch, 2, Xh, 2) may carry the same leading batch
    axes, the phases broadcast over them."""
    nb = x_loc.ndim - 4
    other = x_loc.flip(nb)
    vyp = torch.cat([other.narrow(nb + 1, 1, x_loc.shape[nb + 1] - 1),
                     bot.flip(nb).unsqueeze(nb + 1)], dim=nb + 1)
    vym = torch.cat([top.flip(nb).unsqueeze(nb + 1),
                     other.narrow(nb + 1, 0, x_loc.shape[nb + 1] - 1)],
                    dim=nb + 1)
    pulls = [cshift_pull(x_loc, DIR_XP1, nb), vyp,
             cshift_pull(x_loc, DIR_XM1, nb), vym]
    return _rank1(phase_loc, x_loc, pulls, alpha)


def wilson_phase_apply_plain(phase_half, x, w: float, alpha: float):
    """The any-w kernel's arithmetic in PyTorch: per direction t_s = (U_d/2)
    v_s on both spins, the diagonal -w t_s, then the projector's
    off-diagonal couplings."""
    acc0, acc1 = alpha * x[..., 0], alpha * x[..., 1]
    # (coupling of t1 into out0, of t0 into out1) per direction
    offdiag = {DIR_XP1: (1, 1), DIR_YP1: (-1j, 1j), DIR_XM1: (-1, -1),
               DIR_YM1: (1j, -1j)}
    for d in ALL_DIRS:
        v = cshift_pull(x, d)
        t0, t1 = phase_half[d] * v[..., 0], phase_half[d] * v[..., 1]
        c01, c10 = offdiag[d]
        acc0 = acc0 - w * t0 + c01 * t1
        acc1 = acc1 - w * t1 + c10 * t0
    return torch.stack([acc0, acc1], dim=-1)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

# x's layout per kind: "interleaved" (2, Y, Xh, 2), "split" (2, 2, Yh, Xh,
# 2), "rhs" (nrhs, 2, Y, Xh, 2).
_LAYOUTS = {"interleaved": "(2, Y, Xh, 2)", "split": "(2, 2, Yh, Xh, 2)",
            "rhs": "(nrhs, 2, Y, Xh, 2)"}


def _check(name: str, phase, x, layout: str = "interleaved"):
    """The kernels' input checks; returns the integers the launch function
    takes before its scalars: (Y, Xh), (Yh, Xh) in the split layout,
    (nrhs, Y, Xh) with an rhs axis."""
    if x.dtype != torch.complex64 or phase.dtype != torch.complex64:
        raise TypeError(f"{name} needs complex64 phase and x, got "
                        f"{phase.dtype} and {x.dtype}")
    lead = {"interleaved": (2,), "split": (2, 2), "rhs": (2,)}[layout]
    skip = 1 if layout == "rhs" else 0           # the rhs axis
    if (x.ndim != skip + len(lead) + 3
            or tuple(x.shape[skip:skip + len(lead)]) != lead
            or x.shape[-1] != 2 or (skip and x.shape[0] < 1)):
        raise ValueError(f"{name}: x must be {_LAYOUTS[layout]}, got "
                         f"{tuple(x.shape)}")
    rows, xh_len = x.shape[-3], x.shape[-2]
    if tuple(phase.shape) != (4,) + tuple(x.shape[skip:-1]):
        raise ValueError(f"{name}: phases must be "
                         f"{(4,) + tuple(x.shape[skip:-1])}, got "
                         f"{tuple(phase.shape)}")
    if phase.device != x.device:
        raise ValueError(f"{name}: phases on {phase.device}, x on "
                         f"{x.device}")
    if not (x.is_contiguous() and phase.is_contiguous()):
        raise ValueError(f"{name} needs contiguous phase and x")
    if x.is_conj() or phase.is_conj():
        raise ValueError(f"{name} needs resolved (non-lazy-conj) tensors")
    # The kernels' largest index within a field is the phase's,
    # (3 * 2 + 1) * half + rem < 8 * Y * Xh = 2 x.numel() of one field, in
    # 32-bit ints (the rhs kernel offsets fields in 64 bits).
    if 2 * (x[0].numel() if skip else x.numel()) > 2 ** 31:
        raise ValueError(f"{name}: lattice {tuple(x.shape)} too large for "
                         f"the kernel's 32-bit indices")
    return (x.shape[0], rows, xh_len) if skip else (rows, xh_len)


def _launch(wrapper, launcher: str, phase, x, dims, *scalars):
    """Launch one kernel on x's device and its current stream; ``dims``
    are ``_check``'s integers."""
    name = wrapper.__name__
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.data_ptr() % 16 or phase.data_ptr() % 8:
        raise ValueError(f"{name} needs 16-byte aligned x and 8-byte "
                         f"aligned phases")
    build_wilson()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _LIB[launcher](phase.data_ptr(), x.data_ptr(), out.data_ptr(),
                             *dims, *map(float, scalars), stream)
    if err != 0:
        raise RuntimeError(f"{name}'s launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def wilson_r1_apply(phase_half, x, alpha: float):
    """Rank-1 Wilson apply (w = 1); the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    dims = _check("wilson_r1_apply", phase_half, x)
    if x.device.type == "cpu":
        return wilson_r1_apply_plain(phase_half, x, alpha)
    return _launch(wilson_r1_apply, "wilson_r1_launch", phase_half, x, dims,
                   alpha)


def wilson_r1_rhs_apply(phase_half, x, alpha: float):
    """Rank-1 Wilson apply (w = 1) on nrhs fields x (nrhs, 2, Y, Xh, 2)
    with one set of phases (4, 2, Y, Xh), each field's result bit for bit
    ``wilson_r1_apply``'s; the CUDA kernel for CUDA tensors, the plain twin
    (``wilson_r1_apply_plain`` over the leading axis) for CPU tensors."""
    dims = _check("wilson_r1_rhs_apply", phase_half, x, "rhs")
    if x.device.type == "cpu":
        return wilson_r1_apply_plain(phase_half, x, alpha)
    return _launch(wilson_r1_rhs_apply, "wilson_r1_rhs_launch", phase_half,
                   x, dims, alpha)


def wilson_phase_apply(phase_half, x, w: float, alpha: float):
    """Wilson apply at any Wilson coefficient w, alpha = 2w + mass; the
    CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    dims = _check("wilson_phase_apply", phase_half, x)
    if x.device.type == "cpu":
        return wilson_phase_apply_plain(phase_half, x, w, alpha)
    return _launch(wilson_phase_apply, "wilson_phase_launch", phase_half, x,
                   dims, w, alpha)


def wilson_split_apply(phase_split, x_split, alpha: float):
    """Rank-1 Wilson apply (w = 1) in the split layout; the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
    dims = _check("wilson_split_apply", phase_split, x_split, "split")
    if x_split.device.type == "cpu":
        return wilson_split_apply_plain(phase_split, x_split, alpha)
    return _launch(wilson_split_apply, "wilson_r1_split_launch", phase_split,
                   x_split, dims, alpha)


# wrapper: (C launcher, twin, x's layout)
_BINDINGS = {
    wilson_r1_apply: ("wilson_r1_launch", wilson_r1_apply_plain,
                      "interleaved"),
    wilson_r1_rhs_apply: ("wilson_r1_rhs_launch", wilson_r1_apply_plain,
                          "rhs"),
    wilson_phase_apply: ("wilson_phase_launch", wilson_phase_apply_plain,
                         "interleaved"),
    wilson_split_apply: ("wilson_r1_split_launch", wilson_split_apply_plain,
                         "split")}


def bind_wilson(wrapper, phase, x_shape, *scalars):
    """``wrapper``'s apply (``wilson_r1_apply``, ``wilson_r1_rhs_apply``,
    ``wilson_phase_apply`` or ``wilson_split_apply``) for the fixed phases
    ``phase``, x of shape
    ``x_shape`` and the wrapper's scalar arguments (alpha; w and alpha for
    ``wilson_phase_apply``), with the wrapper's checks made here, once. The
    returned function takes a contiguous, 16-byte aligned complex64 x of
    that shape on ``phase``'s device (checked in one expression): the
    kernel on the current stream (counted in ``wrapper.launches``) for
    CUDA phases, the twin for CPU ones."""
    launcher, twin, layout = _BINDINGS[wrapper]
    name = wrapper.__name__
    takes = "w and alpha" if wrapper is wilson_phase_apply else "alpha"
    if len(scalars) != len(takes.split(" and ")):
        raise TypeError(f"{name} takes {takes}, got {len(scalars)} "
                        f"scalar(s)")
    scalars = tuple(map(float, scalars))
    x_shape, device = torch.Size(x_shape), phase.device
    probe = torch.empty(x_shape, dtype=torch.complex64, device=device)
    dims = _check(name, phase, probe, layout)

    align = 16 if device.type == "cuda" else 1   # the kernels' float4 loads

    def check(x):
        if (x.shape != x_shape or x.device != device
                or x.dtype != torch.complex64 or not x.is_contiguous()
                or x.is_conj() or x.data_ptr() % align):
            raise ValueError(
                f"{name} was bound to x of shape {tuple(x_shape)} on "
                f"{device} (contiguous complex64, {align}-byte aligned), got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")

    if device.type == "cpu":
        def apply(x):
            check(x)
            return twin(phase, x, *scalars)
        return apply
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if phase.data_ptr() % 8:
        raise ValueError(f"{name} needs 8-byte aligned phases")
    build_wilson()
    fn = _LIB[launcher]

    def apply(x):
        check(x)
        if device.index != torch.cuda.current_device():
            with torch.cuda.device(device):
                return apply(x)
        out = torch.empty_like(x)
        # phase.data_ptr() per call: the closure keeps the phases alive
        err = fn(phase.data_ptr(), x.data_ptr(), out.data_ptr(), *dims,
                 *scalars, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}'s launch failed: CUDA error {err}")
        wrapper.launches += 1
        return out
    return apply


def _parity_stride(name: str, what: str, t, p_ax: int, unit: int) -> int:
    """The distance between the two parity halves of ``t`` (parity axis
    ``p_ax``), in sites of ``unit`` elements; the axes after the parity
    axis must be dense."""
    step = 1
    for ax in range(t.ndim - 1, p_ax, -1):
        if t.shape[ax] > 1 and t.stride(ax) != step:
            step = -1
            break
        step *= t.shape[ax]
    if step < 0 or t.stride(p_ax) % unit or t.stride(p_ax) < step:
        raise ValueError(f"{name}: {what} must be dense below its parity "
                         f"axis (a block of its own or a view of whole "
                         f"rows), got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")
    return t.stride(p_ax) // unit


def _field_stride(name: str, what: str, t, ps: int, unit: int) -> int:
    """The distance between two fields of ``t`` (rhs axis 0), in sites of
    ``unit`` elements: at least two parity strides ``ps``, so that no two
    fields overlap; 0 for one field."""
    if t.shape[0] == 1:
        return 0
    fs, rem = divmod(t.stride(0), unit)
    if rem or fs < 2 * ps:
        raise ValueError(f"{name}: the fields of {what} overlap or are not "
                         f"whole sites apart, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return fs


def _halo_args(name: str, phase_loc, x_loc, top, bot, out=None):
    """The slab kernel's input checks; returns the launch function's
    integers: nrhs, Y_loc, Xh, the parity strides of phase, x, the halos
    and out, and the field strides of x, the halos and out, in sites. One
    field without a leading rhs axis is nrhs 1 at field strides 0.
    ``out=None`` stands for a new dense tensor."""
    tensors = {"phase": phase_loc, "x": x_loc, "top": top, "bot": bot}
    if out is not None:
        tensors["out"] = out
    for what, t in tensors.items():
        if t.dtype != torch.complex64:
            raise TypeError(f"{name} needs complex64 tensors, got "
                            f"{t.dtype} {what}")
        if t.device != x_loc.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on "
                             f"{x_loc.device}")
        if t.is_conj():
            raise ValueError(f"{name} needs resolved (non-lazy-conj) "
                             f"tensors")
    rhs = x_loc.ndim == 5
    if (x_loc.ndim not in (4, 5) or x_loc.shape[-4] != 2
            or x_loc.shape[-1] != 2 or (rhs and x_loc.shape[0] < 1)):
        raise ValueError(f"{name}: x must be (2, Y_loc, Xh, 2) or (nrhs, 2, "
                         f"Y_loc, Xh, 2), got {tuple(x_loc.shape)}")
    lead = tuple(x_loc.shape[:1]) if rhs else ()
    y_loc, xh_len = x_loc.shape[-3], x_loc.shape[-2]
    if y_loc % 2:
        raise ValueError(f"{name}: the slab's row count {y_loc} must be "
                         f"even, so that a slab row's parity is the "
                         f"lattice row's")
    expect = {"phase": (4, 2, y_loc, xh_len), "top": lead + (2, xh_len, 2),
              "bot": lead + (2, xh_len, 2), "out": tuple(x_loc.shape)}
    for what, t in tensors.items():
        if what in expect and tuple(t.shape) != expect[what]:
            raise ValueError(f"{name}: {what} must be {expect[what]}, got "
                             f"{tuple(t.shape)}")
    phase_ps = _parity_stride(name, "phase", phase_loc, 1, 1)
    if phase_loc.stride(0) != 2 * phase_loc.stride(1):
        raise ValueError(f"{name}: the phases' direction stride must be "
                         f"twice their parity stride, got strides "
                         f"{phase_loc.stride()}")
    p_ax = len(lead)
    x_ps, halo_ps, bot_ps = (_parity_stride(name, what, tensors[what], p_ax,
                                            2)
                             for what in ("x", "top", "bot"))
    if bot_ps != halo_ps:
        raise ValueError(f"{name}: top and bot must share one parity "
                         f"stride")
    out_ps = (y_loc * xh_len if out is None
              else _parity_stride(name, "out", out, p_ax, 2))
    strides = [phase_ps, x_ps, halo_ps, out_ps]
    field_strides = (0, 0, 0)
    if rhs:
        x_fs, halo_fs, bot_fs = (_field_stride(name, what, tensors[what], ps,
                                               2)
                                 for what, ps in (("x", x_ps),
                                                  ("top", halo_ps),
                                                  ("bot", halo_ps)))
        if bot_fs != halo_fs:
            raise ValueError(f"{name}: top and bot must share one field "
                             f"stride")
        out_fs = (_field_stride(name, "out", out, out_ps, 2)
                  if out is not None else 0 if lead[0] == 1
                  else 2 * y_loc * xh_len)
        field_strides = (x_fs, halo_fs, out_fs)
    # The kernel's largest index within a field is (3 * 2 + 1) * phase_ps
    # + Y_loc * Xh < 8 * phase_ps, in 32-bit ints; fields are offset in 64
    # bits from field strides passed as 32-bit ints.
    largest = max(strides)
    if 8 * largest > 2 ** 31 or max(field_strides) >= 2 ** 31:
        raise ValueError(f"{name}: slab {tuple(x_loc.shape)} with parity "
                         f"strides up to {largest} sites is too large for "
                         f"the kernel's 32-bit indices")
    if x_loc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x_loc.device}")
    return (lead[0] if rhs else 1, y_loc, xh_len, *strides, *field_strides)


def _halo_launch(name: str, ptrs, ints, alpha: float, stream: int):
    """Launch the slab kernel on raw addresses (phase, x, top, bot, out),
    each checked by ``_halo_args`` (whose integers ``ints`` are) and for
    alignment by the caller."""
    err = _LIB["wilson_r1_halo_rhs_launch"](*ptrs, *ints, alpha, stream)
    if err != 0:
        raise RuntimeError(f"{name}'s launch failed: CUDA error {err}")
    wilson_r1_halo_apply.launches += 1


def wilson_r1_halo_apply(phase_loc, x_loc, top, bot, alpha: float,
                         out=None):
    """Rank-1 Wilson apply (w = 1) on a y-slab: x_loc (2, Y_loc, Xh, 2)
    with Y_loc even, phase_loc (4, 2, Y_loc, Xh), halo rows top and bot
    (2, Xh, 2); or nrhs fields, x_loc (nrhs, 2, Y_loc, Xh, 2) and halos
    (nrhs, 2, Xh, 2), with one set of phases, in one launch, field b bit
    for bit the apply to field b alone. The CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors. Each argument may be a view of whole
    rows of a larger field. ``out`` names where the result goes (such a
    view too); by default a new tensor."""
    name = "wilson_r1_halo_apply"
    ints = _halo_args(name, phase_loc, x_loc, top, bot, out)
    if x_loc.device.type == "cpu":
        res = wilson_r1_halo_apply_plain(phase_loc, x_loc, top, bot, alpha)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(x_loc.shape, dtype=x_loc.dtype,
                          device=x_loc.device)
    ptrs = [t.data_ptr() for t in (phase_loc, x_loc, top, bot, out)]
    if ptrs[0] % 8 or any(p % 16 for p in ptrs[1:]):
        raise ValueError(f"{name} needs 16-byte aligned x, halos and out "
                         f"and 8-byte aligned phases")
    build_wilson()
    with torch.cuda.device(x_loc.device):
        _halo_launch(name, ptrs, ints, float(alpha),
                     torch.cuda.current_stream(x_loc.device).cuda_stream)
    return out


def bind_halo(phase_loc, alpha: float, own_halos: bool,
              nrhs: int | None = None):
    """``wilson_r1_halo_apply`` for one slab with fixed contiguous phases
    (4, 2, Y_loc, Xh), with the wrapper's checks made here, once: returns
    apply(x, top, bot) for a contiguous complex64 x (2, Y_loc, Xh, 2), or
    with ``nrhs`` (nrhs, 2, Y_loc, Xh, 2), and halo rows (2, Xh, 2), or
    (nrhs, 2, Xh, 2), that are either the slab's own last and first rows,
    ``x[..., -1, :, :]`` and ``x[..., 0, :, :]`` (``own_halos``: a mesh of
    one slab), or dense buffers (what a halo exchange receives). Each call
    checks shapes, strides, types, devices and alignment in one expression
    per tensor and launches (counted in ``wilson_r1_halo_apply.launches``);
    for CPU phases it runs the twin."""
    name = "wilson_r1_halo_apply"
    if not phase_loc.is_contiguous():
        raise ValueError(f"{name}: bind_halo needs contiguous phases")
    if phase_loc.ndim != 4:
        raise ValueError(f"{name}: phases must be (4, 2, Y_loc, Xh), got "
                         f"{tuple(phase_loc.shape)}")
    _, _, y_loc, xh_len = phase_loc.shape
    device, alpha = phase_loc.device, float(alpha)
    lead = () if nrhs is None else (int(nrhs),)
    x_shape = torch.Size(lead + (2, y_loc, xh_len, 2))
    probe = torch.empty(x_shape, dtype=torch.complex64, device=device)
    if own_halos:
        halos = (probe.select(-3, -1), probe.select(-3, 0))
    else:
        halos = tuple(torch.empty(lead + (2, xh_len, 2),
                                  dtype=torch.complex64, device=device)
                      for _ in range(2))
    ints = _halo_args(name, phase_loc, probe, *halos)
    halo_shape, halo_stride = halos[0].shape, halos[0].stride()

    def check(x, top, bot):
        if (x.shape != x_shape or x.device != device
                or x.dtype != torch.complex64 or not x.is_contiguous()
                or x.is_conj()):
            raise ValueError(
                f"{name} was bound to contiguous complex64 x of shape "
                f"{tuple(x_shape)} on {device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
        for t in (top, bot):
            if (t.shape != halo_shape or t.stride() != halo_stride
                    or t.device != device or t.dtype != torch.complex64
                    or t.is_conj()):
                raise ValueError(
                    f"{name} was bound to complex64 halo rows of shape "
                    f"{tuple(halo_shape)} and strides {halo_stride} on "
                    f"{device}, got {t.dtype} {tuple(t.shape)} with "
                    f"strides {t.stride()} on {t.device}")

    if device.type == "cpu":
        def apply(x, top, bot):
            check(x, top, bot)
            return wilson_r1_halo_apply_plain(phase_loc, x, top, bot, alpha)
        return apply
    if phase_loc.data_ptr() % 8:
        raise ValueError(f"{name} needs 8-byte aligned phases")
    build_wilson()

    def apply(x, top, bot):
        check(x, top, bot)
        out = torch.empty_like(x)
        # phase_loc.data_ptr() per call: the closure keeps the phases alive
        ptrs = (phase_loc.data_ptr(), x.data_ptr(), top.data_ptr(),
                bot.data_ptr(), out.data_ptr())
        if ptrs[1] % 16 or ptrs[2] % 16 or ptrs[3] % 16:
            raise ValueError(f"{name} needs 16-byte aligned x and halos")
        with torch.cuda.device(device):
            _halo_launch(name, ptrs, ints, alpha,
                         torch.cuda.current_stream(device).cuda_stream)
        return out
    return apply


def bind_halo_slabs(phase, ny: int, alpha: float, nrhs: int | None = None):
    """The rank-1 apply on a whole field cut into ``ny`` y-slabs, with
    ``wilson_r1_halo_apply``'s checks made here, once: returns apply(x)
    for a contiguous complex64 x (2, Y, Xh, 2), or with ``nrhs`` (nrhs,
    2, Y, Xh, 2), on ``phase``'s device. Each slab is one launch (counted
    in ``wilson_r1_halo_apply.launches``) on rows of x in place, all
    fields at once, its halos the neighbouring slabs' edge rows (its own
    at ny = 1), its result written into its rows of one output field:
    nothing is copied. For CPU tensors the twin per slab."""
    name = "wilson_r1_halo_apply"
    phase = phase.contiguous()
    _, _, y_len, xh_len = phase.shape
    if y_len % ny:
        raise ValueError(f"{name}: Y={y_len} does not tile {ny} slabs")
    y_loc = y_len // ny
    lead = () if nrhs is None else (int(nrhs),)
    x_shape, device = lead + (2, y_len, xh_len, 2), phase.device
    alpha = float(alpha)

    def slab(x, out, y0):
        return (phase[:, :, y0:y0 + y_loc], x.narrow(-3, y0, y_loc),
                x.select(-3, y0 - 1), x.select(-3, (y0 + y_loc) % y_len),
                out.narrow(-3, y0, y_loc))

    probe = torch.empty(x_shape, dtype=torch.complex64, device=device)
    launches = []   # per slab: its integers, its tensors' byte offsets
    for y0 in range(0, y_len, y_loc):
        views = slab(probe, probe, y0)
        ints = _halo_args(name, *views)
        base = (phase.data_ptr(),) + (probe.data_ptr(),) * 4
        launches.append((ints, [v.data_ptr() - b
                                for v, b in zip(views, base)]))

    def check(x):
        if (tuple(x.shape) != x_shape or x.device != device
                or x.dtype != torch.complex64 or not x.is_contiguous()
                or x.is_conj()):
            raise ValueError(f"{name} was bound to contiguous complex64 x "
                             f"of shape {x_shape} on {device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")

    if device.type == "cpu":
        def apply(x):
            check(x)
            out = torch.empty_like(x)
            for y0 in range(0, y_len, y_loc):
                *args, out_loc = slab(x, out, y0)
                out_loc.copy_(wilson_r1_halo_apply_plain(*args, alpha))
            return out
        return apply

    build_wilson()

    def apply(x):
        check(x)
        out = torch.empty_like(x)
        bases = (phase.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                 out.data_ptr())
        if bases[0] % 8 or bases[1] % 16 or bases[4] % 16:
            raise ValueError(f"{name} needs 16-byte aligned x and out and "
                             f"8-byte aligned phases")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for ints, offsets in launches:
                _halo_launch(name, [b + o for b, o in zip(bases, offsets)],
                             ints, alpha, stream)
        return out
    return apply


wilson_r1_apply.launches = 0
wilson_r1_rhs_apply.launches = 0
wilson_r1_halo_apply.launches = 0
wilson_phase_apply.launches = 0
wilson_split_apply.launches = 0
