"""The Wilson Dslash kernels of ``csrc/wilson.cu`` and their plain PyTorch
twins (port of qmg_tpu/pallas_wilson.py).

All take the per-direction phases ``phase_half`` = U_d/2 of a Wilson
operator (``wilson_phases``), complex64:

  * ``wilson_r1_apply(phase_half, x, alpha)``: the operator at w = 1 with
    rank-1 projectors (``_wilson_rank1_kernel``); x (2, Y, Xh, 2), phases
    (4, 2, Y, Xh), alpha = 2 + mass;
  * ``wilson_phase_apply(phase_half, x, w, alpha)``: the operator at any
    Wilson coefficient w (``_wilson_kernel``); the same layouts,
    alpha = 2w + mass;
  * ``wilson_split_apply(phase_split, x_split, alpha)``: the rank-1
    arithmetic in the row-parity-split layout (``_wilson_split_kernel``);
    x (2p, 2r, Yh, Xh, 2) as ``dslash_kernel.x_to_split`` makes it, phases
    (4, 2p, 2r, Yh, Xh) from ``wilson_phases_split``.

On a CUDA tensor each wrapper launches its kernel, or raises; on a CPU
tensor it runs its ``*_plain`` twin, which repeats the kernel's
arithmetic. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .cshift import cshift_pull, ALL_DIRS
from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from .cuda_build import build_library
from .dslash_kernel import _rows_to_split, _split_pulls

__all__ = ["wilson_r1_apply", "wilson_r1_apply_plain", "wilson_phase_apply",
           "wilson_phase_apply_plain", "wilson_split_apply",
           "wilson_split_apply_plain", "wilson_phases", "wilson_phases_split",
           "build_wilson"]

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
    """The rank-1 kernel's arithmetic in PyTorch."""
    return _rank1(phase_half, x, [cshift_pull(x, d) for d in ALL_DIRS],
                  alpha)


def wilson_split_apply_plain(phase_split, x_split, alpha: float):
    """The split rank-1 kernel's arithmetic in PyTorch: the same combines
    on the split layout's neighbour pulls."""
    return _rank1(phase_split, x_split, _split_pulls(x_split), alpha)


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

def _check(name: str, phase, x, split: bool = False):
    """The kernels' input checks; returns (Y, or Yh of the split layout,
    and Xh) as the launch functions take them."""
    if x.dtype != torch.complex64 or phase.dtype != torch.complex64:
        raise TypeError(f"{name} needs complex64 phase and x, got "
                        f"{phase.dtype} and {x.dtype}")
    lead = (2, 2) if split else (2,)
    if (x.ndim != len(lead) + 3 or tuple(x.shape[:len(lead)]) != lead
            or x.shape[-1] != 2):
        raise ValueError(f"{name}: x must be "
                         f"{'(2, 2, Yh, Xh, 2)' if split else '(2, Y, Xh, 2)'}"
                         f", got {tuple(x.shape)}")
    rows, xh_len = x.shape[-3], x.shape[-2]
    if tuple(phase.shape) != (4,) + tuple(x.shape[:-1]):
        raise ValueError(f"{name}: phases must be "
                         f"{(4,) + tuple(x.shape[:-1])}, got "
                         f"{tuple(phase.shape)}")
    if phase.device != x.device:
        raise ValueError(f"{name}: phases on {phase.device}, x on "
                         f"{x.device}")
    if not (x.is_contiguous() and phase.is_contiguous()):
        raise ValueError(f"{name} needs contiguous phase and x")
    if x.is_conj() or phase.is_conj():
        raise ValueError(f"{name} needs resolved (non-lazy-conj) tensors")
    # The kernels' largest index is the phase's, (3 * 2 + 1) * half + rem
    # < 8 * Y * Xh = 2 x.numel(), in 32-bit ints.
    if 2 * x.numel() > 2 ** 31:
        raise ValueError(f"{name}: lattice {tuple(x.shape)} too large for "
                         f"the kernel's 32-bit indices")
    return rows, xh_len


def _launch(wrapper, launcher: str, phase, x, rows: int, xh_len: int,
            *scalars):
    """Launch one kernel on x's device and its current stream."""
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
                             rows, xh_len, *map(float, scalars), stream)
    if err != 0:
        raise RuntimeError(f"{name}'s launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def wilson_r1_apply(phase_half, x, alpha: float):
    """Rank-1 Wilson apply (w = 1); the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    rows, xh_len = _check("wilson_r1_apply", phase_half, x)
    if x.device.type == "cpu":
        return wilson_r1_apply_plain(phase_half, x, alpha)
    return _launch(wilson_r1_apply, "wilson_r1_launch", phase_half, x, rows,
                   xh_len, alpha)


def wilson_phase_apply(phase_half, x, w: float, alpha: float):
    """Wilson apply at any Wilson coefficient w, alpha = 2w + mass; the
    CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    rows, xh_len = _check("wilson_phase_apply", phase_half, x)
    if x.device.type == "cpu":
        return wilson_phase_apply_plain(phase_half, x, w, alpha)
    return _launch(wilson_phase_apply, "wilson_phase_launch", phase_half, x,
                   rows, xh_len, w, alpha)


def wilson_split_apply(phase_split, x_split, alpha: float):
    """Rank-1 Wilson apply (w = 1) in the split layout; the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
    yh_len, xh_len = _check("wilson_split_apply", phase_split, x_split,
                            split=True)
    if x_split.device.type == "cpu":
        return wilson_split_apply_plain(phase_split, x_split, alpha)
    return _launch(wilson_split_apply, "wilson_r1_split_launch", phase_split,
                   x_split, yh_len, xh_len, alpha)


wilson_r1_apply.launches = 0
wilson_phase_apply.launches = 0
wilson_split_apply.launches = 0
