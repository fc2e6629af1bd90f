"""Rank-1 Wilson Dslash: the CUDA kernel ``csrc/wilson_r1.cu`` and its
plain PyTorch twin (port of qmg_tpu/pallas_wilson.py::_wilson_rank1_kernel).

``wilson_r1_apply(phase_half, x, alpha)`` computes the Wilson operator at
w = 1 for a field x (2, Y, Xh, 2) complex64, from the per-direction
phases ``phase_half`` (4, 2, Y, Xh) complex64 = U_d/2 (see
``wilson_phases``) and alpha = 2 + mass. On a CUDA tensor it launches the
kernel, or raises; on a CPU tensor it runs ``wilson_r1_apply_plain``.
``wilson_r1_apply.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .cshift import cshift_pull
from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from .cuda_build import build_library

__all__ = ["wilson_r1_apply", "wilson_r1_apply_plain", "wilson_phases",
           "build_wilson_r1"]

SOURCE = "wilson_r1.cu"
_LIB = {}


def build_wilson_r1() -> float:
    """Build (at first use) and load the kernel; returns build seconds."""
    if "fn" in _LIB:
        return 0.0
    lib, seconds = build_library(SOURCE)
    fn = lib.wilson_r1_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIB["lib"], _LIB["fn"] = lib, fn
    return seconds


def wilson_phases(hopping):
    """U_d/2 per direction from built Wilson hopping matrices at w = 1
    (H_d[0, 0] = -U_d / 2): (4, 2, Y, Xh) complex64, contiguous."""
    return (-hopping[..., 0, 0]).to(torch.complex64).contiguous()


def wilson_r1_apply_plain(phase_half, x, alpha: float):
    """The kernel's arithmetic in PyTorch: rank-1 combines of the pulled
    neighbour spinors, one complex multiply per direction."""
    vxp = cshift_pull(x, DIR_XP1)
    vxm = cshift_pull(x, DIR_XM1)
    vyp = cshift_pull(x, DIR_YP1)
    vym = cshift_pull(x, DIR_YM1)
    t_xp = phase_half[DIR_XP1] * (vxp[..., 1] - vxp[..., 0])
    t_xm = phase_half[DIR_XM1] * -(vxm[..., 0] + vxm[..., 1])
    t_yp = phase_half[DIR_YP1] * -(vyp[..., 0] + 1j * vyp[..., 1])
    t_ym = phase_half[DIR_YM1] * -(vym[..., 0] - 1j * vym[..., 1])
    out0 = alpha * x[..., 0] + (t_xp + t_xm) + (t_yp + t_ym)
    out1 = alpha * x[..., 1] + (t_xm - t_xp) + 1j * (t_ym - t_yp)
    return torch.stack([out0, out1], dim=-1)


def _check(phase_half, x):
    if x.dtype != torch.complex64 or phase_half.dtype != torch.complex64:
        raise TypeError(f"wilson_r1_apply needs complex64 phase and x, got "
                        f"{phase_half.dtype} and {x.dtype}")
    if x.ndim != 4 or x.shape[0] != 2 or x.shape[3] != 2:
        raise ValueError(f"x must be (2, Y, Xh, 2), got {tuple(x.shape)}")
    y_len, xh_len = x.shape[1], x.shape[2]
    if tuple(phase_half.shape) != (4, 2, y_len, xh_len):
        raise ValueError(f"phase_half must be (4, 2, {y_len}, {xh_len}), "
                         f"got {tuple(phase_half.shape)}")
    if phase_half.device != x.device:
        raise ValueError(f"phase_half on {phase_half.device}, x on "
                         f"{x.device}")
    if not (x.is_contiguous() and phase_half.is_contiguous()):
        raise ValueError("wilson_r1_apply needs contiguous phase and x")
    if x.is_conj() or phase_half.is_conj():
        raise ValueError("wilson_r1_apply needs resolved (non-lazy-conj) "
                         "tensors")
    # The kernel's largest index is the phase's, (3 * 2 + 1) * half + rem
    # < 8 * Y * Xh, in 32-bit ints.
    if 8 * y_len * xh_len > 2 ** 31:
        raise ValueError(f"lattice (Y={y_len}, Xh={xh_len}) too large for "
                         f"the kernel's 32-bit indices")


def wilson_r1_apply(phase_half, x, alpha: float):
    """Rank-1 Wilson apply; the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors."""
    _check(phase_half, x)
    if x.device.type == "cpu":
        return wilson_r1_apply_plain(phase_half, x, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"wilson_r1_apply: unsupported device {x.device}")
    y_len, xh_len = x.shape[1], x.shape[2]
    if x.data_ptr() % 16 or phase_half.data_ptr() % 8:
        raise ValueError("wilson_r1_apply needs 16-byte aligned x and "
                         "8-byte aligned phases")
    build_wilson_r1()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _LIB["fn"](phase_half.data_ptr(), x.data_ptr(), out.data_ptr(),
                         y_len, xh_len, float(alpha), stream)
    if err != 0:
        raise RuntimeError(f"wilson_r1 kernel launch failed: CUDA error "
                           f"{err}")
    wilson_r1_apply.launches += 1
    return out


wilson_r1_apply.launches = 0
