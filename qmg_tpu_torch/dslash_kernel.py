"""Generic distance-1 stencil kernels: the CUDA kernels of
``csrc/dslash.cu``, their coefficient channels and their plain PyTorch
twins (port of qmg_tpu/pallas_dslash.py: K4 ``_dslash_kernel``, K5
``_dslash_split_kernel``, K6 ``_dslash_small_kernel``).

The kernels compute ``stencil.apply_M`` from one channel tensor
``ch = [clover + mass pattern, H_+x, H_+y, H_-x, H_-y]`` (the shifts are
folded into the clover diagonal), as

    out = sum_t ch[t] . v_t,   v = [x, x(s+x), x(s+y), x(s-x), x(s-y)].

Layouts (complex, the ri-plane axis of the TPU kernels is not carried):

  * interleaved (K4, K6): x (2p, Y, Xh, nc), ch (5, 2p, Y, Xh, nc, nc);
  * split (K5, K6): rows stored by y % 2, x (2p, 2r, Yh, Xh, nc) with
    y = 2m + r, ch (5, 2p, 2r, Yh, Xh, nc, nc).

Channels are complex64, or bf16 as a real (..., nc, nc, 2) tensor of the
rounded real and imaginary parts of the complex64 channels; the kernels
and the twins widen bf16 to float32 and accumulate in float32.

Each wrapper (``dslash_apply``, ``dslash_split_apply``,
``dslash_small_apply``, ``dslash_small_interleaved_apply``,
``dslash_small_rhs_apply``) launches its kernel for CUDA tensors, or
raises, and runs its twin for CPU tensors; ``<wrapper>.launches`` counts
kernel launches. K6 has two entries, one per layout: ``dslash_small_apply``
takes the split layout of the TPU kernel,
``dslash_small_interleaved_apply`` the interleaved one that the solve's
fields have, and both count in ``dslash_small_apply.launches``; its third
entry ``dslash_small_rhs_apply`` takes nrhs interleaved fields
(nrhs, 2, Y, Xh, nc) with one set of channels (the batched solve's coarse
levels) and counts in its own ``launches``. The
kernels take nc in ``SUPPORTED_NC``; the wrappers refuse any other nc on
every device. ``bind_apply`` makes a wrapper's checks once for fixed
channels and x shape, for callers that apply one operator many times (the
solve).

K4 and K5 give a thread one output row at nc = 1 and at nc = 8 with
complex64 channels, and take K6's lane split (a thread a lane of an
output row, 16-byte loads) otherwise. On a CUDA device the lane split and
K6 need 16-byte aligned channels and x; a thread a row needs one
element's alignment.

``apply_bytes`` is the kernels' compulsory byte count and ``HBM_BYTES_S``
the card's memory rate; their bound is the one over the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import torch

from .cshift import cshift_pull, ALL_DIRS
from .cuda_build import build_library
from .linalg import stack_terms, stacked_site_matvec
from .stencil import StencilCoeffs, mass_pattern

__all__ = ["SUPPORTED_NC", "HBM_BYTES_S", "stencil_channels",
           "stencil_channels_split", "channels_to_split", "x_to_split",
           "x_from_split", "small_fits", "apply_bytes", "dslash_apply",
           "dslash_split_apply", "dslash_small_apply",
           "dslash_small_interleaved_apply", "dslash_small_rhs_apply",
           "bind_apply",
           "dslash_apply_plain", "dslash_split_apply_plain",
           "dslash_small_apply_plain", "small_grid", "empty_launch",
           "build_dslash"]

SOURCE = "dslash.cu"
SUPPORTED_NC = (1, 2, 4, 8, 16)
# Operand budget of the small-lattice kernel, qmg_tpu's rule
# (pallas_dslash.py:624-634): x + out + clover + hopping <= 14 MiB.
SMALL_MAX_BYTES = 14 * 1024 * 1024
# H100 SXM HBM3 peak, bytes/s (data sheet, at its 700 W power limit).
HBM_BYTES_S = 3.35e12
_LIB = {}


def apply_bytes(nc: int, sites: int, coeff_dtype=None, nrhs: int = 1) -> int:
    """Compulsory bytes of one stencil apply over ``sites`` sites and
    ``nrhs`` fields: the 5 nc^2 channel entries (8 B complex64, 4 B as
    bf16 pairs) read once, each field's x read once and out written once
    (bench.py's byte count at nrhs = 1)."""
    coeff = 4 if coeff_dtype == torch.bfloat16 else 8
    return (5 * nc * nc * coeff + nrhs * 2 * nc * 8) * sites


def build_dslash() -> float:
    """Build (at first use) and load the kernels; returns build seconds."""
    if "lib" in _LIB:
        return 0.0
    lib, seconds = build_library(SOURCE)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    for name, ints in (("dslash_launch", 3), ("dslash_split_launch", 3),
                       ("dslash_small_launch", 3),
                       ("dslash_small_interleaved_launch", 3),
                       ("dslash_small_rhs_launch", 4)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, c_int, ptr, ptr] + [c_int] * ints + [ptr]
        fn.restype = c_int
        _LIB[name] = fn
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.dslash_small_grid.argtypes = [ctypes.c_int] * 4 + [int_p] * 3
    lib.dslash_small_grid.restype = ctypes.c_int
    lib.dslash_alignment.argtypes = [ctypes.c_int] * 2 + [int_p] * 2
    lib.dslash_alignment.restype = ctypes.c_int
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    _LIB["lib"] = lib
    return seconds


# ---------------------------------------------------------------------------
# Channels and layouts.
# ---------------------------------------------------------------------------

def _to_coeff_dtype(ch, coeff_dtype):
    """complex64 channels as themselves, or as bf16 (..., 2) pairs rounded
    (to nearest even) from their float32 real and imaginary parts."""
    if coeff_dtype in (None, torch.float32, torch.complex64):
        return ch.contiguous()
    if coeff_dtype != torch.bfloat16:
        raise ValueError(f"coefficient dtype {coeff_dtype} is not supported "
                         "(float32 or bfloat16)")
    return torch.view_as_real(ch.contiguous()).to(torch.bfloat16)


def stencil_channels(coeffs: StencilCoeffs, coeff_dtype=torch.float32):
    """[clover + mass pattern, H_+x, H_+y, H_-x, H_-y] as one contiguous
    (5, 2, Y, Xh, nc, nc) complex64 tensor, or its bf16 (..., 2) pairs
    (port of pallas_dslash.py::_channels_from_coeffs). A missing clover
    leaves the mass pattern alone."""
    if coeffs.hopping is None:
        raise ValueError("stencil channels need a hopping term")
    clover = mass_pattern(coeffs).to(torch.complex64)
    if coeffs.clover is not None:
        clover = clover + coeffs.clover.to(torch.complex64)
    ch = torch.cat([clover[None], coeffs.hopping.to(torch.complex64)])
    return _to_coeff_dtype(ch, coeff_dtype)


def _rows_to_split(t, y_axis: int):
    """Split the Y axis at ``y_axis`` into (2r, Yh), y = 2m + r."""
    y_len = t.shape[y_axis]
    if y_len % 2:
        raise ValueError(f"the split layout needs even Y, got {y_len}")
    t = t.reshape(t.shape[:y_axis] + (y_len // 2, 2) + t.shape[y_axis + 1:])
    return t.transpose(y_axis, y_axis + 1).contiguous()


def _rows_from_split(t, r_axis: int):
    """Inverse of ``_rows_to_split``: (2r, Yh) at ``r_axis`` -> Y."""
    t = t.transpose(r_axis, r_axis + 1)
    return t.reshape(t.shape[:r_axis] + (-1,) + t.shape[r_axis + 2:])


def x_to_split(x):
    """(2, Y, Xh, nc) -> (2p, 2r, Yh, Xh, nc), contiguous."""
    return _rows_to_split(x, 1)


def x_from_split(xs):
    """(2p, 2r, Yh, Xh, nc) -> (2, Y, Xh, nc)."""
    return _rows_from_split(xs, 1)


def channels_to_split(ch):
    """Interleaved channels (5, 2, Y, Xh, ...) -> split (5, 2p, 2r, Yh,
    Xh, ...), contiguous."""
    return _rows_to_split(ch, 2)


def stencil_channels_split(coeffs: StencilCoeffs, coeff_dtype=torch.float32):
    """``stencil_channels`` in the split layout: (5, 2p, 2r, Yh, Xh, nc,
    nc) complex64, or its bf16 (..., 2) pairs."""
    return channels_to_split(stencil_channels(coeffs, coeff_dtype))


def small_fits(nc: int, y_len: int, xh: int, coeff_dtype=torch.float32):
    """qmg_tpu's eligibility rule for the small-lattice kernel
    (pallas_dslash.py:614-634) without its TPU lane rule: even Y, and
    x + out + clover + hopping at most 14 MiB."""
    if y_len % 2:
        return False
    csize = 2 if coeff_dtype == torch.bfloat16 else 4
    plane = (y_len // 2) * xh
    total = (4 * nc * 2 * plane * 4 * 2
             + (4 + 16) * nc * nc * 2 * plane * csize)
    return total <= SMALL_MAX_BYTES


# ---------------------------------------------------------------------------
# Plain twins.
# ---------------------------------------------------------------------------

def _widen(ch):
    """Channels as complex64: bf16 pairs widened to float32."""
    if ch.dtype == torch.bfloat16:
        return torch.complex(ch[..., 0].float(), ch[..., 1].float())
    return ch


def dslash_apply_plain(ch, x):
    """The K4 kernel's arithmetic in PyTorch: the four neighbours through
    ``cshift_pull`` and one stacked matvec; x may carry leading batch axes
    (``(*batch, 2, Y, Xh, nc)``), the channels broadcast over them."""
    nb = x.ndim - 4
    nbrs = [x] + [cshift_pull(x, d, nb) for d in ALL_DIRS]
    return stacked_site_matvec(stack_terms(_widen(ch)), nbrs)


def _split_pulls(xs):
    """The neighbour pulls [+x, +y, -x, -y] of a split-layout field, as
    torus rolls of the source parity's halves."""
    src = torch.flip(xs, dims=(0,))              # dest q reads parity 1-q
    q = torch.arange(2, device=xs.device)
    direct = (q[:, None] == q[None, :]).reshape(2, 2, 1, 1, 1)  # r == q
    xp = torch.where(direct, src, torch.roll(src, -1, dims=3))
    xm = torch.where(direct, torch.roll(src, 1, dims=3), src)
    s0, s1 = src[:, 0], src[:, 1]
    yp = torch.stack([s1, torch.roll(s0, -1, dims=1)], dim=1)
    ym = torch.stack([torch.roll(s1, 1, dims=1), s0], dim=1)
    return [xp, yp, xm, ym]


def dslash_split_apply_plain(ch, xs):
    """The K5 kernel's arithmetic in PyTorch, in the split layout: half
    r = 0 pulls +-y from half 1 at rows m and m-1, half r = 1 from half 0
    at rows m+1 and m; the +x source is the same column where r == q."""
    return stacked_site_matvec(stack_terms(_widen(ch)),
                               [xs] + _split_pulls(xs))


# K6 computes K5's function in K5's layout and K4's in K4's; its twins are
# theirs.
dslash_small_apply_plain = dslash_split_apply_plain


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def _check(name, ch, x, layout):
    """The checks of x and the channels for x's ``layout``: "interleaved"
    (2, Y, Xh, nc), "split" (2, 2, Yh, Xh, nc) or "rhs" (nrhs, 2, Y, Xh,
    nc), the channels of one field (5, *field, nc)."""
    if x.dtype != torch.complex64:
        raise TypeError(f"{name} needs complex64 x, got {x.dtype}")
    if ch.dtype not in (torch.complex64, torch.bfloat16):
        raise TypeError(f"{name} needs complex64 or bf16 channels, got "
                        f"{ch.dtype}")
    field_ndim = 5 if layout == "split" else 4
    field = tuple(x.shape[1:] if layout == "rhs" else x.shape)
    if (x.ndim != field_ndim + (layout == "rhs")
            or (layout == "rhs" and x.shape[0] < 1)
            or field[0] != 2 or (layout == "split" and field[1] != 2)):
        raise ValueError(f"{name}: x of shape {tuple(x.shape)} is not in "
                         f"the {layout} layout")
    nc = x.shape[-1]
    if nc not in SUPPORTED_NC:
        raise ValueError(f"{name}: nc={nc} is not supported (the kernels "
                         f"are built for nc in {SUPPORTED_NC})")
    expect = (5,) + field + (nc,)
    if ch.dtype == torch.bfloat16:
        expect += (2,)
    if tuple(ch.shape) != expect:
        raise ValueError(f"{name}: channels must be {expect}, got "
                         f"{tuple(ch.shape)}")
    if ch.device != x.device:
        raise ValueError(f"{name}: channels on {ch.device}, x on {x.device}")
    if not (x.is_contiguous() and ch.is_contiguous()):
        raise ValueError(f"{name} needs contiguous channels and x")
    if x.is_conj() or ch.is_conj():
        raise ValueError(f"{name} needs resolved (non-lazy-conj) tensors")
    # The kernels' largest index is the channels', < 5 * 2 * sites * nc^2
    # = 5 nc x.numel() of one field, in 32-bit ints (fields are offset in
    # 64 bits).
    if 5 * nc * math.prod(field) >= 2 ** 31:
        raise ValueError(f"{name}: lattice {tuple(x.shape)} too large for "
                         f"the kernels' 32-bit indices")


def _launcher(wrapper, launcher, ch, x):
    """The C launcher, built at first use, after the device and alignment
    checks of x and the channels."""
    if x.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{x.device}")
    x_align, ch_align = _alignment(wrapper, ch, x.shape[-1])
    if x.data_ptr() % x_align or ch.data_ptr() % ch_align:
        raise ValueError(f"{wrapper.__name__} needs {x_align}-byte aligned "
                         f"x and {ch_align}-byte aligned channels")
    build_dslash()
    return _LIB[launcher]


def _alignment(wrapper, ch, nc):
    """(x's, the channels') alignment in bytes: K6 loads 16 bytes at a
    time; K4 and K5 as their C entry says for nc and the coefficient type
    (16 bytes where they take K6's lanes, one element where a thread
    takes an output row)."""
    if _BINDINGS[wrapper].small:
        return 16, 16
    build_dslash()
    x_align, ch_align = ctypes.c_int(), ctypes.c_int()
    err = _LIB["lib"].dslash_alignment(int(ch.dtype == torch.bfloat16), nc,
                                       ctypes.byref(x_align),
                                       ctypes.byref(ch_align))
    if err != 0:
        raise RuntimeError(f"dslash_alignment failed: CUDA error {err}")
    return x_align.value, ch_align.value


def _run(wrapper, fn, ch, x, dims):
    """Launch ``fn`` on x's device and its current stream, unchecked, and
    count the launch on the wrapper's counter; ``dims`` are the C entry's
    integers after nc."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _run(wrapper, fn, ch, x, dims)
    out = torch.empty_like(x)
    err = fn(ch.data_ptr(), int(ch.dtype == torch.bfloat16), x.data_ptr(),
             out.data_ptr(), x.shape[-1], *dims,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}'s launch failed: CUDA "
                           f"error {err}")
    _BINDINGS[wrapper].counter.launches += 1
    return out


def _launch(wrapper, ch, x):
    binding = _BINDINGS[wrapper]
    return _run(wrapper, _launcher(wrapper, binding.launcher, ch, x), ch, x,
                binding.dims(x.shape))


def dslash_apply(ch, x):
    """K4: the stencil apply in the interleaved layout; the CUDA kernel
    for CUDA tensors, the plain twin for CPU tensors."""
    _check("dslash_apply", ch, x, "interleaved")
    if x.device.type == "cpu":
        return dslash_apply_plain(ch, x)
    return _launch(dslash_apply, ch, x)


def dslash_split_apply(ch, xs):
    """K5: the stencil apply in the split layout."""
    _check("dslash_split_apply", ch, xs, "split")
    if xs.device.type == "cpu":
        return dslash_split_apply_plain(ch, xs)
    return _launch(dslash_split_apply, ch, xs)


def _check_small(name, ch, x, layout):
    nc, xh_len = x.shape[-1], x.shape[-2]
    y_len = 2 * x.shape[2] if layout == "split" else x.shape[-3]
    if not small_fits(nc, y_len, xh_len, ch.dtype):
        raise ValueError(f"{name}: Y={y_len} is odd, or the operands of "
                         f"Y={y_len}, Xh={xh_len}, nc={nc} exceed the small "
                         f"kernel's {SMALL_MAX_BYTES // 2 ** 20} MiB")


def dslash_small_apply(ch, xs):
    """K6 in the split layout: the stencil apply for lattices that
    ``small_fits`` accepts."""
    _check("dslash_small_apply", ch, xs, "split")
    _check_small("dslash_small_apply", ch, xs, "split")
    if xs.device.type == "cpu":
        return dslash_small_apply_plain(ch, xs)
    return _launch(dslash_small_apply, ch, xs)


def dslash_small_interleaved_apply(ch, x):
    """K6 in the interleaved layout (K4's, the solve's own): the same
    kernel with the other row map, the same refusals; its twin is K4's.
    Its launches count in ``dslash_small_apply.launches``."""
    _check("dslash_small_interleaved_apply", ch, x, "interleaved")
    _check_small("dslash_small_interleaved_apply", ch, x, "interleaved")
    if x.device.type == "cpu":
        return dslash_apply_plain(ch, x)
    return _launch(dslash_small_interleaved_apply, ch, x)


def dslash_small_rhs_apply(ch, x):
    """K6 on nrhs interleaved fields x (nrhs, 2, Y, Xh, nc) with one set of
    channels (5, 2, Y, Xh, nc, nc), in one launch whose block row b applies
    field b (each field's block rows read the channels, from L2 after the
    first); field b of the output is bit for bit
    ``dslash_small_interleaved_apply`` on field b. Its twin is K4's over
    the leading axis."""
    _check("dslash_small_rhs_apply", ch, x, "rhs")
    _check_small("dslash_small_rhs_apply", ch, x, "rhs")
    if x.device.type == "cpu":
        return dslash_apply_plain(ch, x)
    return _launch(dslash_small_rhs_apply, ch, x)


dslash_apply.launches = 0
dslash_split_apply.launches = 0
dslash_small_apply.launches = 0
dslash_small_rhs_apply.launches = 0


class _Binding(NamedTuple):
    """What ``bind_apply`` and the wrappers' launches know of a wrapper.
    ``dims`` maps x's shape to the C entry's integers after nc: (rows,
    Xh), rows being Y of the interleaved layout and Yh of the split one;
    then nrhs for the rhs entry."""
    layout: str            # x's layout, as ``_check`` takes it
    launcher: str          # the C entry
    twin: Callable
    dims: Callable
    counter: Callable      # the wrapper whose ``launches`` counts
    small: bool = False    # K6: small_fits' refusal, 16-byte alignment


_BINDINGS = {
    dslash_apply: _Binding("interleaved", "dslash_launch",
                           dslash_apply_plain,
                           lambda shape: (shape[1], shape[2]), dslash_apply),
    dslash_split_apply: _Binding(
        "split", "dslash_split_launch", dslash_split_apply_plain,
        lambda shape: (shape[2], shape[3]), dslash_split_apply),
    dslash_small_apply: _Binding(
        "split", "dslash_small_launch", dslash_small_apply_plain,
        lambda shape: (shape[2], shape[3]), dslash_small_apply, small=True),
    dslash_small_interleaved_apply: _Binding(
        "interleaved", "dslash_small_interleaved_launch", dslash_apply_plain,
        lambda shape: (shape[1], shape[2]), dslash_small_apply, small=True),
    dslash_small_rhs_apply: _Binding(
        "rhs", "dslash_small_rhs_launch", dslash_apply_plain,
        lambda shape: (shape[2], shape[3], shape[0]),
        dslash_small_rhs_apply, small=True)}


def bind_apply(wrapper, ch, x_shape):
    """``wrapper``'s apply for the fixed channels ``ch`` and x of shape
    ``x_shape``, with the wrapper's checks made here, once. The returned
    function takes a contiguous complex64 x of that shape on ``ch``'s
    device, aligned as the kernel needs it (checked in one expression):
    the kernel (counted like the wrapper's own launches) for a CUDA
    ``ch``, the twin for a CPU one."""
    binding = _BINDINGS[wrapper]
    x_shape = torch.Size(x_shape)
    probe = torch.empty(x_shape, dtype=torch.complex64, device=ch.device)
    _check(wrapper.__name__, ch, probe, binding.layout)
    if binding.small:
        _check_small(wrapper.__name__, ch, probe, binding.layout)
    device = ch.device
    x_align = (_alignment(wrapper, ch, x_shape[-1])[0]
               if device.type == "cuda" else 1)

    def check(x):
        if (x.shape != x_shape or x.device != device
                or x.dtype != torch.complex64 or not x.is_contiguous()
                or x.is_conj() or x.data_ptr() % x_align):
            raise ValueError(
                f"{wrapper.__name__} was bound to x of shape "
                f"{tuple(x_shape)} on {device} (contiguous complex64, "
                f"{x_align}-byte aligned), got {x.dtype} {tuple(x.shape)} "
                f"on {x.device}")

    if device.type == "cpu":
        twin = binding.twin

        def apply(x):
            check(x)
            return twin(ch, x)
        return apply
    dims = binding.dims(x_shape)
    fn = _launcher(wrapper, binding.launcher, ch, probe)

    def apply(x):
        check(x)
        return _run(wrapper, fn, ch, x, dims)
    return apply


def small_grid(nc: int, y_len: int, xh_len: int, coeff_dtype=None,
               nrhs: int = 1):
    """(blocks in a block row, threads per block, the card's SMs) of the
    grid that K6 launches on the current CUDA device for ``nrhs`` (2, Y,
    Xh, nc) fields, one block row each, as its launcher sizes it."""
    build_dslash()
    blocks, threads, sms = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _LIB["lib"].dslash_small_grid(
        int(coeff_dtype == torch.bfloat16), nc, 2 * y_len * xh_len,
        nrhs, ctypes.byref(blocks), ctypes.byref(threads),
        ctypes.byref(sms))
    if err != 0:
        raise RuntimeError(f"small_grid failed: CUDA error {err}")
    return blocks.value, threads.value, sms.value


def empty_launch():
    """Launch a kernel that does nothing on the current CUDA stream: the
    card's launch floor, for measurements. No path of the port calls it."""
    build_dslash()
    err = _LIB["lib"].empty_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty_launch failed: CUDA error {err}")
