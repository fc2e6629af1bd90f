"""Stencil-apply benchmark (the port's counterpart of ``bench.py --mode
dslash``).

    python -m qmg_tpu_torch.dslash --size 2048 --kernel matrix --iters 400

Builds bench.py's operator - the Wilson coefficients of
``gauss_gauge_u1`` at beta = 6 from ``QMGRandom(1337)`` with m = -0.075
(``--wilson-coeff`` w, default 1) and the gaussian start vector of the same
stream - or, with ``--nc 8``,
random coarse-like coefficients (gaussian clover and hopping, shift
-0.075, the way tests/test_pallas_dslash.py makes them). It then times
``--iters`` steps of the renormalised chain x <- M x / |M x| with CUDA
events, through one apply:

  wilson-r1     the rank-1 Wilson kernel (nc = 2, w = 1 only); with
                ``--shards NY`` the slab kernel on NY y-slabs of the
                lattice, held in this process (one launch per slab, the
                neighbouring slabs' edge rows as halos);
  wilson-phase  the Wilson kernel for any w (nc = 2; bench.py's ``phase``);
  wilson-split  the rank-1 kernel in the row-parity-split layout (nc = 2,
                w = 1; bench.py's ``phase-split``);
  matrix     the generic stencil kernel, interleaved layout (K4);
  split      the same in the row-parity-split layout (K5);
  small      the small-lattice kernel (K6) through its interleaved entry,
             the one the solve applies (refuses lattices it cannot take);
  small-split  K6 through its split-layout entry, the TPU kernel's layout;
  plain      the plain PyTorch apply (``stencil.apply_M``).

Every kernel is applied as the solve applies it: bound once to its fixed
arguments (``wilson_kernel.bind_wilson``, ``dslash_kernel.bind_apply``), so
that a chain step pays the checks of x only.

It prints us per apply (one chain step: the apply and the
renormalisation, as bench.py times it), the effective GB/s on bench.py's
byte count per step - (nc^2 + 4 nc^2 + 2 nc) * 8 B per site for the
apply (the coefficients at 4 B per complex entry with ``--coeff-dtype
bfloat16``, the Wilson kernels' 4 phases at 32 B per site) plus
2 nc * 8 B per site for the renormalisation - its share of the H100's
3.35 TB/s, and the card's name and power limit. A kernel that does not
build or launch raises; there is no fallback to another apply.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .lattice import Lattice2D
from .operators.wilson import Wilson2D
from .rng import QMGRandom
from .stencil import apply_M, make_coeffs
from .wilson_kernel import (wilson_r1_apply, wilson_phase_apply,
                            wilson_split_apply, wilson_phases,
                            wilson_phases_split, bind_wilson)
from .parallel import Mesh
from .shard_dslash import make_sharded_wilson
from .dslash_kernel import (HBM_BYTES_S, stencil_channels,
                            stencil_channels_split, x_to_split, apply_bytes,
                            bind_apply, dslash_apply, dslash_split_apply,
                            dslash_small_apply,
                            dslash_small_interleaved_apply)
from . import u1

MASS = -0.075
WILSON_KINDS = ("wilson-r1", "wilson-phase", "wilson-split")
MATRIX_KINDS = ("matrix", "split", "small", "small-split")
KINDS = WILSON_KINDS + MATRIX_KINDS + ("plain",)


def make_operator(size: int, nc: int, device, wilson_coeff: float = 1.0):
    """(coefficients, x) of the benchmark: Wilson (nc = 2) as bench.py
    builds it (at Wilson coefficient ``wilson_coeff``), or random
    coarse-like coefficients for any other nc."""
    rng = QMGRandom(1337)
    if nc == 2:
        lat = Lattice2D(size, size, 2)
        gauge = u1.gauss_gauge_u1(lat, rng, 6.0)
        coeffs = Wilson2D(lat, MASS, gauge, wilson_coeff,
                          dtype=torch.complex64, device=device).coeffs
    else:
        lat = Lattice2D(size, size, nc)
        cm = Lattice2D(size, size, nc * nc)

        def field():
            return torch.as_tensor(
                rng.gaussian_cv(cm).reshape(lat.cm_shape())).to(
                    device=device, dtype=torch.complex64)

        coeffs = make_coeffs(lat, clover=field(),
                             hopping=torch.stack([field() for _ in range(4)]),
                             shift=MASS, dtype=torch.complex64)
    x = torch.as_tensor(rng.gaussian_cv(lat)).to(device=device,
                                                  dtype=torch.complex64)
    return coeffs, x / torch.linalg.vector_norm(x)


def make_step(kind: str, coeffs, coeff_dtype=None,
              wilson_coeff: float = 1.0, shards: int | None = None):
    """(apply, layout of its x): the apply of one chain step.
    ``wilson_coeff`` is the w that Wilson coefficients were built with
    (the Wilson kernels need it; the others read the coefficients).
    ``shards`` cuts the lattice into that many y-slabs (wilson-r1 only)."""
    if shards is not None and kind != "wilson-r1":
        raise ValueError(f"--shards runs the rank-1 slab kernel: use "
                         f"--kernel wilson-r1, not {kind}")
    if coeff_dtype is not None and kind not in MATRIX_KINDS:
        raise ValueError(f"--coeff-dtype applies to the matrix kernels, "
                         f"not {kind}")
    if kind in WILSON_KINDS:
        w = wilson_coeff
        if coeffs.lat.nc != 2:
            raise ValueError(f"the Wilson kernels need nc = 2 ({kind})")
        if kind != "wilson-phase" and w != 1.0:
            raise ValueError(f"{kind} is a rank-1 kernel and needs w = 1, "
                             f"got {w}: use wilson-phase")
        if shards is not None:
            return (make_sharded_wilson(coeffs, Mesh(shards, 1),
                                        float(np.real(coeffs.shift)), w),
                    "interleaved")
        phase = wilson_phases(coeffs.hopping, w)
        alpha = 2.0 * w + float(np.real(coeffs.shift))
        lat = coeffs.lat
        if kind == "wilson-split":
            return bind_wilson(wilson_split_apply, wilson_phases_split(phase),
                               (2, 2, lat.y_len // 2, lat.xh, 2),
                               alpha), "split"
        if kind == "wilson-r1":
            return bind_wilson(wilson_r1_apply, phase, lat.cv_shape(),
                               alpha), "interleaved"
        return bind_wilson(wilson_phase_apply, phase, lat.cv_shape(), w,
                           alpha), "interleaved"
    if kind in ("matrix", "small"):
        wrapper = (dslash_apply if kind == "matrix"
                   else dslash_small_interleaved_apply)
        return bind_apply(wrapper, stencil_channels(coeffs, coeff_dtype),
                          coeffs.lat.cv_shape()), "interleaved"
    if kind in ("split", "small-split"):
        lat = coeffs.lat
        return bind_apply(dslash_split_apply if kind == "split"
                          else dslash_small_apply,
                          stencil_channels_split(coeffs, coeff_dtype),
                          (2, 2, lat.y_len // 2, lat.xh, lat.nc)), "split"
    if kind == "plain":
        return (lambda v: apply_M(coeffs, v)), "interleaved"
    raise ValueError(f"unknown kernel {kind!r}")


def step_bytes(kind: str, nc: int, volume: int, coeff_dtype=None) -> int:
    """bench.py's byte count of one chain step (apply + renormalisation);
    the Wilson kernels' own: 4 phases instead of 5 nc^2 coefficients."""
    apply = ((4 * 8 + 2 * nc * 8) * volume if kind in WILSON_KINDS
             else apply_bytes(nc, volume, coeff_dtype))
    return apply + 2 * nc * 8 * volume


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def device_line(device) -> str:
    """What a result ran on: the card's name and power limit, or "cpu"."""
    return card_line() if torch.device(device).type == "cuda" else "cpu"


def run(size: int, kind: str, nc: int = 2, coeff_dtype=None,
        iters: int = 400, device="cuda", wilson_coeff: float = 1.0,
        operator=None, shards: int | None = None, warmup: int = 1) -> dict:
    """Time ``iters`` chain steps with CUDA events after ``warmup`` chains
    of the same length; returns the measurements. On the CPU (the tests)
    it only runs the chain and returns its checksum: a CPU time is no
    device metric. ``operator`` is ``make_operator``'s result for the same
    arguments, for callers that run several kinds on one operator."""
    if wilson_coeff != 1.0 and nc != 2:
        raise ValueError("--wilson-coeff applies to the Wilson operator "
                         "(nc = 2)")
    coeffs, x = operator or make_operator(size, nc, device, wilson_coeff)
    apply, layout = make_step(kind, coeffs, coeff_dtype, wilson_coeff,
                              shards)
    v = x_to_split(x) if layout == "split" else x

    def chain(v, n):
        for _ in range(n):
            y = apply(v)
            v = y / torch.linalg.vector_norm(y)
        return v

    if torch.device(device).type != "cuda":
        out = chain(v, iters)
        return {"size": size, "kernel": kind, "nc": nc, "shards": shards,
                "wilson_coeff": wilson_coeff, "iters": iters,
                "checksum": float(out.abs().sum()), "device": "cpu"}
    for _ in range(warmup):
        chain(v, iters)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = chain(v, iters)
    stop.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(stop) * 1e3 / iters  # per chain step
    gbs = (step_bytes(kind, nc, coeffs.lat.volume, coeff_dtype)
           / (us * 1e-6) / 1e9)
    return {"size": size, "kernel": kind, "nc": nc, "shards": shards,
            "wilson_coeff": wilson_coeff,
            "coeff_dtype": str(coeff_dtype or torch.float32).split(".")[-1],
            "iters": iters, "us_per_apply": us, "gbs": gbs,
            "pct_of_hbm": 100.0 * gbs * 1e9 / HBM_BYTES_S,
            "checksum": float(out.abs().sum()),
            "device": torch.cuda.get_device_name(torch.device(device))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--kernel", default="matrix", choices=KINDS)
    p.add_argument("--nc", type=int, default=2)
    p.add_argument("--coeff-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--wilson-coeff", type=float, default=1.0,
                   help="Wilson coefficient w of the nc = 2 operator (the "
                        "rank-1 kernels need 1)")
    p.add_argument("--shards", type=int, default=None, metavar="NY",
                   help="cut the lattice into NY y-slabs (wilson-r1 only)")
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    is_cuda = torch.device(args.device).type == "cuda"
    if is_cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but no CUDA device")
    coeff_dtype = (torch.bfloat16 if args.coeff_dtype == "bfloat16"
                   else None)
    r = run(args.size, args.kernel, args.nc, coeff_dtype, args.iters,
            args.device, args.wilson_coeff, shards=args.shards)
    if is_cuda:
        print(card_line())
        entry = {"small": " (K6, interleaved entry)",
                 "small-split": " (K6, split entry)"}.get(r["kernel"], "")
        print(f"dslash {r['size']}^2 nc{r['nc']} {r['kernel']}{entry}"
              f"{'' if args.shards is None else f' on {args.shards} slabs'} "
              f"({r['coeff_dtype']} coefficients) on {r['device']}: "
              f"{r['us_per_apply']:.2f} us/apply, {r['gbs']:.1f} GB/s = "
              f"{r['pct_of_hbm']:.1f}% of {HBM_BYTES_S / 1e12} TB/s",
              file=sys.stderr)
    print(json.dumps(r))


if __name__ == "__main__":
    main()
