"""Device-alone timings of the generic stencil kernels K4 and K5 against
the designs they were chosen over, on one CUDA card.

    python -m qmg_tpu_torch.stencil_bench [--old-source PATH] [--ptxas]

For K4 (interleaved layout) and K5 (split layout) at every nc in
``SUPPORTED_NC``, with complex64 and bf16 channels, at shapes whose
compulsory bytes exceed the card's 50 MB L2 (nc 1 and 2 at 2048^2, nc 4
at 1024^2, nc 8 at 512^2, nc 16 at 256^2) and at the smaller shapes of the
port's paths (nc 1 at 512^2, nc 8 and 16 at 128^2, the domain-wall
operator's), it times on the device alone (100 launches captured in one
CUDA graph, replayed 5 times between CUDA events):

  (a) ``--old-source PATH``: another build of ``csrc/dslash.cu`` with the
      same C entries (e.g. the source before the redesign: one thread an
      output row at nc >= 4, a site at nc <= 2, 8-byte loads, 256-thread
      blocks);
  (b) K6's kernel body on a streaming grid, through K6's own entries
      (``dslash_small_interleaved_launch``, ``dslash_small_launch``): the
      lane split with 16-byte loads from device memory;
  (k) K4 / K5 as the port binds them (``bind_apply``).

Each variant's output is held to the plain twin (relative error <= 1e-5),
first at small shapes (16x8, 64x48, 10x6, 2x2), then at each timed one.
The variants run in turns, a b k then k b a, and the line gives both
times, us, beside the bound (``apply_bytes`` / 3.35 TB/s). ``--ptxas``
prints nvcc's register and spill report of every K4 / K5 kernel
instantiation of the sources. Every line names the card and its power
limit. No path of the port uses this module.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys

import torch

from . import dslash_kernel as dk
from .cuda_build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc

TOL = 1e-5
REPS, REPLAYS = 100, 5
# (nc, Y, Xh): streaming shapes (>= 100 MB compulsory in complex64), then
# the smaller shapes of the port's paths.
STREAM_SHAPES = ((1, 2048, 1024), (2, 2048, 1024), (4, 1024, 512),
                 (8, 512, 256), (16, 256, 128))
PATH_SHAPES = ((1, 512, 256), (8, 128, 64), (16, 128, 64))


# --- timing ---

def graph_us(fn):
    """Device us per call of ``fn``: REPS calls in one CUDA graph, replayed
    REPLAYS times between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / (REPS * REPLAYS)


def nvcc_build(src, tag, extra=()):
    """Build ``src`` with the port's nvcc flags (and ``extra``) into the
    build directory; returns (library path, nvcc's standard error)."""
    digest = hashlib.sha256(" ".join(extra).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    digest = digest.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{tag}-{digest}.so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, *extra, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return out, proc.stderr


def ptxas_report(src, tag):
    """One line per K4/K5 kernel instantiation in ``src``: registers,
    stack, spills (nvcc -Xptxas -v)."""
    _, err = nvcc_build(src, tag + "-v", ("-Xptxas", "-v"))
    lines, name, spill = [], None, ""
    for ln in err.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = m.group(1), ""
            continue
        if name is None or not re.search(r"dslash_\w*kernel", name):
            continue
        if "spill" in ln:
            spill = ln.strip()
        m = re.search(r"Used (\d+) registers.*", ln)
        if m:
            demangled = subprocess.run(["c++filt", name], capture_output=True,
                                       text=True).stdout.strip() or name
            m2 = re.search(r"dslash_\w*kernel<[^>]*>", demangled)
            short = m2.group(0) if m2 else demangled
            lines.append(f"ptxas {tag}: {short}: {m.group(0)}; {spill}")
            name = None
    return lines


def inputs(kind, nc, y_len, xh, bf16, dev):
    gen = torch.Generator(device=dev).manual_seed(1000 * nc + y_len + xh)
    ch = torch.randn((5, 2, y_len, xh, nc, nc), dtype=torch.complex64,
                     device=dev, generator=gen)
    x = torch.randn((2, y_len, xh, nc), dtype=torch.complex64, device=dev,
                    generator=gen)
    if bf16:
        ch = torch.view_as_real(ch).to(torch.bfloat16).contiguous()
    if kind == "K5":
        ch, x = dk.channels_to_split(ch), dk.x_to_split(x)
    return ch, x


def c_call(fn, ch, x, nc, dims):
    """A launcher that allocates out, launches ``fn`` with ``dims`` after
    nc, and returns out."""
    def call():
        out = torch.empty_like(x)
        err = fn(ch.data_ptr(), int(ch.dtype == torch.bfloat16), x.data_ptr(),
                 out.data_ptr(), nc, *dims,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return call


def load_old(path):
    """``path`` built and loaded, its K4 / K5 entries typed as the port's
    (``dslash_kernel.build_dslash``)."""
    lib = ctypes.CDLL(nvcc_build(path, "dslash_old")[0])
    for name in ("dslash_launch", "dslash_split_launch"):
        getattr(lib, name).argtypes = ([ctypes.c_void_p, ctypes.c_int] +
                                       [ctypes.c_void_p] * 2 +
                                       [ctypes.c_int] * 3 +
                                       [ctypes.c_void_p])
        getattr(lib, name).restype = ctypes.c_int
    return lib


def variants(kind, nc, ch, x, libs):
    """{label: callable} of the variants at one case."""
    dk.build_dslash()
    rows, xh = (x.shape[1], x.shape[2]) if kind == "K4" else (x.shape[2],
                                                              x.shape[3])
    split = "" if kind == "K4" else "split_"
    out = {}
    if "old" in libs:
        out["a"] = c_call(getattr(libs["old"], f"dslash_{split}launch"),
                          ch, x, nc, (rows, xh))
    out["b"] = c_call(dk._LIB["dslash_small_interleaved_launch"
                              if kind == "K4" else "dslash_small_launch"],
                      ch, x, nc, (rows, xh))
    bound = dk.bind_apply(dk.dslash_apply if kind == "K4"
                          else dk.dslash_split_apply, ch, x.shape)
    out["k"] = lambda: bound(x)
    return out


def check(label, fn, twin, case):
    got = fn()
    torch.cuda.synchronize()
    err = float((got - twin).abs().max() / twin.abs().max())
    if not err <= TOL:
        raise SystemExit(f"FAIL: variant {label} at {case} disagrees with "
                         f"the twin: {err:.3e}")
    return err


def check_small(libs):
    """Every variant against the twin at small shapes (16x8, 64x48, 10x6,
    2x2), every nc, both coefficient types and layouts, before timing."""
    dev = torch.device("cuda", 0)
    n = 0
    for y_len, xh in ((8, 8), (48, 32), (6, 5), (2, 1)):
        for nc in dk.SUPPORTED_NC:
            for kind in ("K4", "K5"):
                for bf16 in (False, True):
                    ch, x = inputs(kind, nc, y_len, xh, bf16, dev)
                    twin = (dk.dslash_apply_plain if kind == "K4"
                            else dk.dslash_split_apply_plain)(ch, x)
                    for label, fn in variants(kind, nc, ch, x, libs).items():
                        check(label, fn, twin, (kind, nc, y_len, xh, bf16))
                        n += 1
    print(f"small shapes: {n} variant cases within {TOL} of the twin",
          flush=True)


def case_line(kind, nc, y_len, xh, bf16, libs, card):
    dev = torch.device("cuda", 0)
    ch, x = inputs(kind, nc, y_len, xh, bf16, dev)
    twin = (dk.dslash_apply_plain if kind == "K4"
            else dk.dslash_split_apply_plain)(ch, x)
    case = f"{kind} nc={nc} {2 * xh}x{y_len} {'bf16' if bf16 else 'c64'}"
    fns = variants(kind, nc, ch, x, libs)
    errs = {k: check(k, f, twin, case) for k, f in fns.items()}
    del twin
    times = {k: [] for k in fns}
    for k in list(fns) + list(reversed(fns)):
        times[k].append(graph_us(fns[k]))
    bytes_moved = dk.apply_bytes(nc, 2 * y_len * xh,
                                 torch.bfloat16 if bf16 else None)
    bound_us = bytes_moved / dk.HBM_BYTES_S * 1e6
    parts = [f"({k}) {ts[0]:.2f} / {ts[1]:.2f} us ({bound_us / min(ts):.0%},"
             f" err {errs[k]:.1e})" for k, ts in times.items()]
    print(f"{case}: " + "; ".join(parts) + f"; bound {bound_us:.2f} us "
          f"({bytes_moved / 1e6:.1f} MB); {card}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-source", help="another dslash.cu with the same "
                    "K4/K5 entries: variant (a)")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stencil_bench needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    sources = {"new": os.path.join(CSRC_DIR, dk.SOURCE)}
    if args.old_source:
        sources["old"] = args.old_source
    if args.ptxas:
        for tag, src in sources.items():
            for line in ptxas_report(src, tag):
                print(line, flush=True)
    libs = {"old": load_old(args.old_source)} if args.old_source else {}
    check_small(libs)
    for nc, y_len, xh in STREAM_SHAPES + PATH_SHAPES:
        for kind in ("K4", "K5"):
            for bf16 in (False, True):
                case_line(kind, nc, y_len, xh, bf16, libs, card)
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
