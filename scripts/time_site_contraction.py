"""Time the plain stencil apply's per-site contraction alone, route by
route, at the shapes the two benchmark cells run.

    python scripts/time_site_contraction.py [--device cuda] [--nrhs 8 1]
        [--only <shape name> ...] [--out <file.json>]

The contraction is ``out[b, s, i] = sum_{t, j} mats[t, s, i, j]
nbrs[t, b, s, j]`` over T stacked terms. Routes:

  * ``broadcast``: the neighbours stacked on a leading term axis, then
    ``(mats * nbrs.unsqueeze(-2)).sum(dim=(0, -1))``, which materialises
    the [T, nrhs, sites, nc, nc] product;
  * ``broadcast_k``: the same formula in the product's layout, ``(A *
    B.unsqueeze(-2)).sum(-1)`` with A (sites, nc, T nc) and B (nrhs,
    sites, T nc): the small-shape route;
  * ``bmm_rows``: A as above, the neighbours stacked next to nc
    (``torch.stack(..., dim=-2)``), one ``torch.bmm`` over a site batch
    axis, B (sites, nrhs, T nc) @ A^T (sites, T nc, nc), written through
    ``out=`` into the (nrhs, sites, nc) field;
  * ``bmm_cols``: A (sites, nc, T nc) @ B^T (sites, T nc, nrhs) into the
    same field through ``out=``;
  * ``einsum``: ``torch.einsum("sik,bsk->bsi", A, B)``;
  * ``hybrid``: the broadcast formula on A viewed as (T, S, nc, nc)
    against the neighbours stacked on a leading term axis;
  * ``hybrid2``: the same operands as [nrhs, S, nc, T, nc], summed over
    its last two axes;
  * ``bmm_real``: ``bmm_cols`` in real arithmetic, A as (S, 2 nc, 2 T nc)
    real blocks.

For each route: device time of the contraction alone (a CUDA graph of
``reps`` calls, CUDA events) and with the neighbour stack, host time a
call (eager, no synchronise), the bytes allocated by one call above its
inputs, the kernels one call launches (``torch.profiler``), and the
largest relative error of its output against the complex128 broadcast.
Complex64, TF32 off (``linalg.pin_full_precision``). Prints one JSON line
a shape and route, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
from qmg_tpu_torch import linalg  # noqa: E402

# (name, site shape, nc, terms): the cells' plain applies, then a sweep
# of colours and terms at 512^2 and at the threshold's neighbourhood.
SWEEP = [(f"sweep.{name}.nc{nc}.t{t}", sites, nc, t)
         for name, sites in (("512sq", (2, 512, 256)),
                             ("64sq", (2, 64, 32)),
                             ("32sq", (2, 32, 16)))
         for nc in (1, 2, 4, 8, 16) for t in (1, 5, 9)]
SHAPES = [
    ("n13.L0.outer.2048sq.nc2.t5", (2, 2048, 1024), 2, 5),
    ("n13.L1.512sq.nc8.t5", (2, 512, 256), 8, 5),
    ("n13.L2.128sq.nc8.t5", (2, 128, 64), 8, 5),
    ("n13.L3.32sq.nc8.t5", (2, 32, 16), 8, 5),
    ("n13.L4.8sq.nc8.t5", (2, 8, 4), 8, 5),
    ("n19.L0.schur.2048sq.nc2.t9", (2048, 1024), 2, 9),
    ("n19.L1.schur.512sq.nc8.t9", (512, 256), 8, 9),
    ("n19.L2.schur.128sq.nc8.t9", (128, 64), 8, 9),
    ("n19.L3.schur.32sq.nc8.t9", (32, 16), 8, 9),
    ("n19.L0.half.2048sq.nc2.t4", (2048, 1024), 2, 4),
    ("n19.L1.half.512sq.nc8.t4", (512, 256), 8, 4),
    ("n19.L2.half.128sq.nc8.t4", (128, 64), 8, 4),
]


def _layout(mats):
    """(T, *sites, nc, nc) -> (S, nc, T nc)."""
    t, nc = mats.shape[0], mats.shape[-1]
    return torch.movedim(mats, 0, -2).reshape(-1, nc, t * nc)


def route_broadcast(mats, pulls):
    nbrs = torch.stack(pulls)
    return (mats.unsqueeze(1) * nbrs.unsqueeze(-2)).sum(dim=(0, -1))


def contract_broadcast(mats, nbrs):
    return (mats.unsqueeze(1) * nbrs.unsqueeze(-2)).sum(dim=(0, -1))


def stack_k(pulls):
    """(nrhs, S, nc) pulls -> (nrhs, S, T nc), stacked next to nc."""
    nrhs, s, nc = pulls[0].shape
    flat = [p.reshape(-1, nc) for p in pulls]
    return torch.stack(flat, dim=-2).reshape(nrhs, s, len(pulls) * nc)


def contract_broadcast_k(a, b):
    return (a * b.unsqueeze(-2)).sum(-1)


def contract_bmm_rows(a, b):
    nrhs, s, _ = b.shape
    out = torch.empty((nrhs, s, a.shape[1]), dtype=a.dtype, device=a.device)
    torch.bmm(b.transpose(0, 1), a.transpose(1, 2), out=out.transpose(0, 1))
    return out


def contract_bmm_cols(a, b):
    nrhs, s, _ = b.shape
    out = torch.empty((nrhs, s, a.shape[1]), dtype=a.dtype, device=a.device)
    torch.bmm(a, b.permute(1, 2, 0), out=out.permute(1, 2, 0))
    return out


def contract_einsum(a, b):
    return torch.einsum("sik,bsk->bsi", a, b)


def contract_hybrid(a, nbrs):
    """The broadcast formula on A in the product's layout, viewed as
    (T, S, nc, nc), against the neighbours stacked on a leading axis."""
    t = nbrs.shape[0]
    a4 = torch.movedim(a.unflatten(-1, (t, a.shape[1])), -2, 0)
    return (a4.unsqueeze(1) * nbrs.unsqueeze(-2)).sum(dim=(0, -1))


def contract_hybrid2(a, nbrs):
    """The broadcast formula on A in the product's layout, viewed as (S,
    nc, T, nc), against the neighbours stacked on a leading axis, viewed
    as (nrhs, S, T, nc): the product [nrhs, S, nc, T, nc] summed over its
    last two axes."""
    t, nrhs, s, nc = nbrs.shape
    a4 = a.view(s, nc, t, nc)
    return (a4 * nbrs.permute(1, 2, 0, 3).unsqueeze(-3)).sum(dim=(-2, -1))


def real_layout(a):
    """(S, nc, K) complex -> (S, 2 nc, 2 K) real: [[re, -im], [im, re]]
    blocks, so that a real product with view_as_real operands is the
    complex one."""
    re, im = a.real, a.imag
    top = torch.stack([re, -im], dim=-1)          # (S, nc, K, 2)
    bot = torch.stack([im, re], dim=-1)
    return torch.stack([top, bot], dim=-3).flatten(-2).flatten(-3, -2)


def contract_bmm_real(ar, b):
    nrhs, s, k = b.shape
    nc2 = ar.shape[1]
    br = torch.view_as_real(b).reshape(nrhs, s, 2 * k)
    out = torch.empty((nrhs, s, nc2), dtype=ar.dtype, device=ar.device)
    torch.bmm(ar, br.permute(1, 2, 0), out=out.permute(1, 2, 0))
    return torch.view_as_complex(out.unflatten(-1, (nc2 // 2, 2)))


ROUTES = {
    "broadcast": None,
    "einsum": contract_einsum,
    "broadcast_k": contract_broadcast_k,
    "bmm_rows": contract_bmm_rows,
    "bmm_cols": contract_bmm_cols,
    "hybrid": None,
    "hybrid2": None,
    "bmm_real": None,
}


def _graph_ms(fn, reps):
    """Device ms a call: a CUDA graph of ``reps`` calls, replayed."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / reps
        best = ms if best is None else min(best, ms)
    del g
    torch.cuda.synchronize()
    return best


def _host_us(fn, reps, device):
    for _ in range(3):
        fn()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    if device == "cuda":
        torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def _kernels(fn):
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(names), sorted(set(n[:60] for n in names))


def _extra_bytes(fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    del out
    return extra


def run_shape(name, sites, nc, terms, nrhs, device, routes):
    gen = torch.Generator(device="cpu").manual_seed(20)
    s = 1
    for d in sites:
        s *= d
    k = terms * nc

    def rnd(*shape):
        return torch.complex(torch.randn(shape, generator=gen),
                             torch.randn(shape, generator=gen)).to(device)

    mats = rnd(terms, s, nc, nc)                  # (T, S, nc, nc)
    pulls = [rnd(nrhs, s, nc) for _ in range(terms)]
    a = _layout(mats)
    b = stack_k(pulls)
    nbrs0 = torch.stack(pulls)
    # The complex128 oracle, built term by term to bound its memory.
    want = torch.zeros((nrhs, s, nc), dtype=torch.complex128, device=device)
    for t in range(terms):
        want += (mats[t].to(torch.complex128).unsqueeze(0)
                 * pulls[t].to(torch.complex128).unsqueeze(-2)).sum(-1)
    wnorm = float(want.abs().max())
    big = terms * nrhs * s * nc * nc * 8 > 2 ** 28
    reps = 5 if big else (20 if s >= 8192 else 200)
    lines = []
    for route in routes:
        if (route in ("broadcast", "broadcast_k", "hybrid", "hybrid2")
                and terms * nrhs * s * nc * nc * 8 > 16e9):
            continue
        if route == "broadcast":
            contract = lambda: contract_broadcast(mats, nbrs0)   # noqa: E731
            whole = lambda: route_broadcast(mats, pulls)         # noqa: E731
        elif route == "hybrid":
            contract = lambda: contract_hybrid(a, nbrs0)         # noqa: E731
            whole = (lambda: contract_hybrid(              # noqa: E731
                a, torch.stack(pulls)))
        elif route == "hybrid2":
            contract = lambda: contract_hybrid2(a, nbrs0)        # noqa: E731
            whole = (lambda: contract_hybrid2(             # noqa: E731
                a, torch.stack(pulls)))
        elif route == "bmm_real":
            ar = real_layout(a)
            contract = lambda: contract_bmm_real(ar, b)          # noqa: E731
            whole = (lambda: contract_bmm_real(            # noqa: E731
                ar, stack_k(pulls)))
        else:
            fn = ROUTES[route]
            contract = (lambda fn=fn: fn(a, b))
            whole = (lambda fn=fn: fn(a, stack_k(pulls)))
        got = contract()
        err = float((got.to(torch.complex128) - want).abs().max()) / wnorm
        del got
        line = {"shape": name, "sites": s, "nc": nc, "terms": terms,
                "nrhs": nrhs, "route": route, "rel_err_vs_c128": err,
                "product_bytes": terms * nrhs * s * nc * nc * 8,
                "compulsory_bytes": (s * nc * k + nrhs * s * k
                                     + nrhs * s * nc) * 8}
        if device == "cuda":
            line["contract_ms"] = _graph_ms(contract, reps)
            line["with_stack_ms"] = _graph_ms(whole, reps)
            line["host_us"] = _host_us(whole, reps, device)
            line["extra_bytes"] = _extra_bytes(contract)
            line["kernels"], line["kernel_names"] = _kernels(whole)
        else:
            line["host_us"] = _host_us(whole, 3, device)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--nrhs", type=int, nargs="+", default=[8, 1])
    p.add_argument("--only", nargs="*", default=None)
    p.add_argument("--routes", nargs="*", default=list(ROUTES))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    linalg.pin_full_precision()
    head = {"device": args.device}
    if args.device == "cuda":
        head["name"] = torch.cuda.get_device_name(0)
        head["torch"] = torch.__version__
        try:
            head["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            head["nvidia_smi"] = repr(e)
    print(json.dumps(head), flush=True)
    lines = [head]
    for name, sites, nc, terms in SHAPES + SWEEP:
        if args.only and name not in args.only:
            continue
        for nrhs in args.nrhs:
            lines += run_shape(name, sites, nc, terms, nrhs, args.device,
                               args.routes)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
