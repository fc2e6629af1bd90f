#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (qmg_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them (there is no CPU
fallback). Phases, any failure exits non-zero:

  1. environment: torch, CUDA, card, nvcc, and the card's name and power
     limit as nvidia-smi reports them;
  2. build: compile both CUDA sources (csrc/wilson_r1.cu and
     csrc/dslash.cu), one nvcc each, started together;
  3. the rank-1 Wilson kernel vs its plain PyTorch twin on the card at
     16x8, 64x48, 512^2 and 2048^2 (max relative error <= 1e-5), with
     CUDA-event timings of both at 512^2 and 2048^2;
  4. the original path: qmg_tpu_torch.kcycle at 512^2 with the rank-1
     kernel (setup, warm-up solve, timed solve). It must converge, reach
     a true relative residual <= 1e-4 (complex128, exact operator), take
     the kernel (launch count > 0) and match qmg_tpu's outer count +-2;
  5. the generic stencil kernels (K4 matrix, K5 split, K6 small) vs their
     twins (max relative error <= 1e-5), each through its wrapper and
     through the solve's bound apply (``bind_apply``): K4 and K5 at every
     nc they take, f32 and bf16 coefficients, at 16x8 and 64x48, at 2048^2
     nc2 and 512^2 nc2 (the fine levels of phases 7 and 8, f32 and bf16)
     and at 512^2 nc8; K6 at 32^2 nc8, 8^2 nc8, 2x2, 64^2 nc2 and 64x8
     nc16;
  6. CUDA-event timings of each of them (through its wrapper and its
     bound apply) and its twin at its path's shape, beside its bound;
  7. the kernel paths at 2048^2 on one hierarchy: the rank-1 kernel
     (plain coarse levels), fine K4 with K6 on the coarse levels that it
     takes, and fine K5 with the gather coarse apply. Each must converge
     to a true residual <= 1e-4 and launch its kernels in the timed
     solve; the outer counts agree within +-1;
  8. 512^2 with fine K4 and coarse K6, against qmg_tpu's outer count for
     the same options (+-2), and again with bf16 coefficient streams.

The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Outer iterations of qmg_tpu's own solve with bench.py's kcycle config at
# 512^2 (gauss gauge beta 6, seed 1337, m = -0.06, complex64, tol 1e-5),
# measured on the CPU backend with the rank-1 Pallas kernel in interpret
# mode as the fine apply (and again with the jnp fine apply).
JAX_ITERS_512 = 9
# The same, through make_planes_solver(use_pallas_fine=True,
# pallas_kind="matrix", pallas_interpret=True, coarse_apply="small") with
# x64 off: the K4 Pallas kernel in interpret mode on level 0 and the K6
# one on the 32^2 nc8 level (recursive res_sq 2.92e-5).
JAX_ITERS_512_MATRIX_SMALL = 9
KERNEL_TOL = 1e-5
TRUE_RES_BOUND = 1e-4
TIMING_REPS = 100
# H100 SXM data sheet peak at 700 W of float32 (non-tensor core) flop/s;
# the memory rate is qmg_tpu_torch.dslash_kernel.HBM_BYTES_S.
FP32_FLOP_S = 67e12


def check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def tool_line(cmd, pick_last=False):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"{cmd[0]} failed: {proc.stderr.strip()}")
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
    return lines[-1] if pick_last else "\n".join(lines)


def time_ms(fn, torch, reps=TIMING_REPS, warmup=10):
    """Mean device ms per call over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_phase(torch, wk, dev):
    """Phase 3: returns (max abs error, {size: (ms, plain_ms)})."""
    shapes = {"16x8": (8, 8), "64x48": (48, 32), "512x512": (512, 256),
              "2048x2048": (2048, 1024)}
    alpha = 2.0 - 0.06
    worst_abs = 0.0
    times = {}
    for name, (y_len, xh) in shapes.items():
        rng = np.random.default_rng(y_len)
        phase = torch.as_tensor(
            0.5 * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                          (4, 2, y_len, xh))),
            dtype=torch.complex64, device=dev)
        x = torch.as_tensor(rng.normal(size=(2, y_len, xh, 2))
                            + 1j * rng.normal(size=(2, y_len, xh, 2)),
                            dtype=torch.complex64, device=dev)
        got = wk.wilson_r1_apply(phase, x, alpha)
        torch.cuda.synchronize()
        ref = wk.wilson_r1_apply_plain(phase, x, alpha)
        abs_err = float((got - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        worst_abs = max(worst_abs, abs_err)
        line = f"kernel vs plain {name}: max rel err {rel:.3e}"
        if y_len >= 512:
            ms = time_ms(lambda: wk.wilson_r1_apply(phase, x, alpha), torch)
            plain_ms = time_ms(
                lambda: wk.wilson_r1_apply_plain(phase, x, alpha), torch)
            sites = 2 * y_len * xh
            gbs = 64.0 * sites / (ms * 1e-3) / 1e9
            times[name] = (ms, plain_ms)
            line += (f"; kernel {ms * 1e3:.2f} us/apply ({gbs:.1f} GB/s "
                     f"at 64 B/site), plain {plain_ms * 1e3:.2f} us/apply")
        print(line, flush=True)
        check(rel <= KERNEL_TOL, f"kernel disagrees with plain at {name}")
    return worst_abs, times


def bound(bytes_moved, flops):
    """(bound ms, "bytes" or "operations"): the least time of the card."""
    from qmg_tpu_torch.dslash_kernel import HBM_BYTES_S
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def stencil_inputs(torch, dk, kind, nc, y_len, xh, dev, bf16=False):
    """Random channels and x for a K4 ("K4") or split-layout kernel."""
    gen = torch.Generator(device=dev).manual_seed(1000 * nc + y_len + xh)
    ch = torch.randn((5, 2, y_len, xh, nc, nc), dtype=torch.complex64,
                     device=dev, generator=gen)
    x = torch.randn((2, y_len, xh, nc), dtype=torch.complex64, device=dev,
                    generator=gen)
    if bf16:
        ch = torch.view_as_real(ch).to(torch.bfloat16).contiguous()
    if kind != "K4":
        ch, x = dk.channels_to_split(ch), dk.x_to_split(x)
    return ch, x


def stencil_wrappers(dk):
    """{kernel: (wrapper, plain twin)} of the generic stencil kernels."""
    return {"K4": (dk.dslash_apply, dk.dslash_apply_plain),
            "K5": (dk.dslash_split_apply, dk.dslash_split_apply_plain),
            "K6": (dk.dslash_small_apply, dk.dslash_small_apply_plain)}


def stencil_phase(torch, dk, dev):
    """Phase 5: each generic stencil kernel against its twin. Returns
    {kernel: worst abs error}."""
    wrappers = stencil_wrappers(dk)
    cases = []
    for kind in ("K4", "K5"):
        for nc in dk.SUPPORTED_NC:
            for shape in ((8, 8), (48, 32)):
                cases += [(kind, nc, shape, False), (kind, nc, shape, True)]
        for shape in ((2048, 1024), (512, 256)):
            cases += [(kind, 2, shape, False), (kind, 2, shape, True)]
        cases.append((kind, 8, (512, 256), False))
    for nc, shape in ((8, (32, 16)), (8, (8, 4)), (8, (2, 1)), (1, (2, 1)),
                      (2, (2, 1)), (2, (64, 32)), (16, (8, 32))):
        cases += [("K6", nc, shape, False), ("K6", nc, shape, True)]
    worst = {k: 0.0 for k in wrappers}
    worst_rel = {k: 0.0 for k in wrappers}
    for kind, nc, (y_len, xh), bf16 in cases:
        ch, x = stencil_inputs(torch, dk, kind, nc, y_len, xh, dev, bf16)
        fn, plain = wrappers[kind]
        got = fn(ch, x)
        bound_got = dk.bind_apply(fn, ch, x.shape)(x)
        torch.cuda.synchronize()
        ref = plain(ch, x)
        check(torch.equal(bound_got, got), f"{kind}'s bound apply differs "
              f"from its wrapper at nc={nc} Y={y_len} Xh={xh} bf16={bf16}")
        abs_err = float((got - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        worst[kind] = max(worst[kind], abs_err)
        worst_rel[kind] = max(worst_rel[kind], rel)
        check(rel <= KERNEL_TOL, f"{kind} disagrees with its twin at nc={nc} "
              f"Y={y_len} Xh={xh} bf16={bf16}: {rel:.3e}")
    for kind in wrappers:
        print(f"{kind} vs plain: {sum(c[0] == kind for c in cases)} cases, "
              f"max rel err {worst_rel[kind]:.3e}", flush=True)
    return worst


def stencil_timings(torch, dk, dev):
    """Phase 6: CUDA-event times of each stencil kernel and its twin at the
    shapes of its path (and K4 also at the first coarse level and with bf16
    coefficients), beside the bound. Returns {kernel: (ms, plain_ms,
    bound_ms, bound_by)} at the path's shape."""
    runs = [("K4", 2, (2048, 1024), False, True),
            ("K4", 2, (2048, 1024), True, False),
            ("K4", 8, (512, 256), False, False),
            ("K5", 2, (2048, 1024), False, True),
            ("K6", 8, (32, 16), False, True),
            ("K6", 2, (64, 32), False, False)]
    wrappers = stencil_wrappers(dk)
    out = {}
    for kind, nc, (y_len, xh), bf16, on_path in runs:
        ch, x = stencil_inputs(torch, dk, kind, nc, y_len, xh, dev, bf16)
        fn, plain = wrappers[kind]
        ms = time_ms(lambda: fn(ch, x), torch)
        bound_apply = dk.bind_apply(fn, ch, x.shape)
        bound_apply_ms = time_ms(lambda: bound_apply(x), torch)
        plain_ms = time_ms(lambda: plain(ch, x), torch)
        sites = 2 * y_len * xh
        bytes_moved = dk.apply_bytes(nc, sites,
                                     torch.bfloat16 if bf16 else None)
        flops = 40 * nc * nc * sites  # 5 nc^2 complex multiply-adds a site
        bound_ms, bound_by = bound(bytes_moved, flops)
        print(f"{kind} Y={y_len} Xh={xh} nc={nc} "
              f"{'bf16' if bf16 else 'f32'}: kernel {ms * 1e3:.2f} us/apply "
              f"({bytes_moved / (ms * 1e-3) / 1e9:.1f} GB/s; through the "
              f"solve's bound apply {bound_apply_ms * 1e3:.2f} us), plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}; {bytes_moved / 1e6:.1f} MB)", flush=True)
        if on_path:
            out[kind] = (ms, plain_ms, bound_ms, bound_by)
    return out


def check_solve(r, label):
    size = r["size"]
    check(r["converged"] and r["iters"] <= 200,
          f"{label}: {size}^2 solve did not converge within max_iter")
    check(r["x_finite"] and r["x_shape"] == (2, size, size // 2, 2),
          f"{label}: solution not finite or of the wrong shape")
    check(r["rel_res_true"] <= TRUE_RES_BOUND,
          f"{label}: true residual {r['rel_res_true']:.3e} > "
          f"{TRUE_RES_BOUND}")


def kernel_paths(torch, dev):
    """Phases 7 and 8. Returns {kernel: launches over its path's run}."""
    from qmg_tpu_torch.kcycle import (build_problem, run_solver,
                                      print_report, reset_launch_counts,
                                      launch_counts)
    launches = {}

    def path(problem, label, **kw):
        reset_launch_counts()
        r = run_solver(problem, **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"--- {label}", flush=True)
        print_report(r)
        print(f"launches over the path (warm-up + timed solve): {counts}",
              flush=True)
        check_solve(r, label)
        return r, counts

    big = build_problem(2048, dev)
    r_r1, c = path(big, "2048^2 wilson-r1 + plain coarse")
    check(r_r1["launches"]["wilson_r1"] > 0, "2048^2: no wilson_r1 launch")
    r_ms, c = path(big, "2048^2 matrix + small coarse", fine_kernel="matrix",
                   coarse_apply="small")
    check(r_ms["launches"]["dslash"] > 0
          and r_ms["launches"]["dslash_small"] > 0,
          "2048^2 matrix + small: K4 or K6 not launched in the timed solve")
    launches["dslash"], launches["dslash_small"] = (c["dslash"],
                                                     c["dslash_small"])
    r_sg, c = path(big, "2048^2 matrix-split + gather coarse",
                   fine_kernel="matrix-split", coarse_apply="gather")
    check(r_sg["launches"]["dslash_split"] > 0,
          "2048^2 matrix-split: K5 not launched in the timed solve")
    launches["dslash_split"] = c["dslash_split"]
    for r in (r_ms, r_sg):
        check(abs(r["iters"] - r_r1["iters"]) <= 1,
              f"2048^2 outer iterations {r['iters']} ({r['fine_kernel']}) "
              f"vs {r_r1['iters']} (wilson-r1)")
    print(f"2048^2 outer iterations wilson-r1 {r_r1['iters']}, matrix+small "
          f"{r_ms['iters']}, matrix-split+gather {r_sg['iters']}: ok",
          flush=True)
    del big

    mid = build_problem(512, dev)
    r, _ = path(mid, "512^2 matrix + small coarse", fine_kernel="matrix",
                coarse_apply="small")
    check(abs(r["iters"] - JAX_ITERS_512_MATRIX_SMALL) <= 2,
          f"512^2 matrix+small outer iterations {r['iters']} vs qmg_tpu's "
          f"{JAX_ITERS_512_MATRIX_SMALL}")
    r_bf, _ = path(mid, "512^2 matrix + small coarse, bf16 coefficients",
                   fine_kernel="matrix", coarse_apply="small",
                   coeff_dtype=torch.bfloat16)
    print(f"512^2 outer iterations matrix+small {r['iters']} (qmg_tpu "
          f"{JAX_ITERS_512_MATRIX_SMALL}), bf16 coefficients "
          f"{r_bf['iters']}: ok", flush=True)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this test needs a CUDA card")
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor
    from qmg_tpu_torch import wilson_kernel as wk, dslash_kernel as dk
    from qmg_tpu_torch.cuda_build import find_nvcc
    from qmg_tpu_torch.kcycle import run_kcycle, print_report

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    # --- 1. environment ---
    nvcc_line = tool_line([find_nvcc(), "--version"], pick_last=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, nvcc: {nvcc_line}", flush=True)
    print(tool_line(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]), flush=True)

    # --- 2. build: one nvcc per source, started together ---
    with ThreadPoolExecutor(2) as pool:
        builds = {"wilson_r1": pool.submit(wk.build_wilson_r1),
                  "dslash": pool.submit(dk.build_dslash)}
        for name, fut in builds.items():
            print(f"build {name} (nvcc sm_90a): {fut.result():.2f} s",
                  flush=True)

    # --- 3. kernel vs plain ---
    worst_abs, times = kernel_phase(torch, wk, dev)

    # --- 4. the original path ---
    wk.wilson_r1_apply.launches = 0
    r = run_kcycle(512, dev)
    torch.cuda.synchronize()
    launches = wk.wilson_r1_apply.launches
    print_report(r)
    print(f"wilson_r1 launches over the main path (setup + 2 solves): "
          f"{launches}", flush=True)
    check_solve(r, "512^2 wilson-r1")
    check(launches > 0 and r["launches"]["wilson_r1"] > 0,
          "the main path never launched wilson_r1")
    check(abs(r["iters"] - JAX_ITERS_512) <= 2,
          f"outer iterations {r['iters']} vs qmg_tpu's {JAX_ITERS_512}")
    print(f"outer iterations {r['iters']} vs qmg_tpu reference "
          f"{JAX_ITERS_512}: ok", flush=True)

    # --- 5. and 6. the generic stencil kernels vs their twins ---
    worst = stencil_phase(torch, dk, dev)
    stimes = stencil_timings(torch, dk, dev)

    # --- 7. and 8. the kernel paths ---
    path_launches = kernel_paths(torch, dev)

    ms, plain_ms = times["512x512"]
    kernels = [{
        "name": "wilson_r1", "route": "cuda",
        "source": "qmg_tpu_torch/csrc/wilson_r1.cu",
        "replaces": "qmg_tpu/pallas_wilson.py:475",
        "launches": launches, "max_abs_err": worst_abs,
        "ms": ms, "plain_ms": plain_ms,
        # 64 B/site (4 phases, x read, out written), 52 flops/site
        **dict(zip(("bound_ms", "bound_by"),
                   bound(64 * 512 * 512, 52 * 512 * 512))),
        "library_ms": None}]
    for name, kid, line in (("dslash", "K4", 76), ("dslash_split", "K5", 351),
                            ("dslash_small", "K6", 548)):
        k_ms, k_plain, k_bound, k_by = stimes[kid]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "qmg_tpu_torch/csrc/dslash.cu",
            "replaces": f"qmg_tpu/pallas_dslash.py:{line}",
            "launches": path_launches[name], "max_abs_err": worst[kid],
            "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound,
            "bound_by": k_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"# chip_smoke wall {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
