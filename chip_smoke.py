#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (qmg_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them (there is no CPU
fallback). Phases, one line each, any failure exits non-zero:

  1. environment: torch, CUDA, card, nvcc, and the card's name and power
     limit as nvidia-smi reports them;
  2. build: compile the rank-1 Wilson kernel (csrc/wilson_r1.cu) with nvcc;
  3. kernel vs its plain PyTorch twin on the card at 16x8, 64x48, 512^2
     and 2048^2 (max relative error <= 1e-5), with CUDA-event timings of
     both at 512^2 and 2048^2 and the kernel's effective GB/s;
  4. the main path: qmg_tpu_torch.kcycle at 512^2 (setup, warm-up solve,
     timed solve). It must converge, reach a true relative residual
     <= 1e-4 (complex128, exact operator), take the kernel (launch count
     > 0) and match the outer iteration count of qmg_tpu within +-2.

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
KERNEL_TOL = 1e-5
TRUE_RES_BOUND = 1e-4
TIMING_REPS = 100


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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this test needs a CUDA card")
    sys.path.insert(0, REPO)
    from qmg_tpu_torch import wilson_kernel as wk
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

    # --- 2. build ---
    build_s = wk.build_wilson_r1()
    print(f"build wilson_r1 (nvcc sm_90a): {build_s:.2f} s", flush=True)

    # --- 3. kernel vs plain ---
    worst_abs, times = kernel_phase(torch, wk, dev)

    # --- 4. the main path ---
    wk.wilson_r1_apply.launches = 0
    r = run_kcycle(512, dev)
    torch.cuda.synchronize()
    launches = wk.wilson_r1_apply.launches
    print_report(r)
    print(f"wilson_r1 launches over the main path (setup + 2 solves): "
          f"{launches}", flush=True)
    check(r["converged"] and r["iters"] <= 200, "512^2 solve did not "
          "converge within max_iter")
    check(r["x_finite"] and r["x_shape"] == (2, 512, 256, 2),
          "solution not finite or of the wrong shape")
    check(r["rel_res_true"] <= TRUE_RES_BOUND,
          f"true residual {r['rel_res_true']:.3e} > {TRUE_RES_BOUND}")
    check(launches > 0 and r["kernel_launches_timed_solve"] > 0,
          "the main path never launched wilson_r1")
    check(abs(r["iters"] - JAX_ITERS_512) <= 2,
          f"outer iterations {r['iters']} vs qmg_tpu's {JAX_ITERS_512}")
    print(f"outer iterations {r['iters']} vs qmg_tpu reference "
          f"{JAX_ITERS_512}: ok", flush=True)

    ms, plain_ms = times["512x512"]
    print(json.dumps({"kernels": [{
        "name": "wilson_r1", "route": "cuda",
        "source": "qmg_tpu_torch/csrc/wilson_r1.cu",
        "replaces": "qmg_tpu/pallas_wilson.py:475",
        "launches": launches, "max_abs_err": worst_abs,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"# chip_smoke wall {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
