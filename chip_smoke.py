#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (qmg_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them (there is no CPU
fallback). Phases, any failure exits non-zero:

  1. environment: torch, CUDA, card, nvcc, and the card's name and power
     limit as nvidia-smi reports them;
  2. build: compile both CUDA sources (csrc/wilson.cu and
     csrc/dslash.cu), one nvcc each, and the host heatbath
     (csrc/heatbath.cpp, c++), all started together;
  3. the Wilson kernels vs their plain PyTorch twins on the card at 16x8,
     64x48, 512^2 and 2048^2 (max relative error <= 1e-5): the rank-1
     kernel (K1); the any-w kernel (K2) at w = 1 and w = 1.3, and at w = 1
     against K1's kernel; the split rank-1 kernel (K3) in its own layout
     and, converted back, against K1's kernel; with CUDA-event timings at
     512^2 and 2048^2 beside the bound: each kernel through its wrapper,
     through its bound apply (``bind_wilson``, bit-equal to the wrapper)
     and on the device alone (100 bound launches captured in one CUDA
     graph and replayed: a measuring device of this script, no path of
     the port uses it), its twin, and the card's launch floor (an empty
     kernel timed the same way);
  4. the original path: qmg_tpu_torch.kcycle at 512^2 with the rank-1
     kernel (setup, warm-up solve, timed solve, one profiled solve for its
     device kernels). It must converge, reach
     a true relative residual <= 1e-4 (complex128, exact operator), take
     the kernel (launch count > 0) and match qmg_tpu's outer count +-2;
  5. the generic stencil kernels (K4 matrix, K5 split, K6 small) vs their
     twins (max relative error <= 1e-5), each through its wrapper and
     through the solve's bound apply (``bind_apply``): K4 and K5 at every
     nc they take, f32 and bf16 coefficients, at 16x8, 64x48 and 10x6
     (an odd Xh), at 2048^2
     nc2 and 512^2 nc2 (the fine levels of phases 7 and 8, f32 and bf16)
     and at 512^2 nc8; K6 at 32^2 nc8, 8^2 nc8, 64^2 nc8, 2x2, 64^2 nc2
     and 64x8 nc16, in both its layouts: the split entry against K5's
     twin, the interleaved entry (the solve's) against K4's twin and,
     bit for bit after ``x_from_split``, against the split entry;
  6. CUDA-event timings of each of them (through its wrapper, through its
     bound apply and on the device alone) and its twin at its path's
     shape, beside its bound; K6 in both layouts and K4 also at 32^2 nc8
     and 8^2 nc8, with the grid K6 launches there (at least as many
     blocks as the card has SMs at 32^2 nc8, at least 8 at 8^2 nc8);
     one coarse apply as the solve binds it, beside the same apply made
     of the split entry between its two layout copies; and K4 and K5 at
     every nc, f32 and bf16, on channels that stream from device memory
     (nc 1 and 2 at 2048^2, nc 4 at 1024^2, nc 8 at 512^2, nc 16 at
     256^2, and the domain-wall operator at Ls 8 on 128^2), each against
     its twin, on the device alone with its share of the bound and GB/s,
     beside ``torch.sum`` over the same channels (a read yardstick);
  7. the kernel paths at 2048^2 on one hierarchy: the rank-1 kernel
     (plain coarse levels), fine K4 with K6 on the coarse levels that it
     takes, fine K5 with the gather coarse apply, and the any-w Wilson
     kernel K2 (fine_kernel="wilson-phase", plain coarse levels). Each
     must converge to a true residual <= 1e-4 and launch its kernels in
     the timed solve; the outer counts agree within +-1; the K4 + K6
     solves must call neither ``x_to_split`` nor ``x_from_split``, and
     one more K4 + K6 solve runs under torch.profiler to count its device
     kernels;
  8. 512^2 with fine K4 and coarse K6, against qmg_tpu's outer count for
     the same options (+-2), and again with bf16 coefficient streams;
  9. a Wilson operator at w = 1.3 (512^2, its own setup): solved with K2
     and with the plain fine apply, both to a true residual <= 1e-4
     against the operator at that w, outer counts within +-1 of each
     other and +-2 of qmg_tpu's; the rank-1 kernel must refuse it;
 10. the stencil-apply chains of qmg_tpu_torch.dslash at 2048^2 through
     K3 ("wilson-split") and K2 ("wilson-phase"): us per chain step, and
     after 20 steps the same checksum as the rank-1 chain (1e-3); and
     at 32^2 nc8 through K6's two entries ("small", "small-split"), the
     same checksum as the plain chain (1e-5);
 11. the slab kernel (K7: the rank-1 kernel on a y-slab with halo rows)
     on ny in {1, 2, 4, 8} slabs of 16x8 ... 2048^2 lattices, the slabs
     being views of the whole field: each slab against its twin (5e-7),
     the slabs together against K1's kernel on the whole lattice (bit for
     bit at ny = 1, 2e-7 otherwise); CUDA-event timings at 2048^2 of one
     slab launch and of the whole sharded apply at ny = 1 and 4 beside
     K1's and the bound, and at 512^2 and 2048^2 of one slab that is the
     whole lattice with its own rows as halos (the one-rank distributed
     form) through the wrapper, through ``bind_halo`` and on the device
     alone;
 12. (inside 7) the 2048^2 solve with level 0 cut into 4 y-slabs held in
     this process (``make_solver(mesh=Mesh(4, 1))``): outer count within
     +-1 of the rank-1 path's, true residual <= 1e-4, 4 K7 launches for
     every fine apply of the K-cycle and no K1 launch;
 13. the 512^2 problem on a ``torch.distributed`` mesh of one rank on
     NCCL (a ``file://`` store in a temporary directory), built by the
     sharded setup and solved with K7: the group plumbing, ``all_reduce``
     / ``all_gather`` and the self-halo branch on the card; outer count
     within +-1 of qmg_tpu's; the setup summed and gathered, sent no
     halo, and ran the digest check of the coarse levels;
 14. the rhs-axis kernels: K1's rhs entry at 512^2 and 2048^2 and K6's at
     32^2 nc8 and 8^2 nc8, nrhs 8, against their twins (max relative
     error <= 1e-5) and lane by lane bit for bit against the single-field
     kernel; each timed three ways beside 8 single-field launches; K1's
     single-field (nrhs = 1) time on the device alone beside the one
     recorded before the rhs axis; K7's rhs entry on one rank's slab of
     the 4096^2 four-card cell, 1024 x 4096 at nrhs 4 with received halo
     buffers, against its twin (5e-7) and field by field bit for bit
     against one-field K7 launches, timed three ways beside those 4
     launches and the bound;
 15. the batched solve: the 512^2 problem of phase 4 with 8 right-hand
     sides (6 gaussian, a point and a wall source) through
     ``kcycle.run_batched(fine_kernel="wilson-r1", coarse_apply="small")``:
     one batched solve and 8 sequential ones with the same options, 3
     turns; each lane's outer iterations within +-1 of its sequential
     solve, every true residual <= 1e-4, finite solutions, K1's and K6's
     rhs entries launched; ms per right-hand side of both;
 16. the measurement stream at full width:
     ``stream.run_stream(L=512, n_refine=3, batched=True)`` for 3
     configurations (200 thermalization updates, 5 between
     configurations): plaquettes in 0.85-0.97, a positive correlator with
     C(1) > C(5), no configuration at max_iter, the rhs kernels launched;
     the first configuration's correlator within 1e-3 (t < 16) of the one
     that plain applies and sequential solves give on the same
     configuration; setup and solve seconds per configuration and the
     heatbath's seconds per update. The correlator is not required to
     fall at every step from t = 1 to t = 5: at m = -0.06 single quenched
     configurations of this volume rise there (PERF.md).

 17. the n19 Schur path (no kernel applies it, in either package):
     ``kcycle.build_problem(512, outer="schur")`` (setup timed; inside
     it the per-site QR inverse, timed again per level beside
     ``torch.linalg.qr`` on 16384 blocks of 2x2), a warm-up solve and the
     median of 3 timed solves, one more under torch.profiler. It must
     converge, reach a true relative residual <= 1e-4 (complex128, the
     reconstructed full x against the exact ORIGINAL operator), take
     qmg_tpu's outer count +-1, build each fused Schur set once and no
     other derived set after the setup, and launch no kernel. The fused
     Schur apply at 512^2 against the two half applies
     (``apply_rbj_schur``, max relative error <= 1e-5), both timed with
     CUDA events. Beside it, the standard solve of phase 4 and the
     standard solve on the same 512^2 problem with plain applies.
 18. the deflated normal-operator coarsest (``kcycle --deflate 8``: CG
     on M^dag M from the projection onto its 8 lowest eigenpairs, which
     the setup's deflation stage computes; no dense inverse):
     (a) 512^2 with the rank-1 kernel on level 0 and plain coarse levels,
     a true residual <= 1e-4, K1 launched, qmg_tpu's outer count +-2;
     again with ``--coarse-apply small``, which must launch K6 too;
     (b) each eigenpair of the stage against the card's coarsest
     operator (||A v - lambda v|| / |lambda| <= 1e-3 in complex64), the
     stage's time, and the relative gap of the spectrum at the cut;
     (c) 2048^2 with the rank-1 kernel: converged, K1 launched;
     (d) a checkpoint round trip of the 512^2 hierarchy (``save_hierarchy``,
     ``load_hierarchy(device="cuda")``): the same outer count;
     (e) the refined solve (``make_refined_solver``) of the 512^2 problem
     to a complex128 true residual <= 1e-10: passes and K-cycle
     iterations;
     (f) one 512^2 solve with the CGNE smoother on level 0: a true
     residual <= 1e-4.
     For (a) and (c) setup s, solve ms, ms per outer iteration, per-level
     iterations, coarsest CG iterations per visit and device kernels of
     one profiled solve, beside the direct-coarsest solve of the same
     problem sizes (phase 4's profiled 512^2 solve and phase 7's 2048^2
     one).

 19. the n22 adaptive setup (``kcycle --setup adaptive``) on phase 4's
     problem (its gauge field, mass and right-hand side; the setup's
     gaussians drawn from the stream after it): ``AdaptiveConfig(n_refine=3,
     coarse_dof=8, n_setup=1)`` with the dense coarsest inverse, each stage
     timed and every array of the hierarchy finite; the Richardson-only
     hierarchy (``n_setup=0``, the same seeds) solved once with K1; the
     adapted one solved with K1 and with K1 + K6 (``--coarse-apply
     small``), each from launch counts set to 0, to a true relative
     residual <= 1e-4, launching K1 (and K6), in at most the Richardson-only
     count + 1 outer iterations; the adapted K1 and the Richardson-only
     counts within +-2 of qmg_tpu's (``JAX_ITERS_512_ADAPTIVE``); one more
     setup under a counter of the device operations it dispatches and of
     its host read-backs; setup s by stage, solve ms, ms per outer
     iteration, the device kernels of one profiled solve and the
     per-level operator report.

 20. the other operators: (a) K4 at nc = 1 on the staggered and gauged
     Laplace operators' channels (gauss gauge beta 6, seed 1337) at 512^2
     and 2048^2, and at nc 8 and 16 on the domain-wall operator's (Ls 4
     and 8) at 128^2, against its twin (max relative error <= 1e-5) and
     timed three ways beside its bound (56 B/site at nc = 1); (b) the
     2048^2 staggered solve (m = 0.1, complex64, BiCGstab(6) to 1e-6)
     through K4 and through the plain apply: complex128 true residuals
     <= 1e-4, iterations within two l-cycles (12) of each other and of
     qmg_tpu's count (``JAX_ITERS_2048_STAGGERED``), ms and K4 launches;
     and the eo-Schur
     CG solve beside it; (c) ``goldstone.run_goldstone`` at 32^2,
     staggered, m = 0.1, 60 configurations x 100 updates (PARITY.md's
     setting) through K4: every solve converged, a positive correlator,
     m_pi within 3 of its own jackknife sigmas of the reference's
     0.355891, and each configuration's correlator within 1e-4 of the
     plain apply's on the same configurations; (d) the same entry at
     512^2, 3 configurations: seconds per configuration and K4 launches.

 21. the two examples' entry points: (a) ``wilson_kcycle.run(256, -0.075,
     6.0, 2, spectrum_nev=4, coarsest_direct=True)`` in complex128 (the n13
     study at the reference's fixture size: the example's heatbath, setup
     with the dense coarsest inverse, since the example's GCR coarsest
     stagnates at two refinements, mg.solve to 1e-10): converged, true
     residual <= 1e-9, qmg_tpu's outer count (``JAX_ITERS_256_N13``), the 4
     fine eigenpairs nearest 0 with ||M v - lambda v|| / |lambda| <= 1e-6,
     and a second solve with ``VerboseMG(DETAIL, SUMMARY)`` printing one
     outer iteration line per outer iteration and summary lines for every
     level that runs a Krylov solve (all but the direct coarsest); heatbath
     s, setup s, solve ms; (b) the dense spectrum and the colinear study at
     16^2 (16 vectors; 32^2 put the phase over 120 s): the lowest mode's
     ||(1 - P P^dag) v|| below the highest kept mode's; (c)
     ``wilson_tpu_solve.run(512, -0.06, n_refine=3)`` with a checkpoint in
     a temporary directory, twice (the second restores it and takes the
     same outer count), then with ``schur=True``: true residuals <= 10 tol,
     outer counts within +-2 of qmg_tpu's (``JAX_ITERS_512_TPU_SOLVE``), K1
     launched in the standard solves and not in the Schur one.

 22. one K-cycle for one and many right-hand sides (the single solve is
     the batched solve's one-field case): (a) phase 4's 512^2 solve at
     nrhs = 1, qmg_tpu's outer count +-2, with its device operations
     counted (``count_device_ops``) and held to +2% of the count before
     the solvers took the rhs axis (``OPS_512_BEFORE_LANES``); (b) the
     512^2 n19 Schur problem and (c) the 512^2 ``--deflate 8`` problem,
     each with NRHS right-hand sides (6 gaussian, a point, a wall)
     through ``kcycle.run_batched``: a batched solve and the NRHS
     sequential ones in alternating turns, each lane's outer iterations
     within +-1 of its sequential solve's (ROADMAP F5), every true
     residual <= 1e-4, finite solutions; (b) launches no kernel, (c)
     (K1 + K6) launches the rhs entries of K1 and K6; (d) one ``--outer
     schur --deflate 8`` solve to a true residual <= 1e-4.

 23. the mesh, the sharded setup and every formulation, on an in-process
     ``Mesh(4, 1)`` (``kcycle.build_problem(mesh=)``, whose setup is
     ``make_kcycle_setup_planes(mesh=)``), in at most 90 s: (a) 2048^2
     with K7 on level 0: outer count within +-1 of phase 7's unsharded
     2048^2 solve, true residual <= 1e-4, K7 launched and K1 not, the
     setup's seconds beside the unsharded one's; (b) the 512^2 n19 Schur
     solve, qmg_tpu's count +-1, no kernel; (c) 512^2 with 8 right-hand
     sides in one batched solve with K7's rhs entry on level 0 beside
     their sequential mesh solves (each lane within +-1, F5; K7 launched,
     K1 and its rhs entry not); (d) 512^2 ``--deflate 8`` with K7,
     qmg_tpu's count +-1. K7's launches over (a) join its row of the
     summary, and those of one batched solve of (c) the K7 rhs row.

 24. ``python -m qmg_tpu_torch.bench`` and ``.attrib`` in this process,
     each JSON line parsed: (a) the 2048^2 dslash chain with
     ``--kernel phase-r1``, its checksum after 20 steps against ``dslash
     --kernel wilson-r1``'s (1e-3); (b)
     ``--mode kcycle`` at 2048^2 ``--setup device`` and at 512^2
     ``--setup host``, outer counts within +-1 of phases 7 and 4, K1
     launched; (c) ``--mode refine`` at 512^2: a complex128 true residual
     <= 1e-10 in phase 18(e)'s passes; (d) ``--nrhs 8 --chain 3`` at
     512^2: every lane converged, a positive marginal; (e) ``attrib`` at
     2048^2 on level 0's parts (``python -m qmg_tpu_torch.attrib`` times
     every level): every part's marginal > 0, K1 launched inside
     ``precond`` and not inside ``fine``, and the probe's model line. K1's launches and
     its rhs entry's over the phase join their rows of the summary
     (``bench_launches``).

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
# The same at a Wilson coefficient w = 1.3 (Wilson2D(wilson_coeff=1.3),
# m = -0.06), with the jnp fine apply, from
# ``python tests/test_torch_wilson_phase_solve.py --size 512
# --wilson-coeff 1.3``. This (w, m) pair was taken because w = 1.3 is the
# other Wilson coefficient that qmg_tpu's own kernel tests use, and the
# Wilson term's additive mass shift grows with w, so at w = 1.3 the entry
# point's m = -0.06 lies further from critical than at w = 1 (w = 0.9
# would move it towards critical): qmg_tpu converges there in 8 iterations.
W_OTHER = 1.3
JAX_ITERS_512_W_OTHER = 8
# The same with bench.py's --outer schur configuration (the n19 path:
# rbjacobi null vectors by restarted GCR, rbjacobi coarsening, RIGHT_SCHUR
# on every level) through make_planes_solver(outer_type=RIGHT_SCHUR) on
# the CPU backend with x64 off, from
# ``python tests/test_torch_schur_kcycle.py --size 512`` (the port's own
# setup and solve on the CPU took 6 too).
JAX_ITERS_512_SCHUR = 6
# The same with bench.py's --deflate 8 configuration (an MDAGGER_M
# coarsest solved by CG from the projection onto its 8 lowest eigenpairs,
# no dense inverse) through make_planes_solver on the CPU backend with x64
# off, from ``python tests/test_torch_deflation.py --size 512``.
JAX_ITERS_512_DEFLATE = 9
# Outer iterations of qmg_tpu's solve on ``kcycle --setup adaptive``'s
# 512^2 hierarchy (its traced ``make_adaptive_setup_planes`` with the dense
# coarsest inverse, the planes solver, complex64, on the CPU backend) after
# one pass and with none, from ``python tests/test_torch_adaptive.py
# --size 512`` (qmg_tpu's setup takes ~26 min there).
JAX_ITERS_512_ADAPTIVE = (11, 31)
# Outer iterations of qmg_tpu's own n13 study at 256^2 (its heatbath
# configuration from QMGRandom(1337), complex128, tol 1e-10) with the dense
# coarsest inverse, from ``PYTHONPATH=. JAX_PLATFORMS=cpu python
# tests/test_torch_examples.py --n13 256`` (examples/wilson_kcycle.py 256
# -0.075 6.0 2 --cpu, its setup wrapped to set coarsest_direct: the
# example's restarted-GCR coarsest stagnates from two refinements on, in
# both packages).
N13_ARGS = (256, -0.075, 6.0, 2)
JAX_ITERS_256_N13 = 21
N13_TRUE_RES = 1e-9
N13_SPECTRUM_NEV = 4
N13_EIG_RES = 1e-6
# The colinear study at 16^2 (the CPU tests' size): at 32^2 it took 21.5 s
# of the card's 124.8 s phase (two host eigensystems of 2048 and 512
# dimensions), over the phase's 120 s.
COLINEAR_ARGS = (16, -0.075, 6.0, 1)
COLINEAR_NEV = 16
# Outer iterations of qmg_tpu's example solve at 512^2 (gauss gauge beta 6
# from QMGRandom(1337), m = -0.06, complex64, tol 1e-5, three
# refinements), standard and n19 Schur, from ``PYTHONPATH=.
# JAX_PLATFORMS=cpu python tests/test_torch_examples.py --tpu-solve 512``
# (examples/wilson_tpu_solve.py 512 -0.06 --n-refine 3 [--schur]).
TPU_SOLVE_ARGS = (512, -0.06, 3)
JAX_ITERS_512_TPU_SOLVE = (9, 6)
ADAPTIVE_SIZE = 512       # phase 19's lattice: phase 4's problem
DEFLATE_N = 8
DEFLATE_SIZES = (512, 2048)   # phase 18's lattices
DEFLATE_EIG_TOL = 1e-3
REFINE_TOL = 1e-10
SCHUR_APPLY_TOL = 1e-5
SCHUR_SIZE = 512          # phase 17's lattice
KERNEL_TOL = 1e-5
HALO_TWIN_TOL = 5e-7      # K7 against its twin
HALO_K1_TOL = 2e-7        # K7's slabs together against K1's kernel
CHAIN_TOL = 1e-3
TRUE_RES_BOUND = 1e-4
TIMING_REPS = 100
PLAIN_REPS = 20           # the twins: tens of small kernels a call
# H100 SXM data sheet peak at 700 W of float32 (non-tensor core) flop/s;
# the memory rate is qmg_tpu_torch.dslash_kernel.HBM_BYTES_S.
FP32_FLOP_S = 67e12


T_START = time.perf_counter()


def check(cond, msg):
    """Exits 1 on a failed check; the message goes to both streams, so that
    a caller that keeps only the standard error still reads it."""
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        print(f"chip_smoke FAIL: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def phase(label):
    """Marks the start of a phase on the standard error, with the seconds
    since the script started."""
    print(f"# chip_smoke {time.perf_counter() - T_START:.1f} s: {label}",
          file=sys.stderr, flush=True)


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


def graph_ms(fn, torch, reps=TIMING_REPS, replays=5):
    """Device ms per call of ``fn`` alone: ``reps`` calls captured in one
    CUDA graph (``fn`` launches on the current stream), replayed
    ``replays`` times between two CUDA events, so that no host work
    stands between two launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def three_ways(wrapper_call, bound_call, torch):
    """(ms through the wrapper, through the bound apply, on the device
    alone) of one kernel."""
    return (time_ms(wrapper_call, torch), time_ms(bound_call, torch),
            graph_ms(bound_call, torch))


def rel_err(got, ref):
    """(max abs error, the same over max |ref|)."""
    abs_err = float((got - ref).abs().max())
    return abs_err, abs_err / float(ref.abs().max())


def kernel_phase(torch, wk, dk, dev):
    """Phase 3: the three Wilson kernels against their twins and each
    other. Returns ({kernel: max abs error vs its twin},
    {kernel: {size: (ms through the wrapper, plain_ms, ms through the
    bound apply, ms on the device alone)}})."""
    shapes = {"16x8": (8, 8), "64x48": (48, 32), "512x512": (512, 256),
              "2048x2048": (2048, 1024)}
    mass = -0.06
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    times = {k: {} for k in worst}
    for name, (y_len, xh) in shapes.items():
        rng = np.random.default_rng(y_len)
        phase = torch.as_tensor(
            0.5 * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                          (4, 2, y_len, xh))),
            dtype=torch.complex64, device=dev)
        x = torch.as_tensor(rng.normal(size=(2, y_len, xh, 2))
                            + 1j * rng.normal(size=(2, y_len, xh, 2)),
                            dtype=torch.complex64, device=dev)
        phase_s, x_s = wk.wilson_phases_split(phase), dk.x_to_split(x)
        a1, aw = 2.0 + mass, 2.0 * W_OTHER + mass
        # kernel -> (wrapper call, its twin's call)
        calls = {
            "K1": (lambda: wk.wilson_r1_apply(phase, x, a1),
                   lambda: wk.wilson_r1_apply_plain(phase, x, a1)),
            "K2": (lambda: wk.wilson_phase_apply(phase, x, W_OTHER, aw),
                   lambda: wk.wilson_phase_apply_plain(phase, x, W_OTHER,
                                                       aw)),
            "K3": (lambda: wk.wilson_split_apply(phase_s, x_s, a1),
                   lambda: wk.wilson_split_apply_plain(phase_s, x_s, a1))}
        binds = {
            "K1": wk.bind_wilson(wk.wilson_r1_apply, phase, x.shape, a1),
            "K2": wk.bind_wilson(wk.wilson_phase_apply, phase, x.shape,
                                 W_OTHER, aw),
            "K3": wk.bind_wilson(wk.wilson_split_apply, phase_s, x_s.shape,
                                 a1)}
        got = {}
        for kid, (kernel, plain) in calls.items():
            got[kid] = kernel()
            arg = x_s if kid == "K3" else x
            bound_got = binds[kid](arg)
            torch.cuda.synchronize()
            check(torch.equal(bound_got, got[kid]),
                  f"{kid}'s bound apply differs from its wrapper at {name}")
            abs_err, rel = rel_err(got[kid], plain())
            worst[kid] = max(worst[kid], abs_err)
            line = f"{kid} vs plain {name}: max rel err {rel:.3e}"
            if y_len >= 512:
                ms, bound_ms, dev_ms = three_ways(
                    kernel, lambda: binds[kid](arg), torch)
                plain_ms = time_ms(plain, torch, reps=PLAIN_REPS)
                sites = 2 * y_len * xh
                gbs = 64.0 * sites / (dev_ms * 1e-3) / 1e9
                times[kid][name] = (ms, plain_ms, bound_ms, dev_ms)
                line += (f"; us/apply through the wrapper {ms * 1e3:.2f}, "
                         f"through bind_wilson {bound_ms * 1e3:.2f}, on the "
                         f"device alone {dev_ms * 1e3:.2f} ({gbs:.1f} GB/s "
                         f"at 64 B/site), bound "
                         f"{wilson_bound(kid, sites)[0] * 1e3:.2f}, plain "
                         f"{plain_ms * 1e3:.2f}")
            print(line, flush=True)
            check(rel <= KERNEL_TOL, f"{kid} disagrees with plain at {name}")
        # K2 at w = 1: against its twin and against K1's kernel; K3 in
        # K1's layout against K1's kernel.
        k2 = wk.wilson_phase_apply(phase, x, 1.0, a1)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(k2, wk.wilson_phase_apply_plain(phase, x, 1.0,
                                                               a1))
        worst["K2"] = max(worst["K2"], abs_err)
        rel_k1 = rel_err(k2, got["K1"])[1]
        rel_k3 = rel_err(dk.x_from_split(got["K3"]), got["K1"])[1]
        print(f"K2 at w=1 {name}: vs plain {rel:.3e}, vs the K1 kernel "
              f"{rel_k1:.3e}; K3 vs the K1 kernel {rel_k3:.3e}", flush=True)
        check(max(rel, rel_k1, rel_k3) <= KERNEL_TOL,
              f"K2 at w=1 or K3 disagrees with the K1 kernel at {name}")
    return worst, times


def wilson_bound(kid, sites, nrhs=1):
    """Bound of one Wilson apply to ``nrhs`` fields: 32 B/site of phases
    read once and 32 B/site a field (x read, out written); 52 flops/site a
    field for the rank-1 kernels, 100 for the any-w one (8 complex
    multiplies, 4 x (4 multiplies + 8 adds), alpha x)."""
    return bound((32 + 32 * nrhs) * sites,
                 (100 if kid == "K2" else 52) * sites * nrhs)


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


def small_grid_line(dk, nc, y_len, xh, at_least):
    """K6's grid at one shape, held to its least block count."""
    blocks, threads, sms = dk.small_grid(nc, y_len, xh)
    least = sms if at_least == "SMs" else at_least
    print(f"K6 Y={y_len} Xh={xh} nc={nc}: {blocks} blocks of {threads} "
          f"threads on {sms} SMs", flush=True)
    check(blocks >= least, f"K6 launches {blocks} blocks at Y={y_len} "
          f"Xh={xh} nc={nc}, fewer than {least}")


def stencil_phase(torch, dk, dev):
    """Phase 5: each generic stencil kernel against its twin. Returns
    {kernel: worst abs error}; "K6i" is K6's interleaved entry."""
    wrappers = stencil_wrappers(dk)
    cases = []
    for kind in ("K4", "K5"):
        for nc in dk.SUPPORTED_NC:
            for shape in ((8, 8), (48, 32), (6, 5)):
                cases += [(kind, nc, shape, False), (kind, nc, shape, True)]
        for shape in ((2048, 1024), (512, 256)):
            cases += [(kind, 2, shape, False), (kind, 2, shape, True)]
        cases.append((kind, 8, (512, 256), False))
    for nc, shape in ((8, (32, 16)), (8, (8, 4)), (8, (64, 32)), (8, (2, 1)),
                      (1, (2, 1)), (2, (2, 1)), (2, (64, 32)), (16, (8, 32)),
                      (4, (48, 32))):
        cases += [("K6", nc, shape, False), ("K6", nc, shape, True)]
    worst = {k: 0.0 for k in (*wrappers, "K6i")}
    worst_rel = dict(worst)
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
        if kind != "K6":
            continue
        # K6's interleaved entry on the same numbers in K4's layout.
        ch_i, x_i = stencil_inputs(torch, dk, "K4", nc, y_len, xh, dev, bf16)
        fn_i = dk.dslash_small_interleaved_apply
        got_i = fn_i(ch_i, x_i)
        bound_i = dk.bind_apply(fn_i, ch_i, x_i.shape)(x_i)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got_i, dk.dslash_apply_plain(ch_i, x_i))
        worst["K6i"], worst_rel["K6i"] = (max(worst["K6i"], abs_err),
                                          max(worst_rel["K6i"], rel))
        check(rel <= KERNEL_TOL, f"K6's interleaved entry disagrees with "
              f"its twin at nc={nc} Y={y_len} Xh={xh} bf16={bf16}: {rel:.3e}")
        check(torch.equal(got_i, dk.x_from_split(got))
              and torch.equal(bound_i, got_i),
              f"K6's two entries (or the interleaved one's bound apply) "
              f"differ at nc={nc} Y={y_len} Xh={xh} bf16={bf16}")
    for kind in worst:
        n_cases = sum(c[0] == kind[:2] for c in cases)
        print(f"{kind} vs plain: {n_cases} cases, max rel err "
              f"{worst_rel[kind]:.3e}"
              + (" (K6's interleaved entry; bit-equal to the split entry "
                 "in every case)" if kind == "K6i" else ""), flush=True)
    return worst


def stencil_timings(torch, dk, dev):
    """Phase 6: CUDA-event times of each stencil kernel (through its
    wrapper, its bound apply and on the device alone) and its twin at the
    shapes of its path, beside the bound: K4 also at the first coarse
    level and with bf16 coefficients, and K6 (both entries) and K4 side by
    side at the K-cycle's small levels. Returns {kernel: (ms, plain_ms,
    bound_ms, bound_by, bound-apply ms, device ms)} at the path's shape;
    "K6i" is K6's interleaved entry, the one on the solve's path."""
    small_grid_line(dk, 8, 32, 16, "SMs")
    small_grid_line(dk, 8, 8, 4, 8)
    # (kernel, nc, (Y, Xh), bf16 coefficients, the path's shape)
    runs = [("K4", 2, (2048, 1024), False, True),
            ("K4", 2, (2048, 1024), True, False),
            ("K4", 8, (512, 256), False, False),
            ("K5", 2, (2048, 1024), False, True),
            ("K6", 2, (64, 32), False, False)]
    for shape in ((32, 16), (8, 4)):
        runs += [(kind, 8, shape, False, shape == (32, 16))
                 for kind in ("K6i", "K6", "K4", "K6i")]
    wrappers = dict(stencil_wrappers(dk),
                    K6i=(dk.dslash_small_interleaved_apply,
                         dk.dslash_apply_plain))
    out = {}
    for kind, nc, (y_len, xh), bf16, on_path in runs:
        ch, x = stencil_inputs(torch, dk, "K4" if kind == "K6i" else kind,
                               nc, y_len, xh, dev, bf16)
        fn, plain = wrappers[kind]
        bound_apply = dk.bind_apply(fn, ch, x.shape)
        ms, bound_apply_ms, dev_ms = three_ways(
            lambda: fn(ch, x), lambda: bound_apply(x), torch)
        plain_ms = time_ms(lambda: plain(ch, x), torch, reps=PLAIN_REPS)
        sites = 2 * y_len * xh
        bytes_moved = dk.apply_bytes(nc, sites,
                                     torch.bfloat16 if bf16 else None)
        flops = 40 * nc * nc * sites  # 5 nc^2 complex multiply-adds a site
        bound_ms, bound_by = bound(bytes_moved, flops)
        print(f"{kind} Y={y_len} Xh={xh} nc={nc} "
              f"{'bf16' if bf16 else 'f32'}: us/apply through the wrapper "
              f"{ms * 1e3:.2f}, through the solve's bound apply "
              f"{bound_apply_ms * 1e3:.2f}, on the device alone "
              f"{dev_ms * 1e3:.2f} "
              f"({bytes_moved / (dev_ms * 1e-3) / 1e9:.1f} GB/s), plain "
              f"{plain_ms * 1e3:.2f}, bound {bound_ms * 1e3:.2f} "
              f"({bound_by}; {bytes_moved / 1e6:.2f} MB)", flush=True)
        if on_path and kind not in out:
            out[kind] = (ms, plain_ms, bound_ms, bound_by, bound_apply_ms,
                         dev_ms)
    solve_apply_timings(torch, dk, dev)
    stream_timings(torch, dk, dev)
    return out


# Phase 6's streaming rows: (nc, Y, Xh) of at least 100 MB of compulsory
# bytes in complex64 (twice the card's L2), random channels; then the
# domain-wall operator at Ls 8 on 128^2 (nc 16).
STREAM_CASES = ((1, 2048, 1024), (2, 2048, 1024), (4, 1024, 512),
                (8, 512, 256), (16, 256, 128))
STREAM_DWF = (8, 128)


def stream_timings(torch, dk, dev):
    """K4 and K5 at every nc on channels that stream from device memory,
    with complex64 and bf16 channels: each against its twin, its device
    alone time (100 bound launches in one CUDA graph), share of its bound
    and GB/s, beside a read yardstick: ``torch.sum`` over the same channel
    tensor viewed as float32, one PyTorch call that reads the channel bytes
    once (printed only; no path of the port calls it)."""
    cases = [("random", nc, y_len, xh) for nc, y_len, xh in STREAM_CASES]
    cases.append(("dwf", 2 * STREAM_DWF[0], STREAM_DWF[1],
                  STREAM_DWF[1] // 2))
    for src, nc, y_len, xh in cases:
        for bf16 in (False, True):
            if src == "dwf":
                ch, x = other_k4_inputs(torch, dev, "dwf", y_len,
                                        STREAM_DWF[0])
                if bf16:
                    ch = torch.view_as_real(ch).to(torch.bfloat16)
            else:
                ch, x = stencil_inputs(torch, dk, "K4", nc, y_len, xh, dev,
                                       bf16)
            sites = 2 * y_len * xh
            bytes_moved = dk.apply_bytes(nc, sites,
                                         torch.bfloat16 if bf16 else None)
            bound_ms, bound_by = bound(bytes_moved, 40 * nc * nc * sites)
            flat = ch.view(torch.float32)
            sum_ms = graph_ms(lambda: flat.sum(), torch)
            ch_bytes = ch.numel() * ch.element_size()
            for kind in ("K4", "K5"):
                if kind == "K5":
                    ch, x = dk.channels_to_split(ch), dk.x_to_split(x)
                fn, plain = stencil_wrappers(dk)[kind]
                apply = dk.bind_apply(fn, ch, x.shape)
                got = apply(x)
                _, rel = rel_err(got, plain(ch, x))
                check(rel <= KERNEL_TOL, f"{kind} disagrees with its twin "
                      f"on {src} nc={nc} Y={y_len} Xh={xh} bf16={bf16}: "
                      f"{rel:.3e}")
                dev_ms = graph_ms(lambda: apply(x), torch)
                print(f"stream {kind} {src} nc={nc} {2 * xh}x{y_len} "
                      f"{'bf16' if bf16 else 'c64'}: device alone "
                      f"{dev_ms * 1e3:.2f} us, {bound_ms / dev_ms:.0%} of "
                      f"the bound {bound_ms * 1e3:.2f} us ({bound_by}; "
                      f"{bytes_moved / 1e6:.1f} MB), "
                      f"{bytes_moved / (dev_ms * 1e-3) / 1e9:.0f} GB/s; "
                      f"max rel err {rel:.2e}; torch.sum over the channels "
                      f"{sum_ms * 1e3:.2f} us "
                      f"({ch_bytes / (sum_ms * 1e-3) / 1e9:.0f} GB/s)",
                      flush=True)
            del ch, x, flat, got
            torch.cuda.empty_cache()


def solve_apply_timings(torch, dk, dev):
    """One coarse apply as the solve makes it on a 32^2 nc8 level: the
    interleaved entry bound by ``solve._matrix_apply``, beside the same
    apply composed around the split entry (``x_to_split``, the kernel,
    ``x_from_split``: the layout copies the interleaved entry spares)."""
    from qmg_tpu_torch import dslash, solve
    coeffs, v = dslash.make_operator(32, 8, dev)
    direct = solve._matrix_apply(coeffs, "small")
    split = dk.bind_apply(dk.dslash_small_apply,
                          dk.stencil_channels_split(coeffs),
                          (2, 2, 16, 16, 8))

    def copied(t):
        return dk.x_from_split(split(dk.x_to_split(t.to(torch.complex64)))
                               ).to(t.dtype)

    check(torch.equal(direct(v), copied(v)),
          "the solve's small apply differs from the split entry between "
          "its layout copies")
    for label, fn in (("interleaved entry", direct),
                      ("split entry between two layout copies", copied),
                      ("interleaved entry again", direct)):
        print(f"the solve's coarse apply at 32^2 nc8, {label}: "
              f"{time_ms(lambda: fn(v), torch) * 1e3:.2f} us a call, "
              f"{graph_ms(lambda: fn(v), torch) * 1e3:.2f} us on the device "
              f"alone", flush=True)


def slab_views(phase, x, y0, y_loc):
    """Slab [y0, y0 + y_loc) of whole phases and x, and its halo rows
    (the row below and the row above, periodic), all as views."""
    return (phase[:, :, y0:y0 + y_loc], x[:, y0:y0 + y_loc], x[:, y0 - 1],
            x[:, (y0 + y_loc) % x.shape[1]])


def halo_bound(y_loc, xh):
    """Bound of one slab launch: 64 B/site of the slab plus 2 halo rows x
    2 parities x Xh x 16 B; 52 flops a site."""
    sites = 2 * y_loc * xh
    return bound(64 * sites + 2 * 2 * xh * 16, 52 * sites)


def halo_phase(torch, wk, dev):
    """Phase 11. Returns (worst abs error of K7 against its twin, (ms,
    plain_ms, bound_ms, bound_by, wrapper ms, device ms) of one slab
    launch at the sharded solve's shape, a 512-row slab of the 2048^2
    lattice)."""
    from qmg_tpu_torch import dslash
    shapes = {"16x8": (8, 8), "64x48": (48, 32), "512x512": (512, 256),
              "2048x2048": (2048, 1024)}
    alpha = 2.0 - 0.06
    worst = 0.0
    for name, (y_len, xh) in shapes.items():
        rng = np.random.default_rng(y_len + 7)
        phase = torch.as_tensor(
            0.5 * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                          (4, 2, y_len, xh))),
            dtype=torch.complex64, device=dev)
        x = torch.as_tensor(rng.normal(size=(2, y_len, xh, 2))
                            + 1j * rng.normal(size=(2, y_len, xh, 2)),
                            dtype=torch.complex64, device=dev)
        whole = wk.wilson_r1_apply(phase, x, alpha)
        for ny in (1, 2, 4, 8):
            if y_len % ny or (y_len // ny) % 2:
                continue
            y_loc = y_len // ny
            out = torch.empty_like(x)
            twin_rel = 0.0
            for iy in range(ny):
                args = slab_views(phase, x, iy * y_loc, y_loc)
                got = wk.wilson_r1_halo_apply(
                    *args, alpha, out=out[:, iy * y_loc:(iy + 1) * y_loc])
                torch.cuda.synchronize()
                abs_err, rel = rel_err(
                    got, wk.wilson_r1_halo_apply_plain(*args, alpha))
                worst, twin_rel = max(worst, abs_err), max(twin_rel, rel)
            k1_rel = rel_err(out, whole)[1]
            same = torch.equal(out, whole)
            print(f"K7 {name} on {ny} slab(s): vs twin {twin_rel:.3e}, vs "
                  f"the K1 kernel {k1_rel:.3e}"
                  f"{' (bit for bit)' if same else ''}", flush=True)
            check(twin_rel <= HALO_TWIN_TOL,
                  f"K7 disagrees with its twin at {name}, ny={ny}")
            check(k1_rel <= HALO_K1_TOL and (same or ny > 1),
                  f"K7's slabs disagree with the K1 kernel at {name}, "
                  f"ny={ny}")
        if y_len < 512:
            continue
        # One slab that is the whole lattice, its own first and last rows
        # as halos: what one rank of the distributed path launches.
        own = (x, x[:, -1], x[:, 0])
        rank = wk.bind_halo(phase, alpha, own_halos=True)
        check(torch.equal(rank(*own), whole),
              f"the bind_halo apply differs from the K1 kernel at {name}")
        ms, bound_ms, dev_ms = three_ways(
            lambda: wk.wilson_r1_halo_apply(phase, *own, alpha),
            lambda: rank(*own), torch)
        print(f"K7 {name}, one slab with its own halos: us/apply through "
              f"the wrapper {ms * 1e3:.2f}, through bind_halo "
              f"{bound_ms * 1e3:.2f}, on the device alone {dev_ms * 1e3:.2f},"
              f" bound {halo_bound(y_len, xh)[0] * 1e3:.2f}", flush=True)
    # One slab launch at the sharded solve's shape: a 512-row slab of the
    # 2048^2 lattice (x, phase are still bound). Through the wrapper a
    # call is bound by its Python checks, so the kernel's time is taken
    # as the solve launches it: the 4-slab apply with its checks made
    # once (``bind_halo_slabs``), a quarter of it a launch.
    y_loc = 512
    args = slab_views(phase, x, y_loc, y_loc)
    out = torch.empty_like(x)
    wrapper_ms = time_ms(lambda: wk.wilson_r1_halo_apply(
        *args, alpha, out=out[:, y_loc:2 * y_loc]), torch)
    slabs = wk.bind_halo_slabs(phase, 4, alpha)
    check(torch.equal(slabs(x), whole),
          "the bound 4-slab apply differs from the K1 kernel")
    ms = time_ms(lambda: slabs(x), torch) / 4
    dev_ms = graph_ms(lambda: slabs(x), torch) / 4
    plain_ms = time_ms(lambda: wk.wilson_r1_halo_apply_plain(*args, alpha),
                       torch, reps=PLAIN_REPS)
    slab_bound, slab_by = halo_bound(y_loc, xh)
    print(f"K7 one 512-row slab of 2048^2: kernel {ms * 1e3:.2f} us a launch "
          f"in the bound 4-slab apply, {dev_ms * 1e3:.2f} us on the device "
          f"alone ({wrapper_ms * 1e3:.2f} us through the wrapper, bound by "
          f"its checks), plain {plain_ms * 1e3:.2f} us, bound "
          f"{slab_bound * 1e3:.2f} us ({slab_by})", flush=True)
    del phase, x, out, whole, args
    coeffs, v = dslash.make_operator(2048, 2, dev)
    applies = {"K1": dslash.make_step("wilson-r1", coeffs)[0]}
    for ny in (1, 4):
        applies[f"K7 x {ny}"] = dslash.make_step("wilson-r1", coeffs,
                                                 shards=ny)[0]
    for label, fn in list(applies.items()) + [("K1 again", applies["K1"])]:
        t = time_ms(lambda: fn(v), torch)
        ny = int(label[-1]) if label.startswith("K7") else 1
        t_bound = (ny * halo_bound(2048 // ny, 1024)[0]
                   if label.startswith("K7")
                   else wilson_bound("K1", 2048 * 2048)[0])
        print(f"sharded apply 2048^2 {label}: {t * 1e3:.2f} us/apply (halo "
              f"rows taken in place + {ny} launch(es)), bound "
              f"{t_bound * 1e3:.2f} us", flush=True)
    return worst, (ms, plain_ms, slab_bound, slab_by, wrapper_ms, dev_ms)


def nccl_phase(torch, dev):
    """Phase 13: the 512^2 problem on a distributed mesh of one rank,
    built by the sharded setup (``kcycle.build_problem(mesh=)``: the
    solvers' sums and the coarse gather on NCCL, the digest check of the
    coarse levels), then solved with K7 on level 0."""
    import tempfile
    import torch.distributed as dist
    from qmg_tpu_torch.parallel import Mesh
    from qmg_tpu_torch.kcycle import (build_problem, run_solver,
                                      print_report, reset_launch_counts,
                                      launch_counts)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = Mesh(1, 1, dist.group.WORLD)
            problem = build_problem(512, dev, mesh=mesh)
            reset_launch_counts()
            r = run_solver(problem)
            torch.cuda.synchronize()
            counts = launch_counts()
        finally:
            dist.destroy_process_group()
    print("--- 512^2 sharded setup + wilson-r1 on a distributed mesh of 1 "
          "rank (NCCL)", flush=True)
    print_report(r)
    print(f"bytes handed to the collectives: {mesh.sent}; launches "
          f"{counts}", flush=True)
    check_solve(r, "512^2 NCCL world size 1")
    check(abs(r["iters"] - JAX_ITERS_512) <= 1,
          f"512^2 NCCL outer iterations {r['iters']} vs qmg_tpu's "
          f"{JAX_ITERS_512}")
    check(counts["wilson_r1_halo"] > 0 and counts["wilson_r1"] == 0,
          "the distributed path did not run the slab kernel alone")
    check(mesh.sent["sum"] > 0 and mesh.sent["gather"] > 0
          and mesh.sent["halo"] == 0,
          f"one rank must reduce and gather but send no halo: {mesh.sent}")
    check(mesh.sent["digest"] > 0 and problem["setup"] == "sharded kcycle",
          f"the sharded setup and its digest check of the coarse levels "
          f"did not run: {problem['setup']}, {mesh.sent}")


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
    """Phases 7 and 8. Returns {kernel: launches over its path's run} and
    the 2048^2 rank-1 solve's report."""
    from qmg_tpu_torch import solve as solve_module
    from qmg_tpu_torch.kcycle import (build_problem, run_solver,
                                      print_report, reset_launch_counts,
                                      launch_counts)
    launches = {}
    # Calls of the split-layout copies from the solve's applies.
    copies = {"x_to_split": 0, "x_from_split": 0}

    def counted(name):
        inner = getattr(solve_module, name)

        def fn(t):
            copies[name] += 1
            return inner(t)
        return fn

    for name in copies:
        setattr(solve_module, name, counted(name))

    def no_copies(label):
        check(not any(copies.values()), f"{label} made layout copies: "
              f"{copies}")
        print(f"{label}: no x_to_split / x_from_split call", flush=True)

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
    no_copies("2048^2 matrix + small")
    r_prof = run_solver(big, fine_kernel="matrix", coarse_apply="small",
                        profile=True)
    check(r_prof["device_kernels"] > 0 and r_prof["iters"] == r_ms["iters"],
          "the profiled 2048^2 matrix + small solve counted no device kernel")
    print(f"2048^2 matrix + small: {r_prof['device_kernels']} device kernels "
          f"in one profiled solve, {r_prof['device_busy_ms']:.3f} ms of "
          f"device time, {r_ms['launches']['dslash_small']} K6 and "
          f"{r_ms['launches']['dslash']} K4 launches a solve", flush=True)
    r_sg, c = path(big, "2048^2 matrix-split + gather coarse",
                   fine_kernel="matrix-split", coarse_apply="gather")
    check(r_sg["launches"]["dslash_split"] > 0,
          "2048^2 matrix-split: K5 not launched in the timed solve")
    check(copies["x_to_split"] > 0 and copies["x_from_split"] > 0,
          "the matrix-split path must pass through the layout copies")
    copies.update(x_to_split=0, x_from_split=0)
    launches["dslash_split"] = c["dslash_split"]
    r_ph, c = path(big, "2048^2 wilson-phase + plain coarse",
                   fine_kernel="wilson-phase")
    check(r_ph["launches"]["wilson_phase"] > 0,
          "2048^2 wilson-phase: K2 not launched in the timed solve")
    launches["wilson_phase"] = c["wilson_phase"]
    # --- 12. level 0 cut into 4 y-slabs held in this process ---
    from qmg_tpu_torch.parallel import Mesh
    r_sh, c = path(dict(big, mesh=Mesh(4, 1)), "2048^2 wilson-r1 on 4 slabs")
    check(r_sh["launches"]["wilson_r1_halo"]
          == 4 * r_r1["launches"]["wilson_r1"]
          and c["wilson_r1"] == 0,
          f"2048^2 on 4 slabs: {r_sh['launches']['wilson_r1_halo']} K7 "
          f"launches a solve against 4 x {r_r1['launches']['wilson_r1']} "
          f"K1 launches of the unsharded path; K1 launches {c['wilson_r1']}")
    launches["wilson_r1_halo"] = c["wilson_r1_halo"]
    for r in (r_ms, r_sg, r_ph, r_sh):
        check(abs(r["iters"] - r_r1["iters"]) <= 1,
              f"2048^2 outer iterations {r['iters']} "
              f"({r['level_applies'][0]}) vs {r_r1['iters']} (wilson-r1)")
    print(f"2048^2 outer iterations wilson-r1 {r_r1['iters']}, matrix+small "
          f"{r_ms['iters']}, matrix-split+gather {r_sg['iters']}, "
          f"wilson-phase {r_ph['iters']}, wilson-r1 on 4 slabs "
          f"{r_sh['iters']}: ok", flush=True)
    del big

    mid = build_problem(512, dev)
    r, _ = path(mid, "512^2 matrix + small coarse", fine_kernel="matrix",
                coarse_apply="small")
    check(abs(r["iters"] - JAX_ITERS_512_MATRIX_SMALL) <= 2,
          f"512^2 matrix+small outer iterations {r['iters']} vs qmg_tpu's "
          f"{JAX_ITERS_512_MATRIX_SMALL}")
    check(r["launches"]["dslash_small"] > 0,
          "512^2 matrix + small: K6 not launched in the timed solve")
    r_bf, _ = path(mid, "512^2 matrix + small coarse, bf16 coefficients",
                   fine_kernel="matrix", coarse_apply="small",
                   coeff_dtype=torch.bfloat16)
    no_copies("512^2 matrix + small (f32 and bf16)")
    print(f"512^2 outer iterations matrix+small {r['iters']} (qmg_tpu "
          f"{JAX_ITERS_512_MATRIX_SMALL}), bf16 coefficients "
          f"{r_bf['iters']}: ok", flush=True)
    del mid

    # --- 9. a Wilson operator at w != 1 ---
    other = build_problem(512, dev, wilson_coeff=W_OTHER)
    r_k2, c = path(other, f"512^2 w={W_OTHER} wilson-phase",
                   fine_kernel="wilson-phase")
    check(r_k2["launches"]["wilson_phase"] > 0,
          f"512^2 w={W_OTHER}: K2 not launched in the timed solve")
    r_pl, _ = path(other, f"512^2 w={W_OTHER} plain fine apply",
                   fine_kernel=None)
    check(abs(r_k2["iters"] - r_pl["iters"]) <= 1
          and abs(r_k2["iters"] - JAX_ITERS_512_W_OTHER) <= 2,
          f"512^2 w={W_OTHER} outer iterations: wilson-phase "
          f"{r_k2['iters']}, plain {r_pl['iters']}, qmg_tpu "
          f"{JAX_ITERS_512_W_OTHER}")
    try:
        run_solver(other, fine_kernel="wilson-r1")
    except ValueError as e:
        print(f"wilson-r1 at w={W_OTHER} refused: {e}", flush=True)
    else:
        check(False, f"wilson-r1 accepted a Wilson operator at w={W_OTHER}")
    print(f"512^2 w={W_OTHER} outer iterations wilson-phase "
          f"{r_k2['iters']}, plain {r_pl['iters']} (qmg_tpu "
          f"{JAX_ITERS_512_W_OTHER}): ok", flush=True)
    return launches, r_r1


def dslash_chains(torch, dev):
    """Phase 10: the 2048^2 chains through K3 and K2, beside K1's, and
    the 32^2 nc8 chains through K6's two entries beside the plain one.
    Returns (K3's launches over its timed run, those of K6's split
    entry over its)."""
    from qmg_tpu_torch import dslash
    from qmg_tpu_torch.kcycle import reset_launch_counts, launch_counts
    operator = dslash.make_operator(2048, 2, dev)
    short = {kind: dslash.run(2048, kind, iters=20, device=dev,
                              operator=operator)["checksum"]
             for kind in dslash.WILSON_KINDS}
    launches = {}
    for kind in dslash.WILSON_KINDS:
        name = kind.replace("-", "_")
        reset_launch_counts()
        r = dslash.run(2048, kind, iters=200, device=dev, operator=operator)
        launches[name] = launch_counts()[name]
        err = abs(short[kind] - short["wilson-r1"]) / abs(short["wilson-r1"])
        print(f"dslash chain 2048^2 {kind}: {r['us_per_apply']:.2f} us/step "
              f"(apply + renormalisation), {r['gbs']:.1f} GB/s = "
              f"{r['pct_of_hbm']:.1f}% of peak; {launches[name]} launches; "
              f"checksum after 20 steps {short[kind]:.6f} vs wilson-r1's "
              f"{short['wilson-r1']:.6f} (rel {err:.2e})", flush=True)
        check(launches[name] > 0, f"the {kind} chain launched no {name}")
        check(err <= CHAIN_TOL and np.isfinite(short[kind]),
              f"the {kind} chain's checksum differs from wilson-r1's")
    operator = dslash.make_operator(32, 8, dev)
    plain = dslash.run(32, "plain", 8, iters=20, device=dev,
                       operator=operator)["checksum"]
    for kind in ("small", "small-split"):
        reset_launch_counts()
        r = dslash.run(32, kind, 8, iters=200, device=dev, operator=operator)
        launches[kind] = launch_counts()["dslash_small"]
        short = dslash.run(32, kind, 8, iters=20, device=dev,
                           operator=operator)["checksum"]
        err = abs(short - plain) / abs(plain)
        print(f"dslash chain 32^2 nc8 {kind}: {r['us_per_apply']:.2f} "
              f"us/step (apply + renormalisation); {launches[kind]} "
              f"launches; checksum after 20 steps {short:.6f} vs the plain "
              f"chain's {plain:.6f} (rel {err:.2e})", flush=True)
        check(launches[kind] > 0, f"the {kind} chain launched no K6")
        check(err <= KERNEL_TOL and np.isfinite(short),
              f"the {kind} chain's checksum differs from the plain chain's")
    return launches["wilson_split"], launches["small-split"]


NRHS = 8
# (Y, Xh) of phase 14: K1 at the batched solve's fine level and at 2048^2,
# K6 at its two small levels (nc 8).
RHS_K1_SHAPES = ((512, 256), (2048, 1024))
RHS_K6_SHAPES = ((32, 16), (8, 4))
# Phase 16: the stream's lattice and (configurations, thermalization
# updates, updates between configurations). 200 updates from the cold start
# settle the gauge modes of wavelengths up to ~2 pi sqrt(200) ~ 90 lattice
# units, far beyond the pion's correlation length of ~10.
STREAM_L = 512
STREAM_COUNTS = (3, 200, 5)
# The correlator of the stream's first configuration against the one that
# plain applies and sequential solves give on the same configuration:
# timeslices 0..STREAM_REF_T - 1 within STREAM_REF_RTOL (the CPU test's
# tolerance against qmg_tpu's stream).
STREAM_REF_T = 16
STREAM_REF_RTOL = 1e-3
# K1's device-alone times (us) recorded before the kernel took an rhs axis
# (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W), against which the
# single-field entry, now the nrhs = 1 case of the rhs kernel, is printed.
K1_BEFORE_RHS_DEVICE_US = {512: 4.01, 2048: 110.35}


def lanes_equal(torch, got, single):
    """Every lane of ``got`` bit for bit ``single(lane)``."""
    return all(torch.equal(got[b], single(b)) for b in range(got.shape[0]))


def rhs_kernel_phase(torch, wk, dk, dev):
    """Phase 14. Returns ({kernel: worst abs error vs its twin},
    {kernel: (ms, plain_ms, bound_ms, bound_by, bound-apply ms, device
    ms)} at the batched solve's shapes: K1 at 512^2, K6 at 32^2 nc8)."""
    worst = {"K1rhs": 0.0, "K6rhs": 0.0}
    times = {}
    alpha = 2.0 - 0.06
    for y_len, xh in RHS_K1_SHAPES:
        rng = np.random.default_rng(y_len + 3)
        phase = torch.as_tensor(
            0.5 * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                          (4, 2, y_len, xh))),
            dtype=torch.complex64, device=dev)
        x = torch.as_tensor(rng.normal(size=(NRHS, 2, y_len, xh, 2))
                            + 1j * rng.normal(size=(NRHS, 2, y_len, xh, 2)),
                            dtype=torch.complex64, device=dev)
        got = wk.wilson_r1_rhs_apply(phase, x, alpha)
        rhs_apply = wk.bind_wilson(wk.wilson_r1_rhs_apply, phase, x.shape,
                                   alpha)
        single = wk.bind_wilson(wk.wilson_r1_apply, phase, x.shape[1:],
                                alpha)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, wk.wilson_r1_apply_plain(phase, x,
                                                             alpha))
        worst["K1rhs"] = max(worst["K1rhs"], abs_err)
        same = lanes_equal(torch, got, lambda b: single(x[b]))
        check(rel <= KERNEL_TOL and same and torch.equal(rhs_apply(x), got),
              f"K1's rhs entry at {y_len}^2: rel err {rel:.3e}, lanes equal "
              f"to the single-field kernel {same}")
        ms, apply_ms, dev_ms = three_ways(
            lambda: wk.wilson_r1_rhs_apply(phase, x, alpha),
            lambda: rhs_apply(x), torch)

        def eight():
            for b in range(NRHS):
                single(x[b])
        eight_ms, eight_dev = time_ms(eight, torch), graph_ms(eight, torch)
        one_dev = graph_ms(lambda: single(x[0]), torch)
        plain_ms = time_ms(lambda: wk.wilson_r1_apply_plain(phase, x, alpha),
                           torch, reps=PLAIN_REPS)
        b_ms, b_by = wilson_bound("K1", 2 * y_len * xh, NRHS)
        print(f"K1 rhs {y_len}^2 nrhs {NRHS}: rel err {rel:.3e}, lanes bit "
              f"for bit the single-field kernel's; us through the wrapper "
              f"{ms * 1e3:.2f}, through bind_wilson {apply_ms * 1e3:.2f}, on "
              f"the device alone {dev_ms * 1e3:.2f}, bound {b_ms * 1e3:.2f} "
              f"({b_by}); 8 single-field launches {eight_ms * 1e3:.2f} "
              f"bound, {eight_dev * 1e3:.2f} on the device alone; plain "
              f"{plain_ms * 1e3:.2f}", flush=True)
        before = K1_BEFORE_RHS_DEVICE_US.get(y_len, float("nan"))
        print(f"K1 nrhs 1 (the single-field entry) {y_len}^2: "
              f"{one_dev * 1e3:.2f} us on the device alone, before the rhs "
              f"axis {before:.2f} "
              f"({100 * (one_dev * 1e3 / before - 1):+.1f}%)", flush=True)
        times.setdefault("K1rhs", (ms, plain_ms, b_ms, b_by, apply_ms,
                                   dev_ms))
        del phase, x, got
    for y_len, xh in RHS_K6_SHAPES:
        nc = 8
        gen = torch.Generator(device=dev).manual_seed(77 + y_len)
        ch = torch.randn((5, 2, y_len, xh, nc, nc), dtype=torch.complex64,
                         device=dev, generator=gen)
        x = torch.randn((NRHS, 2, y_len, xh, nc), dtype=torch.complex64,
                        device=dev, generator=gen)
        ref = dk.dslash_apply_plain(ch, x)
        single = dk.bind_apply(dk.dslash_small_interleaved_apply, ch,
                               x.shape[1:])
        sites = 2 * y_len * xh
        b_ms, b_by = bound(dk.apply_bytes(nc, sites, nrhs=NRHS),
                           40 * nc * nc * sites * NRHS)
        rhs_apply = dk.bind_apply(dk.dslash_small_rhs_apply, ch, x.shape)
        got = dk.dslash_small_rhs_apply(ch, x)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, ref)
        worst["K6rhs"] = max(worst["K6rhs"], abs_err)
        same = lanes_equal(torch, got, lambda b: single(x[b]))
        check(rel <= KERNEL_TOL and same and torch.equal(rhs_apply(x), got),
              f"K6's rhs entry at {y_len}^2 nc8: rel err {rel:.3e}, lanes "
              f"equal to the single-field kernel {same}")
        blocks, threads, sms = dk.small_grid(nc, y_len, xh, nrhs=NRHS)
        ms, apply_ms, dev_ms = three_ways(
            lambda: dk.dslash_small_rhs_apply(ch, x),
            lambda: rhs_apply(x), torch)

        def eight():
            for b in range(NRHS):
                single(x[b])
        eight_ms, eight_dev = time_ms(eight, torch), graph_ms(eight, torch)
        plain_ms = time_ms(lambda: dk.dslash_apply_plain(ch, x), torch,
                           reps=PLAIN_REPS)
        print(f"K6 rhs {y_len}^2 nc8 nrhs {NRHS}, {NRHS} block rows of "
              f"{blocks} blocks x {threads} threads ({sms} SMs): rel err "
              f"{rel:.3e}, lanes bit for bit the single-field kernel's; us "
              f"through the wrapper {ms * 1e3:.2f}, through bind_apply "
              f"{apply_ms * 1e3:.2f}, on the device alone {dev_ms * 1e3:.2f}, "
              f"bound {b_ms * 1e3:.2f} ({b_by}); 8 single-field launches "
              f"{eight_ms * 1e3:.2f} bound, {eight_dev * 1e3:.2f} on the "
              f"device alone; plain {plain_ms * 1e3:.2f}", flush=True)
        times.setdefault("K6rhs", (ms, plain_ms, b_ms, b_by, apply_ms,
                                   dev_ms))
    return worst, times


# Phase 14's K7 rhs row: one rank's slab of the 4096^2 four-card cell.
HALO_RHS_SLAB = (1024, 2048)   # (Y_loc, Xh)
HALO_RHS_NRHS = 4


def halo_rhs_phase(torch, wk, dev):
    """Phase 14, K7's rhs entry on the slab one rank of the four-card
    4096^2 cell holds, 1024 x 4096 at nrhs 4, with received halo buffers
    (what ``make_sharded_wilson`` hands it): against its twin and field by
    field against one-field K7 launches, timed three ways beside 4
    one-field launches. Returns (worst abs error vs the twin, (ms,
    plain_ms, bound_ms, bound_by, bound-apply ms, device ms))."""
    y_loc, xh = HALO_RHS_SLAB
    n = HALO_RHS_NRHS
    alpha = 2.0 - 0.06
    rng = np.random.default_rng(y_loc + 11)
    phase = torch.as_tensor(
        0.5 * np.exp(1j * rng.uniform(-np.pi, np.pi, (4, 2, y_loc, xh))),
        dtype=torch.complex64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4096)
    x = torch.randn((n, 2, y_loc, xh, 2), dtype=torch.complex64,
                    device=dev, generator=gen)
    top, bot = (torch.randn((n, 2, xh, 2), dtype=torch.complex64,
                            device=dev, generator=gen) for _ in range(2))
    rhs = wk.bind_halo(phase, alpha, own_halos=False, nrhs=n)
    single = wk.bind_halo(phase, alpha, own_halos=False)
    tops = [t.contiguous() for t in top]
    bots = [b.contiguous() for b in bot]
    got = wk.wilson_r1_halo_apply(phase, x, top, bot, alpha)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, wk.wilson_r1_halo_apply_plain(
        phase, x, top, bot, alpha))
    same = all(torch.equal(got[b], single(x[b], tops[b], bots[b]))
               for b in range(n))
    check(rel <= HALO_TWIN_TOL and same
          and torch.equal(rhs(x, top, bot), got),
          f"K7's rhs entry on a {y_loc} x {2 * xh} slab: rel err "
          f"{rel:.3e}, fields equal to one-field K7 {same}")
    ms, apply_ms, dev_ms = three_ways(
        lambda: wk.wilson_r1_halo_apply(phase, x, top, bot, alpha),
        lambda: rhs(x, top, bot), torch)

    def singles():
        for b in range(n):
            single(x[b], tops[b], bots[b])
    singles_ms, singles_dev = time_ms(singles, torch), graph_ms(singles,
                                                                torch)
    plain_ms = time_ms(lambda: wk.wilson_r1_halo_apply_plain(
        phase, x, top, bot, alpha), torch, reps=PLAIN_REPS)
    sites = 2 * y_loc * xh
    b_ms, b_by = bound((32 + 32 * n) * sites + n * 2 * 2 * xh * 16,
                       52 * sites * n)
    print(f"K7 rhs {y_loc} x {2 * xh} slab nrhs {n}: rel err {rel:.3e}, "
          f"fields bit for bit one-field K7's; us through the wrapper "
          f"{ms * 1e3:.2f}, through bind_halo {apply_ms * 1e3:.2f}, on the "
          f"device alone {dev_ms * 1e3:.2f}, bound {b_ms * 1e3:.2f} "
          f"({b_by}); {n} one-field launches {singles_ms * 1e3:.2f} bound, "
          f"{singles_dev * 1e3:.2f} on the device alone; plain "
          f"{plain_ms * 1e3:.2f}", flush=True)
    return abs_err, (ms, plain_ms, b_ms, b_by, apply_ms, dev_ms)


MESH_SHAPE = (4, 1)       # phase 23's in-process mesh
MESH_BIG = 2048           # phase 23(a)'s lattice (n_refine 4)
MESH_SIZE = 512           # phase 23(b)-(d)'s lattice
MESH_BUDGET_S = 90


def mesh_phase(torch, dev, direct_big):
    """Phase 23: the mesh, the sharded setup and every formulation, on an
    in-process ``Mesh(4, 1)`` (the setup too: ``kcycle.build_problem(...,
    mesh=)``, ``make_kcycle_setup_planes(mesh=)``): (a) 2048^2 with K7 on
    level 0, its outer count within one of ``direct_big``'s (phase 7's
    unsharded 2048^2 solve) and its setup seconds beside that one's; (b)
    the 512^2 n19 Schur solve; (c) 512^2 with NRHS right-hand sides in one
    batched solve beside their sequential mesh solves; (d) 512^2
    ``--deflate 8`` with K7. Returns K7's launches over (a) and over one
    of (c)'s batched solves."""
    from qmg_tpu_torch.parallel import Mesh
    from qmg_tpu_torch.kcycle import (build_problem, run_solver,
                                      run_batched, print_report,
                                      print_batched_report,
                                      reset_launch_counts, launch_counts)
    t0 = time.perf_counter()
    mesh = Mesh(*MESH_SHAPE)
    shape = f"{MESH_SHAPE[0]}x{MESH_SHAPE[1]}"

    def mesh_solve(label, size, kw, solver_kw):
        reset_launch_counts()
        part = build_problem(size, dev, mesh=mesh, **kw)
        r = run_solver(part, **solver_kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"--- {label}", flush=True)
        print_report(r)
        print(f"launches over the sharded setup and the solves: {counts}",
              flush=True)
        check_solve(r, label)
        return r, counts

    # (a) 2048^2, K7 on level 0 after the sharded setup
    label = f"(a) {MESH_BIG}^2 sharded setup + wilson-r1 on {shape} blocks"
    r_a, c_a = mesh_solve(label, MESH_BIG, {}, {})
    check(abs(r_a["iters"] - direct_big["iters"]) <= 1,
          f"{label}: outer iterations {r_a['iters']} vs the unsharded "
          f"{direct_big['iters']}")
    check(c_a["wilson_r1_halo"] > 0 and c_a["wilson_r1"] == 0,
          f"{label}: K7 must run alone on level 0: {c_a}")
    print(f"{MESH_BIG}^2 setup s: sharded on {shape} blocks "
          f"{r_a['setup_s']:.3f}, unsharded {direct_big['setup_s']:.3f}; "
          f"outer iterations {r_a['iters']} (unsharded "
          f"{direct_big['iters']}); K7 launches {c_a['wilson_r1_halo']}",
          flush=True)
    # (b) the n19 Schur solve
    label = f"(b) {MESH_SIZE}^2 n19 Schur on {shape} blocks"
    r_b, c_b = mesh_solve(label, MESH_SIZE, dict(outer="schur"),
                          dict(fine_kernel=None))
    check(abs(r_b["iters"] - JAX_ITERS_512_SCHUR) <= 1,
          f"{label}: outer iterations {r_b['iters']} vs qmg_tpu's "
          f"{JAX_ITERS_512_SCHUR}")
    check(not any(c_b.values()), f"{label}: no kernel applies a Schur "
          f"operator, yet {c_b}")
    # (c) NRHS right-hand sides in one batched solve on the mesh, K7's rhs
    # entry on level 0
    label = f"(c) {MESH_SIZE}^2 nrhs {NRHS} batched on {shape} blocks"
    part = build_problem(MESH_SIZE, dev, mesh=mesh)
    r_c = run_batched(part, eight_rhs(torch, part, dev), "wilson-r1",
                      "plain")
    torch.cuda.synchronize()
    # One batched solve's launches: the sequential solves beside it launch
    # one-field K7 on the same counter.
    c_c = r_c["launches"]
    print(f"--- {label}; setup {part['setup_s']:.3f} s", flush=True)
    print_batched_report(r_c)
    check_batched(r_c, label)
    check(c_c["wilson_r1_halo"] > 0 and c_c["wilson_r1"] == 0
          and c_c["wilson_r1_rhs"] == 0,
          f"{label}: K7 must run alone on level 0 of the batched solve: "
          f"{c_c}")
    same = sum(a == b for a, b in zip(r_c["iters"], r_c["sequential_iters"]))
    print(f"{label}: {same} of {NRHS} lanes at their sequential mesh "
          "solve's count, the others within one", flush=True)
    del part
    # (d) the deflated coarsest, K7 on level 0
    label = f"(d) {MESH_SIZE}^2 --deflate {DEFLATE_N} on {shape} blocks"
    r_d, c_d = mesh_solve(label, MESH_SIZE, dict(deflate=DEFLATE_N), {})
    check(abs(r_d["iters"] - JAX_ITERS_512_DEFLATE) <= 1,
          f"{label}: outer iterations {r_d['iters']} vs qmg_tpu's "
          f"{JAX_ITERS_512_DEFLATE}")
    check(f"deflated by {DEFLATE_N}" in r_d["coarsest"]
          and c_d["wilson_r1_halo"] > 0,
          f"{label}: solved {r_d['coarsest']} with {c_d}")
    elapsed = time.perf_counter() - t0
    print(f"phase 23 took {elapsed:.1f} s (budget {MESH_BUDGET_S} s)",
          flush=True)
    check(elapsed <= MESH_BUDGET_S,
          f"phase 23 took {elapsed:.1f} s, over its {MESH_BUDGET_S} s")
    return c_a["wilson_r1_halo"], c_c["wilson_r1_halo"]


def rhs_counts():
    """The rhs entries' launch counts."""
    from qmg_tpu_torch.kcycle import launch_counts
    counts = launch_counts()
    return {k: counts[k] for k in ("wilson_r1_rhs", "dslash_small_rhs")}


def eight_rhs(torch, problem, dev):
    """The batched phases' NRHS right-hand sides: ``problem``'s own, 5
    gaussians from QMGRandom(2024), a point and a wall source."""
    from qmg_tpu_torch.rng import QMGRandom
    lat_shape = tuple(problem["b"].shape)
    rng = QMGRandom(2024)
    rhs = [problem["b"]] + [
        torch.as_tensor(rng.gaussian_cv(problem["op"].lat)).to(
            device=dev, dtype=torch.complex64) for _ in range(NRHS - 3)]
    point = torch.zeros(lat_shape, dtype=torch.complex64, device=dev)
    point[0, 0, 0, 0] = 1.0
    wall = torch.zeros(lat_shape, dtype=torch.complex64, device=dev)
    wall[:, 0] = 1.0
    return torch.stack(rhs + [point, wall])


def check_batched(r, label):
    """The checks of a ``kcycle.run_batched`` report: each lane's outer
    count within 1 of its sequential solve's (F5), every true residual
    within ``TRUE_RES_BOUND``, every lane converged, the solutions
    finite."""
    check(all(abs(a - b) <= 1 for a, b in zip(r["iters"],
                                              r["sequential_iters"])),
          f"{label}: batched lanes' outer iterations {r['iters']} vs "
          f"sequential {r['sequential_iters']}")
    worst = max(r["rel_res_true"] + r["sequential_rel_res_true"])
    check(worst <= TRUE_RES_BOUND and all(r["converged"]),
          f"{label}: a true residual exceeds {TRUE_RES_BOUND} or a lane did "
          f"not converge: {r['rel_res_true']} {r['sequential_rel_res_true']}")
    check(r["x_finite"], f"{label}: batched solution not finite")


def batched_phase(torch, dev):
    """Phase 15: NRHS right-hand sides (``eight_rhs``) on the 512^2
    problem in one batched solve through K1's and K6's rhs entries, 3
    turns against their sequential solves (``kcycle.run_batched``).
    Returns the rhs kernels' launches over the warm-up and the 3 batched
    solves."""
    from qmg_tpu_torch.kcycle import (build_problem, run_batched,
                                      print_batched_report,
                                      reset_launch_counts)
    problem = build_problem(512, dev)
    B = eight_rhs(torch, problem, dev)
    reset_launch_counts()
    r = run_batched(problem, B, "wilson-r1", "small", repeats=3)
    torch.cuda.synchronize()
    counts = rhs_counts()
    print(f"--- 512^2 batched solve, nrhs {NRHS} (6 gaussian, a point, a "
          "wall)", flush=True)
    print_batched_report(r)
    print(f"batched / sequential per rhs: "
          f"{r['batched_ms'] / r['sequential_ms']:.3f}; rhs-kernel launches "
          f"over the warm-up and 3 batched solves: {counts}", flush=True)
    check_batched(r, "phase 15")
    check(counts["wilson_r1_rhs"] > 0 and counts["dslash_small_rhs"] > 0,
          f"the batched solve did not launch the rhs kernels: {counts}")
    return counts


def stream_phase(torch, dev):
    """Phase 16. Returns the rhs kernels' launches over the stream."""
    from qmg_tpu_torch import stream
    from qmg_tpu_torch.kcycle import reset_launch_counts
    n_configs, n_therm, n_update = STREAM_COUNTS
    kw = dict(L=STREAM_L, n_refine=3, n_therm=n_therm, n_update=n_update,
              device=dev, verbose=False)
    log = []
    reset_launch_counts()
    t0 = time.perf_counter()
    mean, _, plaqs, iters, _ = stream.run_stream(
        n_configs=n_configs, batched=True, log=log, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = rhs_counts()
    # The first configuration again (the same draws), its two sources
    # solved one by one through the plain applies.
    _, _, ref_plaqs, ref_iters, ref_pions = stream.run_stream(
        n_configs=1, fine_kernel=None, coarse_apply="plain", **kw)
    ref = ref_pions[0][:STREAM_REF_T]
    ref_rel = float(np.max(np.abs(log[0]["pion"][:STREAM_REF_T] - ref)
                           / np.abs(ref)))
    hb_s = float(np.mean([e["heatbath_s"] for e in log])) / n_update
    print(f"--- stream {STREAM_L}^2, n_refine 3, batched, {n_configs} "
          f"configs, {n_therm} thermalization + {n_update} updates between "
          f"configs: {wall:.1f} s; heatbath {hb_s * 1e3:.1f} ms an update at "
          f"{STREAM_L}^2", flush=True)
    for e in log:
        print(f"config {e['config']}: plaq {e['plaq']:.6f}, outer iterations "
              f"per source {e['iters']}, heatbath {e['heatbath_s']:.3f} s, "
              f"setup {e['setup_s']:.3f} s, solves {e['solve_s']:.3f} s, "
              f"C(0..5) " + " ".join(f"{c:.4e}" for c in e["pion"][:6]),
              flush=True)
    print("mean C(0..5) " + " ".join(f"{c:.4e}" for c in mean[:6])
          + f"; rhs-kernel launches {counts}", flush=True)
    print(f"config 0 through plain applies and sequential solves: outer "
          f"iterations {ref_iters}, C(0..5) "
          + " ".join(f"{c:.4e}" for c in ref[:6])
          + f"; max rel difference over t < {STREAM_REF_T}: {ref_rel:.3e}",
          flush=True)
    check(len(plaqs) == n_configs,
          f"{n_configs - len(plaqs)} configuration(s) hit max_iter")
    check(all(0.85 < p < 0.97 for p in plaqs), f"plaquettes {plaqs}")
    check(ref_plaqs == plaqs[:1] and ref_rel <= STREAM_REF_RTOL,
          f"config 0's correlator differs from the plain path's: rel "
          f"{ref_rel:.3e}, plaquettes {plaqs[:1]} vs {ref_plaqs}")
    check(bool(np.all(mean[:8] > 0)) and mean[1] > mean[5],
          f"the correlator is not positive and decaying: {mean[:8]}")
    check(counts["wilson_r1_rhs"] > 0 and counts["dslash_small_rhs"] > 0,
          f"the stream did not launch the rhs kernels: {counts}")
    return counts


def schur_phase(torch, dev, standard):
    """Phase 17: the 512^2 n19 Schur solve beside ``standard`` (phase 4's
    result) and a standard solve with plain applies on one problem."""
    from qmg_tpu_torch.kcycle import (build_problem, run_solver,
                                      print_report, reset_launch_counts,
                                      launch_counts)
    from qmg_tpu_torch import stencil, linalg

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # torch.linalg.qr forms Q one matrix at a time on the card; the port's
    # site_inv_qr (one batched geqrf and n reflector products) does not.
    blocks = (torch.randn(16384, 2, 2, dtype=torch.complex64, device=dev)
              + 3 * torch.eye(2, device=dev))
    linalg.site_inv_qr(blocks)
    _, qr_ms = synced(lambda: torch.linalg.qr(blocks))
    inv, inv_ms = synced(lambda: linalg.site_inv_qr(blocks))
    check(float((inv @ blocks - torch.eye(2, device=dev)).abs().max())
          <= 1e-5, "site_inv_qr: B B^-1 != 1 on the card")
    print(f"16384 blocks of 2x2 c64: torch.linalg.qr {qr_ms:.2f} ms, "
          f"site_inv_qr (the whole inverse) {inv_ms:.2f} ms", flush=True)

    builds0 = dict(stencil.DERIVED_BUILDS)
    problem = build_problem(SCHUR_SIZE, dev, outer="schur")
    mg = problem["mg"]
    n_levels = mg.get_num_levels()
    for lvl in range(n_levels):
        st = mg.get_stencil(lvl)
        b_mat = stencil.mass_pattern(st.coeffs) + st.coeffs.clover
        _, qr_lvl = synced(lambda: linalg.site_inv_qr(b_mat))
        rbj, rbj_ms = synced(lambda: stencil.build_rbjacobi(st.coeffs))
        _, fused_ms = synced(lambda: stencil.build_rbj_schur_fused(rbj))
        print(f"level {lvl} {st.lat.x_len}x{st.lat.y_len} nc{st.lat.nc}: "
              f"site_inv_qr {qr_lvl:.2f} ms, build_rbjacobi {rbj_ms:.2f} "
              f"ms, build_rbj_schur_fused {fused_ms:.2f} ms", flush=True)
    builds1 = dict(stencil.DERIVED_BUILDS)
    # The fused sets the solver's make still has to build (the direct
    # coarsest's densification built the coarsest one in the setup).
    unbuilt = sum(not mg.get_stencil(lvl).built_rbj_schur_fused
                  for lvl in range(n_levels))
    reset_launch_counts()
    r = run_solver(problem, fine_kernel=None, profile=True, repeats=3)
    torch.cuda.synchronize()
    counts = launch_counts()
    builds2 = dict(stencil.DERIVED_BUILDS)
    print(f"--- {SCHUR_SIZE}^2 n19 Schur (outer schur)", flush=True)
    print_report(r)
    check_solve(r, "512^2 schur")
    check(abs(r["iters"] - JAX_ITERS_512_SCHUR) <= 1,
          f"Schur outer iterations {r['iters']} vs qmg_tpu's "
          f"{JAX_ITERS_512_SCHUR}")
    check(not any(counts.values()),
          f"the Schur solves launched kernels: {counts}")
    setup_builds = {k: builds1.get(k, 0) - builds0.get(k, 0)
                    for k in builds1}
    solve_builds = {k: n - builds1.get(k, 0) for k, n in builds2.items()
                    if n != builds1.get(k, 0)}
    check(solve_builds == ({"schur_fused": unbuilt} if unbuilt else {}),
          f"derived sets built over the solver's make and 5 solves: "
          f"{solve_builds}, expected the {unbuilt} unbuilt fused Schur sets "
          "once")
    print(f"derived sets built in the setup {setup_builds}, by the solver "
          f"{solve_builds} (once, before its 5 solves); kernel launches "
          f"{counts}", flush=True)

    # --- the fused apply against the two half applies at 512^2 ---
    op = problem["op"]
    rbj, fused = op.rbjacobi, op._rbj_schur_fused
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(op.solve_size_shape(stencil.StencilType.RIGHT_SCHUR),
                    dtype=torch.complex64, device=dev, generator=gen)
    got = stencil.apply_rbj_schur_fused(fused, x)
    ref = stencil.apply_rbj_schur(rbj, x)
    abs_err, rel = rel_err(got, ref)
    fused_ms = time_ms(lambda: stencil.apply_rbj_schur_fused(fused, x),
                       torch)
    halves_ms = time_ms(lambda: stencil.apply_rbj_schur(rbj, x), torch)
    print(f"{SCHUR_SIZE}^2 Schur apply: fused {fused_ms * 1e3:.2f} us, two "
          f"half applies {halves_ms * 1e3:.2f} us (CUDA events, 100 calls); "
          f"max abs err {abs_err:.3e}, relative {rel:.3e}", flush=True)
    check(rel <= SCHUR_APPLY_TOL,
          f"fused Schur apply vs apply_rbj_schur: {rel:.3e}")

    # --- the standard formulation on one problem, plain applies ---
    plain = run_solver(build_problem(SCHUR_SIZE, dev), fine_kernel=None,
                       repeats=3)
    print(f"--- {SCHUR_SIZE}^2 standard (outer original), plain applies",
          flush=True)
    print_report(plain)
    check_solve(plain, "512^2 standard, plain applies")
    print(f"{SCHUR_SIZE}^2 Schur against standard: setup s, solve ms, ms "
          "per outer iteration, outer iterations", flush=True)
    for label, res in (("schur, plain applies", r),
                       ("standard, plain applies", plain),
                       ("standard, wilson-r1 (phase 4)", standard)):
        print(f"  {label}: {res['setup_s']:.3f} s, {res['solve_ms']:.3f} "
              f"ms, {res['ms_per_iter']:.3f} ms, {res['iters']}",
              flush=True)
    print(f"  schur profiled solve: {r['device_kernels']} device kernels, "
          f"device busy {r['device_busy_ms']:.3f} ms = "
          f"{100 * r['device_busy_ms'] / r['solve_ms']:.1f}% of the median "
          f"solve", flush=True)


def deflation_phase(torch, dev, direct, direct_big):
    """Phase 18: the deflated CG coarsest at 512^2 and 2048^2, its
    eigenpairs, a checkpoint round trip, the refined solve and the CGNE
    smoother. ``direct`` is phase 4's 512^2 direct-coarsest solve,
    ``direct_big`` phase 7's 2048^2 one. Returns the refined solve's
    passes."""
    import dataclasses
    import tempfile
    from qmg_tpu_torch.kcycle import (build_problem, run_solver,
                                      print_report, reset_launch_counts,
                                      launch_counts)
    from qmg_tpu_torch import checkpoint, eig
    from qmg_tpu_torch.solve import make_refined_solver
    from qmg_tpu_torch.stencil import StencilType
    size, big_size = DEFLATE_SIZES

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def path(problem, label, **kw):
        print(f"--- {label}", flush=True)
        reset_launch_counts()
        r = run_solver(problem, **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        print_report(r)
        print(f"launches over the path: {counts}", flush=True)
        check_solve(r, label)
        return r, counts

    # --- (a) 512^2, plain coarse levels, then K6 on those it takes ---
    mid = build_problem(size, dev, deflate=DEFLATE_N)
    r_a, c = path(mid, f"{size}^2 --deflate {DEFLATE_N} wilson-r1 + plain "
                  "coarse", profile=True)
    check(c["wilson_r1"] > 0 and r_a["launches"]["wilson_r1"] > 0,
          f"{size}^2 --deflate: K1 not launched")
    check(r_a["coarsest"] == f"mdagger_m, deflated by {DEFLATE_N} "
          "eigenpairs", f"{size}^2 --deflate: coarsest {r_a['coarsest']}")
    check(abs(r_a["iters"] - JAX_ITERS_512_DEFLATE) <= 2,
          f"{size}^2 --deflate outer iterations {r_a['iters']} vs "
          f"qmg_tpu's {JAX_ITERS_512_DEFLATE}")
    r_s, c = path(mid, f"{size}^2 --deflate {DEFLATE_N} wilson-r1 + small "
                  "coarse", coarse_apply="small")
    check(c["dslash_small"] > 0 and r_s["launches"]["dslash_small"] > 0
          and r_s["launches"]["wilson_r1"] > 0,
          f"{size}^2 --deflate --coarse-apply small: K1 or K6 not launched")
    print(f"{size}^2 --deflate {DEFLATE_N} outer iterations: plain coarse "
          f"{r_a['iters']}, small coarse {r_s['iters']} (qmg_tpu "
          f"{JAX_ITERS_512_DEFLATE}): ok", flush=True)

    # --- (b) the stage's eigenpairs on the card's coarsest operator ---
    mg = mid["mg"]
    st = mg.get_stencil(mg.get_num_levels() - 1)
    mv = st.get_apply_function(StencilType.MDAGGER_M)
    worst = 0.0
    for lam, v in zip(mg.coarsest_evals, mg.coarsest_evecs):
        worst = max(worst, float(torch.linalg.vector_norm(mv(v) - lam * v)
                                 / abs(lam)))
    check(worst <= DEFLATE_EIG_TOL,
          f"deflation eigenpairs: ||A v - lambda v|| / |lambda| = {worst:.3e}")
    _, stage_ms = synced(lambda: mg.deflate_coarsest(DEFLATE_N, 0))
    ref = st.coeffs.ref
    dense, _ = eig.dense_eigensystem(mv, st.lat.cv_shape(), dtype=ref.dtype,
                                     device=ref.device)
    lows = np.sort(dense.real)
    gap = (lows[DEFLATE_N] - lows[DEFLATE_N - 1]) / lows[DEFLATE_N - 1]
    print(f"deflation stage ({st.lat.x_len}x{st.lat.y_len} nc{st.lat.nc}, "
          f"dimension {lows.size}): {stage_ms:.2f} ms; eigenvalues "
          f"{lows[:DEFLATE_N + 1]}; relative gap at the cut {gap:.3e}; "
          f"worst ||A v - lambda v|| / |lambda| {worst:.3e}", flush=True)

    # --- (d) checkpoint round trip ---
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "mg.npz")
        _, save_ms = synced(lambda: checkpoint.save_hierarchy(mg, ckpt))
        loaded, load_ms = synced(lambda: checkpoint.load_hierarchy(
            ckpt, mid["op"], device="cuda"))
    r_d = run_solver(dict(mid, mg=loaded))
    check_solve(r_d, f"{size}^2 --deflate from a checkpoint")
    check(r_d["iters"] == r_a["iters"],
          f"checkpointed hierarchy: {r_d['iters']} outer iterations vs "
          f"{r_a['iters']}")
    print(f"checkpoint: save {save_ms:.1f} ms, load {load_ms:.1f} ms, "
          f"{r_d['iters']} outer iterations as before: ok", flush=True)

    # --- (e) the refined solve to a complex128 1e-10 ---
    refined = make_refined_solver(mg, tol=REFINE_TOL, inner_tol=1e-5,
                                  max_iter=200, restart_freq=mid["restart"])
    res, refine_ms = synced(lambda: refined(mid["b"]))
    check(res.converged and res.rel_resid <= REFINE_TOL,
          f"refined solve: {res.rel_resid:.3e} after {res.outer_iters} "
          f"passes, history {res.history}")
    print(f"refined solve {size}^2: true complex128 residual "
          f"{res.rel_resid:.3e} in {res.outer_iters} passes, "
          f"{res.inner_iters} K-cycle iterations, {refine_ms:.1f} ms; "
          f"history {[f'{h:.2e}' for h in res.history]}", flush=True)

    # --- (f) the CGNE smoother on level 0 ---
    saved = mg.level_solve_list[0]
    mg.level_solve_list[0] = dataclasses.replace(saved, pre_cgne=True,
                                                 post_cgne=True)
    try:
        r_f, _ = path(mid, f"{size}^2 --deflate {DEFLATE_N}, CGNE smoother on "
                      "level 0")
    finally:
        mg.level_solve_list[0] = saved
    del mid, mg, loaded

    # --- (c) 2048^2 ---
    big = build_problem(big_size, dev, deflate=DEFLATE_N)
    r_c, c = path(big, f"{big_size}^2 --deflate {DEFLATE_N} wilson-r1",
                  profile=True)
    check(c["wilson_r1"] > 0 and r_c["launches"]["wilson_r1"] > 0,
          f"{big_size}^2 --deflate: K1 not launched")
    del big

    print("deflated against direct coarsest: setup s, solve ms, ms per "
          "outer iteration, outer iterations, per-level iterations, coarsest "
          "iterations per visit, device kernels in one profiled solve",
          flush=True)
    for label, r in ((f"{size}^2 --deflate {DEFLATE_N}", r_a),
                     (f"{size}^2 --deflate {DEFLATE_N} + small", r_s),
                     (f"{size}^2 --deflate {DEFLATE_N} CGNE level 0", r_f),
                     (f"{size}^2 direct (phase 4)", direct),
                     (f"{big_size}^2 --deflate {DEFLATE_N}", r_c),
                     (f"{big_size}^2 direct (phase 7)", direct_big)):
        kernels = r["device_kernels"]
        print(f"  {label}: {r['setup_s']:.3f} s, {r['solve_ms']:.3f} ms, "
              f"{r['ms_per_iter']:.3f} ms, {r['iters']}, {r['level_iters']}, "
              f"{r['coarsest_iters_per_visit']:.2f}, "
              + (f"{kernels}" if kernels is not None else "not profiled"),
              flush=True)
    return res.outer_iters


def count_device_ops(torch, fn):
    """Runs ``fn()`` counting the aten operations it dispatches on the card
    (views excluded; each of the others launches at least one kernel, a
    copy of a scalar to the host included) and among them the scalar
    read-backs (``.item()``, ``bool()``: one synchronisation each).
    Returns (fn's result, operations, read-backs)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    item = torch.ops.aten._local_scalar_dense.default

    class Counter(TorchDispatchMode):
        ops = reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is item:
                if args[0].is_cuda:
                    Counter.ops += 1
                    Counter.reads += 1
            elif not func.is_view and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in tree_leaves(out)):
                Counter.ops += 1
            return out

    with Counter():
        result = fn()
    torch.cuda.synchronize()
    return result, Counter.ops, Counter.reads


def check_finite_hierarchy(torch, mg, label):
    """Every coefficient, null vector and the dense inverse of ``mg``
    finite."""
    arrays = {"cdinv": mg.coarsest_dinv}
    for lvl in range(mg.get_num_levels()):
        c = mg.get_stencil(lvl).coeffs
        arrays[f"clover{lvl}"], arrays[f"hopping{lvl}"] = c.clover, c.hopping
    for lvl in range(mg.get_num_levels() - 1):
        arrays[f"nvb{lvl}"] = mg.get_transfer(lvl)._nvb
    bad = [k for k, a in arrays.items() if a is not None and not bool(
        torch.isfinite(torch.view_as_real(a)).all())]
    check(not bad, f"{label}: non-finite {bad}")


def adaptive_phase(torch, dev, problem):
    """Phase 19 on ``problem``, phase 4's 512^2 problem. Returns the
    launches of K1 and K6 over the adapted hierarchy's K1 + K6 path."""
    from qmg_tpu_torch.kcycle import (adaptive_problem, run_solver,
                                      print_report, reset_launch_counts,
                                      launch_counts)
    size = problem["size"]

    def stages_line(p):
        return ", ".join(f"{label} {sec:.3f}" for label, sec in p["stages"])

    def path(p, label, **kw):
        print(f"--- {label}", flush=True)
        reset_launch_counts()
        r = run_solver(p, **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        print_report(r)
        print(f"launches over the path: {counts}", flush=True)
        check_solve(r, label)
        check(r["launches"]["wilson_r1"] > 0 and counts["wilson_r1"] > 0,
              f"{label}: K1 not launched")
        return r, counts

    adapted = adaptive_problem(problem, 1)
    check_finite_hierarchy(torch, adapted["mg"], f"{size}^2 adaptive setup")
    print(f"{size}^2 adaptive setup (n_setup 1, dense coarsest): "
          f"{adapted['setup_s']:.3f} s; stages s: {stages_line(adapted)}",
          flush=True)
    rich = adaptive_problem(problem, 0, seeds=(adapted["seeds"][0], []))
    check_finite_hierarchy(torch, rich["mg"], f"{size}^2 Richardson setup")
    print(f"{size}^2 Richardson-only setup (n_setup 0): {rich['setup_s']:.3f}"
          f" s; stages s: {stages_line(rich)}", flush=True)
    r0, _ = path(rich, f"{size}^2 Richardson-only hierarchy, wilson-r1")
    del rich
    r1, _ = path(adapted, f"{size}^2 adapted hierarchy, wilson-r1",
                 profile=True)
    r6, c6 = path(adapted, f"{size}^2 adapted hierarchy, wilson-r1 + small "
                  "coarse", coarse_apply="small")
    check(r6["launches"]["dslash_small"] > 0 and c6["dslash_small"] > 0,
          f"{size}^2 adapted, small coarse: K6 not launched")
    for r in (r1, r6):
        check(r["iters"] <= r0["iters"] + 1,
              f"{size}^2 adapted hierarchy ({r['level_applies']}): "
              f"{r['iters']} outer iterations against the Richardson-only "
              f"{r0['iters']}")
    j1, j0 = JAX_ITERS_512_ADAPTIVE
    check(abs(r1["iters"] - j1) <= 2 and abs(r0["iters"] - j0) <= 2,
          f"{size}^2 adaptive outer iterations {r1['iters']} (Richardson-"
          f"only {r0['iters']}) vs qmg_tpu's {j1} ({j0})")
    print(f"{size}^2 outer iterations: adapted {r1['iters']}, K1 + K6 "
          f"{r6['iters']}, Richardson-only {r0['iters']} (qmg_tpu {j1}, "
          f"{j0}): ok", flush=True)
    counted, ops, reads = count_device_ops(torch, lambda: adaptive_problem(
        problem, 1, seeds=adapted["seeds"]))
    check_finite_hierarchy(torch, counted["mg"], f"{size}^2 counted setup")
    print(f"{size}^2 adaptive setup: {ops} device operations dispatched, "
          f"{reads} of them host read-backs ({counted['setup_s']:.3f} s with "
          f"the counter on); stages s: {stages_line(counted)}", flush=True)
    print(f"{size}^2 adaptive against Richardson-only: setup s, solve ms, ms "
          "per outer iteration, outer iterations, per-level iterations, "
          "device kernels of one profiled solve", flush=True)
    for label, r in (("adapted, wilson-r1", r1),
                     ("adapted, wilson-r1 + small", r6),
                     ("Richardson-only, wilson-r1", r0)):
        kernels = r["device_kernels"]
        print(f"  {label}: {r['setup_s']:.3f}, {r['solve_ms']:.3f}, "
              f"{r['ms_per_iter']:.3f}, {r['iters']}, {r['level_iters']}, "
              + (f"{kernels}" if kernels is not None else "not profiled"),
              flush=True)
    return {"wilson_r1": c6["wilson_r1"], "dslash_small": c6["dslash_small"]}


# --- phase 20: the other operators ---

OTHER_K4_SIZES = (512, 2048)   # K4 at nc = 1 on staggered / Laplace
DWF_K4_CASES = ((4, 128), (8, 128))   # (Ls, L): K4 at nc 8 and 16
STAG_SIZE = 2048               # the staggered solve
STAG_MASS = 0.1
STAG_TOL = 1e-6
# Iterations of qmg_tpu's BiCGstab(6) on that solve (gauss gauge beta 6
# from QMGRandom(1337), a gaussian right-hand side drawn after it,
# complex64, the jnp apply) on the CPU backend, from ``python
# tests/test_torch_goldstone.py --size 2048`` (the port's plain apply on
# the CPU took 114 there). BiCGstab(6) counts whole l-cycles of 6
# iterations, and in complex64 applies that round differently part by a
# cycle or two on this solve (on the card: 126 through K4, 114 through the
# plain apply), so the counts are held to two cycles of each other.
JAX_ITERS_2048_STAGGERED = 120
STAG_ITERS_SLACK = 12
GOLDSTONE_L = 32               # PARITY.md's physics setting
GOLDSTONE_COUNTS = (60, 1000, 100)   # configs, thermalization, updates
GOLDSTONE_REF = (0.355891, 0.000412)  # the reference's m_pi at m = 0.1
GOLDSTONE_JAX = (0.388, 0.146)        # qmg_tpu's (PARITY.md)
GOLDSTONE_SIGMAS = 3.0
GOLDSTONE_PLAIN_RTOL = 1e-4
GOLDSTONE_BIG = (512, 3, 200, 5)      # L, configs, thermalization, updates


def other_k4_inputs(torch, dev, kind, size, ls=None):
    """K4's channels and a field for one operator of phase 20(a), from a
    gauss gauge at beta 6 from QMGRandom(1337): the staggered operator at
    m = 0.1, the gauged Laplace at m^2 = 0.01, or the domain-wall operator
    at Ls = ``ls`` (m = 0.1, M5 = -1)."""
    from qmg_tpu_torch.lattice import Lattice2D
    from qmg_tpu_torch.operators import Staggered2D, GaugedLaplace2D, Dwf2D
    from qmg_tpu_torch.rng import QMGRandom
    from qmg_tpu_torch import u1, dslash_kernel as dk
    nc = 1 if ls is None else 2 * ls
    lat = Lattice2D(size, size, nc)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, 6.0)
    kw = dict(dtype=torch.complex64, device=dev)
    if kind == "staggered":
        op = Staggered2D(lat, STAG_MASS, g, **kw)
    elif kind == "laplace":
        op = GaugedLaplace2D(lat, STAG_MASS ** 2, g, **kw)
    else:
        op = Dwf2D(lat, STAG_MASS, g, ls, **kw)
    gen = torch.Generator(device=dev).manual_seed(size + nc)
    x = torch.randn(lat.cv_shape(), dtype=torch.complex64, device=dev,
                    generator=gen)
    return dk.stencil_channels(op.coeffs), x


def other_k4_phase(torch, dk, dev):
    """Phase 20(a): K4 at nc = 1 on staggered and Laplace coefficients at
    512^2 and 2048^2 and at nc 8 and 16 on domain-wall coefficients at
    128^2, against its twin, timed three ways beside its bound. Returns
    (worst abs error at nc = 1, the 512^2 staggered times: ms, plain_ms,
    bound_ms, bound_by, bound-apply ms, device ms)."""
    cases = [(kind, size, None) for size in OTHER_K4_SIZES
             for kind in ("staggered", "laplace")]
    cases += [("dwf", size, ls) for ls, size in DWF_K4_CASES]
    worst, times = 0.0, None
    for kind, size, ls in cases:
        ch, x = other_k4_inputs(torch, dev, kind, size, ls)
        nc = x.shape[-1]
        got = dk.dslash_apply(ch, x)
        bound_apply = dk.bind_apply(dk.dslash_apply, ch, x.shape)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, dk.dslash_apply_plain(ch, x))
        check(torch.equal(bound_apply(x), got),
              f"K4's bound apply differs from its wrapper on {kind} "
              f"{size}^2 nc={nc}")
        check(rel <= KERNEL_TOL, f"K4 disagrees with its twin on {kind} "
              f"{size}^2 nc={nc}: {rel:.3e}")
        if nc == 1:
            worst = max(worst, abs_err)
        ms, apply_ms, dev_ms = three_ways(lambda: dk.dslash_apply(ch, x),
                                          lambda: bound_apply(x), torch)
        plain_ms = time_ms(lambda: dk.dslash_apply_plain(ch, x), torch,
                           reps=PLAIN_REPS)
        sites = size * size
        bytes_moved = dk.apply_bytes(nc, sites)
        bound_ms, bound_by = bound(bytes_moved, 40 * nc * nc * sites)
        print(f"K4 {kind}{'' if ls is None else f' Ls={ls}'} {size}^2 "
              f"nc={nc}: max rel err {rel:.3e}; us/apply through the wrapper "
              f"{ms * 1e3:.2f}, bound apply {apply_ms * 1e3:.2f}, device "
              f"alone {dev_ms * 1e3:.2f} "
              f"({bytes_moved / (dev_ms * 1e-3) / 1e9:.1f} GB/s, "
              f"{bound_ms / dev_ms:.0%} of the bound), plain "
              f"{plain_ms * 1e3:.2f}, bound {bound_ms * 1e3:.2f} "
              f"({bound_by}; {bytes_moved / 1e6:.2f} MB, "
              f"{bytes_moved // sites} B/site)", flush=True)
        if kind == "staggered" and size == 512:
            times = (ms, plain_ms, bound_ms, bound_by, apply_ms, dev_ms)
    return worst, times


def staggered_solve_phase(torch, dk, dev):
    """Phase 20(b): the 2048^2 staggered solve by BiCGstab(6) with K4 and
    with the plain apply, and the eo-Schur CG solve (plain half applies);
    true residuals in complex128 against the exact operator."""
    from qmg_tpu_torch import goldstone, solvers
    op, b = goldstone.staggered_problem(STAG_SIZE, STAG_MASS,
                                        dtype=torch.complex64, device=dev)
    op128, b128 = goldstone.staggered_problem(
        STAG_SIZE, STAG_MASS, dtype=torch.complex128, device=dev)

    def true_res(x):
        r = b128 - op128.apply_M(x.to(torch.complex128))
        return float(torch.linalg.vector_norm(r)
                     / torch.linalg.vector_norm(b128))

    # A warm-up solve: the first one at this size pays for its workspace.
    solvers.bicgstab_l(goldstone.bind_matvec(op, "matrix"), b, max_iter=4000,
                       tol=STAG_TOL, l=6)
    iters = {}
    for kernel in ("matrix", None):
        matvec = goldstone.bind_matvec(op, kernel)
        before = dk.dslash_apply.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solvers.bicgstab_l(matvec, b, max_iter=4000, tol=STAG_TOL,
                                 l=6)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dk.dslash_apply.launches - before
        rr = true_res(res.x)
        label = "K4" if kernel else "plain apply"
        print(f"staggered {STAG_SIZE}^2 m={STAG_MASS} BiCGstab(6) tol "
              f"{STAG_TOL} through the {label}: {int(res.iters)} iterations, "
              f"{ms:.1f} ms, true residual {rr:.3e}, K4 launches {launches}",
              flush=True)
        check(bool(res.converged) and rr <= TRUE_RES_BOUND,
              f"the {label} staggered solve: converged {bool(res.converged)}"
              f", true residual {rr:.3e}")
        check((launches > 0) == (kernel is not None),
              f"the {label} staggered solve launched K4 {launches} times")
        iters[label] = int(res.iters)
    print(f"qmg_tpu's count on the CPU: {JAX_ITERS_2048_STAGGERED}",
          flush=True)
    for label, n in iters.items():
        check(abs(n - JAX_ITERS_2048_STAGGERED) <= STAG_ITERS_SLACK
              and abs(n - iters["K4"]) <= STAG_ITERS_SLACK,
              f"the {label} staggered solve took {n} iterations: K4 "
              f"{iters['K4']}, qmg_tpu {JAX_ITERS_2048_STAGGERED}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solvers.cg(op.apply_eo_prec_M, op.prepare_b(b), max_iter=4000,
                     tol=STAG_TOL)
    x = op.reconstruct_x(res.x, b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rr = true_res(x)
    print(f"staggered {STAG_SIZE}^2 eo-Schur CG (plain half applies): "
          f"{int(res.iters)} iterations, {ms:.1f} ms, true residual "
          f"{rr:.3e}", flush=True)
    check(bool(res.converged) and rr <= TRUE_RES_BOUND,
          f"the eo-Schur CG solve: converged {bool(res.converged)}, true "
          f"residual {rr:.3e}")


def goldstone_phase(torch, dk, dev):
    """Phase 20(c) and (d): the goldstone entry, staggered, through K4 at
    32^2 (PARITY.md's 60 configurations) and again through the plain
    apply, and at 512^2. Returns K4's launches over the two K4 runs, the
    counts set to 0 just before them."""
    from qmg_tpu_torch import goldstone
    from qmg_tpu_torch.kcycle import reset_launch_counts
    n_configs, n_therm, n_update = GOLDSTONE_COUNTS
    kw = dict(op="staggered", L=GOLDSTONE_L, mass=STAG_MASS,
              n_configs=n_configs, n_therm=n_therm, n_update=n_update,
              device=dev, dtype=torch.complex64, verbose=False)
    logs = {"matrix": [], "none": []}
    reset_launch_counts()
    t0 = time.perf_counter()
    pions, plaqs, _ = goldstone.run_goldstone(fine_kernel="matrix",
                                              log=logs["matrix"], **kw)
    wall = time.perf_counter() - t0
    launches = dk.dslash_apply.launches
    goldstone.run_goldstone(fine_kernel="none", log=logs["none"], **kw)
    lo, hi = GOLDSTONE_L // 4, GOLDSTONE_L // 2 - 1
    m_pi, m_err = goldstone.plateau_mass(pions, lo, hi)
    diff = max(float(np.max(np.abs(a["pion"] - p["pion"])
                            / np.abs(p["pion"])))
               for a, p in zip(logs["matrix"], logs["none"]))
    iters = [e["iters"][0] for e in logs["matrix"]]
    print(f"--- goldstone staggered {GOLDSTONE_L}^2 m={STAG_MASS}, "
          f"{n_configs} configs x {n_update} updates after {n_therm}: "
          f"{wall:.1f} s through K4 ({launches} K4 launches, "
          f"{launches / n_configs:.0f} a configuration; BiCGstab iterations "
          f"{min(iters)}-{max(iters)}, mean {np.mean(iters):.1f}); plaquette "
          f"{np.mean(plaqs):.5f}; m_pi = {m_pi:.5f} +/- {m_err:.5f} "
          f"(plateau [{lo},{hi})), reference {GOLDSTONE_REF[0]}"
          f"({GOLDSTONE_REF[1] * 1e6:.0f}), qmg_tpu {GOLDSTONE_JAX[0]}"
          f"({GOLDSTONE_JAX[1] * 1e3:.0f}); max rel difference of a "
          f"configuration's correlator from the plain apply's {diff:.3e}",
          flush=True)
    check(len(pions) == n_configs and all(
        all(e["converged"]) for log in logs.values() for e in log),
          f"{n_configs - len(pions)} goldstone configuration(s) did not "
          "converge")
    check(bool(np.all(pions > 0)), "the goldstone correlator is not positive")
    check(np.isfinite(m_pi) and abs(m_pi - GOLDSTONE_REF[0])
          <= GOLDSTONE_SIGMAS * m_err,
          f"m_pi {m_pi:.5f} +/- {m_err:.5f} is not within "
          f"{GOLDSTONE_SIGMAS} sigma of {GOLDSTONE_REF[0]}")
    check(diff <= GOLDSTONE_PLAIN_RTOL,
          f"K4's correlators differ from the plain apply's by {diff:.3e}")
    size, n_big, therm_big, update_big = GOLDSTONE_BIG
    log = []
    before = dk.dslash_apply.launches
    goldstone.run_goldstone(op="staggered", L=size, mass=STAG_MASS,
                            n_configs=n_big, n_therm=therm_big,
                            n_update=update_big, device=dev,
                            dtype=torch.complex64, verbose=False,
                            fine_kernel="matrix", log=log)
    launches += dk.dslash_apply.launches - before
    for e in log:
        print(f"goldstone staggered {size}^2 config {e['config']}: heatbath "
              f"{e['heatbath_s']:.3f} s, solve {e['solve_s']:.3f} s, "
              f"{e['iters'][0]} iterations, true residual "
              f"{e['true_res'][0]:.2e}, K4 launches {e['launches']}",
              flush=True)
    check(all(e["converged"] == [True] and e["launches"] > 0 for e in log),
          f"the {size}^2 goldstone run: {[e['converged'] for e in log]}")
    return launches


def examples_phase(torch, wk, dev):
    """Phase 21: the n13 study, its spectrum and colinearity legs, and the
    checkpointed solve. Returns K1's launches over (c)'s standard solves,
    the count set to 0 just before them."""
    import contextlib
    import io
    import tempfile
    from qmg_tpu_torch import wilson_kcycle, wilson_tpu_solve
    from qmg_tpu_torch.solvers import VerboseMG, Verbosity
    t0 = time.perf_counter()

    # (a) the n13 study at 256^2, complex128
    L, mass, beta, n_refine = N13_ARGS
    r = wilson_kcycle.run(L, mass, beta, n_refine, spectrum=True,
                          spectrum_nev=N13_SPECTRUM_NEV,
                          coarsest_direct=True, device=dev)
    print(f"--- n13 {L}^2 complex128 on {dev}: heatbath {r['heatbath_s']:.3f}"
          f" s, setup {r['setup_s']:.3f} s, solve {r['solve_s'] * 1e3:.1f} "
          f"ms, {r['iters']} outer iterations (qmg_tpu "
          f"{JAX_ITERS_256_N13}), true residual {r['resid']:.3e}; fine "
          f"eigenpair residuals "
          + ", ".join(f"{e:.2e}" for e in r["fine_eig_res"])
          + f"; (a) took {time.perf_counter() - t0:.1f} s", flush=True)
    check(r["converged"] and r["resid"] <= N13_TRUE_RES,
          f"n13 {L}^2: converged {r['converged']}, true residual "
          f"{r['resid']:.3e} > {N13_TRUE_RES}")
    check(r["iters"] == JAX_ITERS_256_N13,
          f"n13 {L}^2: {r['iters']} outer iterations, qmg_tpu "
          f"{JAX_ITERS_256_N13}")
    check(len(r["fine_eig_res"]) == N13_SPECTRUM_NEV
          and max(r["fine_eig_res"]) <= N13_EIG_RES,
          f"n13 {L}^2 fine eigenpair residuals {r['fine_eig_res']}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = r["mg"].solve(r["b"], tol=1e-10, max_iter=1000,
                            restart_freq=32,
                            verbose=VerboseMG(Verbosity.DETAIL,
                                              Verbosity.SUMMARY))
    lines = out.getvalue().splitlines()
    outer = [ln for ln in lines if "Level 0 iter " in ln]
    # Every level that runs a Krylov solve: all but a direct coarsest.
    iterative = r["levels"] - int(r["mg"].coarsest_solve.direct)
    summaries = {lvl: sum(f"Level {lvl} " in ln and "summary:" in ln
                          for ln in lines) for lvl in range(iterative)}
    print(f"verbose solve: {res.iters} outer iterations, {len(outer)} outer "
          f"iteration lines, summary lines by level {summaries}; last "
          f"{lines[-1].strip() if lines else None}", flush=True)
    check(bool(res.converged) and len(outer) == res.iters
          and all(summaries.values()),
          f"the verbose n13 solve: {res.iters} iterations, {len(outer)} "
          f"iteration lines, summaries {summaries}")
    del r, res

    # (b) the dense spectrum and the colinear study at 32^2
    t1 = time.perf_counter()
    L, mass, beta, n_refine = COLINEAR_ARGS
    r = wilson_kcycle.run(
        L, mass, beta, n_refine, spectrum=True, colinear=True,
        colinear_nev=COLINEAR_NEV, device=dev,
        out=lambda ln: None if "SPECTRUM]" in ln else print(ln))
    rows = r["overlap"]
    print(f"--- n13 colinear {L}^2: onePP lowest {rows[0][3]:.4f}, highest "
          f"kept {rows[-1][3]:.4f}; onePAPA {rows[0][4]:.4f} / "
          f"{rows[-1][4]:.4f}; {len(r['spectra'][0])} fine and "
          f"{len(r['spectra'][1])} coarse eigenvalues; (b) took "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    check(r["converged"] and len(rows) == COLINEAR_NEV
          and all(row[5] for row in rows) and rows[0][3] < rows[-1][3],
          f"the colinear study at {L}^2: {rows}")
    del r

    # (c) the checkpointed solve at 512^2, and the Schur solve
    t1 = time.perf_counter()
    L, mass, n_refine = TPU_SOLVE_ARGS
    wk.wilson_r1_apply.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "mg.npz")
        runs = [wilson_tpu_solve.run(L, mass, n_refine=n_refine, ckpt=ckpt,
                                     device=dev) for _ in range(2)]
    launches = wk.wilson_r1_apply.launches
    runs.append(wilson_tpu_solve.run(L, mass, n_refine=n_refine,
                                     schur=True, device=dev))
    for run, want in zip(runs, (JAX_ITERS_512_TPU_SOLVE[0],) * 2
                         + (JAX_ITERS_512_TPU_SOLVE[1],)):
        kind = ("schur" if run["schur"] else
                "restored" if run["restored"] else "built")
        setup = ("restored" if run["setup_s"] is None
                 else f"{run['setup_s']:.3f} s")
        print(f"wilson_tpu_solve {L}^2 {kind}: setup {setup}, first solve "
              f"{run['first_s']:.3f} s, timed solve "
              f"{run['solve_ms']:.1f} ms, {run['iters']} outer iterations "
              f"(qmg_tpu {want}), true residual {run['resid']:.2e}, K1 "
              f"launches {run['k1_launches']}", flush=True)
        check(run["ok"] and abs(run["iters"] - want) <= 2,
              f"wilson_tpu_solve {kind}: {run['iters']} outer iterations "
              f"(qmg_tpu {want}), true residual {run['resid']:.2e}")
        check((run["k1_launches"] > 0) != run["schur"],
              f"wilson_tpu_solve {kind}: {run['k1_launches']} K1 launches")
    check(not runs[0]["restored"] and runs[1]["restored"]
          and runs[1]["iters"] == runs[0]["iters"],
          f"the restored hierarchy took {runs[1]['iters']} outer "
          f"iterations, the built one {runs[0]['iters']}")
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s ((c) "
          f"{time.perf_counter() - t1:.1f} s); K1 launches over the "
          f"standard checkpointed runs {launches}", flush=True)
    return launches


# --- phase 22: one K-cycle for one and many right-hand sides ---

# Device operations (``count_device_ops``: aten operations on the card,
# views excluded) of one 512^2 rank-1 solve of phase 4's problem on the
# tree before the solvers took a leading rhs axis (commit e4669ba), from
# ``python tests/compare_solve_ops.py --other <that tree>`` on the card
# (PERF.md section 6; the unified code dispatched 29,392): a solve
# may dispatch at most 2% more.
OPS_512_BEFORE_LANES = 29680
OPS_GROWTH_BOUND = 1.02
LANES_SIZE = 512          # phase 22's lattice


def lanes_phase(torch, dev, problem):
    """Phase 22 (< 60 s): (a) phase 4's 512^2 solve at nrhs = 1 with its
    device operations counted; (b) the n19 Schur formulation and (c) the
    ``--deflate 8`` hierarchy with NRHS right-hand sides (``eight_rhs``),
    each batched against its sequential solves in alternating turns
    (``kcycle.run_batched``), (c) through K1's and K6's rhs entries; (d)
    one ``--outer schur --deflate 8`` solve. Returns the rhs kernels'
    launches over (c)."""
    from qmg_tpu_torch.kcycle import (build_problem, run_solver,
                                      run_batched, print_batched_report,
                                      print_report, reset_launch_counts,
                                      launch_counts, TOL, MAX_ITER)
    from qmg_tpu_torch.solve import make_solver
    t0 = time.perf_counter()
    # (a) nrhs = 1: the unified solve's operations
    solve = make_solver(problem["mg"], tol=TOL, max_iter=MAX_ITER,
                        restart_freq=problem["restart"])
    solve(problem["b"])
    (res, _), ops, reads = count_device_ops(
        torch, lambda: solve(problem["b"]))
    growth = ops / OPS_512_BEFORE_LANES
    print(f"--- (a) {LANES_SIZE}^2 wilson-r1 solve at nrhs = 1: {res.iters} "
          f"outer "
          f"iterations, {ops} device operations dispatched, {reads} host "
          f"read-backs; before the rhs axis {OPS_512_BEFORE_LANES} "
          f"({growth:.4f}x)", flush=True)
    check(abs(res.iters - JAX_ITERS_512) <= 2,
          f"nrhs = 1: outer iterations {res.iters} vs qmg_tpu's "
          f"{JAX_ITERS_512}")
    check(growth <= OPS_GROWTH_BOUND,
          f"nrhs = 1 dispatches {ops} device operations, {growth:.4f}x the "
          f"{OPS_512_BEFORE_LANES} before the rhs axis")
    launches = None
    for label, kw, route in (
            ("(b) n19 Schur", dict(outer="schur"), (None, "plain")),
            (f"(c) --deflate {DEFLATE_N}", dict(deflate=DEFLATE_N),
             ("wilson-r1", "small"))):
        part = build_problem(LANES_SIZE, dev, **kw)
        B = eight_rhs(torch, part, dev)
        reset_launch_counts()
        r = run_batched(part, B, *route, repeats=2)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"--- {label}, nrhs {NRHS} (6 gaussian, a point, a wall); "
              f"setup {part['setup_s']:.3f} s", flush=True)
        print_batched_report(r)
        print(f"batched / sequential per rhs: "
              f"{r['batched_ms'] / r['sequential_ms']:.3f}; kernel "
              f"launches over the phase's batched and sequential solves: "
              + ", ".join(f"{k} {counts[k]}" for k in (
                  "wilson_r1_rhs", "dslash_small_rhs", "wilson_r1")),
              flush=True)
        check_batched(r, label)
        if route[0] is None:
            check(not any(counts.values()),
                  f"{label}: no kernel applies a Schur operator, yet "
                  f"{counts}")
        else:
            launches = {k: counts[k] for k in ("wilson_r1_rhs",
                                               "dslash_small_rhs")}
            check(all(launches.values()),
                  f"{label}: the batched solve did not launch the rhs "
                  f"kernels: {launches}")
        del part, B
    # (d) one --outer schur --deflate 8 solve
    part = build_problem(LANES_SIZE, dev, outer="schur", deflate=DEFLATE_N)
    r = run_solver(part, fine_kernel=None)
    label = f"(d) {LANES_SIZE}^2 --outer schur --deflate {DEFLATE_N}"
    print(f"--- {label}", flush=True)
    print_report(r)
    check_solve(r, label)
    check(r["level_applies"][-1] == "mdagger_m"
          and f"deflated by {DEFLATE_N}" in r["coarsest"],
          f"{label} solved {r['coarsest']}")
    elapsed = time.perf_counter() - t0
    print(f"phase 22 took {elapsed:.1f} s", flush=True)
    return launches


BENCH_BIG, BENCH_SIZE = 2048, 512     # phase 24's lattices
BENCH_CHECK_ITERS = 20                # the dslash checksum's chain steps
BENCH_NRHS, BENCH_CHAIN = 8, 3
ATTRIB_N_REFINE, ATTRIB_REPS = 4, 2   # the probe's depth at 2048^2


def bench_phase(torch, dev, direct, direct_big, refine_passes):
    """Phase 24: ``python -m qmg_tpu_torch.bench``'s modes and ``attrib``,
    run in this process (their JSON lines parsed as a reader would).
    ``direct`` is phase 4's 512^2 solve, ``direct_big`` phase 7's 2048^2
    one, ``refine_passes`` phase 18(e)'s. Returns the launches of each
    kernel over the phase's runs."""
    import contextlib
    import io
    from qmg_tpu_torch import attrib, bench, dslash
    from qmg_tpu_torch.kcycle import reset_launch_counts, launch_counts
    t0 = time.perf_counter()
    card = dslash.card_line()
    total = {}

    def run(*argv):
        reset_launch_counts()
        f = io.StringIO()
        t_run = time.perf_counter()
        with contextlib.redirect_stdout(f):
            out = bench.main(["--device", str(dev), *argv])
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        last = f.getvalue().strip().splitlines()[-1]
        line = json.loads(last)
        print(f"bench {' '.join(argv)} ({time.perf_counter() - t_run:.1f} "
              f"s): {last}; launches "
              f"{ {k: n for k, n in counts.items() if n} }", flush=True)
        check(line == out["line"] and line["value"] > 0
              and line["device"] == card,
              f"bench {' '.join(argv)}: last line {last}")
        return line, out, counts

    # (a) the dslash chain, checksum against dslash's own chain
    _, out, c = run("--mode", "dslash", "--size", str(BENCH_BIG),
                    "--kernel", "phase-r1", "--iters",
                    str(BENCH_CHECK_ITERS))
    ref = dslash.run(BENCH_BIG, "wilson-r1", iters=BENCH_CHECK_ITERS,
                     device=dev)
    check(c["wilson_r1"] > 0 and abs(out["checksum"] - ref["checksum"])
          <= CHAIN_TOL * abs(ref["checksum"]),
          f"bench dslash: checksum {out['checksum']} against dslash's "
          f"{ref['checksum']}, K1 launches {c['wilson_r1']}")
    # (b) kcycle, device setup at 2048^2 and host setup at 512^2
    for size, setup, want in ((BENCH_BIG, "device", direct_big),
                              (BENCH_SIZE, "host", direct)):
        _, out, c = run("--mode", "kcycle", "--size", str(size), "--setup",
                        setup)
        r = out["report"]
        check(abs(r["iters"] - want["iters"]) <= 1
              and r["launches"]["wilson_r1"] > 0,
              f"bench kcycle {size}^2 --setup {setup}: {r['iters']} outer "
              f"iterations against kcycle's {want['iters']}, K1 launches "
              f"{r['launches']['wilson_r1']} a solve")
        print(f"bench kcycle {size}^2 --setup {setup}: {r['iters']} outer, "
              f"{r['solve_ms']:.3f} ms, setup {r['setup_s']:.3f} s; kcycle's "
              f"own: {want['iters']} outer, {want['solve_ms']:.3f} ms",
              flush=True)
    # (c) refine to a complex128 1e-10
    _, out, c = run("--mode", "refine", "--size", str(BENCH_SIZE))
    res = out["result"]
    check(res.converged and res.rel_resid <= REFINE_TOL
          and res.outer_iters == refine_passes and c["wilson_r1"] > 0,
          f"bench refine: {res.rel_resid:.3e} in {res.outer_iters} passes "
          f"against phase 18(e)'s {refine_passes}; K1 launches "
          f"{c['wilson_r1']}")
    # (d) the steady per-solve cost of 8 right-hand sides, chained
    _, out, c = run("--mode", "kcycle", "--size", str(BENCH_SIZE), "--nrhs",
                    str(BENCH_NRHS), "--chain", str(BENCH_CHAIN))
    check(all(out["report"]["converged"]) and out["steady_ms_per_solve"] > 0
          and c["wilson_r1_rhs"] > 0,
          f"bench --nrhs {BENCH_NRHS} --chain {BENCH_CHAIN}: converged "
          f"{out['report']['converged']}, marginal "
          f"{out['steady_ms_per_solve']:.3f} ms, K1 rhs launches "
          f"{c['wilson_r1_rhs']}")
    print(f"bench --nrhs {BENCH_NRHS} --chain {BENCH_CHAIN} at "
          f"{BENCH_SIZE}^2: {out['steady_ms_per_solve']:.3f} ms a batched "
          f"solve chained, {out['report']['batched_ms']:.3f} ms alone",
          flush=True)
    # (e) one 2048^2 solve by part, level 0's parts only
    reset_launch_counts()
    t_run = time.perf_counter()
    a = attrib.run(BENCH_BIG, ATTRIB_N_REFINE, dev, reps=ATTRIB_REPS,
                   levels=(0,))
    torch.cuda.synchronize()
    print(f"attrib {BENCH_BIG}^2: {time.perf_counter() - t_run:.1f} s",
          flush=True)
    for k, n in launch_counts().items():
        total[k] = total.get(k, 0) + n
    attrib.print_report(a)
    parts = [ms for row in a["components"].values() for ms in row.values()]
    check(all(ms > 0 for ms in parts) and a["outer1_ms"] > 0,
          f"attrib: a part's marginal is not positive: {a['components']}, "
          f"outer1 {a['outer1_ms']}")
    k1 = {name: a["launches"][0][name].get("wilson_r1", 0)
          for name in ("precond", "fine")}
    check(k1["precond"] > 0 and k1["fine"] == 0,
          f"attrib: K1 launches inside precond {k1['precond']} (want > 0), "
          f"inside fine {k1['fine']} (want 0)")
    print(f"phase 24 took {time.perf_counter() - t0:.1f} s", flush=True)
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this test needs a CUDA card")
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor
    from qmg_tpu_torch import wilson_kernel as wk, dslash_kernel as dk
    from qmg_tpu_torch.cuda_build import find_nvcc
    from qmg_tpu_torch.kcycle import build_problem, run_solver, print_report

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    # --- 1. environment ---
    phase("1. environment")
    nvcc_line = tool_line([find_nvcc(), "--version"], pick_last=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, nvcc: {nvcc_line}; host: {os.cpu_count()} CPUs, "
          f"numpy {np.__version__}", flush=True)
    print(tool_line(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]), flush=True)

    # --- 2. build: one compiler per source, started together ---
    phase("2. build")
    from qmg_tpu_torch import u1
    with ThreadPoolExecutor(3) as pool:
        builds = {"wilson (nvcc sm_90a)": pool.submit(wk.build_wilson),
                  "dslash (nvcc sm_90a)": pool.submit(dk.build_dslash),
                  "heatbath (host c++)": pool.submit(u1.build_heatbath)}
        for name, fut in builds.items():
            print(f"build {name}: {fut.result():.2f} s", flush=True)

    # --- 3. kernel vs plain ---
    phase("3. kernel vs plain")
    floor_ms = graph_ms(dk.empty_launch, torch)
    print(f"launch floor: an empty kernel {floor_ms * 1e3:.2f} us a launch "
          f"on the device alone (100 launches in one CUDA graph), "
          f"{time_ms(dk.empty_launch, torch) * 1e3:.2f} us a launch from a "
          f"Python loop", flush=True)
    wilson_worst, wilson_times = kernel_phase(torch, wk, dk, dev)

    # --- 4. the original path ---
    phase("4. the original path")
    wk.wilson_r1_apply.launches = 0
    problem = build_problem(ADAPTIVE_SIZE, dev)
    r = run_solver(problem, profile=True)
    torch.cuda.synchronize()
    launches = wk.wilson_r1_apply.launches
    print_report(r)
    print(f"wilson_r1 launches over the main path (setup + 3 solves, the "
          f"last profiled): "
          f"{launches}", flush=True)
    check_solve(r, "512^2 wilson-r1")
    check(launches > 0 and r["launches"]["wilson_r1"] > 0,
          "the main path never launched wilson_r1")
    check(abs(r["iters"] - JAX_ITERS_512) <= 2,
          f"outer iterations {r['iters']} vs qmg_tpu's {JAX_ITERS_512}")
    print(f"outer iterations {r['iters']} vs qmg_tpu reference "
          f"{JAX_ITERS_512}: ok", flush=True)

    # --- 5. and 6. the generic stencil kernels vs their twins ---
    phase("5.-6. the stencil kernels")
    worst = stencil_phase(torch, dk, dev)
    stimes = stencil_timings(torch, dk, dev)

    # --- 7. and 8. the kernel paths ---
    phase("7.-9., 12. the kernel paths")
    path_launches, direct_big = kernel_paths(torch, dev)

    # --- 10. the dslash chains through K3 and K2 ---
    phase("10. the dslash chains")
    (path_launches["wilson_split"],
     path_launches["dslash_small_split"]) = dslash_chains(torch, dev)
    path_launches["wilson_r1"] = launches

    # --- 11. the slab kernel, 13. the distributed mesh of one rank ---
    phase("11., 13. the slab kernel and the mesh")
    halo_worst, halo_times = halo_phase(torch, wk, dev)
    nccl_phase(torch, dev)

    # --- 14.-16. the rhs-axis kernels, the batched solve, the stream ---
    phase("14.-16. the rhs axis, the batched solve, the stream")
    rhs_worst, rhs_times = rhs_kernel_phase(torch, wk, dk, dev)
    rhs_worst["K7rhs"], rhs_times["K7rhs"] = halo_rhs_phase(torch, wk, dev)
    rhs_launches = batched_phase(torch, dev)
    for name, n in stream_phase(torch, dev).items():
        rhs_launches[name] += n

    # --- 17. the n19 Schur path ---
    phase("17. the Schur path")
    schur_phase(torch, dev, r)

    # --- 18. the deflated normal-operator coarsest ---
    phase("18. the deflated coarsest")
    refine_passes = deflation_phase(torch, dev, r, direct_big)

    # --- 19. the n22 adaptive setup on phase 4's problem ---
    phase("19. the adaptive setup")
    adaptive_launches = adaptive_phase(torch, dev, problem)

    # --- 20. the other operators: K4 at nc = 1, the goldstone entry ---
    phase("20. the other operators")
    nc1_worst, nc1_times = other_k4_phase(torch, dk, dev)
    staggered_solve_phase(torch, dk, dev)
    nc1_launches = goldstone_phase(torch, dk, dev)

    # --- 21. the examples' entry points ---
    phase("21. the examples' entry points")
    tpu_solve_launches = examples_phase(torch, wk, dev)

    # --- 22. one K-cycle for one and many right-hand sides ---
    phase("22. one K-cycle for one and many right-hand sides")
    lanes_launches = lanes_phase(torch, dev, problem)
    del problem

    # --- 23. the mesh: sharded setup and every formulation ---
    phase("23. the mesh: sharded setup and every formulation")
    mesh_launches, mesh_rhs_launches = mesh_phase(torch, dev, direct_big)

    # --- 24. bench.py's modes and the attribution probe ---
    phase("24. bench and attrib")
    bench_launches = bench_phase(torch, dev, r, direct_big, refine_passes)

    # Each Wilson kernel at its path's shape: K1 the 512^2 solve, K2 the
    # 2048^2 solve, K3 the 2048^2 chain.
    kernels = []
    for name, kid, line, size in (("wilson_r1", "K1", 475, 512),
                                  ("wilson_phase", "K2", 50, 2048),
                                  ("wilson_split", "K3", 267, 2048)):
        ms, plain_ms, apply_ms, dev_ms = wilson_times[kid][f"{size}x{size}"]
        k_bound, k_by = wilson_bound(kid, size * size)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "qmg_tpu_torch/csrc/wilson.cu",
            "replaces": f"qmg_tpu/pallas_wilson.py:{line}",
            "launches": path_launches[name],
            "max_abs_err": wilson_worst[kid], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": k_bound, "bound_by": k_by,
            "library_ms": None, "bound_apply_ms": apply_ms,
            "device_ms": dev_ms})
        if name in adaptive_launches:
            kernels[-1]["adaptive_launches"] = adaptive_launches[name]
        if name == "wilson_r1":
            kernels[-1]["tpu_solve_launches"] = tpu_solve_launches
            kernels[-1]["bench_launches"] = bench_launches["wilson_r1"]
    k_ms, k_plain, k_bound, k_by, k_wrapper, k_dev = halo_times
    kernels.append({
        "name": "wilson_r1_halo", "route": "cuda",
        "source": "qmg_tpu_torch/csrc/wilson.cu",
        "replaces": "qmg_tpu/shard_dslash.py:135",
        "launches": path_launches["wilson_r1_halo"],
        "max_abs_err": halo_worst, "ms": k_ms, "plain_ms": k_plain,
        "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
        "wrapper_ms": k_wrapper, "device_ms": k_dev,
        "sharded_setup_path_launches": mesh_launches})
    # K6 twice: its interleaved entry (the solve's coarse levels) and its
    # split entry (the 32^2 nc8 "small-split" chain).
    for name, kid, line in (("dslash", "K4", 76), ("dslash_split", "K5", 351),
                            ("dslash_small", "K6i", 548),
                            ("dslash_small_split", "K6", 548)):
        k_ms, k_plain, k_bound, k_by, k_apply, k_dev = stimes[kid]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "qmg_tpu_torch/csrc/dslash.cu",
            "replaces": f"qmg_tpu/pallas_dslash.py:{line}",
            "launches": path_launches[name], "max_abs_err": worst[kid],
            "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound,
            "bound_by": k_by, "library_ms": None, "bound_apply_ms": k_apply,
            "device_ms": k_dev})
        if name in adaptive_launches:
            kernels[-1]["adaptive_launches"] = adaptive_launches[name]
    # The rhs entries of K1 and K6 at the batched solve's shapes (512^2 and
    # 32^2 nc8, nrhs 8); launches over phases 15 and 16.
    for name, kid, source, line in (
            ("wilson_r1_rhs", "K1rhs", "wilson.cu", "pallas_wilson.py:475"),
            ("dslash_small_rhs", "K6rhs", "dslash.cu",
             "pallas_dslash.py:548")):
        k_ms, k_plain, k_bound, k_by, k_apply, k_dev = rhs_times[kid]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"qmg_tpu_torch/csrc/{source}",
            "replaces": f"qmg_tpu/{line}",
            "launches": rhs_launches[name], "max_abs_err": rhs_worst[kid],
            "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound,
            "bound_by": k_by, "library_ms": None, "bound_apply_ms": k_apply,
            "device_ms": k_dev,
            "batched_deflate_launches": lanes_launches[name],
            "bench_launches": bench_launches[name]})
    # K7's rhs entry on one rank's slab of the 4096^2 cell; launches of
    # one of phase 23(c)'s batched mesh solves.
    k_ms, k_plain, k_bound, k_by, k_apply, k_dev = rhs_times["K7rhs"]
    kernels.append({
        "name": "wilson_r1_halo_rhs", "route": "cuda",
        "source": "qmg_tpu_torch/csrc/wilson.cu",
        "replaces": "qmg_tpu/shard_dslash.py:135",
        "launches": mesh_rhs_launches, "max_abs_err": rhs_worst["K7rhs"],
        "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound,
        "bound_by": k_by, "library_ms": None, "bound_apply_ms": k_apply,
        "device_ms": k_dev})
    # K4 at nc = 1: the goldstone entry's staggered apply (phase 20), timed
    # at 512^2.
    k_ms, k_plain, k_bound, k_by, k_apply, k_dev = nc1_times
    kernels.append({
        "name": "dslash_nc1", "route": "cuda",
        "source": "qmg_tpu_torch/csrc/dslash.cu",
        "replaces": "qmg_tpu/pallas_dslash.py:76",
        "launches": nc1_launches, "max_abs_err": nc1_worst, "ms": k_ms,
        "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
        "library_ms": None, "bound_apply_ms": k_apply, "device_ms": k_dev})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    print(f"# chip_smoke wall {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
