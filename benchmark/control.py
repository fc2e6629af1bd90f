"""The control of the comparison that decides ``correct``, and the
program's own readings of it, for the limits in the configurations.

    python -m benchmark.control --workload <cell> --seeds 11 12 13 \
        [--program-seeds 21 22 ...] [--seconds 1]

The control is the plain reference put in the program's place: a plain
BiCGstab on the reference Wilson operator, computed in TF32, the
precision below the configuration's complex64 with TF32 off: every
product's operands rounded to TF32's 10-bit mantissa (as the tensor cores
round them), sums in float32. It runs through ``run.run_cell`` in place
of the program's solver (``run_cell(solver=...)``), on the cell's own
inputs, traffic and sizes, and is judged by the same code as the
program: the true relative residual in complex128 against the
configuration's ``check.true_residual_limit``, so that it comes out
``correct: false``. ``--precision fp32`` runs the same solver without the
rounding, to show that the precision, not the solver, is what the
comparison catches. ``--program-seeds`` runs the cell itself on each seed
in this process: the sound readings. A window of ``--seconds`` (at least
one whole solve). One JSON line per seed and side.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import wilson as ref


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """A complex64 tensor with each float32 component rounded to nearest
    (ties to even) at TF32's 10 mantissa bits."""
    bits = torch.view_as_real(t).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return torch.view_as_complex(bits.view(torch.float32))


def control_apply(gauge: torch.Tensor, mass: float, r: float,
                  precision: str):
    """The reference Wilson apply on complex64 full-grid fields, with the
    operands of every product rounded to TF32 (``precision="tf32"``) or
    not ("fp32"). The spin projectors' entries are 0, +-1, +-i, whose
    products are exact in either."""
    grid = torch.stack([ref.unpack(gauge[0]), ref.unpack(gauge[1])]).to(
        torch.complex64)
    if precision == "fp32":
        return lambda psi: ref.wilson_apply(grid, psi, mass, r)
    grid = to_tf32(grid)
    diag = float(to_tf32(torch.tensor(mass + 2.0 * r,
                                      dtype=torch.complex64)).real)
    return lambda psi: ref.wilson_apply(grid, to_tf32(psi),
                                        diag - 2.0 * r, r)


def bicgstab(apply, b: torch.Tensor, tol: float, max_iter: int):
    """Plain BiCGstab from x = 0 until the recursive relative residual is
    at most ``tol`` (tested every 10 iterations) or ``max_iter``; returns
    (x, iterations)."""
    x = torch.zeros_like(b)
    r = b.clone()
    r0 = b.clone()
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    b_norm = float(torch.linalg.vector_norm(b))
    for it in range(1, max_iter + 1):
        rho_new = torch.vdot(r0.reshape(-1), r.reshape(-1))
        p = r + (rho_new / rho) * (alpha / omega) * (p - omega * v)
        v = apply(p)
        alpha = rho_new / torch.vdot(r0.reshape(-1), v.reshape(-1))
        s = r - alpha * v
        t = apply(s)
        omega = (torch.vdot(t.reshape(-1), s.reshape(-1))
                 / torch.vdot(t.reshape(-1), t.reshape(-1)))
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        if it % 10 == 0 and float(torch.linalg.vector_norm(r)) <= tol * b_norm:
            return x, it
    return x, max_iter


class ControlResult(NamedTuple):
    x: torch.Tensor
    iters: list
    converged: list


# Kinds of apply in the port's ``carry["counts"]``; the control counts none.
COUNT_KINDS = 8


def control_solver(precision: str, max_iter: int):
    """``run_cell``'s ``solver``: the control's solve of one batch of
    ``nrhs`` sources, lane by lane, in the run's (res, carry) form."""
    def make(data: dict, config: dict, nrhs: int):
        op = config["operator"]
        apply = control_apply(data["gauge"], op["mass"], op["wilson_coeff"],
                              precision)
        tol = config["solve"]["tol"]

        def solve(b):
            lanes = b.reshape((nrhs,) + tuple(data["pool"].shape[1:]))
            xs, iters = [], []
            for lane in lanes:
                x, n = bicgstab(apply, ref.unpack(lane), tol, max_iter)
                xs.append(ref.pack(x))
                iters.append(n)
            carry = {"iters": np.zeros((nrhs, 1), dtype=np.int64),
                     "counts": np.zeros((nrhs, 1, COUNT_KINDS),
                                        dtype=np.int64)}
            return ControlResult(torch.stack(xs).reshape(b.shape), iters,
                                 [n < max_iter for n in iters]), carry
        return solve
    return make


def main(argv=None) -> int:
    from benchmark import run
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--precision", choices=("tf32", "fp32"), default="tf32")
    p.add_argument("--max-iter", type=int, default=4000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = run.bench_file()
    cell, config, traffic = run.cell_inputs(bench, args.workload)
    sides = ([("program", seed, None) for seed in args.program_seeds]
             + [(f"control-{args.precision}", seed,
                 control_solver(args.precision, args.max_iter))
                for seed in args.seeds])
    for side, seed, solver in sides:
        t0 = time.perf_counter()
        res = run.run_cell(bench, cell, config, traffic, seed, args.seconds,
                           False, args.device, t0, solver=solver)
        print(json.dumps({"side": side, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "check": res["check"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
