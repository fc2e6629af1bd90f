"""How much the n22 adaptive setup of ``kcycle --setup adaptive`` (the
hierarchy of ``chip_smoke.py`` phase 19) depends on its exact inputs.

On the n13 problem of ``--size`` (gauge, mass and right-hand side of
``kcycle.build_problem``), runs ``kcycle.adaptive_problem`` (one pass, the
dense coarsest) from the seeds phase 19 draws, from ``--perturbed`` copies
of those seeds with every gaussian scaled by 1 + eps * N(0, 1) (``--eps``,
by default about one complex64 rounding step), and from ``--fresh`` new
seed sets drawn after them. For each it prints, as one JSON line: the
setup's seconds, the arrays of the hierarchy that are not finite, the
outer iterations of a K1 solve on it with its true relative residual and
per-level Krylov iterations, the Richardson-only hierarchy's count (for
the phase-19 and fresh seeds), and over the setup the squared norms at or
below float32's smallest normal number (each one is a direction on which
the GCR breakdown guard of ``solvers._gcr`` fires, or a residual
that vanished) and the smallest squared norm seen.

    python tests/adaptive_seed_probe.py [--size 512] [--device cuda]
        [--perturbed 4] [--fresh 2] [--eps 2e-7]
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from qmg_tpu_torch import solvers  # noqa: E402
from qmg_tpu_torch.kcycle import (build_problem, adaptive_problem,  # noqa
                                  run_solver)


class NormWatch:
    """Wraps ``solvers.lane_reductions`` so that every squared norm a solver
    takes is also counted on the device: how many are <= float32's
    smallest normal number, and the smallest."""

    def __init__(self, device):
        self.device = device
        self.reset()
        self._reductions = solvers.lane_reductions
        solvers.lane_reductions = self._wrapped

    def reset(self):
        self.tiny = torch.zeros((), dtype=torch.int64, device=self.device)
        self.least = torch.full((), float("inf"), dtype=torch.float64,
                                device=self.device)

    def _wrapped(self, reduce=None):
        vdot, norm2sq, total = self._reductions(reduce)

        def watched(v):
            out = norm2sq(v)
            self.tiny += (out <= torch.finfo(out.dtype).tiny).long().sum()
            self.least = torch.minimum(self.least, out.double().min())
            return out
        return vdot, watched, total

    def read(self):
        return int(self.tiny), float(self.least)


def finite_failures(mg):
    arrays = {"cdinv": mg.coarsest_dinv}
    for lvl in range(mg.get_num_levels()):
        c = mg.get_stencil(lvl).coeffs
        arrays[f"clover{lvl}"], arrays[f"hopping{lvl}"] = c.clover, c.hopping
    for lvl in range(mg.get_num_levels() - 1):
        arrays[f"nvb{lvl}"] = mg.get_transfer(lvl)._nvb
    return [k for k, a in arrays.items() if a is not None and not bool(
        torch.isfinite(torch.view_as_real(a)).all())]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--perturbed", type=int, default=4)
    ap.add_argument("--fresh", type=int, default=2)
    ap.add_argument("--eps", type=float, default=2e-7)
    args = ap.parse_args()
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    problem = build_problem(args.size, dev)
    watch = NormWatch(dev)

    def variant(label, seeds, richardson):
        watch.reset()
        p = adaptive_problem(problem, 1, seeds=seeds)
        tiny, least = watch.read()
        line = {"seeds": label, "setup_s": p["setup_s"],
                "not_finite": finite_failures(p["mg"]),
                "norms_at_or_below_tiny": tiny, "least_norm2": least}
        if not line["not_finite"]:
            r = run_solver(p)
            line.update(iters=r["iters"], rel_res_true=r["rel_res_true"],
                        level_iters=r["level_iters"])
        if richardson:
            q = adaptive_problem(problem, 0, seeds=(p["seeds"][0], []))
            line["richardson_only_iters"] = run_solver(q)["iters"]
        print(json.dumps(line), flush=True)
        return p["seeds"]

    init, passes = variant("phase 19", None, True)
    noise = np.random.default_rng(7)

    def perturb(a):
        return a * (1 + args.eps * noise.standard_normal(a.shape))

    for t in range(args.perturbed):
        variant(f"perturbed {t}", ([perturb(a) for a in init],
                                   [[[perturb(a) for a in lvl] for lvl in p]
                                    for p in passes]), False)
    for t in range(args.fresh):
        variant(f"fresh {t}", None, True)
    print(f"# {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
