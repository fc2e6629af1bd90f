"""Count a benchmark cell's site contractions by route and shape.

    python scripts/contraction_counts.py --workload <cell> --seed <n> \
        [--device cuda] [--out <file.json>]

Builds the cell's inputs, hierarchy and solver as ``benchmark.run`` does,
warms up with one solve, then solves the pool's next batch. For each phase
(``setup``, ``warmup``, ``batch``) it prints the ``linalg.CONTRACTIONS``
delta and a tally of every ``linalg.stacked_site_matvec`` call by route,
site shape, colours, terms and fields; for the batch on a card, also the
device memory peak of the solve. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import sys

sys.path.insert(0, ".")
# First: ``run`` sets the kernel caches' paths before torch loads.
from benchmark import run  # noqa: E402

import torch  # noqa: E402

from benchmark.inputs import make_inputs  # noqa: E402
from qmg_tpu_torch import linalg, solvers  # noqa: E402
from qmg_tpu_torch.lattice import Lattice2D  # noqa: E402
from qmg_tpu_torch.setup_planes import make_kcycle_setup_planes  # noqa: E402
from qmg_tpu_torch.solve import make_solver, make_batched_solver  # noqa: E402
from qmg_tpu_torch.stencil import StencilType  # noqa: E402


class Tally:
    """Wraps ``linalg.stacked_site_matvec`` and counts its calls by route
    and shape into the current phase."""

    def __init__(self):
        self.phases = {}
        self.phase = None
        self.inner = linalg.stacked_site_matvec

    def __call__(self, mats, pulls):
        before = dict(linalg.CONTRACTIONS)
        out = self.inner(mats, pulls)
        route = next(k for k, v in linalg.CONTRACTIONS.items()
                     if v != before.get(k, 0))
        nc = pulls[0].shape[-1]
        n_site_axes = mats.ndim - (2 if nc >= linalg.PRODUCT_MIN_NC else 3)
        site_shape = out.shape[-1 - n_site_axes:-1]
        sites = "x".join(str(d) for d in site_shape)
        nrhs = out.numel() // (math.prod(site_shape) * nc)
        key = f"{route} sites={sites} nc={nc} terms={len(pulls)} nrhs={nrhs}"
        self.phases[self.phase]["shapes"][key] += 1
        return out

    def start(self, phase):
        self.phase = phase
        self.phases[phase] = {"shapes": collections.Counter(),
                              "before": dict(linalg.CONTRACTIONS)}

    def report(self):
        out = {}
        for phase, d in self.phases.items():
            out[phase] = {
                "contractions": {k: v - d["before"].get(k, 0)
                                 for k, v in linalg.CONTRACTIONS.items()
                                 if v != d["before"].get(k, 0)},
                "by_shape": dict(sorted(d["shapes"].items())),
            }
        return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = run.bench_file()
    _, config, traffic = run.cell_inputs(bench, args.workload)
    device = args.device
    on_card = torch.device(device).type == "cuda"
    if on_card:
        solvers.GCR_STORE_LIMIT_BYTES = max(
            solvers.GCR_STORE_LIMIT_BYTES,
            torch.cuda.get_device_properties(device).total_memory // 2)
    tally = Tally()
    linalg.stacked_site_matvec = tally

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    nrhs, sol, op = traffic["nrhs"], config["solve"], config["operator"]
    data = make_inputs(config, traffic, args.seed, device)
    lat = config["lattice"]
    tally.start("setup")
    setup_fn = make_kcycle_setup_planes(
        Lattice2D(lat["x"], lat["y"], lat["nc"]), run.kcycle_config(config),
        op["mass"], op["wilson_coeff"], dtype=getattr(torch, op["dtype"]),
        device=device)
    mg = setup_fn(data["gauge"], *data["seeds"])
    kw = dict(tol=sol["tol"], max_iter=sol["max_iter"],
              restart_freq=sol["restart_freq"],
              fine_kernel=sol["fine_kernel"],
              coarse_apply=sol["coarse_apply"],
              outer_type=StencilType[sol["outer_type"]])
    solve = (make_solver(mg, **kw) if nrhs == 1
             else make_batched_solver(mg, **kw))
    pool = data["pool"]
    tally.start("warmup")
    solve(pool[0] if nrhs == 1 else pool[:nrhs])
    sync()
    tally.start("batch")
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    res, carry = solve(pool[1] if nrhs == 1 else pool[nrhs:2 * nrhs])
    sync()
    report = {"workload": args.workload, "seed": args.seed,
              "device": (torch.cuda.get_device_name(device) if on_card
                         else "cpu"),
              "thresholds": {"PRODUCT_MIN_SITES": linalg.PRODUCT_MIN_SITES,
                             "PRODUCT_MIN_NC": linalg.PRODUCT_MIN_NC},
              "phases": tally.report(),
              "batch_outer_iters": res.iters.tolist()}
    if on_card:
        report["batch_memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
