"""A rank of ``ranks.launch`` with a fault planted on rank 1:

    python -m benchmark.tests.rank_faults <fault> <job.json> <rank>

``answer_altered``: rank 1's block of every answer altered where the
solve returns it (``test_benchmark_faults.FAULTS``); ``exchange_dropped``:
every halo that rank 1 receives replaced by zeros, the exchange between
chips left out in effect; ``setup_raises``: rank 1 raises in set-up;
``setup_hangs``: rank 1 waits in set-up for good. The other ranks run as
``python -m benchmark.ranks`` does."""

import sys
import time

from benchmark import ranks, run
from benchmark.tests.test_benchmark_faults import _broken
from qmg_tpu_torch.parallel import Mesh


def _raises(*args, **kw):
    raise RuntimeError("planted: set-up fails on this rank")


def _zero_halos(ring_recv):
    def dropped(self, edges, axis, offset):
        return [edge.new_zeros(edge.shape)
                for edge in ring_recv(self, edges, axis, offset)]
    return dropped


def _hangs(*args, **kw):
    while True:
        time.sleep(1)


def main(argv) -> int:
    fault, job, rank = argv
    if int(rank) == 1:
        if fault == "answer_altered":
            run.make_solver = _broken(run.make_solver, fault)
            run.make_batched_solver = _broken(run.make_batched_solver, fault)
        elif fault == "exchange_dropped":
            Mesh.ring_recv = _zero_halos(Mesh.ring_recv)
        elif fault == "setup_raises":
            run.make_kcycle_setup_planes = _raises
        elif fault == "setup_hangs":
            run.make_kcycle_setup_planes = _hangs
        else:
            raise ValueError(f"unknown fault {fault!r}")
    return ranks.worker_main([job, rank])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
