"""A cell on several chips: one ``torch.distributed`` rank a chip, level 0
cut over the configuration's ``mesh`` (``run.mesh_shape``).

``launch(job)`` is the parent's side. It writes the job (the cell, its
configuration and traffic, the run's arguments and the parent's start on
the host's monotonic clock, which every process reads alike) into a fresh
temporary directory and starts one process a rank,

    python -m benchmark.ranks <job.json> <rank>

each with its standard output and error in files there. The ranks meet
through a ``file://`` store in that directory: no port, no network. The
parent waits until every rank has ended. When a rank exits with another
code than 0, or the deadline (``--seconds`` plus ``SETUP_ALLOWANCE_S``)
passes, it kills every rank and its children and raises ``RankFailed``,
naming the rank and quoting the end of its standard error. A rank dies
with the parent. On success it returns rank 0's standard output and
error: the result line and the numbers compared.

``worker_main`` is a rank's side: rank r runs on ``cuda:r`` with NCCL, or
on the CPU with gloo when the job's device is "cpu", and calls
``run.run_cell`` with a ``Ranks``, which holds what ``run_cell`` needs of
the other ranks: the cut of a whole field into the rank's block, rank 0's
decisions, values from every rank, and whole fields from the blocks.
"""

from __future__ import annotations

import ctypes
import datetime
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback

# First: ``run`` sets the kernel caches' paths before torch loads.
from benchmark import run

import torch
import torch.distributed as dist

# Seconds a distributed run may take beyond its window: starting the
# ranks, set-up (a first run in a checkout builds the kernels), the traced
# solve, the last solve's overrun of the window and the check.
SETUP_ALLOWANCE_S = 300.0
POLL_S = 0.1
GRACE_S = 1.0
TAIL_CHARS = 4000
PR_SET_PDEATHSIG = 1


class RankFailed(RuntimeError):
    """A rank of a distributed run failed or outlived the deadline; every
    rank is ended when this is raised. ``pids``: the ranks' processes."""

    def __init__(self, message: str, pids: list):
        super().__init__(message)
        self.pids = pids


def _tail(path: str) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-TAIL_CHARS:]


def _failed_at(workdir: str, rank: int) -> float:
    """When ``rank`` reported its failure, on the monotonic clock; a rank
    that ended without a report counts as failing last."""
    try:
        with open(os.path.join(workdir, f"rank{rank}.failed")) as f:
            return float(f.read())
    except (OSError, ValueError):
        return float("inf")


def _end(procs):
    """Kills every rank still running, with the processes it started (each
    rank leads a session of its own), and waits for each."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def _on_sigterm(signum, frame):
    raise SystemExit(128 + signum)


def launch(job: dict, command=(sys.executable, "-m", "benchmark.ranks")
           ) -> tuple:
    """Runs ``job`` on ``job["cell"]["chips"]`` ranks, each ``command``
    followed by the job file and the rank (a test puts a rank with a fault
    planted in its place); returns (rank 0's standard output, its standard
    error) or raises ``RankFailed``."""
    world = job["cell"]["chips"]
    workdir = tempfile.mkdtemp(prefix="qmg-bench-ranks-")
    procs, files = [], []
    previous = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        job = dict(job, store="file://" + os.path.join(workdir, "store"),
                   parent=os.getpid())
        path = os.path.join(workdir, "job.json")
        with open(path, "w") as f:
            json.dump(job, f)
        # The ranks share the host's cores: few threads each.
        threads = str(max(1, (os.cpu_count() or 1) // world))
        env = dict(os.environ, OMP_NUM_THREADS=threads)
        for r in range(world):
            out = open(os.path.join(workdir, f"rank{r}.out"), "w")
            err = open(os.path.join(workdir, f"rank{r}.err"), "w")
            files += [out, err]
            procs.append(subprocess.Popen(
                [*command, path, str(r)],
                stdin=subprocess.DEVNULL, stdout=out, stderr=err,
                cwd=run.ROOT, env=env, start_new_session=True))
        deadline = time.monotonic() + job["seconds"] + SETUP_ALLOWANCE_S
        pids = [p.pid for p in procs]
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                # A rank's failure fails the ranks that wait for it: let
                # them end, then name the one that failed first.
                time.sleep(GRACE_S)
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                r = min(bad, key=lambda r: _failed_at(workdir, r))
                raise RankFailed(
                    f"rank {r} of {world} failed first, with exit code "
                    f"{codes[r]} (ranks {bad} exited with another code than "
                    f"0); the end of its standard error:\n"
                    f"{_tail(os.path.join(workdir, f'rank{r}.err'))}", pids)
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                alive = [r for r, c in enumerate(codes) if c is None]
                raise RankFailed(
                    f"ranks {alive} of {world} still running "
                    f"{job['seconds'] + SETUP_ALLOWANCE_S:.0f} s after the "
                    f"start, past the deadline; the end of rank "
                    f"{alive[0]}'s standard error:\n"
                    f"{_tail(os.path.join(workdir, f'rank{alive[0]}.err'))}",
                    pids)
            time.sleep(POLL_S)
        with open(os.path.join(workdir, "rank0.out")) as f:
            out = f.read()
        with open(os.path.join(workdir, "rank0.err")) as f:
            err = f.read()
        return out, err
    finally:
        _end(procs)
        for f in files:
            f.close()
        signal.signal(signal.SIGTERM, previous)
        shutil.rmtree(workdir, ignore_errors=True)


class Ranks:
    """This process as rank ``rank`` of ``world`` in the default process
    group, over a (ny, nx) ``shape`` mesh (rank = iy * nx + ix, the
    program's ``parallel.Mesh`` order); collectives take tensors on
    ``device``."""

    def __init__(self, rank: int, world: int, shape, device):
        self.rank, self.world, self.shape = rank, world, tuple(shape)
        self.device = device
        self.root = rank == 0
        self.group = dist.group.WORLD

    def block(self, field, y_dim: int):
        """The rank's block of a whole field, as a view: axes ``y_dim`` and
        ``y_dim + 1`` are (Y, Xh). The benchmark's own cut, independent of
        the program's ``shard_field``."""
        ny, nx = self.shape
        iy, ix = divmod(self.rank, nx)
        y_len, xh = field.shape[y_dim], field.shape[y_dim + 1]
        if y_len % ny or xh % nx:
            raise ValueError(f"a ({y_len}, {xh}) field does not tile the "
                             f"mesh {self.shape}")
        y_loc, x_loc = y_len // ny, xh // nx
        return (field.narrow(y_dim, iy * y_loc, y_loc)
                .narrow(y_dim + 1, ix * x_loc, x_loc))

    def whole(self, block, y_dim: int):
        """The whole field from every rank's ``block``, on every rank."""
        block = block.contiguous()
        parts = [torch.empty_like(block) for _ in range(self.world)]
        dist.all_gather([torch.view_as_real(p) for p in parts],
                             torch.view_as_real(block))
        ny, nx = self.shape
        rows = [torch.cat(parts[iy * nx:(iy + 1) * nx], dim=y_dim + 1)
                for iy in range(ny)]
        return torch.cat(rows, dim=y_dim)

    def share(self, *flags) -> list:
        """Rank 0's ``flags`` (bools), on every rank."""
        t = torch.tensor([int(f) for f in flags], dtype=torch.int64,
                         device=self.device)
        dist.broadcast(t, 0)
        return [bool(v) for v in t.tolist()]

    def all_true(self, flags) -> list:
        """Each of ``flags`` (bools) true on every rank."""
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return [bool(v) for v in t.tolist()]

    def gather(self, value: float) -> list:
        """Every rank's ``value``, in rank order; also a barrier."""
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return [float(p.item()) for p in parts]


def _die_with_parent(parent: int):
    """Has the kernel kill this process when the launching parent ends, so
    that no rank outlives a parent that was killed."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(
            ctypes.c_int(PR_SET_PDEATHSIG), ctypes.c_ulong(signal.SIGKILL))
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def worker_main(argv) -> int:
    """One rank: ``argv`` is (job.json, rank). Rank 0 prints the run's
    result as ``run.main`` does; every rank checks its modules."""
    path, rank = argv[0], int(argv[1])
    job = run.load_json(path)
    _die_with_parent(job["parent"])
    world = job["cell"]["chips"]
    timeout = datetime.timedelta(seconds=job["seconds"] + SETUP_ALLOWANCE_S)
    try:
        if job["device"] == "cpu":
            device = "cpu"
            dist.init_process_group("gloo", init_method=job["store"],
                                    rank=rank, world_size=world,
                                    timeout=timeout)
        else:
            device = f"cuda:{rank}"
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", init_method=job["store"],
                                    rank=rank, world_size=world,
                                    timeout=timeout,
                                    device_id=torch.device(device))
        ranks = Ranks(rank, world, run.mesh_shape(job["cell"], job["config"]),
                      device)
        result = run.run_cell(job["bench"], job["cell"], job["config"],
                              job["traffic"], job["seed"], job["seconds"],
                              job["trace"], device, job["t_start"],
                              ranks=ranks)
        found = run.forbidden_modules()
        if found:
            print(f"rank {rank}: modules loaded that the benchmark may not "
                  f"load: {found}", file=sys.stderr, flush=True)
            os._exit(3)
        dist.destroy_process_group()
    except BaseException:   # noqa: B036 - a rank's boundary: report, end
        failed_at = time.monotonic()
        traceback.print_exc()
        sys.stderr.flush()
        with open(os.path.join(os.path.dirname(path), f"rank{rank}.failed"),
                  "w") as f:
            f.write(repr(failed_at))
        # At once: a rank that failed must not wait in the process group's
        # teardown for ranks that wait for it.
        os._exit(1)
    if result is not None:
        run.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
