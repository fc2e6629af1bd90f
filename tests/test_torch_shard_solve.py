"""The K-cycle solve on a fine level cut into blocks, against the unsharded
port and against qmg_tpu's ``make_planes_solver(mesh=...)``:

  (a) in-process meshes (one process holds every block);
  (b) ``torch.distributed`` meshes on gloo, one block per process: the halo
      exchange, the sharded applies, the sharded restrict/prolong (with
      the bytes each collective moved) and the same solves.

The gloo workers are spawned processes that import this module, so the
qmg_tpu (JAX) imports live inside the fixtures that need them: a worker
imports none of it. Each group rendezvouses through a ``file://`` store
under the test's temporary directory (no TCP port), its collectives time
out after 60 s, and the parent joins with a deadline and kills what is
left, so a deadlock is a failed test, never a hung run.
"""

import datetime
import os
import time
import traceback

import numpy as np
import pytest
import torch

from qmg_tpu_torch.parallel import Mesh, unshard_field
from qmg_tpu_torch.shard_dslash import (make_sharded_dslash,
                                        make_sharded_wilson)
from qmg_tpu_torch.setup import KCycleConfig
from qmg_tpu_torch.solve import make_solver, state_from_numpy, shard_state
from qmg_tpu_torch.stencil import apply_M
from qmg_tpu_torch.kcycle import true_residual

torch.set_num_threads(1)

L = 32
MASS = -0.05
CFG = KCycleConfig(n_refine=1, coarse_dof=4, nullvec_max_iter=100,
                   nullvec_tol=1e-3)
TOL64, TOL128 = 1e-5, 1e-10
SPAWN_DEADLINE_S = 110


@pytest.fixture(scope="module")
def jax_problem():
    """qmg_tpu's hierarchy of tests/test_sharded_dslash.py's mesh solve
    (32^2, n_refine 1, nc 4), its state in float32 and float64 planes, a
    right-hand side and a test field."""
    import jax.numpy as jnp
    from qmg_tpu.lattice import Lattice2D
    from qmg_tpu import u1 as ju1
    from qmg_tpu.operators import Wilson2D as JWilson2D
    from qmg_tpu.setup import (KCycleConfig as JKCycleConfig,
                               build_kcycle_hierarchy as jbuild)
    from qmg_tpu.tpu_compat import mg_state_planes
    from qmg_tpu.rng import QMGRandom as JQMGRandom
    lat = Lattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = JWilson2D(lat, MASS, g)
    mg = jbuild(lat, op, JKCycleConfig(n_refine=1, coarse_dof=4,
                                       nullvec_max_iter=100,
                                       nullvec_tol=1e-3), rng)
    return {"mg": mg, "b": rng.gaussian_cv(lat), "x": rng.gaussian_cv(lat),
            "s32": mg_state_planes(mg),
            "s64": mg_state_planes(mg, dtype=np.float64)}


@pytest.fixture(scope="module")
def jax_mesh_iters(jax_problem):
    """Outer iterations of qmg_tpu's sharded solve: the rank-1 Pallas
    kernel (interpret mode) per shard of a virtual (4, 1) mesh."""
    import jax
    from qmg_tpu import parallel as jparallel
    from qmg_tpu.tpu_compat import (make_planes_solver, shard_planes_state,
                                    host_to_planes)
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    jax.clear_caches()  # a large SPMD compile late in a long test run
    ymesh = jparallel.make_mesh(4, shape=(4, 1))
    b_p = host_to_planes(np.asarray(jax_problem["b"], np.complex64))
    solve, state = make_planes_solver(
        jax_problem["mg"], tol=TOL64, max_iter=200, restart_freq=32,
        mesh=ymesh, use_pallas_fine=True, pallas_kind="wilson-r1",
        pallas_interpret=True)
    placed, b_placed = shard_planes_state(state, ymesh, b_p)
    _, iters, _ = jax.jit(solve)(placed, b_placed)
    return int(iters)


def _solve(mg, b, tol, fine_kernel, mesh=None):
    res, _ = make_solver(mg, tol=tol, max_iter=200, restart_freq=32,
                         fine_kernel=fine_kernel, mesh=mesh)(b)
    assert bool(res.converged)
    return res


@pytest.fixture(scope="module")
def unsharded(jax_problem):
    """The port's unsharded solves on qmg_tpu's state: complex64 with the
    rank-1 twin and with the plain fine apply, complex128 plain."""
    mg32 = state_from_numpy(jax_problem["s32"], CFG, device="cpu")
    mg64 = state_from_numpy(jax_problem["s64"], CFG, device="cpu")
    b64 = torch.as_tensor(jax_problem["b"])
    b32 = b64.to(torch.complex64)
    return {"mg32": mg32, "mg64": mg64, "b32": b32, "b64": b64,
            "wilson-r1": _solve(mg32, b32, TOL64, "wilson-r1"),
            "plain": _solve(mg32, b32, TOL64, None),
            "c128": _solve(mg64, b64, TOL128, None)}


# ---------------------------------------------------------------------------
# (a) in-process meshes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape, fine_kernel", [
    ((4, 1), "wilson-r1"), ((4, 1), None), ((4, 2), None),
    ((1, 1), "wilson-r1")], ids=["4x1-r1", "4x1-plain", "4x2-plain",
                                 "1x1-r1"])
def test_in_process_solve_c64(unsharded, jax_mesh_iters, shape, fine_kernel):
    """Outer count equal to the unsharded port's and within +-1 of
    qmg_tpu's sharded solve; true residual < 1e-4."""
    mg, b = unsharded["mg32"], unsharded["b32"]
    res = _solve(mg, b, TOL64, fine_kernel, Mesh(*shape))
    assert res.iters == unsharded[fine_kernel or "plain"].iters
    assert abs(res.iters - jax_mesh_iters) <= 1
    assert true_residual(mg.get_stencil(0), b, res.x) < 1e-4
    assert mg.get_stencil(0).apply_override is None


@pytest.mark.parametrize("shape", [(4, 1), (4, 2), (2, 4)])
def test_in_process_solve_c128_equals_unsharded(unsharded, shape):
    res = _solve(unsharded["mg64"], unsharded["b64"], TOL128, None,
                 Mesh(*shape))
    ref = unsharded["c128"]
    assert res.iters == ref.iters
    assert float((res.x - ref.x).abs().max()) <= 1e-12


def test_in_process_level_applies_and_kcycle_entry(unsharded, capsys):
    solve = make_solver(unsharded["mg32"], fine_kernel="wilson-r1",
                        mesh=Mesh(4, 1))
    assert solve.level_applies[0] == "wilson-r1 on 4x1 blocks"
    from qmg_tpu_torch.kcycle import main
    main(["--size", "32", "--device", "cpu", "--shards", "4"])
    out = capsys.readouterr().out
    assert "level 0 cut over Mesh(4, 1, in-process)" in out
    assert "outer iterations: 9" in out
    for argv in (["--shards", "2", "--fine-kernel", "matrix"],
                 ["--distributed", "--fine-kernel", "wilson-phase"],
                 ["--shards", "2", "--distributed"]):
        with pytest.raises(SystemExit):
            main(["--size", "32", "--device", "cpu", *argv])


# ---------------------------------------------------------------------------
# (b) torch.distributed meshes on gloo.
# ---------------------------------------------------------------------------

def _gloo_worker(rank: int, shape, workdir: str):
    """One rank of a gloo group: loads the inputs, runs every sharded
    piece on its block and writes its results to ``rank<r>.npz``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    ny, nx = shape
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/store", rank=rank,
            world_size=ny * nx, timeout=datetime.timedelta(seconds=60))
        try:
            out = _gloo_pieces(Mesh(ny, nx, dist.group.WORLD), workdir)
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _gloo_pieces(mesh: Mesh, workdir: str) -> dict:
    data = np.load(os.path.join(workdir, "inputs.npz"))
    states = {p: {k[4:]: data[k] for k in data.files if k.startswith(p)}
              for p in ("s32_", "s64_")}
    out = {}

    def sent_since(before):
        return np.array([mesh.sent[k] - before[k]
                         for k in ("halo", "sum", "gather")])

    # --- complex128: plain sharded apply, transfer, solve ---
    (cut,), (b_loc,) = shard_state(states["s64_"], mesh, data["b"])
    (x_loc,) = shard_state({}, mesh, data["x"])[1]
    mg = state_from_numpy(cut, CFG, device="cpu", mesh=mesh)
    fine, transfer = mg.get_stencil(0), mg.get_transfer(0)
    x_loc, b_loc = torch.as_tensor(x_loc), torch.as_tensor(b_loc)
    before = dict(mesh.sent)
    out["dslash"] = make_sharded_dslash(fine.coeffs, mesh)(x_loc).numpy()
    out["dslash_sent"] = sent_since(before)
    before = dict(mesh.sent)
    coarse = transfer.restrict_f2c(x_loc)
    out["restrict"] = coarse.numpy()
    out["restrict_sent"] = sent_since(before)
    before = dict(mesh.sent)
    out["prolong"] = transfer.prolong_c2f(coarse).numpy()
    out["prolong_sent"] = sent_since(before)
    res = _solve(mg, b_loc, TOL128, None, mesh)
    out["c128_iters"], out["c128_x"] = res.iters, res.x.numpy()
    out["c128_res"] = true_residual(fine, b_loc, res.x, mesh)

    # --- complex64: the slab kernel's twin and the solves ---
    (cut,), (b_loc,) = shard_state(states["s32_"], mesh, data["b"])
    mg = state_from_numpy(cut, CFG, device="cpu", mesh=mesh)
    fine = mg.get_stencil(0)
    b_loc = torch.as_tensor(b_loc).to(torch.complex64)
    kernels = [None] + (["wilson-r1"] if mesh.nx == 1 else [])
    if mesh.nx == 1:
        out["wilson"] = make_sharded_wilson(
            fine.coeffs, mesh, MASS)(x_loc.to(torch.complex64)).numpy()
    for fine_kernel in kernels:
        res = _solve(mg, b_loc, TOL64, fine_kernel, mesh)
        name = fine_kernel or "plain"
        out[f"{name}_iters"], out[f"{name}_x"] = res.iters, res.x.numpy()
        out[f"{name}_res"] = true_residual(fine, b_loc, res.x, mesh)
    return out


def _spawn(shape, workdir: str, worker=None):
    """Run ``worker`` (``_gloo_worker`` by default; a module-level
    function (rank, shape, workdir) that writes ``rank<r>.npz``) on every
    rank of a ``shape`` mesh; returns the ranks' result files. Fails, with
    the workers' tracebacks, if a rank fails or is still running at the
    deadline."""
    ctx = torch.multiprocessing.get_context("spawn")
    world = shape[0] * shape[1]
    procs = [ctx.Process(target=worker or _gloo_worker,
                         args=(r, shape, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    assert not hung, f"ranks {hung} still running at the deadline\n" \
        + "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), \
        f"exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errors)
    return [np.load(os.path.join(workdir, f"rank{r}.npz"))
            for r in range(world)]


@pytest.fixture(scope="module", params=[(2, 1), (4, 1), (2, 2)],
                ids=["2x1", "4x1", "2x2"])
def gloo_run(request, jax_problem, tmp_path_factory):
    """One spawn per mesh shape: (shape, the ranks' results)."""
    shape = request.param
    workdir = str(tmp_path_factory.mktemp(f"gloo{shape[0]}x{shape[1]}"))
    arrays = {"b": jax_problem["b"], "x": jax_problem["x"]}
    for prefix in ("s32", "s64"):
        arrays.update({f"{prefix}_{k}": v
                       for k, v in jax_problem[prefix].items()})
    np.savez(os.path.join(workdir, "inputs.npz"), **arrays)
    return shape, _spawn(shape, workdir)


def _whole(ranks, key, shape, y_dim=1):
    return unshard_field([torch.as_tensor(r[key]) for r in ranks],
                         Mesh(*shape), y_dim)


def test_gloo_sharded_applies(gloo_run, unsharded, jax_problem):
    """The ranks' blocks of M x put together are the unsharded apply's
    (<= 1e-13 at complex128; the slab twin bit for bit), and an apply
    moves halo rows and columns only."""
    shape, ranks = gloo_run
    x = torch.as_tensor(jax_problem["x"])
    fine = unsharded["mg64"].get_stencil(0)
    expect = apply_M(fine.coeffs, x)
    assert float((_whole(ranks, "dslash", shape) - expect).abs().max()) \
        <= 1e-13
    ny, nx = shape
    rows = 2 * 2 * (L // 2 // nx) * 2 * 16 if ny > 1 else 0  # +-y, 2 parities
    cols = 4 * (L // ny) * 2 * 16 if nx > 1 else 0           # +-x, 2 halves
    for r in ranks:
        assert r["dslash_sent"].tolist() == [rows + cols, 0, 0]
    if nx == 1:
        mg32 = unsharded["mg32"]
        ref = make_sharded_wilson(mg32.get_stencil(0).coeffs, Mesh(ny, 1),
                                  MASS)(x.to(torch.complex64))
        assert torch.equal(_whole(ranks, "wilson", shape), ref)


def test_gloo_sharded_transfer(gloo_run, unsharded, jax_problem):
    """Restrict and prolong on blocks equal the unsharded transfer (<=
    1e-13); restrict gathers the coarse slabs and nothing else, prolong
    sends nothing: no fine field crosses ranks."""
    shape, ranks = gloo_run
    x = torch.as_tensor(jax_problem["x"])
    transfer = unsharded["mg64"].get_transfer(0)
    coarse = transfer.restrict_f2c(x)
    fine = transfer.prolong_c2f(coarse)
    world = shape[0] * shape[1]
    slab_bytes = coarse.numel() * 16 // world
    assert 4 * slab_bytes <= x.numel() * 16 // world  # no fine block's size
    for r in ranks:
        assert float((torch.as_tensor(r["restrict"]) - coarse).abs().max()) \
            <= 1e-13
        assert r["restrict_sent"].tolist() == [0, 0, slab_bytes]
        assert r["prolong_sent"].tolist() == [0, 0, 0]
    assert float((_whole(ranks, "prolong", shape) - fine).abs().max()) \
        <= 1e-13


def test_gloo_solve_c128_equals_unsharded(gloo_run, unsharded):
    shape, ranks = gloo_run
    ref = unsharded["c128"]
    assert {int(r["c128_iters"]) for r in ranks} == {ref.iters}
    assert float((_whole(ranks, "c128_x", shape) - ref.x).abs().max()) \
        <= 1e-12
    assert all(float(r["c128_res"]) < 1e-9 for r in ranks)


def test_gloo_solve_c64_iteration_counts(gloo_run, unsharded,
                                         jax_mesh_iters):
    """Every rank reports the in-process (= unsharded) solve's outer
    count, within +-1 of qmg_tpu's sharded solve; true residual < 1e-4."""
    shape, ranks = gloo_run
    for name in ["plain"] + (["wilson-r1"] if shape[1] == 1 else []):
        iters = {int(r[f"{name}_iters"]) for r in ranks}
        assert iters == {unsharded[name].iters}
        assert abs(unsharded[name].iters - jax_mesh_iters) <= 1
        assert all(float(r[f"{name}_res"]) < 1e-4 for r in ranks)
        residuals = {float(r[f"{name}_res"]) for r in ranks}
        assert len(residuals) == 1  # one summed value on every rank
