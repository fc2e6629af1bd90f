"""The slab kernel K7 on an rhs axis, and the batched solve on a mesh that
applies level 0 through it, on the CPU at small sizes:

  (a) the rhs twin against K7's one-field twin, field by field, for every
      layout the solve hands it (slabs that are views of whole fields,
      received halo buffers, one field), and on a 32^2 lattice cut into
      4 x 1 slabs against the plain reference
      ``benchmark/reference/wilson.py`` on the whole lattice;
  (b) ``make_batched_solver(fine_kernel="wilson-r1")`` on an in-process
      ``Mesh(4, 1)`` and over 2 gloo ranks, against the unsharded batched
      K1 solve, every true residual by the reference;
  (c) the mesh's spans (``qmg.mesh.*``) in one profiled gloo set-up and
      solve, against the collectives ``torch.distributed`` launched.

The gloo ranks are spawned by tests/test_torch_shard_solve.py's
``_spawn``. This file imports no JAX, so its card tests (marker ``cuda``)
run on a GPU host: ``python -m pytest tests/test_torch_halo_rhs.py -m
cuda``.
"""

import collections
import datetime
import os
import traceback

import numpy as np
import pytest
import torch
from torch.profiler import profile, ProfilerActivity

from benchmark.reference import wilson as reference
from qmg_tpu_torch import wilson_kernel as wk
from qmg_tpu_torch import u1
from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.operators.wilson import Wilson2D
from qmg_tpu_torch.parallel import Mesh, shard_field, unshard_field
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch.setup import KCycleConfig
from qmg_tpu_torch.setup_planes import (make_kcycle_setup_planes,
                                        gauss_seed_planes)
from qmg_tpu_torch.solve import make_batched_solver

from test_torch_shard_solve import _spawn

torch.set_num_threads(1)

L = 32
MASS = -0.06
ALPHA = 2.0 + MASS
NRHS = 4
TOL = 1e-5
CFG = KCycleConfig(n_refine=1, coarse_dof=4, nullvec_max_iter=100,
                   nullvec_tol=1e-3, coarsest_direct=True)
# Two solves of one system whose arithmetic differs by the order of
# complex64 sums (the set-up's and the solve's, over blocks and ranks):
# the same outer count, answers apart by rounding carried through the
# solve, measured at 2.3e-7 of the largest entry in process and 3.4e-6
# over 2 gloo ranks; the solve's own tolerance is 1e-5.
ROUNDING = 1e-5
# The mesh's span kinds, and the torch.distributed collectives they launch.
KINDS = ("digest", "gather", "halo", "sum")
COLLECTIVES = ("all_gather", "all_reduce", "batch_isend_irecv")


def _fields(shape, seed):
    """Gaussians (n, *shape[1:]) complex64, field 1 a point source and
    field 2 a wall source where the batch holds them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    if shape[0] > 1:
        x[1] = 0
        x[1][0, 3, 2, 1] = 1.0          # parity 0, row 3, column 2, spin 1
    if shape[0] > 2:
        x[2] = 0
        x[2][:, 0] = 1.0                # row 0
    return torch.as_tensor(x, dtype=torch.complex64)


def _phases(y_len, xh, seed=0):
    rng = np.random.default_rng(seed)
    ph = 0.5 * np.exp(1j * rng.uniform(-np.pi, np.pi, (4, 2, y_len, xh)))
    return torch.as_tensor(ph, dtype=torch.complex64)


def _slab(phase, x, y0, y_loc):
    """Slab [y0, y0 + y_loc) of whole phases and of x (*rhs, 2, Y, Xh, 2)
    and its halo rows, all as views."""
    y_len = x.shape[-3]
    return (phase[:, :, y0:y0 + y_loc], x.narrow(-3, y0, y_loc),
            x.select(-3, y0 - 1), x.select(-3, (y0 + y_loc) % y_len))


# ---------------------------------------------------------------------------
# (a) the rhs twin.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["views", "received", "one_field"])
def test_rhs_twin_is_the_one_field_twin_field_by_field(layout):
    """A gaussian, a point and a wall source in one batch: each field of
    the rhs twin (directly, through the wrapper, ``bind_halo`` and
    ``bind_halo_slabs``) is bit for bit K7's twin on that field alone."""
    y_len, xh, y_loc = 16, 8, 4
    phase = _phases(y_len, xh)
    n = 1 if layout == "one_field" else 3
    x = _fields((n, 2, y_len, xh, 2), seed=n)
    ph, xs, top, bot = _slab(phase, x, y_loc, y_loc)
    if layout == "received":
        xs, top, bot = xs.contiguous(), top.contiguous(), bot.contiguous()
    got = wk.wilson_r1_halo_apply_plain(ph, xs, top, bot, ALPHA)
    wrapped = wk.wilson_r1_halo_apply(ph, xs, top, bot, ALPHA)
    for b in range(n):
        one = wk.wilson_r1_halo_apply_plain(ph, xs[b], top[b], bot[b],
                                            ALPHA)
        assert torch.equal(got[b], one), b
        assert torch.equal(wrapped[b], one), b
    if layout == "received":
        bound = wk.bind_halo(ph.contiguous(), ALPHA, own_halos=False,
                             nrhs=n)
        assert torch.equal(bound(xs, top, bot), got)
    whole = wk.bind_halo_slabs(phase, y_len // y_loc, ALPHA, nrhs=n)(x)
    for b in range(n):
        assert torch.equal(whole[b],
                           wk.wilson_r1_apply_plain(phase, x[b], ALPHA)), b
    own = wk.bind_halo(phase, ALPHA, own_halos=True, nrhs=n)
    assert torch.equal(own(x, x.select(-3, -1), x.select(-3, 0)), whole)


def test_rhs_refusals():
    """The rhs axis's own checks: halos of another rhs count, fields that
    overlap, and one-field halos bound to a batch."""
    phase = _phases(8, 4)
    x = _fields((3, 2, 8, 4, 2), seed=1)
    ph, xs, top, bot = _slab(phase, x, 4, 4)
    with pytest.raises(ValueError, match="top must be"):
        wk.wilson_r1_halo_apply(ph, xs, top[:2], bot, ALPHA)
    # fields 8 sites apart, parity halves 16
    overlapping = torch.empty(128, dtype=torch.complex64).as_strided(
        (3, 2, 4, 4, 2), (16, 32, 8, 2, 1))
    with pytest.raises(ValueError, match="overlap"):
        wk.wilson_r1_halo_apply(ph, xs, top, bot, ALPHA, out=overlapping)
    apply = wk.bind_halo(ph.contiguous(), ALPHA, own_halos=False, nrhs=3)
    with pytest.raises(ValueError, match="was bound to"):
        apply(xs.contiguous(), top[0].contiguous(), bot[0].contiguous())


@pytest.fixture(scope="module")
def operator32():
    """The 32^2 Wilson operator on a gauss gauge (beta 6) and its gauge
    field, complex64 and complex128."""
    lat = Lattice2D(L, L, 2)
    gauge = u1.gauss_gauge_u1(lat, QMGRandom(2022), 6.0)
    op = Wilson2D(lat, MASS, gauge, dtype=torch.complex64)
    return op, torch.as_tensor(gauge)


def test_slabs_on_four_cuts_match_the_reference(operator32):
    """Three fields on a 32^2 lattice cut into 4 x 1 slabs: the bound
    slabs' rhs twin against ``benchmark/reference/wilson.wilson_apply``
    on the whole lattice in complex128, to 1e-5 of the largest entry
    (complex64 phases and fields)."""
    op, gauge = operator32
    x = _fields((3, 2, L, L // 2, 2), seed=7)
    got = wk.bind_halo_slabs(wk.wilson_phases(op.coeffs.hopping), 4, ALPHA,
                             nrhs=3)(x)
    grid = torch.stack([reference.unpack(gauge[0]),
                        reference.unpack(gauge[1])])
    for b in range(3):
        expect = reference.pack(reference.wilson_apply(
            grid, reference.unpack(x[b]).to(torch.complex128), MASS))
        err = (got[b].to(torch.complex128) - expect).abs().max()
        assert float(err / expect.abs().max()) <= 1e-5, b


# ---------------------------------------------------------------------------
# (b) the batched solve on a mesh.
# ---------------------------------------------------------------------------

def _inputs():
    """The gauss gauge, the null-vector seeds and NRHS gaussian sources
    (NRHS, 2, L, L/2, 2) complex64, from fixed seeds."""
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(3022)
    gauge = u1.gauss_gauge_u1(lat, rng, 6.0)
    seeds = gauss_seed_planes(lat, CFG, rng)
    gen = np.random.default_rng(4022)
    shape = (NRHS, 2, L, L // 2, 2)
    B = gen.normal(size=shape) + 1j * gen.normal(size=shape)
    return lat, gauge, seeds, torch.as_tensor(B, dtype=torch.complex64)


def _setup(mesh=None):
    lat, gauge, seeds, B = _inputs()
    mg = make_kcycle_setup_planes(lat, CFG, MASS, 1.0, device="cpu",
                                  mesh=mesh)(gauge, *seeds)
    return mg, gauge, B


def _batched(mg, B, mesh=None):
    solve = make_batched_solver(mg, tol=TOL, max_iter=200, restart_freq=32,
                                fine_kernel="wilson-r1", mesh=mesh)
    res, _ = solve(B)
    return solve, res


def _true_residuals(gauge, B, X):
    return [reference.true_residual(torch.as_tensor(gauge), B[k], X[k],
                                    MASS) for k in range(B.shape[0])]


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded batched K1 solve: (gauge, B, its result)."""
    mg, gauge, B = _setup()
    return gauge, B, _batched(mg, B)[1]


def test_in_process_mesh_batched_solve(unsharded, monkeypatch):
    """On ``Mesh(4, 1)`` level 0 applies through the slabs' rhs twin, one
    call a slab for all lanes; every lane converges to the unsharded
    batched K1 solve's count and answer."""
    gauge, B, ref = unsharded
    mesh = Mesh(4, 1)
    mg = _setup(mesh)[0]
    calls = collections.Counter()
    twin = wk.wilson_r1_halo_apply_plain

    def counted(phase, x, top, bot, alpha):
        calls[x.shape[0] if x.ndim == 5 else None] += 1
        return twin(phase, x, top, bot, alpha)

    monkeypatch.setattr(wk, "wilson_r1_halo_apply_plain", counted)
    solve, res = _batched(mg, B, mesh)
    assert solve.level_applies[0] == "wilson-r1 on 4x1 blocks"
    assert set(calls) == {NRHS} and calls[NRHS] % 4 == 0
    assert bool(res.converged.all())
    assert np.asarray(res.iters).tolist() == np.asarray(ref.iters).tolist()
    assert float((res.x - ref.x).abs().max() / ref.x.abs().max()) \
        <= ROUNDING
    assert max(_true_residuals(gauge, B, res.x)) < 2 * TOL


def _rhs_worker(rank: int, shape, workdir: str):
    """One gloo rank: the sharded setup and the batched K7 solve of the
    rank's blocks, both profiled; writes ``rank<r>.npz`` with the answer
    block, the counts, and each ``qmg.mesh.*`` span count beside the
    ``torch.distributed`` collectives launched, over both and over the
    solve alone."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    launched = collections.Counter()

    def counted(name, fn):
        def call(*args, **kw):
            launched[name] += 1
            return fn(*args, **kw)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, counted(name, getattr(dist, name)))
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/store", rank=rank,
            world_size=shape[0] * shape[1],
            timeout=datetime.timedelta(seconds=60))
        try:
            mesh = Mesh(*shape, dist.group.WORLD)
            out = {}
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                mg, _, B = _setup(mesh)
                (B_loc,) = shard_field(B, mesh, 2)
                before = collections.Counter(launched)
                solve, res = _batched(mg, B_loc.contiguous(), mesh)
            found = collections.Counter(
                e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("qmg.mesh."))
            out["kinds"] = np.array(KINDS)
            out["spans"] = np.array([found[f"qmg.mesh.{k}"] for k in KINDS])
            out["launched"] = np.array([launched[f] for f in COLLECTIVES])
            out["solve_launched"] = np.array(
                [launched[f] - before[f] for f in COLLECTIVES])
            out["x"], out["iters"] = res.x.numpy(), np.asarray(res.iters)
            out["converged"] = np.asarray(res.converged)
            out["fine_apply"] = solve.level_applies[0]
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """One spawn of 2 gloo ranks (``_rhs_worker``): their result files."""
    workdir = str(tmp_path_factory.mktemp("halo_rhs_gloo"))
    return _spawn((2, 1), workdir, _rhs_worker)


def test_gloo_mesh_batched_solve(unsharded, gloo_ranks):
    """Over 2 gloo ranks: every lane converges, on every rank, to the
    unsharded batched K1 solve's count; the answers put together equal
    its answers to complex64 rounding; every true residual by the
    reference within the tolerance."""
    gauge, B, ref = unsharded
    for r in gloo_ranks:
        assert str(r["fine_apply"]) == "wilson-r1 on 2x1 blocks"
        assert r["converged"].all()
        assert r["iters"].tolist() == np.asarray(ref.iters).tolist()
    x = unshard_field([torch.as_tensor(r["x"]) for r in gloo_ranks],
                      Mesh(2, 1), 2)
    assert float((x - ref.x).abs().max() / ref.x.abs().max()) <= ROUNDING
    assert max(_true_residuals(gauge, B, x)) < 2 * TOL


def test_gloo_mesh_spans_equal_calls(gloo_ranks):
    """Each ``qmg.mesh.<kind>`` span of the profiled set-up and solve is
    one collective launched: a halo span one ``batch_isend_irecv``, a sum
    one ``all_reduce``, a gather or a digest one ``all_gather``. The
    set-up and the solve ran every kind, and the solve exchanged halos,
    summed and gathered."""
    for r in gloo_ranks:
        spans = dict(zip(r["kinds"].tolist(), r["spans"].tolist()))
        launched = dict(zip(COLLECTIVES, r["launched"].tolist()))
        assert min(spans.values()) > 0
        assert spans["halo"] == launched["batch_isend_irecv"]
        assert spans["sum"] == launched["all_reduce"]
        assert spans["gather"] + spans["digest"] == launched["all_gather"]
        solve = dict(zip(COLLECTIVES, r["solve_launched"].tolist()))
        assert min(solve.values()) > 0


def test_in_process_mesh_spans_exchanges_it_would_launch():
    """An in-process mesh opens a span under a profiler for each halo
    exchange a distributed one would launch, and sends nothing; a mesh
    of one block along the axis exchanges nothing."""
    mesh = Mesh(4, 1)
    x = _fields((3, 2, 16, 4, 2), seed=3)
    from qmg_tpu_torch.shard_dslash import halo_roll
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        halo_roll(shard_field(x, mesh, 2), 1, 2, "y", mesh)
        halo_roll(shard_field(x, Mesh(1, 1), 2), 1, 2, "y", Mesh(1, 1))
    spans = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("qmg.mesh.")]
    assert spans == ["qmg.mesh.halo"]
    assert mesh.sent == dict.fromkeys(mesh.sent, 0)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views", "received"])
@pytest.mark.parametrize("shape", [(16, 8), (512, 256)],
                         ids=["16x16", "512x512"])
def test_k7_rhs_on_card(cuda_device, shape, layout):
    """K7's rhs entry on 4 fields: field b bit for bit one K7 launch on
    field b, and the twin to 1e-6 of the largest entry; the bound slabs
    (one launch a slab) bit for bit K1's rhs entry on the whole field."""
    y_len, xh = shape
    y_loc = y_len // 4
    phase = _phases(y_len, xh, seed=y_len).to(cuda_device)
    x = _fields((NRHS, 2, y_len, xh, 2), seed=y_len).to(cuda_device)
    ph, xs, top, bot = _slab(phase, x, y_loc, y_loc)
    if layout == "received":
        xs, top, bot = xs.contiguous(), top.contiguous(), bot.contiguous()
    before = wk.wilson_r1_halo_apply.launches
    got = wk.wilson_r1_halo_apply(ph, xs, top, bot, ALPHA)
    singles = [wk.wilson_r1_halo_apply(ph, xs[b], top[b], bot[b], ALPHA)
               for b in range(NRHS)]
    torch.cuda.synchronize()
    assert wk.wilson_r1_halo_apply.launches == before + 1 + NRHS
    twin = wk.wilson_r1_halo_apply_plain(ph, xs, top, bot, ALPHA)
    for b in range(NRHS):
        assert torch.equal(got[b], singles[b]), b
    assert float((got - twin).abs().max() / twin.abs().max()) <= 1e-6
    slabs = wk.bind_halo_slabs(phase, 4, ALPHA, nrhs=NRHS)(x)
    own = wk.bind_halo(phase, ALPHA, own_halos=True, nrhs=NRHS)(
        x, x.select(-3, -1), x.select(-3, 0))
    whole = wk.wilson_r1_rhs_apply(phase, x, ALPHA)
    torch.cuda.synchronize()
    assert torch.equal(own, whole)
    assert float((slabs - whole).abs().max() / whole.abs().max()) <= 2e-7
