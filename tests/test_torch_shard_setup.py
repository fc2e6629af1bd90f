"""The sharded setup (``make_kcycle_setup_planes(mesh=)``) and every
formulation on a mesh, against qmg_tpu's unsharded setup and the port's
unsharded solves:

  * the setup oracle of qmg_tpu's tests/test_setup_planes.py (32^2,
    n_refine 2, coarse_dof 4, 4 x 4 blocks, null vectors by a fixed 24
    iterations, complex128) with the dense coarsest and with the
    deflation stage, and the n19 configuration at 16^2: every array of
    the port's sharded state, put together, within 1e-8 of its largest
    entry of qmg_tpu's unsharded state (the derived sets, which qmg_tpu's
    setup state does not carry, against the port's unsharded ones);
  * the Schur, deflated and batched solves on a mesh (to 1e-8): complex128
    equal to the unsharded solve (x to 1e-10 relative, the same count),
    the batched solve lane by lane (the complex64 Schur count on a mesh
    against qmg_tpu's ``make_planes_solver`` is in
    tests/test_torch_schur_kcycle.py, beside qmg_tpu's solve it reuses);
  * the digest check of the ranks' coarse levels (``parallel.
    check_replicated``) raises on a copy that one rank changed.

In-process meshes (2, 1) and (2, 2), and gloo meshes of 2 x 2 ranks and
of 2 x 1 (two of them) from one group of 4 spawned as in
tests/test_torch_shard_solve.py (whose harness this file imports; the
workers import no qmg_tpu module).
"""

import contextlib
import datetime
import os
import traceback

import numpy as np
import pytest
import torch

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.setup import KCycleConfig, SCHUR_CONFIG
from qmg_tpu_torch.setup_planes import (make_kcycle_setup_planes,
                                        gauss_seed_planes)
from qmg_tpu_torch.solve import (make_solver, make_batched_solver,
                                 state_to_numpy, state_from_numpy,
                                 shard_state)
from qmg_tpu_torch.stencil import StencilType, WHOLE
from qmg_tpu_torch.parallel import (Mesh, check_replicated, shard_field,
                                    unshard_field)
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch import u1

from test_torch_shard_solve import _spawn

torch.set_num_threads(1)

MASS = -0.05
SCHUR = StencilType.RIGHT_SCHUR
ORIGINAL = StencilType.ORIGINAL
_ORACLE = dict(coarse_dof=4, x_block=4, y_block=4, nullvec_max_iter=24,
               nullvec_tol=0.0)
# name -> (lattice size, KCycleConfig fields, deflation pairs). The n13
# setup ends with the dense inverse of the coarsest M^dag M and with its
# deflation pairs: its solves take either coarsest.
SETUPS = {
    "n13": (32, dict(n_refine=2, coarsest_stencil_app=StencilType.MDAGGER_M,
                     coarsest_direct=True, **_ORACLE), 4),
    "n19": (16, dict(n_refine=1, **_ORACLE, **SCHUR_CONFIG), 0),
}
# formulation -> (setup, the dense coarsest inverse taken)
FORMULATIONS = {"n13-direct": ("n13", True), "n13-deflated": ("n13", False),
                "n19": ("n19", False)}
# Level 0's arrays, cut by block, and the axis their rows are on.
Y_DIMS = {"clover0": 1, "hopping0": 2, "nvb0": 3, "rbjcinv0": 1,
          "rbjh0": 2, "schurf0": 1}
TOL = 1e-8


def problem(name):
    """(lattice, KCycleConfig, gauge, seeds, deflation pairs, b, B) of a
    setup: the gauge and seeds of qmg_tpu's oracle (QMGRandom 1337 and
    999), b drawn after the gauge, and three right-hand sides (b, a point
    source and b rolled by a row)."""
    size, fields, deflate = SETUPS[name]
    lat = Lattice2D(size, size, 2)
    cfg = KCycleConfig(**fields)
    rng = QMGRandom(1337)
    gauge = np.asarray(u1.gauss_gauge_u1(lat, rng, 6.0))
    b = rng.gaussian_cv(lat)
    point = np.zeros_like(b)
    point[0, 0, 0, 0] = 1.0
    B = np.stack([b, point, np.roll(b, 1, axis=1)])
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999))
    return lat, cfg, gauge, seeds, deflate, b, B


def port_setup(name, mesh=None):
    lat, cfg, gauge, seeds, deflate, _, _ = problem(name)
    return make_kcycle_setup_planes(lat, cfg, MASS, dtype=torch.complex128,
                                    device="cpu", deflate_low=deflate,
                                    mesh=mesh)(gauge, *seeds)


def outer(name):
    return SETUPS[name][1].get("fine_stencil_app", ORIGINAL)


@contextlib.contextmanager
def formulation(mg, form):
    """``mg`` solving as ``form`` does: its coarsest by the dense inverse
    or by the deflated CG."""
    saved = mg.coarsest_solve.direct
    mg.coarsest_solve.direct = FORMULATIONS[form][1]
    try:
        yield outer(FORMULATIONS[form][0])
    finally:
        mg.coarsest_solve.direct = saved


def solve(mg, form, b, mesh=None):
    with formulation(mg, form) as outer_type:
        res, _ = make_solver(mg, tol=TOL, max_iter=200, fine_kernel=None,
                             mesh=mesh, outer_type=outer_type)(
            torch.as_tensor(b))
    assert bool(res.converged)
    return res


def solve_batch(mg, form, B, mesh=None):
    with formulation(mg, form) as outer_type:
        res, _ = make_batched_solver(mg, tol=TOL, max_iter=200,
                                     fine_kernel=None, mesh=mesh,
                                     outer_type=outer_type)(
            torch.as_tensor(B).contiguous())
    assert bool(res.converged.all())
    return res


def _jax_fields(fields):
    from qmg_tpu.stencil import StencilType as JStencilType
    from qmg_tpu.operators.coarse import CoarseOperator2D as JCoarse
    out = {k: (JStencilType(int(v)) if isinstance(v, StencilType) else v)
           for k, v in fields.items()}
    if "build_extra" in out:
        out["build_extra"] = JCoarse.BUILD_RBJACOBI
    return out


@pytest.fixture(scope="module")
def jax_states():
    """qmg_tpu's unsharded ``make_kcycle_setup_planes`` of each setup at
    complex128 (its float64 planes state)."""
    import jax
    import jax.numpy as jnp
    from qmg_tpu.lattice import Lattice2D as JLattice2D
    from qmg_tpu.setup import KCycleConfig as JKCycleConfig
    from qmg_tpu.setup_planes import make_kcycle_setup_planes as jsetup
    from qmg_tpu.tpu_compat import host_to_planes
    out = {}
    for name, (size, fields, deflate) in SETUPS.items():
        _, _, gauge, seeds, _, _, _ = problem(name)
        setup = jsetup(JLattice2D(size, size, 2),
                       JKCycleConfig(**_jax_fields(fields)), MASS,
                       dtype=jnp.complex128, deflate_low=deflate)
        state = setup(host_to_planes(gauge, np.float64),
                      *[host_to_planes(s, np.float64) for s in seeds])
        out[name] = {k: np.asarray(jax.device_get(v))
                     for k, v in state.items()}
    return out


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded setups (complex128) and states, and each
    formulation's solves (of b, and of the three right-hand sides one by
    one)."""
    setups, solves = {}, {}
    for name in SETUPS:
        mg = port_setup(name)
        setups[name] = {"mg": mg, "state": state_to_numpy(mg, np.float64,
                                                          outer(name))}
    for form, (name, _) in FORMULATIONS.items():
        mg = setups[name]["mg"]
        _, _, _, _, _, b, B = problem(name)
        solves[form] = {"mg": mg, "res": solve(mg, form, b),
                        "lanes": [solve(mg, form, bk) for bk in B]}
    return {"setup": setups, "solve": solves}


def check_state(state, name, jax_states, unsharded):
    """Every array within 1e-8 of its largest entry of qmg_tpu's unsharded
    state; the derived sets, absent there, and the shifts, which qmg_tpu
    keeps in complex64 on level 0, of the port's unsharded state."""
    ref = unsharded["setup"][name]["state"]
    assert set(state) == set(ref)
    jref = jax_states[name]
    assert set(jref) <= set(state)
    for k, v in state.items():
        want = ref[k] if k.startswith("shifts") else jref.get(k, ref[k])
        scale = max(float(np.max(np.abs(want))), 1e-30)
        assert float(np.max(np.abs(v - want))) <= 1e-8 * scale, (name, k)


def rel(x, want):
    return float(np.abs(np.asarray(x) - want.numpy()).max()
                 / want.abs().max())


# ---------------------------------------------------------------------------
# In-process meshes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SETUPS))
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_in_process_setup_matches_qmg_tpu(jax_states, unsharded, shape,
                                          name):
    """The whole hierarchy an in-process mesh's setup returns: qmg_tpu's
    state, bit for bit the port's unsharded one (every product and sum of
    a block is the whole lattice's), a plain level-0 stencil."""
    mg = port_setup(name, Mesh(*shape))
    state = state_to_numpy(mg, np.float64, outer(name))
    check_state(state, name, jax_states, unsharded)
    ref = unsharded["setup"][name]["state"]
    for k in state:
        assert np.array_equal(state[k], ref[k]), k
    assert mg.get_stencil(0).pulls is WHOLE


@pytest.mark.parametrize("shape, form", [
    ((2, 2), "n13-direct"), ((2, 2), "n13-deflated"), ((2, 2), "n19"),
    ((4, 1), "n19")], ids=["2x2-n13-direct", "2x2-n13-deflated", "2x2-n19",
                          "4x1-n19"])
def test_in_process_solves_equal_unsharded(unsharded, shape, form):
    """Every formulation (the direct coarsest, the deflated CG one, n19's
    Schur) on an in-process mesh: the unsharded solve's count and x to
    1e-10, for b and for the batch of three lane by lane."""
    mg, ref = unsharded["solve"][form]["mg"], unsharded["solve"][form]["res"]
    _, _, _, _, _, b, B = problem(FORMULATIONS[form][0])
    res = solve(mg, form, b, Mesh(*shape))
    assert res.iters == ref.iters and rel(res.x, ref.x) <= 1e-10
    batched = solve_batch(mg, form, B, Mesh(*shape))
    for k, one in enumerate(unsharded["solve"][form]["lanes"]):
        assert int(batched.iters[k]) == one.iters, k
        assert rel(batched.x[k], one.x) <= 1e-10, k


def test_in_process_batched_schur_lanes(unsharded):
    """``torch_lanes.check_lanes`` on a (2, 2) mesh: the batched Schur
    solve's lanes are its single solves' (counts, carries, x)."""
    from torch_lanes import check_lanes
    _, _, _, _, _, _, B = problem("n19")
    check_lanes(unsharded["setup"]["n19"]["mg"], B, tol=TOL, max_iter=200,
                mesh=Mesh(2, 2), outer_type=SCHUR)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2), (1, 4)],
                         ids=["2x1", "2x2", "4x2", "1x4"])
def test_block_coefficients_are_the_cut(shape):
    """A block's Wilson coefficients from its own gauge rows and the row
    and column its -y and -x hops read are ``shard_coeffs`` of the whole
    operator's, bit for bit."""
    from qmg_tpu_torch.operators.wilson import wilson_coeff_arrays
    from qmg_tpu_torch.parallel import shard_coeffs
    from qmg_tpu_torch.stencil import make_coeffs
    lat, _, gauge, _, _, _, _ = problem("n19")
    whole = make_coeffs(lat, *wilson_coeff_arrays(
        lat, gauge, 1.0, dtype=torch.complex128, device="cpu"))
    mesh = Mesh(*shape)
    for (iy, ix), cut in zip(mesh.blocks, shard_coeffs(whole, mesh)):
        clover, hopping = wilson_coeff_arrays(
            lat, gauge, 1.0, dtype=torch.complex128, device="cpu",
            block=(*shape, iy, ix))
        assert torch.equal(clover, cut.clover)
        assert torch.equal(hopping, cut.hopping)


@pytest.mark.parametrize("shape, message", [
    ((3, 1), "does not tile"), ((16, 1), "Y_loc must be even"),
    ((1, 8), "does not align"),
    ((1, 4), "whole even-odd packed coarse blocks"),
], ids=["rows", "odd_local_rows", "columns", "coarse_columns"])
def test_setup_mesh_refusals(shape, message):
    """The refusals on 16^2 with 4 x 4 aggregates, qmg_tpu's: level 0 must
    tile the mesh with even local rows, and a block hold whole aggregates
    and an even number of coarse columns."""
    with pytest.raises(ValueError, match=message):
        make_kcycle_setup_planes(Lattice2D(16, 16, 2),
                                 KCycleConfig(**SETUPS["n19"][1]), MASS,
                                 device="cpu", mesh=Mesh(*shape))


# ---------------------------------------------------------------------------
# gloo meshes, one block per process.
# ---------------------------------------------------------------------------

def _gloo_worker(rank: int, shape, workdir: str):
    """One rank of a gloo group of 4: every piece on the (2, 2) mesh of
    the whole group, then on the (2, 1) mesh of ranks 0 and 1 (one spawn
    serves both shapes); results under "2x2_" and "2x1_"."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/store", rank=rank,
            world_size=4, timeout=datetime.timedelta(seconds=60))
        try:
            out = {f"2x2_{k}": v for k, v in _gloo_pieces(
                Mesh(2, 2, dist.group.WORLD), rank).items()}
            pair = dist.new_group([0, 1])
            if rank < 2:
                out.update({f"2x1_{k}": v for k, v in _gloo_pieces(
                    Mesh(2, 1, pair), rank).items()})
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _gloo_pieces(mesh: Mesh, rank: int) -> dict:
    """Each setup on the mesh (the rank's cut of its state, the bytes
    each collective moved), each formulation's solve of b and of the
    batch of three on the rank's blocks, the n19 solve from
    ``shard_state``'s cut of the unsharded state (derived rows included),
    and the digest check with one rank's copy of the dense inverse
    changed."""
    out, mgs = {}, {}
    for name in SETUPS:
        before = dict(mesh.sent)
        mgs[name] = mg = port_setup(name, mesh)
        out[f"{name}_sent"] = np.array([mesh.sent[k] - before[k] for k in
                                        ("halo", "sum", "gather", "digest")])
        for k, v in state_to_numpy(mg, np.float64, outer(name)).items():
            out[f"{name}_state_{k}"] = v
    for form, (name, _) in FORMULATIONS.items():
        _, _, _, _, _, b, B = problem(name)
        _, (b_loc,) = shard_state({}, mesh, b)
        res = solve(mgs[name], form, b_loc, mesh)
        out[f"{form}_iters"], out[f"{form}_x"] = res.iters, res.x.numpy()
        (B_loc,) = shard_field(torch.as_tensor(B), mesh, 2)
        batched = solve_batch(mgs[name], form, B_loc, mesh)
        out[f"{form}_lanes_iters"] = batched.iters
        out[f"{form}_lanes_x"] = batched.x.numpy()
    arrays = mgs["n13"].replicated_arrays()
    out["checked"] = check_replicated(mesh, arrays)
    if rank == 1:
        arrays["coarsest_dinv"] = arrays["coarsest_dinv"] * (1 + 1e-15)
    try:
        check_replicated(mesh, arrays)
    except ValueError as e:
        out["p3"] = str(e)
    whole = state_to_numpy(port_setup("n19"), np.float64, SCHUR)
    (cut,), (b_loc,) = shard_state(whole, mesh, problem("n19")[5])
    mg = state_from_numpy(cut, problem("n19")[1], device="cpu", mesh=mesh)
    res = solve(mg, "n19", b_loc, mesh)
    out["cut_iters"], out["cut_x"] = res.iters, res.x.numpy()
    return out


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """One spawn of 4 gloo ranks (``_gloo_worker``): their result files."""
    workdir = str(tmp_path_factory.mktemp("setup_gloo"))
    return _spawn((2, 2), workdir, _gloo_worker)


@pytest.fixture(params=[(2, 1), (2, 2)], ids=["2x1", "2x2"])
def gloo_run(request, gloo_ranks):
    """(shape, each rank's results on that mesh, in mesh order)."""
    shape = request.param
    prefix = f"{shape[0]}x{shape[1]}_"
    return shape, [{k[len(prefix):]: r[k] for k in r.files
                    if k.startswith(prefix)}
                   for r in gloo_ranks[:shape[0] * shape[1]]]


def _whole(ranks, key, shape, y_dim):
    return unshard_field([torch.as_tensor(r[key]) for r in ranks],
                         Mesh(*shape), y_dim).numpy()


@pytest.mark.parametrize("name", list(SETUPS))
def test_gloo_setup_matches_qmg_tpu(gloo_run, jax_states, unsharded, name):
    """The ranks' cuts put together are qmg_tpu's state; every rank holds
    the same coarse levels; the setup moved halos, sums, gathered coarse
    slabs and digests."""
    shape, ranks = gloo_run
    prefix = f"{name}_state_"
    state = {}
    for key in ranks[0]:
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        if k in Y_DIMS:
            state[k] = _whole(ranks, key, shape, Y_DIMS[k])
        else:
            state[k] = ranks[0][key]
            for r in ranks[1:]:
                assert np.array_equal(r[key], state[k]), k
    check_state(state, name, jax_states, unsharded)
    for r in ranks:
        assert min(r[f"{name}_sent"].tolist()) > 0


@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_gloo_solves_equal_unsharded(gloo_run, unsharded, form):
    """Each formulation's distributed solve and its batch of three: the
    unsharded counts on every rank, x to 1e-10."""
    shape, ranks = gloo_run
    ref = unsharded["solve"][form]
    assert {int(r[f"{form}_iters"]) for r in ranks} == {ref["res"].iters}
    assert rel(_whole(ranks, f"{form}_x", shape, 1), ref["res"].x) <= 1e-10
    lanes_x = _whole(ranks, f"{form}_lanes_x", shape, 2)
    for k, one in enumerate(ref["lanes"]):
        assert {int(r[f"{form}_lanes_iters"][k]) for r in ranks} \
            == {one.iters}, k
        assert rel(lanes_x[k], one.x) <= 1e-10, k


def test_gloo_state_cut_and_digest(gloo_run, unsharded):
    """``shard_state`` cuts level 0's derived rows and the ranks solve on
    them as on the sharded setup; the ranks' coarse levels pass the
    digest check, and a copy that one rank changed raises on every rank,
    naming the array."""
    shape, ranks = gloo_run
    ref = unsharded["solve"]["n19"]["res"]
    assert {int(r["cut_iters"]) for r in ranks} == {ref.iters}
    assert rel(_whole(ranks, "cut_x", shape, 1), ref.x) <= 1e-10
    for r in ranks:
        assert int(r["checked"]) > 0
        assert "coarsest_dinv" in str(r["p3"])
