"""The sharded Dslash of the port (``parallel``, ``shard_dslash``, the slab
kernel's twin) against qmg_tpu: the twin per slab against qmg_tpu's
halo-frame Pallas kernel in interpret mode and against
``make_sharded_pallas_wilson`` on a virtual mesh, the plain sharded apply
against ``apply_M``, every refusal, and the layout helpers.

All meshes here are in-process ones (one process holds every block); the
``torch.distributed`` meshes are in test_torch_shard_solve.py. The
kernel-vs-twin tests carry the ``cuda`` marker and skip where there is no
CUDA device; run them on a GPU host with
``python -m pytest tests/test_torch_shard_dslash.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import stencil as jstencil, u1 as ju1, parallel as jparallel
from qmg_tpu.operators import Wilson2D as JWilson2D, Staggered2D
from qmg_tpu.pallas_wilson import (make_pallas_wilson_rank1_shaped,
                                   wilson_phases_from_coeffs)
from qmg_tpu.pallas_dslash import x_to_planes, x_from_planes
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.multigrid import MultigridMG
from qmg_tpu_torch.stencil import make_coeffs
from qmg_tpu_torch.parallel import (Mesh, make_mesh, shard_field,
                                    unshard_field, shard_coeffs,
                                    shardable_dims, validate_mg_sharding,
                                    replication_crossover)
from qmg_tpu_torch.shard_dslash import (make_sharded_dslash,
                                        make_sharded_wilson,
                                        cshift_pull_sharded, halo_roll)
from qmg_tpu_torch.cshift import cshift_pull, ALL_DIRS
from qmg_tpu_torch.wilson_kernel import (wilson_r1_apply,
                                         wilson_r1_apply_plain,
                                         wilson_r1_halo_apply,
                                         wilson_r1_halo_apply_plain,
                                         bind_halo_slabs, wilson_phases)
from qmg_tpu_torch.solve import (make_solver, state_from_numpy,
                                 state_to_numpy, shard_state)
from qmg_tpu_torch.setup import KCycleConfig

torch.set_num_threads(1)

MASS = -0.07
ALPHA = 2.0 + MASS


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _jax_wilson(L, dtype=jnp.complex64):
    lat = Lattice2D(L, L, 2)
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(lat, rng, 6.0)
    op = JWilson2D(lat, MASS, jnp.asarray(g, dtype), dtype=dtype)
    x = rng.gaussian_cv(lat).astype(np.dtype(dtype))
    return lat, op, x


def _torch_coeffs(jcoeffs, nc, dtype):
    """qmg_tpu coefficients as the port's record (same layouts)."""
    lat = TLattice2D(jcoeffs.lat.x_len, jcoeffs.lat.y_len, nc)

    def arr(a):
        return None if a is None else torch.as_tensor(np.array(a)).to(dtype)

    return make_coeffs(lat, clover=arr(jcoeffs.clover),
                       hopping=arr(jcoeffs.hopping),
                       shift=complex(jcoeffs.shift),
                       eo_shift=complex(jcoeffs.eo_shift),
                       dof_shift=complex(jcoeffs.dof_shift), dtype=dtype)


def _slab_inputs(phase, x, y0, y_loc):
    """Views of slab [y0, y0 + y_loc) of whole phases and x, and its halo
    rows."""
    y_len = x.shape[1]
    return (phase[:, :, y0:y0 + y_loc], x[:, y0:y0 + y_loc], x[:, y0 - 1],
            x[:, (y0 + y_loc) % y_len])


# ---------------------------------------------------------------------------
# The slab kernel's twin against qmg_tpu.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L, ny", [(16, 1), (16, 2), (32, 2), (32, 4),
                                   (64, 4)])
def test_twin_per_slab_matches_pallas_halo_frame_interpret(L, ny):
    """Each slab through the twin against qmg_tpu's rank-1 kernel in its
    ``halo_frame=True`` form (interpret mode), fed the 8-row frame that
    ``make_sharded_pallas_wilson`` would assemble, here built with numpy:
    no mesh, no SPMD compile. 2e-6 relative at complex64 (two float32
    evaluation orders of a 9-term sum)."""
    lat, op, x = _jax_wilson(L)
    y_loc = L // ny
    kernel = make_pallas_wilson_rank1_shaped(y_loc, lat.xh, 1.0, MASS,
                                             tile=8, interpret=True,
                                             halo_frame=True)
    ph_pl = np.asarray(wilson_phases_from_coeffs(op.coeffs))
    x_pl = np.asarray(x_to_planes(jnp.asarray(x)))
    phase = wilson_phases(torch.as_tensor(np.array(op.coeffs.hopping)))
    xt = torch.as_tensor(x)
    for iy in range(ny):
        y0 = iy * y_loc
        rows = np.arange(y0 - 8, y0 + y_loc + 8) % L
        expect = np.asarray(x_from_planes(kernel(
            jnp.asarray(ph_pl[..., y0:y0 + y_loc, :]),
            jnp.asarray(x_pl[..., rows, :]))))
        got = wilson_r1_halo_apply_plain(*_slab_inputs(phase, xt, y0, y_loc),
                                         ALPHA).numpy()
        assert _rel(got, expect) <= 2e-6, (iy, _rel(got, expect))


def test_sharded_wilson_matches_jax_sharded_pallas_wilson():
    """``make_sharded_wilson`` on an in-process (4, 1) mesh against
    ``make_sharded_pallas_wilson`` on qmg_tpu's virtual (4, 1) mesh at
    32^2, and both against ``apply_M``, as qmg_tpu's own test runs it."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    jax.clear_caches()  # a large SPMD compile late in a long test run
    from qmg_tpu.shard_dslash import make_sharded_pallas_wilson
    lat, op, x = _jax_wilson(32)
    ymesh = jparallel.make_mesh(4, shape=(4, 1))
    apply_fn = jax.jit(make_sharded_pallas_wilson(
        op.coeffs, ymesh, mass=MASS, tile=8, interpret=True))
    jgot = np.asarray(apply_fn(jparallel.shard_field(jnp.asarray(x), ymesh)))
    expect = np.asarray(jstencil.apply_M(op.coeffs, jnp.asarray(x)))
    coeffs = _torch_coeffs(op.coeffs, 2, torch.complex64)
    got = make_sharded_wilson(coeffs, Mesh(4, 1), MASS)(
        torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, jgot, atol=5e-5)
    np.testing.assert_allclose(got, expect, atol=5e-5)


@pytest.mark.parametrize("ny", [1, 2, 4, 8, 16])
def test_sharded_wilson_equals_unsharded_twin(ny):
    """The slabs' outputs put together are the whole-lattice rank-1 twin's,
    bit for bit (same arithmetic on the same neighbours)."""
    _, op, x = _jax_wilson(32)
    coeffs = _torch_coeffs(op.coeffs, 2, torch.complex64)
    xt = torch.as_tensor(x)
    got = make_sharded_wilson(coeffs, Mesh(ny, 1), MASS)(xt)
    assert torch.equal(got, wilson_r1_apply_plain(
        wilson_phases(coeffs.hopping), xt, ALPHA))


# ---------------------------------------------------------------------------
# The plain sharded apply.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 2), (1, 1), (8, 1), (1, 8), (2, 4)])
@pytest.mark.parametrize("kind", ["wilson", "staggered"])
def test_sharded_dslash_matches_apply_M(kind, shape):
    """Wilson (nc = 2) and a staggered stencil (nc = 1, no clover) at
    complex128 on in-process meshes against qmg_tpu's ``apply_M``."""
    rng = JQMGRandom(1337)
    nc = 2 if kind == "wilson" else 1
    lat = Lattice2D(32, 32, nc)
    g = ju1.gauss_gauge_u1(lat, rng, 6.0)
    op = (JWilson2D(lat, MASS, g) if kind == "wilson"
          else Staggered2D(lat, 0.1, g))
    x = rng.gaussian_cv(lat)
    expect = np.asarray(jstencil.apply_M(op.coeffs, jnp.asarray(x)))
    coeffs = _torch_coeffs(op.coeffs, nc, torch.complex128)
    got = make_sharded_dslash(coeffs, Mesh(*shape))(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 2), (2, 1), (1, 4)])
def test_cshift_pull_sharded_is_exact(shape):
    """Every pull of ``cshift`` (distance 1, distance 2 with two-row halos,
    the corners; full and half fields, with a leading batch axis) on
    blocks is the whole field's, bit for bit."""
    from qmg_tpu_torch.cshift import cshift_pull_half
    from qmg_tpu_torch.shard_dslash import cshift_pull_half_sharded
    mesh = Mesh(*shape)
    field = torch.arange(3 * 2 * 16 * 8 * 3).reshape(3, 2, 16, 8, 3)
    for d in range(12):
        for nb, f in ((0, field[0]), (1, field)):
            got = unshard_field(cshift_pull_sharded(
                shard_field(f, mesh, nb + 1), d, mesh, nb), mesh, nb + 1)
            assert torch.equal(got, cshift_pull(f, d, nb)), (d, nb)
            for parity in (0, 1):
                half = f.select(nb, parity)
                got = unshard_field(cshift_pull_half_sharded(
                    shard_field(half, mesh, nb), parity, d, mesh, nb), mesh,
                    nb)
                assert torch.equal(got, cshift_pull_half(half, parity, d,
                                                         nb)), (d, nb)
    with pytest.raises(ValueError, match="distance-2"):
        halo_roll(shard_field(field[0], mesh), 3, 1, "y", mesh)
    with pytest.raises(ValueError, match="unsupported direction"):
        cshift_pull_sharded(shard_field(field[0], mesh), 12, mesh)
    if mesh.ny > 1:
        thin = [b.narrow(1, 0, 1) for b in shard_field(field[0], mesh)]
        with pytest.raises(ValueError, match="cannot give a halo of 2"):
            halo_roll(thin, 2, 1, "y", mesh)


def test_dslash_entry_shards_on_cpu(capsys):
    """``dslash --kernel wilson-r1 --shards NY``: the chain through the
    slab twin has the unsharded chain's checksum; other kernels refuse
    ``--shards``."""
    import json
    from qmg_tpu_torch.dslash import main
    sums = {}
    for shards in (None, 4):
        main(["--size", "16", "--kernel", "wilson-r1", "--iters", "3",
              "--device", "cpu"] + ([] if shards is None
                                    else ["--shards", str(shards)]))
        r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert r["shards"] == shards
        sums[shards] = r["checksum"]
    assert sums[4] == sums[None]
    with pytest.raises(ValueError, match="--shards runs the rank-1 slab"):
        main(["--size", "16", "--kernel", "matrix", "--shards", "2",
              "--iters", "1", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Layout helpers.
# ---------------------------------------------------------------------------

def test_make_mesh_shape_rule():
    """qmg_tpu's rule: as square as possible, more blocks along y."""
    assert make_mesh(8).shape == (4, 2)
    assert make_mesh(4).shape == (2, 2)
    assert make_mesh(6).shape == (3, 2)
    assert make_mesh(7).shape == (7, 1)
    assert make_mesh(4, shape=(4, 1)).shape == (4, 1)
    assert len(make_mesh(8).blocks) == 8 and not make_mesh(8).distributed
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh(4, shape=(3, 1))
    with pytest.raises(ValueError, match="positive"):
        Mesh(0, 1)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 1)])
def test_shard_unshard_round_trip(shape):
    mesh = Mesh(*shape)
    rng = np.random.default_rng(3)
    field = torch.as_tensor(rng.normal(size=(2, 16, 8, 2)))
    blocks = shard_field(field, mesh)
    assert len(blocks) == mesh.ny * mesh.nx
    assert blocks[-1].shape == (2, 16 // mesh.ny, 8 // mesh.nx, 2)
    assert blocks[0].data_ptr() == field.data_ptr()  # views, not copies
    assert torch.equal(unshard_field(blocks, mesh), field)
    hop = torch.as_tensor(rng.normal(size=(4, 2, 16, 8, 2, 2)))
    assert torch.equal(unshard_field(shard_field(hop, mesh, 2), mesh, 2), hop)
    assert shardable_dims(TLattice2D(16, 16, 2), mesh)
    assert not shardable_dims(TLattice2D(16, 12, 2), Mesh(8, 1))
    with pytest.raises(ValueError, match="does not tile"):
        shard_field(field, Mesh(3, 1))
    with pytest.raises(ValueError, match="nothing to gather"):
        mesh.gather(field)


def test_shard_coeffs_cuts_arrays_and_keeps_scalars():
    _, op, _ = _jax_wilson(16, jnp.complex128)
    coeffs = _torch_coeffs(op.coeffs, 2, torch.complex128)
    mesh = Mesh(2, 2)
    local = shard_coeffs(coeffs, mesh)
    assert len(local) == 4
    for c, (iy, ix) in zip(local, mesh.blocks):
        assert c.lat == TLattice2D(8, 8, 2)
        assert c.shift == coeffs.shift and c.eo_shift == coeffs.eo_shift
        assert torch.equal(c.clover, coeffs.clover[:, 8 * iy:8 * iy + 8,
                                                   4 * ix:4 * ix + 4])
        assert torch.equal(c.hopping, coeffs.hopping[:, :, 8 * iy:8 * iy + 8,
                                                     4 * ix:4 * ix + 4])


def test_shard_state_round_trip():
    """``shard_state`` cuts clover0, hopping0, nvb0 and the rhs by block
    and leaves the rest whole; the cuts put together are the state."""
    rng = np.random.default_rng(5)
    state = {"clover0": rng.normal(size=(2, 16, 8, 2, 2, 2)),
             "hopping0": rng.normal(size=(4, 2, 16, 8, 2, 2, 2)),
             "shifts0": rng.normal(size=(3, 2)),
             "nvb0": rng.normal(size=(4, 2, 32, 4, 2, 2)),
             "clover1": rng.normal(size=(2, 4, 2, 4, 4, 2)),
             "cdinv": rng.normal(size=(64, 64, 2))}
    b = rng.normal(size=(2, 16, 8, 2))
    mesh = Mesh(2, 2)
    cuts, b_cuts = shard_state(state, mesh, b)
    assert len(cuts) == 4 and len(b_cuts) == 4
    for k, y_dim in (("clover0", 1), ("hopping0", 2), ("nvb0", 3)):
        parts = [torch.as_tensor(c[k]) for c in cuts]
        assert np.array_equal(unshard_field(parts, mesh, y_dim).numpy(),
                              state[k])
    assert np.array_equal(
        unshard_field([torch.as_tensor(p) for p in b_cuts], mesh).numpy(), b)
    for c in cuts:
        for k in ("shifts0", "clover1", "cdinv"):
            assert c[k] is state[k]
    assert shard_state(state, Mesh(1, 1))[0]["clover0"].shape == \
        state["clover0"].shape
    with pytest.raises(ValueError, match="does not cut"):
        shard_state(state, Mesh(3, 1))


# ---------------------------------------------------------------------------
# Refusals.
# ---------------------------------------------------------------------------

def _hierarchy(*dims):
    """A level stack of bare lattices (x, y, nc): all the sharding rules
    read."""
    lats = [TLattice2D(*d) for d in dims]
    mg = MultigridMG(lats[0], None)
    for lat in lats[1:]:
        mg.push_level(lat, None)
    return mg


def test_validate_mg_sharding_and_crossover():
    """qmg_tpu's case: 32^2 -> 8^2 -> 2^2 on a (4, 2) mesh."""
    mg = _hierarchy((32, 32, 2), (8, 8, 2), (2, 2, 2))
    mesh = make_mesh(8)
    validate_mg_sharding(mg, mesh)
    # 8^2: Xh = 4 tiles nx = 2 and Y_loc = 2 is even; 2^2: Y = 2 does not
    # tile ny = 4, so level 2 is the first held whole.
    assert replication_crossover(mg, mesh) == 2
    assert replication_crossover(mg, Mesh(1, 1)) == 3
    with pytest.raises(ValueError, match="does not tile"):
        validate_mg_sharding(mg, mesh, level=2)


@pytest.mark.parametrize("dims, shape, message", [
    (((32, 12, 2), (8, 3, 8)), (8, 1), "does not tile"),
    (((24, 32, 2), (6, 8, 8)), (1, 8), "does not tile"),
    (((32, 24, 2), (8, 6, 8)), (8, 1), "Y_loc must be even"),
    (((12, 12, 1), (4, 4, 2)), (1, 1), "x blocking 3 must be even"),
    (((32, 32, 2), (8, 8, 8)), (16, 1), "does not align"),
    (((32, 32, 2), (8, 8, 8)), (1, 16), "does not align"),
], ids=["tile_y", "tile_x", "odd_rows", "odd_x_block", "align_y", "align_x"])
def test_validate_mg_sharding_refusals(dims, shape, message):
    with pytest.raises(ValueError, match=message):
        validate_mg_sharding(_hierarchy(*dims), Mesh(*shape))


def _random_coeffs(x_len, y_len, nc, dtype=torch.complex64):
    lat = TLattice2D(x_len, y_len, nc)
    gen = torch.Generator().manual_seed(7)
    return make_coeffs(
        lat, clover=torch.randn(lat.cm_shape(), dtype=dtype, generator=gen),
        hopping=torch.randn(lat.hopping_shape(), dtype=dtype, generator=gen),
        shift=-0.05, dtype=dtype)


@pytest.mark.parametrize("dims, shape, message", [
    ((12, 12, 1), (2, 4), "tile the mesh"),
    ((16, 12, 1), (2, 3), "tile the mesh"),
    ((16, 12, 1), (4, 1), "Y_loc must be even"),
], ids=["tile_x", "tile_xh", "odd_rows"])
def test_sharded_dslash_refusals(dims, shape, message):
    with pytest.raises(ValueError, match=message):
        make_sharded_dslash(_random_coeffs(*dims), Mesh(*shape))


@pytest.mark.parametrize("dims, shape, w, message", [
    ((16, 16, 2), (4, 2), 1.0, "x-unsharded"),
    ((16, 16, 4), (4, 1), 1.0, "nc=2"),
    ((16, 12, 2), (8, 1), 1.0, "does not tile 8 y-shards"),
    ((16, 12, 2), (4, 1), 1.0, "must be even"),
    ((16, 16, 2), (4, 1), 1.3, "w == 1"),
], ids=["x_sharded", "nc", "tile", "odd_rows", "w"])
def test_sharded_wilson_refusals(dims, shape, w, message):
    with pytest.raises(ValueError, match=message):
        make_sharded_wilson(_random_coeffs(*dims), Mesh(*shape), MASS, w)


@pytest.fixture(scope="module")
def small_mg():
    """A two-level hierarchy of the port at 16^2 (4 x 4 blocks, nc 4)."""
    from qmg_tpu_torch.operators import Wilson2D
    from qmg_tpu_torch.setup import build_kcycle_hierarchy
    from qmg_tpu_torch.rng import QMGRandom
    from qmg_tpu_torch import u1
    lat = TLattice2D(16, 16, 2)
    rng = QMGRandom(1337)
    op = Wilson2D(lat, -0.05, u1.gauss_gauge_u1(lat, rng, 6.0),
                  dtype=torch.complex64)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4, nullvec_max_iter=50,
                       nullvec_tol=1e-3)
    return build_kcycle_hierarchy(lat, op, cfg, rng), cfg


@pytest.mark.parametrize("kw, message", [
    (dict(fine_kernel="wilson-phase", mesh=Mesh(2, 1)),
     "mesh requires fine_kernel='wilson-r1'"),
    (dict(fine_kernel="matrix", mesh=Mesh(2, 1)),
     "mesh requires fine_kernel='wilson-r1'"),
    (dict(fine_kernel="wilson-r1", mesh=Mesh(2, 2)), "x-unsharded"),
    (dict(fine_kernel=None, mesh=Mesh(8, 1)), "does not align"),
    (dict(fine_kernel=None, mesh=Mesh(3, 1)), "does not tile"),
    (dict(fine_kernel="wilson-r1", coeff_dtype=torch.bfloat16,
          mesh=Mesh(2, 1)), "coeff_dtype applies to the matrix kernels"),
], ids=["phase", "matrix", "x_sharded", "align", "tile", "bf16"])
def test_make_solver_mesh_refusals(small_mg, kw, message):
    mg, _ = small_mg
    with pytest.raises(ValueError, match=message):
        make_solver(mg, **kw)
    assert mg.get_stencil(0).apply_override is None


@pytest.mark.parametrize("kw, message", [
    (dict(fine_kernel="wilson-r1", mesh=Mesh(2, 2)), "x-unsharded"),
    (dict(fine_kernel=None, mesh=Mesh(8, 1)), "does not align"),
    (dict(fine_kernel=None, mesh=Mesh(3, 1)), "does not tile"),
], ids=["r1", "align", "tile"])
def test_make_batched_solver_mesh_refusals(small_mg, kw, message):
    """The batched solve on a mesh takes the single solve's refusals: the
    slab kernel's x-unsharded mesh, tiling and alignment."""
    from qmg_tpu_torch.solve import make_batched_solver
    mg, _ = small_mg
    with pytest.raises(ValueError, match=message):
        make_batched_solver(mg, **kw)
    assert mg.get_stencil(0).apply_override is None


def test_state_from_numpy_refuses_in_process_mesh(small_mg):
    mg, cfg = small_mg
    with pytest.raises(ValueError, match="in-process mesh takes the whole"):
        state_from_numpy(state_to_numpy(mg), cfg, device="cpu",
                         mesh=Mesh(2, 1))


# ---------------------------------------------------------------------------
# The slab kernel's wrapper.
# ---------------------------------------------------------------------------

def _inputs(y_len, xh, device, seed=0):
    rng = np.random.default_rng(seed)
    phase = 0.5 * np.exp(1j * rng.uniform(-np.pi, np.pi, (4, 2, y_len, xh)))
    x = rng.normal(size=(2, y_len, xh, 2)) \
        + 1j * rng.normal(size=(2, y_len, xh, 2))
    return (torch.as_tensor(phase, dtype=torch.complex64, device=device),
            torch.as_tensor(x, dtype=torch.complex64, device=device))


def test_cpu_wrapper_takes_twin_without_launch():
    phase, x = _inputs(8, 4, "cpu")
    args = _slab_inputs(phase, x, 4, 4)
    before = wilson_r1_halo_apply.launches
    got = wilson_r1_halo_apply(*args, ALPHA)
    assert wilson_r1_halo_apply.launches == before
    assert torch.equal(got, wilson_r1_halo_apply_plain(*args, ALPHA))
    out = torch.zeros_like(x)
    assert wilson_r1_halo_apply(*args, ALPHA, out=out[:, 4:]) is not None
    assert torch.equal(out[:, 4:], got) and not out[:, :4].any()


def test_bound_slabs_check_once_and_refuse_other_layouts():
    """``bind_halo_slabs`` makes the wrapper's checks when it is built and
    holds x to the layout it was bound to."""
    phase, x = _inputs(16, 4, "cpu")
    apply = bind_halo_slabs(phase, 4, ALPHA)
    assert torch.equal(apply(x), wilson_r1_apply_plain(phase, x, ALPHA))
    for bad in (x[:, :8], x.to(torch.complex128),
                x.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError, match="was bound to"):
            apply(bad)
    with pytest.raises(ValueError, match="does not tile 3 slabs"):
        bind_halo_slabs(phase, 3, ALPHA)
    with pytest.raises(ValueError, match="must be even"):
        bind_halo_slabs(phase, 16, ALPHA)
    with pytest.raises(TypeError, match="complex64"):
        bind_halo_slabs(phase.to(torch.complex128), 2, ALPHA)


@pytest.mark.parametrize("own_halos", [True, False],
                         ids=["own_rows", "received"])
def test_bound_halo_is_the_wrapper_on_cpu(own_halos):
    """``bind_halo`` (one rank's slab): the wrapper's result for the
    slab's own edge rows as halos and for dense received buffers, no
    launch counted on the CPU, other halo layouts refused."""
    from qmg_tpu_torch.wilson_kernel import bind_halo
    phase, x = _inputs(8, 4, "cpu", seed=5)
    if own_halos:
        top, bot = x[:, -1], x[:, 0]
    else:
        top, bot = _inputs(8, 4, "cpu", seed=6)[1][:, :2].unbind(1)
        top, bot = top.contiguous(), bot.contiguous()
    before = wilson_r1_halo_apply.launches
    apply = bind_halo(phase, ALPHA, own_halos=own_halos)
    assert torch.equal(apply(x, top, bot),
                       wilson_r1_halo_apply(phase, x, top, bot, ALPHA))
    assert wilson_r1_halo_apply.launches == before
    other = top.contiguous() if own_halos else x[:, -1]
    for bad in ((x[:, :4], top, bot), (x.to(torch.complex128), top, bot),
                (x, other, bot), (x, top, bot[:, :2]),
                (x, top, bot.to(torch.complex128))):
        with pytest.raises(ValueError, match="was bound to"):
            apply(*bad)


@pytest.mark.parametrize("bad, message", [
    ("odd_rows", "must be even"), ("noncontig", "contiguous phases"),
    ("dtype", "complex64"), ("meta", "unsupported device"),
    ("ndim", "phases must be")])
def test_bind_halo_checks_once(bad, message):
    from qmg_tpu_torch.wilson_kernel import bind_halo
    phase = torch.empty((4, 2, 8, 4), dtype=torch.complex64,
                        device="meta" if bad == "meta" else "cpu")
    phase = {"odd_rows": phase[:, :, :7].contiguous(),
             "noncontig": phase[:, :, :, :2],
             "dtype": phase.to(torch.complex128), "meta": phase,
             "ndim": phase[0]}[bad]
    with pytest.raises((TypeError, ValueError), match=message):
        bind_halo(phase, ALPHA, own_halos=True)


def _check_rejects(device, bad):
    phase, x = _inputs(8, 4, device)
    ph, xs, top, bot = _slab_inputs(phase, x, 4, 4)
    out = None
    if bad == "dtype":
        top = top.to(torch.complex128)
    elif bad == "odd_rows":
        ph, xs = phase[:, :, 4:7], x[:, 4:7]
    elif bad == "phase_shape":
        ph = phase[:, :, :6]
    elif bad == "halo_shape":
        top = top[:, :2]
    elif bad == "out_shape":
        out = torch.empty_like(x)
    elif bad == "strided_x":
        xs = x.transpose(1, 2).contiguous().transpose(1, 2)[:, 4:]
    elif bad == "halo_strides":
        top = top.contiguous()
    elif bad == "phase_dir_stride":
        # three parity halves a direction: the direction stride is not
        # twice the parity stride
        ph = torch.cat([ph, ph[:, :1]], dim=1)[:, :2]
    before = wilson_r1_halo_apply.launches
    with pytest.raises((TypeError, ValueError)):
        wilson_r1_halo_apply(ph, xs, top, bot, ALPHA, out=out)
    assert wilson_r1_halo_apply.launches == before


BAD_INPUTS = ["dtype", "odd_rows", "phase_shape", "halo_shape", "out_shape",
              "strided_x", "halo_strides", "phase_dir_stride"]


@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_wrapper_rejects_bad_input_cpu(bad):
    _check_rejects("cpu", bad)


@pytest.mark.parametrize("xh, message", [(16384, "unsupported device"),
                                         (16385, "32-bit")],
                         ids=["at_limit", "past_limit"])
def test_wrapper_index_range_guard(xh, message):
    """The kernel indexes a slab's phases up to 8 x the parity stride in
    int32; a slab that is a view of a whole field has the field's stride.
    Shape-only meta tensors: at the limit the check passes and the meta
    device is refused instead."""
    y_len = 16384
    phase = torch.empty((4, 2, y_len, xh), dtype=torch.complex64,
                        device="meta")
    x = torch.empty((2, y_len, xh, 2), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match=message):
        wilson_r1_halo_apply(*_slab_inputs(phase, x, 8, 8), ALPHA)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("ny", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(8, 8), (48, 32), (512, 256)],
                         ids=["16x8", "64x48", "512x512"])
def test_kernel_matches_twin_and_rank1_kernel_on_card(cuda_device, shape,
                                                      ny):
    """Each slab through the kernel (views of the whole field, written in
    place) against its twin, and the slabs together against the
    whole-lattice rank-1 kernel."""
    y_len, xh = shape
    if (y_len // ny) % 2 or y_len % ny:
        pytest.skip(f"{y_len} rows do not cut into {ny} even slabs")
    phase, x = _inputs(y_len, xh, cuda_device, seed=y_len)
    y_loc = y_len // ny
    out = torch.empty_like(x)
    before = wilson_r1_halo_apply.launches
    for iy in range(ny):
        args = _slab_inputs(phase, x, iy * y_loc, y_loc)
        got = wilson_r1_halo_apply(*args, ALPHA,
                                   out=out[:, iy * y_loc:(iy + 1) * y_loc])
        torch.cuda.synchronize()
        expect = wilson_r1_halo_apply_plain(*args, ALPHA)
        assert float((got - expect).abs().max() / expect.abs().max()) <= 1e-5
    assert wilson_r1_halo_apply.launches == before + ny
    whole = wilson_r1_apply(phase, x, ALPHA)
    assert float((out - whole).abs().max() / whole.abs().max()) <= 2e-7
    if ny == 1:
        assert torch.equal(out, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_wrapper_rejects_bad_input_on_card(cuda_device, bad):
    _check_rejects(cuda_device, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("own_halos", [True, False],
                         ids=["own_rows", "received"])
def test_bound_halo_is_the_kernel_on_card(cuda_device, own_halos):
    from qmg_tpu_torch.wilson_kernel import bind_halo
    phase, x = _inputs(48, 32, cuda_device, seed=8)
    if own_halos:
        top, bot = x[:, -1], x[:, 0]
    else:
        top, bot = x[:, -1].contiguous(), x[:, 0].contiguous()
    apply = bind_halo(phase, ALPHA, own_halos=own_halos)
    before = wilson_r1_halo_apply.launches
    got = apply(x, top, bot)
    torch.cuda.synchronize()
    assert wilson_r1_halo_apply.launches == before + 1
    assert torch.equal(got, wilson_r1_apply(phase, x, ALPHA))
