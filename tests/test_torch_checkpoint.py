"""Hierarchy checkpoints across the two packages (qmg_tpu's
tests/test_checkpoint.py, test_direct_coarsest.py and test_deflation.py's
round trip; complex128): the port's files load in the port and in
qmg_tpu, qmg_tpu's load in the port, with the dense coarsest inverse and
the deflation pairs, and every loaded hierarchy solves at its source's
outer and per-level counts; the version-2 null-vector layout is converted
on load; the bi-orthonormal transfers (restriction vectors and saved
block decompositions) round-trip in both directions."""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import u1 as ju1, checkpoint as jcheckpoint
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.setup import (KCycleConfig as JKCycleConfig,
                           build_kcycle_hierarchy as jbuild)
from qmg_tpu.stencil import StencilType as JStencilType
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch import checkpoint as tcheckpoint
from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.operators import Wilson2D as TWilson2D
from qmg_tpu_torch.setup import (KCycleConfig as TKCycleConfig,
                                 build_kcycle_hierarchy as tbuild)
from qmg_tpu_torch.solve import make_solver
from qmg_tpu_torch.stencil import StencilType

torch.set_num_threads(1)

MASS = -0.05


def _tracker(jmg):
    n = jmg.get_num_levels()
    return (np.array([[jmg.get_tracker_count(t, lvl) for t in range(4)]
                      for lvl in range(n)]),
            np.array([jmg.get_iterations_count(lvl) for lvl in range(n)]))


def jax_solve(jmg, b):
    c0, i0 = _tracker(jmg)
    res = jmg.solve(jnp.asarray(b), tol=1e-9, max_iter=300, restart_freq=32)
    c1, i1 = _tracker(jmg)
    return res, (c1 - c0)[:, 1:].tolist(), (i1 - i0).tolist()


def port_solve(tmg, b):
    res, carry = make_solver(tmg, tol=1e-9, max_iter=300, restart_freq=32,
                             fine_kernel=None)(torch.as_tensor(b))
    return res, carry["counts"][:, 1:].tolist(), carry["iters"].tolist()


def same_solve(a, b, x_tol=None):
    """Two solves' outer iterations, per-level counts and iterations
    agree, and their solutions within ``x_tol``."""
    assert bool(a[0].converged) and bool(b[0].converged)
    assert int(a[0].iters) == int(b[0].iters)
    assert a[1:] == b[1:]
    if x_tol is not None:
        xa, xb = np.asarray(a[0].x), np.asarray(b[0].x)
        assert np.max(np.abs(xa - xb)) <= x_tol


def _gauge(L, seed=1337):
    rng = JQMGRandom(seed)
    return ju1.gauss_gauge_u1(Lattice2D(L, L, 2), rng, 6.0), rng


@pytest.fixture(scope="module", params=["direct", "deflated"])
def port_mg(request):
    """The port's 32^2 hierarchy (two refinements to 2^2 nc8): with the
    dense coarsest inverse, or with an MDAGGER_M coarsest deflated by 4
    low and 2 high eigenpairs."""
    g, rng = _gauge(32)
    lat = TLattice2D(32, 32, 2)
    op = TWilson2D(lat, MASS, g, dtype=torch.complex128)
    kw = dict(n_refine=2, coarse_dof=8, nullvec_max_iter=150,
              nullvec_tol=5e-4)
    if request.param == "direct":
        kw["coarsest_direct"] = True
    else:
        kw["coarsest_stencil_app"] = StencilType.MDAGGER_M
    mg = tbuild(lat, op, TKCycleConfig(**kw), rng)
    if request.param == "deflated":
        mg.deflate_coarsest(4, 2)
    return request.param, g, mg, rng.gaussian_cv(Lattice2D(32, 32, 2))


def test_port_to_port(port_mg, tmp_path):
    """Save, load (``device="cpu"``), the same arrays and the same solve,
    solution included (1e-12)."""
    kind, g, mg, b = port_mg
    path = str(tmp_path / "mg.npz")
    tcheckpoint.save_hierarchy(mg, path)
    meta = json.loads(bytes(np.load(path)["__meta__"]).decode())
    assert meta["version"] == tcheckpoint.FORMAT_VERSION == \
        jcheckpoint.FORMAT_VERSION
    fine = TWilson2D(TLattice2D(32, 32, 2), MASS, g, dtype=torch.complex128)
    mg2 = tcheckpoint.load_hierarchy(path, fine, device="cpu")
    assert mg2.get_num_levels() == 3
    for lvl in (1, 2):
        assert torch.equal(mg2.get_stencil(lvl).coeffs.hopping,
                           mg.get_stencil(lvl).coeffs.hopping)
        assert torch.equal(mg2.get_transfer(lvl - 1)._nvb,
                           mg.get_transfer(lvl - 1)._nvb)
    if kind == "direct":
        assert mg2.coarsest_solve.direct
        assert torch.equal(mg2.coarsest_dinv, mg.coarsest_dinv)
    else:
        assert mg2.coarsest_solve.coarsest_stencil_app == StencilType.MDAGGER_M
        assert torch.equal(mg2.coarsest_evals, mg.coarsest_evals)
        assert torch.equal(mg2.coarsest_evecs, mg.coarsest_evecs)
    same_solve(port_solve(mg2, b), port_solve(mg, b), x_tol=1e-12)


def test_port_to_qmg_tpu(port_mg, tmp_path):
    """qmg_tpu loads the port's file and solves at the port's counts."""
    kind, g, mg, b = port_mg
    path = str(tmp_path / "mg.npz")
    tcheckpoint.save_hierarchy(mg, path)
    jmg = jcheckpoint.load_hierarchy(
        path, JWilson2D(Lattice2D(32, 32, 2), MASS, jnp.asarray(g)))
    assert (jmg.coarsest_dinv is not None) == (kind == "direct")
    assert (jmg.coarsest_evecs is not None) == (kind == "deflated")
    same_solve(jax_solve(jmg, b), port_solve(mg, b), x_tol=1e-10)


@pytest.fixture(scope="module", params=["direct", "deflated"])
def jax_file(request, tmp_path_factory):
    """qmg_tpu's test_checkpoint hierarchy (nc2 coarse levels from
    geometric null vectors), saved by qmg_tpu: 16^2 -> 4^2 -> 1^2 with the
    dense coarsest inverse, or 16^2 -> 4^2 with an MDAGGER_M coarsest
    deflated by 2 low and 1 high eigenpairs. (A volume-1 coarsest is not
    deflated: its zero padding slot gives zero eigenvalues, which the
    deflation guess divides by, in both packages.)"""
    g, rng = _gauge(16)
    lat = Lattice2D(16, 16, 2)
    kw = dict(coarse_dof=2, free_null_vectors=True)
    if request.param == "direct":
        kw.update(n_refine=2, coarsest_direct=True)
    else:
        kw.update(n_refine=1, coarsest_stencil_app=JStencilType.MDAGGER_M)
    jmg = jbuild(lat, JWilson2D(lat, MASS, jnp.asarray(g)),
                 JKCycleConfig(**kw), rng)
    if request.param == "deflated":
        jmg.deflate_coarsest(num_low=2, num_high=1)
    path = str(tmp_path_factory.mktemp("ckpt") / "mg.npz")
    jcheckpoint.save_hierarchy(jmg, path)
    return request.param, g, jmg, path, rng.gaussian_cv(lat)


def test_qmg_tpu_to_port(jax_file):
    kind, g, jmg, path, b = jax_file
    fine = TWilson2D(TLattice2D(16, 16, 2), MASS, g, dtype=torch.complex128)
    tmg = tcheckpoint.load_hierarchy(path, fine, device="cpu")
    if kind == "direct":
        assert tmg.coarsest_solve.direct
        assert tmg.get_stencil(2).lat.volume == 1
        np.testing.assert_array_equal(tmg.coarsest_dinv.numpy(),
                                      np.asarray(jmg.coarsest_dinv))
    else:
        np.testing.assert_array_equal(tmg.coarsest_evecs.numpy(),
                                      np.asarray(jmg.coarsest_evecs))
    same_solve(port_solve(tmg, b), jax_solve(jmg, b), x_tol=1e-10)


def test_legacy_null_vector_layout(jax_file, tmp_path):
    """A version-2 file (null vectors block-minor) loads in both packages
    to the same version-3 null vectors."""
    kind, g, jmg, path, b = jax_file
    data = dict(np.load(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    meta["version"] = 2
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    for k in [k for k in data if k.startswith("nvb")]:
        data[k] = np.moveaxis(data[k], 2, -1)
    legacy = str(tmp_path / "v2.npz")
    np.savez(legacy, **data)
    fine = TWilson2D(TLattice2D(16, 16, 2), MASS, g, dtype=torch.complex128)
    tmg = tcheckpoint.load_hierarchy(legacy, fine, device="cpu")
    jmg2 = jcheckpoint.load_hierarchy(
        legacy, JWilson2D(Lattice2D(16, 16, 2), MASS, jnp.asarray(g)))
    for lvl in range(jmg.get_num_levels() - 1):
        want = np.asarray(jmg.get_transfer(lvl)._nvb)
        np.testing.assert_array_equal(tmg.get_transfer(lvl)._nvb.numpy(),
                                      want)
        np.testing.assert_array_equal(np.asarray(jmg2.get_transfer(lvl)._nvb),
                                      want)
    same_solve(port_solve(tmg, b), jax_solve(jmg, b), x_tol=1e-10)


def _asymmetric_hierarchy():
    """qmg_tpu's two-level hierarchy over an asymmetric, operator-doubled
    transfer with saved decompositions (test_checkpoint.py's), its gauge
    and rng."""
    from qmg_tpu.transfer import TransferMG, DoublingType
    from qmg_tpu.stateful import (StatefulMultigridMG, LevelSolveMG,
                                  CoarsestSolveMG)
    lat, clat = Lattice2D(8, 8, 2), Lattice2D(2, 2, 4)
    rng = JQMGRandom(11)
    g = ju1.gauss_gauge_u1(lat, rng, 6.0)
    op = JWilson2D(lat, MASS, jnp.asarray(g))
    pv = jnp.stack([jnp.asarray(rng.gaussian_cv(lat)) for _ in range(4)])
    rv = pv + 0.1 * jnp.stack([jnp.asarray(rng.gaussian_cv(lat))
                               for _ in range(4)])
    t = TransferMG(lat, clat, pv, do_block_ortho=True, save_decomp=True,
                   restrict_null_vectors=rv, doubling=DoublingType.OPERATOR)
    jmg = StatefulMultigridMG(lat, op, CoarsestSolveMG(coarsest_tol=0.2))
    jmg.push_level(clat, t, LevelSolveMG(), build_stencil=True,
                   is_chiral=True)
    return jmg, np.asarray(g), rng


def test_asymmetric_round_trip(tmp_path):
    """qmg_tpu's asymmetric hierarchy loads in the port with its
    restriction vectors and decompositions (keys ``rnvb``, ``blockL``,
    ``blockU``), gives qmg_tpu's coarse sigma operators of every type and
    solves at qmg_tpu's counts; the port's save of it loads back in
    qmg_tpu with the same arrays and sigma operators."""
    from qmg_tpu.operators.coarse import CoarseSigmaType as JCST
    jmg, g, rng = _asymmetric_hierarchy()
    path = str(tmp_path / "asym.npz")
    jcheckpoint.save_hierarchy(jmg, path)
    assert {"rnvb0", "blockL0", "blockU0"} <= set(np.load(path).files)
    fine = TWilson2D(TLattice2D(8, 8, 2), MASS, g, dtype=torch.complex128)
    tmg = tcheckpoint.load_hierarchy(path, fine, device="cpu")
    jt, tt = jmg.get_transfer(0), tmg.get_transfer(0)
    assert not tt.is_symmetric() and tt.has_decompositions()
    for attr in ("_nvb", "_restrict_nvb", "block_L", "block_U"):
        np.testing.assert_array_equal(getattr(tt, attr).numpy(),
                                      np.asarray(getattr(jt, attr)))
    xc = np.asarray(rng.gaussian_cv(Lattice2D(2, 2, 4)))
    want = {c: np.asarray(jmg.get_stencil(1).apply_coarse_sigma(
        jnp.asarray(xc), c)) for c in (JCST.SIGMA_1_L, JCST.SIGMA_1_R,
                                       JCST.SIGMA_1_L_RBJ,
                                       JCST.SIGMA_1_R_RBJ)}
    for c, w in want.items():
        got = tmg.get_stencil(1).apply_coarse_sigma(torch.as_tensor(xc), c)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())
    b = np.asarray(rng.gaussian_cv(Lattice2D(8, 8, 2)))
    same_solve(port_solve(tmg, b), jax_solve(jmg, b), x_tol=1e-10)

    back = str(tmp_path / "asym_port.npz")
    tcheckpoint.save_hierarchy(tmg, back)
    jmg2 = jcheckpoint.load_hierarchy(
        back, JWilson2D(Lattice2D(8, 8, 2), MASS, jnp.asarray(g)))
    jt2 = jmg2.get_transfer(0)
    assert jt2.block_cholesky is None and not jt2.is_symmetric()
    for attr in ("_nvb", "_restrict_nvb", "block_L", "block_U"):
        np.testing.assert_array_equal(np.asarray(getattr(jt2, attr)),
                                      np.asarray(getattr(jt, attr)))
    for c, w in want.items():
        got = np.asarray(jmg2.get_stencil(1).apply_coarse_sigma(
            jnp.asarray(xc), c))
        np.testing.assert_array_equal(got, w)


def test_refusals(tmp_path):
    """Another fine lattice and a fine stencil on another device are
    refused; a symmetric hierarchy without saved decompositions writes
    none of a transfer's optional arrays."""
    fine = TWilson2D(TLattice2D(8, 8, 2), MASS,
                     ju1.gauss_gauge_u1(Lattice2D(8, 8, 2), JQMGRandom(11),
                                        6.0), dtype=torch.complex128)

    tlat = TLattice2D(16, 16, 2)
    g16, rng16 = _gauge(16)
    op16 = TWilson2D(tlat, MASS, g16, dtype=torch.complex128)
    mg = tbuild(tlat, op16, TKCycleConfig(n_refine=1, coarse_dof=4,
                                          nullvec_max_iter=20), rng16)
    path = str(tmp_path / "mg.npz")
    tcheckpoint.save_hierarchy(mg, path)
    extras = {key for key, _ in tcheckpoint.TRANSFER_EXTRAS}
    assert not any(k.rstrip("0123456789") in extras
                   for k in np.load(path).files)
    with pytest.raises(ValueError, match="does not match"):
        tcheckpoint.load_hierarchy(path, fine, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        tcheckpoint.load_hierarchy(path, op16)        # device="cuda"
