"""The port's measurement stream (``qmg_tpu_torch.stream``) against
examples/wilson_mg_stream.py at qmg_tpu's test arguments
(test_mg_stream.py), its batched form against its sequential one, the
per-configuration setup from gaussian seeds (``setup_planes``) against the
eager build from the same rng, and the entry point."""

import numpy as np
import pytest
import torch

from qmg_tpu import native as jnative

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.operators import Wilson2D
from qmg_tpu_torch.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu_torch.setup_planes import (gauss_seed_planes,
                                        make_kcycle_setup_planes)
from qmg_tpu_torch.solve import state_to_numpy
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch import stream, u1

torch.set_num_threads(1)

# qmg_tpu's test arguments (test_mg_stream.py:17-19)
KW = dict(L=16, n_configs=2, n_therm=100, n_update=50, n_refine=1,
          coarse_dof=4, tol=1e-6, verbose=False)
# the heatbath path qmg_tpu takes: its native sweep where it is built
SWEEP = "native" if jnative.have_heatbath() else "numpy"


@pytest.fixture(scope="module")
def streams():
    """qmg_tpu's stream once (sequential), the port's sequential and
    batched streams, each (mean, err, plaqs, iters, pions)."""
    from examples.wilson_mg_stream import run_stream as jax_stream
    return {"jax": jax_stream(**KW),
            "seq": stream.run_stream(device="cpu", sweep=SWEEP, **KW),
            "batched": stream.run_stream(device="cpu", sweep=SWEEP,
                                         batched=True, **KW)}


def test_stream_matches_jax(streams):
    mean, _, plaqs, iters, pions = streams["seq"]
    jmean, _, jplaqs, jiters, _ = streams["jax"]
    assert len(plaqs) == 2 and pions.shape == (2, 16)
    np.testing.assert_allclose(plaqs, jplaqs, rtol=1e-12)
    np.testing.assert_allclose(mean, jmean, rtol=1e-3)
    # qmg_tpu builds through its traced setup, the port eagerly: a
    # function check of the counts, not per-array parity (ROADMAP F2)
    assert all(abs(a - b) <= 2 for a, b in zip(iters, jiters)), (
        f"outer iterations: port {iters}, qmg_tpu {jiters}")
    assert all(0.85 < p < 0.97 for p in plaqs)
    assert np.all(mean[:8] > 0) and mean[1] > mean[5]


def test_batched_stream_matches_sequential(streams):
    mean, _, plaqs, iters, _ = streams["batched"]
    smean, _, splaqs, siters, _ = streams["seq"]
    np.testing.assert_allclose(plaqs, splaqs, rtol=1e-12)
    np.testing.assert_allclose(mean, smean, rtol=1e-3)
    # batched reports the slower source, sequential the last one
    assert all(abs(a - b) <= 1 for a, b in zip(iters, siters)), (
        f"outer iterations: batched {iters}, sequential {siters}")


def test_stream_log_and_numpy_sweep():
    log = []
    kw = dict(KW, n_configs=1, n_therm=10, n_update=5)
    mean, err, plaqs, iters, pions = stream.run_stream(
        device="cpu", sweep="numpy", log=log, **kw)
    assert len(log) == 1 and log[0]["plaq"] == plaqs[0]
    assert len(log[0]["iters"]) == 2 and log[0]["iters"][-1] == iters[0]
    assert np.array_equal(log[0]["pion"], pions[0])
    assert min(log[0][k] for k in ("heatbath_s", "setup_s", "solve_s")) > 0
    assert np.all(err == 0)


def test_stream_plain_solver_options():
    """The solvers' options reach the stream: the plain applies give the
    kernels' correlator (here their twins') on the same configuration."""
    kw = dict(KW, n_configs=1, n_therm=10, n_update=5)
    mean, _, plaqs, _, _ = stream.run_stream(device="cpu", batched=True, **kw)
    pmean, _, pplaqs, _, _ = stream.run_stream(
        device="cpu", fine_kernel=None, coarse_apply="plain", **kw)
    assert plaqs == pplaqs
    np.testing.assert_allclose(mean, pmean, rtol=1e-3)


def test_stream_trace_lanes(capsys):
    """--trace-lanes (the on-card probe of a batched solve that did not
    stop): one line per lane at every outer restart and at the end, with
    the iterations the solve reports."""
    kw = dict(KW, n_configs=1, n_therm=10, n_update=5)
    _, _, _, iters, _ = stream.run_stream(device="cpu", sweep=SWEEP,
                                          batched=True, trace_lanes=True,
                                          **kw)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[QMG-LANES]")]
    ends = [ln for ln in lines if "(end," in ln]
    assert len(ends) == 2
    assert max(int(ln.split(" iters ")[1].split()[0]) for ln in ends) \
        == iters[0]
    # The solver's hook at each restart: per-lane counts, the recursive
    # and the true squared residuals.
    from qmg_tpu_torch import solvers
    gen = torch.Generator().manual_seed(3)
    a = 4 * torch.eye(16, dtype=torch.complex128) + torch.randn(
        16, 16, dtype=torch.complex128, generator=gen)
    b = torch.randn(2, 16, dtype=torch.complex128, generator=gen)
    calls = []
    res, _ = solvers.gcr_var_precond_restart_batched(
        lambda v: v @ a.T, b, lambda r, c, lanes: (r, c), max_iter=9,
        tol=1e-12, restart_freq=2,
        trace=lambda *args: calls.append(args))
    assert len(calls) == 5 and calls[-1][3] is None
    for k, it, rsq, true_rsq, bsq in calls[:-1]:
        assert k in (2, 4, 6, 8) and list(it) == [k, k]
        assert torch.allclose(true_rsq, rsq, rtol=1e-6)
    assert list(calls[-1][1]) == list(res.iters) == [9, 9]


def test_seeded_setup_equals_eager_build():
    """setup_fn from gauss_seed_planes against build_kcycle_hierarchy with
    the same rng, complex128: level 0 exact, level 1 within 1e-12."""
    lat = Lattice2D(16, 16, 2)
    cfg = KCycleConfig(n_refine=2, coarse_dof=4, nullvec_max_iter=100,
                       nullvec_tol=5e-4, coarsest_direct=True)
    gauge = u1.gauss_gauge_u1(lat, QMGRandom(3), 6.0)
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(21))
    assert [s.shape for s in seeds] == [(2, 2, 16, 8, 2), (2, 2, 4, 2, 4)]
    setup_fn = make_kcycle_setup_planes(lat, cfg, -0.06,
                                        dtype=torch.complex128, device="cpu")
    mg = setup_fn(gauge, *seeds)
    ref = build_kcycle_hierarchy(
        lat, Wilson2D(lat, -0.06, gauge, dtype=torch.complex128), cfg,
        QMGRandom(21))
    got, want = (state_to_numpy(m, np.float64) for m in (mg, ref))
    assert set(got) == set(want) and "cdinv" in got
    for k in ("clover0", "hopping0", "shifts0"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("nvb0", "clover1", "hopping1"):
        scale = np.max(np.abs(want[k]))
        assert np.max(np.abs(got[k] - want[k])) <= 1e-12 * scale, k


def test_setup_planes_refusals():
    lat = Lattice2D(16, 16, 2)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4)
    for name in ("per_level_jit", "channels_first", "matmul_precision"):
        with pytest.raises(ValueError, match="TPU"):
            make_kcycle_setup_planes(lat, cfg, -0.06, **{name: True})
    # The sharded setup is ported; it refuses what qmg_tpu's refuses.
    from qmg_tpu_torch.parallel import Mesh
    with pytest.raises(ValueError, match="does not tile"):
        make_kcycle_setup_planes(lat, cfg, -0.06, mesh=Mesh(3, 1))
    with pytest.raises(ValueError, match="does not align"):
        make_kcycle_setup_planes(lat, cfg, -0.06, mesh=Mesh(1, 8))
    # The deflation stage is ported; it needs a normal coarsest.
    for name in ("deflate_low", "deflate_high"):
        with pytest.raises(ValueError, match="NORMAL"):
            make_kcycle_setup_planes(lat, cfg, -0.06, **{name: 1})
    with pytest.raises(TypeError, match="bogus"):
        make_kcycle_setup_planes(lat, cfg, -0.06, bogus=1)
    with pytest.raises(ValueError, match="nc must be 2"):
        make_kcycle_setup_planes(Lattice2D(16, 16, 4), cfg, -0.06)
    with pytest.raises(ValueError, match="too large for the dense"):
        make_kcycle_setup_planes(Lattice2D(512, 512, 2), KCycleConfig(
            n_refine=2, coarsest_direct=True), -0.06)
    setup_fn = make_kcycle_setup_planes(lat, cfg, -0.06, device="cpu")
    with pytest.raises(ValueError, match="gauss seed"):
        setup_fn(u1.gauss_gauge_u1(lat, QMGRandom(1), 6.0))
    with pytest.raises(ValueError, match="exactly one"):
        build_kcycle_hierarchy(lat, Wilson2D(lat, -0.06, np.ones(
            (2, 2, 16, 8))), cfg)


def test_entry_point(tmp_path, capsys):
    out = tmp_path / "corr.npz"
    stream.main(["--L", "16", "--n-configs", "3", "--n-therm", "10",
                 "--n-update", "5", "--n-refine", "1", "--tol", "1e-6",
                 "--cpu", "--batched", "--save", str(out)])
    text = capsys.readouterr().out
    for tag in ("[QMG-MEAS]: config 3/3", "[QMG-MEAS]: mean plaquette",
                "[QMG-PION]: 15", "[QMG-MASS]", "[QMG-PION-MASS]",
                "[QMG-NOTE]: per-config correlators saved"):
        assert tag in text, tag
    assert "[QMG-PION-MASS-FIT]" in text or "cosh fit failed" in text
    saved = np.load(out)
    assert saved["pions"].shape == (3, 16) and int(saved["L"]) == 16
