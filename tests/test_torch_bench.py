"""Port vs qmg_tpu on the measuring surface: ``make_solver``'s
``precond_mode`` / ``fixed_outer_iters`` and ``component_chain`` against
qmg_tpu's ``make_planes_solver`` and ``_planes_component_chain`` on one
hierarchy, and ``python -m qmg_tpu_torch.bench`` / ``.attrib`` on the CPU.

The hierarchy (bench.py's kcycle config at 32^2, complex128) is built by
the port, saved as a checkpoint, loaded by qmg_tpu and handed back
through qmg_tpu's planes state (``mg_state_planes`` ->
``state_from_numpy``), so both packages run on the same arrays; qmg_tpu's
own eager build costs 28-43 s of XLA compiles at 16^2-32^2 on the CPU.
bench's ``--setup host`` count is held to qmg_tpu's in
tests/test_torch_kcycle.py, beside the qmg_tpu hierarchy built there."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qmg_tpu_torch import attrib, bench, dslash  # noqa: E402
from qmg_tpu_torch.kcycle import kcycle_config, true_residual  # noqa: E402
from qmg_tpu_torch.lattice import Lattice2D  # noqa: E402
from qmg_tpu_torch.operators import Wilson2D  # noqa: E402
from qmg_tpu_torch.rng import QMGRandom  # noqa: E402
from qmg_tpu_torch.setup import build_kcycle_hierarchy  # noqa: E402
from qmg_tpu_torch.solve import (FINE_KERNELS, COMPONENTS,  # noqa: E402
                                 make_solver, component_chain,
                                 state_from_numpy)
from qmg_tpu_torch import checkpoint, u1  # noqa: E402

L = 32
MASS = -0.06
CHAIN_K = 2


@pytest.fixture(scope="module")
def handed(tmp_path_factory):
    """(qmg_tpu's hierarchy, its planes state, the port's hierarchy from
    that state, b): bench.py's kcycle config at 32^2 in complex128."""
    import jax.numpy as jnp
    from qmg_tpu import checkpoint as jcheckpoint
    from qmg_tpu.lattice import Lattice2D as JLattice2D
    from qmg_tpu.operators import Wilson2D as JWilson2D
    from qmg_tpu.tpu_compat import mg_state_planes

    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    gauge = u1.gauss_gauge_u1(lat, rng, 6.0)
    cfg, _ = kcycle_config(L)
    op = Wilson2D(lat, MASS, gauge, dtype=torch.complex128, device="cpu")
    built = build_kcycle_hierarchy(lat, op, cfg, rng)
    b = rng.gaussian_cv(lat)
    path = str(tmp_path_factory.mktemp("bench") / "mg.npz")
    checkpoint.save_hierarchy(built, path)
    jmg = jcheckpoint.load_hierarchy(
        path, JWilson2D(JLattice2D(L, L, 2), MASS, jnp.asarray(gauge),
                        dtype=jnp.complex128))
    state = mg_state_planes(jmg, dtype=np.float64)
    return jmg, state, state_from_numpy(state, cfg, device="cpu"), b


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# --- (a) make_solver(precond_mode=, fixed_outer_iters=) ---

def test_precond_none_fixed_trips_matches_jax(handed):
    """Plain restarted FGCR for exactly 3 trips in both packages: 3
    iterations each, x within 1e-10 relative (complex128)."""
    import jax
    from qmg_tpu.tpu_compat import (make_planes_solver, host_to_planes,
                                    from_planes)
    jmg, state, tmg, b = handed
    kw = dict(tol=1e-8, max_iter=200, restart_freq=32, precond_mode="none",
              fixed_outer_iters=3)
    jsolve, _ = make_planes_solver(jmg, **kw)
    xp, it_j, _ = jax.jit(jsolve)(state, host_to_planes(b, np.float64))
    res, carry = make_solver(tmg, fine_kernel=None, **kw)(torch.as_tensor(b))
    assert int(it_j) == 3 and res.iters == 3
    assert carry["iters"][0] == 3 and carry["iters"][1:].sum() == 0
    assert _rel(res.x.numpy(), np.asarray(from_planes(xp))) <= 1e-10


def test_precond_mode_refused(handed):
    _, _, tmg, _ = handed
    with pytest.raises(ValueError, match="precond_mode"):
        make_solver(tmg, fine_kernel=None, precond_mode="bogus")


# --- (b) component_chain ---

def _jax_chain(jmg, v0, component, K, level):
    """qmg_tpu's ``_planes_component_chain`` body on ``jmg``'s own arrays
    at any level, composed here from qmg_tpu's ``get_stencil(level)``,
    ``restrict_f2c`` / ``prolong_c2f(., level)``, ``solvers.minres`` and
    ``make_preconditioner(level)``, without the float32 cast of its
    result."""
    import jax
    import jax.numpy as jnp
    from qmg_tpu import solvers as jsolvers
    from qmg_tpu.stencil import apply_M as japply_M

    coeffs = jmg.get_stencil(level).coeffs
    n_levels = jmg.get_num_levels()

    def step(v):
        if component == "fine":
            return japply_M(coeffs, v)
        if component == "transfer":
            return jmg.prolong_c2f(jmg.restrict_f2c(v, level), level)
        if component == "smooth2":
            return jsolvers.minres(lambda u: japply_M(coeffs, u), v,
                                   max_iter=2, tol=0.0, omega=0.85).x
        carry = {"counts": jnp.zeros((n_levels, 4), jnp.int32),
                 "iters": jnp.zeros((n_levels,), jnp.int32)}
        return jmg.make_preconditioner(level)(v, carry)[0]

    @jax.jit
    def chain(v):
        for _ in range(K):
            out = step(v)
            v = out / jnp.sqrt(jnp.real(jnp.vdot(out, out)) + 1.0)
        return jnp.sum(jnp.abs(v))

    return float(chain(jnp.asarray(v0)))


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("component", COMPONENTS)
def test_component_chain_matches_jax(handed, component, level):
    """The port's chain against qmg_tpu's composed on the same hierarchy,
    K = 2, complex128: within 1e-9 relative. On level 0 the composition
    is also held to qmg_tpu's ``_planes_component_chain`` called as
    scripts/probe_2048_attrib.py calls it, to its float32 result's
    rounding."""
    import jax
    from qmg_tpu.tpu_compat import host_to_planes, _planes_component_chain
    jmg, state, tmg, b = handed
    if level == 0:
        v = b
    else:
        v = QMGRandom(7).gaussian_cv(tmg.get_lattice(level))
    want = _jax_chain(jmg, v, component, CHAIN_K, level)
    kw = {"fine_kernel": None} if component == "precond" else {}
    got = component_chain(tmg, torch.as_tensor(v), component, CHAIN_K,
                          level=level, **kw)
    assert abs(got - want) <= 1e-9 * abs(want)
    if level == 0:
        chain = jax.jit(lambda s, bp, k: _planes_component_chain(
            jmg, s, bp, component, k), static_argnums=(2,))
        probe = float(chain(state, host_to_planes(b, np.float64), CHAIN_K))
        assert abs(probe - want) <= 2.0 ** -23 * abs(want)


def test_component_chain_refusals(handed):
    _, _, tmg, b = handed
    b = torch.as_tensor(b)
    with pytest.raises(ValueError, match="unknown component"):
        component_chain(tmg, b, "restrict", 2)
    with pytest.raises(ValueError, match="coarser level"):
        component_chain(tmg, b, "precond", 2, level=2)
    with pytest.raises(ValueError, match="takes no"):
        component_chain(tmg, b, "smooth2", 2, fine_kernel="wilson-r1")


# --- (c)-(e) python -m qmg_tpu_torch.bench ---

def _bench(capsys, *argv):
    out = bench.main(["--device", "cpu", *argv])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out["line"] and line["device"] == "cpu"
    assert line["value"] > 0
    return line, out


def test_bench_kcycle_line(capsys):
    """One solve on the device setup (``--setup host`` runs in the
    batched cases below and in tests/test_torch_kcycle.py)."""
    line, out = _bench(capsys, "--mode", "kcycle", "--size", "16",
                       "--setup", "device")
    assert line["metric"] == "wilson_kcycle_solve_time"
    assert line["unit"] == "ms"
    r = out["report"]
    assert r["setup"] == "kcycle" and r["converged"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / r["iters"],
                                                abs=1e-2)


def test_bench_dslash_line(capsys):
    line, out = _bench(capsys, "--mode", "dslash", "--size", "16",
                       "--iters", "20")
    assert line["metric"] == "wilson_dslash_effective_bandwidth"
    assert line["unit"] == "GB/s"
    assert line["vs_baseline"] == pytest.approx(line["value"] / 3350,
                                                abs=1e-4)
    # bench.py's byte count: 224 B a site a step whatever the kernel; the
    # rank-1 kernel's own traffic is 96.
    assert line["own_traffic_gbs"] == pytest.approx(
        line["value"] * 96 / 224, abs=0.01)
    ref = dslash.run(16, "wilson-r1", iters=20, device="cpu")
    assert out["checksum"] == ref["checksum"]


@pytest.mark.parametrize("chain", [0, 2])
def test_bench_batched_lines(capsys, chain):
    argv = ["--mode", "kcycle", "--size", "16", "--nrhs", "2"]
    if chain:
        argv += ["--chain", str(chain)]
    line, out = _bench(capsys, *argv)
    assert line["metric"] == ("wilson_kcycle_batched_steady_ms_per_rhs"
                              if chain else
                              "wilson_kcycle_batched_ms_per_rhs")
    assert line["unit"] == "ms" and line["vs_baseline"] == 2
    assert all(out["report"]["converged"])


def test_bench_refine_line(capsys):
    """True complex128 residual <= 1e-10, in the passes that
    ``make_refined_solver`` takes on the same hierarchy."""
    line, out = _bench(capsys, "--mode", "refine", "--size", "16")
    assert line["metric"] == "wilson_refined_1e10_solve_time"
    assert line["unit"] == "ms"
    res, problem = out["result"], out["problem"]
    op = problem["mg"].get_stencil(0)
    assert true_residual(op, problem["b"], res.x) <= 1e-10
    again = bench.refined_solver(problem["mg"], "wilson-r1", "plain")(
        problem["b"])
    assert again.converged and line["vs_baseline"] == again.outer_iters


@pytest.mark.parametrize("argv", [
    ["--tile", "32"],
    ["--channels-first", "on"],
    ["--mode", "kcycle", "--deflate", "2", "--setup", "host"],
    ["--kernel", "bogus"],
    ["--mode", "kcycle", "--kernel", "phase-split"],
    ["--mode", "kcycle", "--outer", "schur", "--kernel", "phase-r1"],
    ["--mode", "kcycle", "--chain", "1"],
], ids=["tile", "channels-first", "deflate-host", "unknown-kernel",
        "phase-split-solve", "schur-kernel", "chain-1"])
def test_bench_refusals(argv):
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--size", "16", *argv])
    assert e.value.code not in (0, None)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_bench_cuda_without_card():
    p = subprocess.run([sys.executable, "-m", "qmg_tpu_torch.bench",
                        "--size", "16"], capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and "no CUDA device" in p.stderr
    assert "metric" not in p.stdout


def test_bench_kernel_mapping():
    assert bench.DSLASH_KINDS == {
        "phase-r1": "wilson-r1", "phase-split": "wilson-split",
        "phase": "wilson-phase", "pallas": "matrix", "split": "split",
        "small": "small", "xla": "plain"}
    assert bench.SOLVE_KERNELS == {
        "phase-r1": "wilson-r1", "phase": "wilson-phase",
        "pallas": "matrix", "split": "matrix-split", "small": "small",
        "xla": None}
    assert set(bench.DSLASH_KINDS.values()) <= set(dslash.KINDS)
    assert set(bench.SOLVE_KERNELS.values()) <= set(FINE_KERNELS) | {None}


# --- (f) python -m qmg_tpu_torch.attrib ---

def test_attrib_line(capsys):
    """Every part > 0 on every level, outer1 and the solve too. Five
    rounds: under a full host one round's marginal of a 0.1-0.3 ms part
    can go negative (3 of 40 runs, one round, 8 processes on 8 cores;
    none of 40 with five)."""
    attrib.main(["--device", "cpu", "--size", "16", "--n-refine", "1",
                 "--reps", "5"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert any(s.startswith("model: precond") for s in out[:-1])
    assert set(line["components"]) == {"0", "1"}
    assert set(line["components"]["0"]) == {"fine", "transfer", "smooth2",
                                            "precond", "fine:wilson-r1"}
    assert set(line["components"]["1"]) == {"fine", "smooth2"}
    assert all(ms > 0 for row in line["components"].values()
               for ms in row.values())
    assert line["outer1_ms"] > 0 and line["solve_ms"] > 0
    assert line["outer_iters"] > 0 and line["device"] == "cpu"


def test_attrib_level0_only():
    """``attrib.run(levels=(0,))`` times level 0's parts alone (the
    on-card check times only those at 2048^2), and the solve as ever."""
    r = attrib.run(16, 1, "cpu", reps=5, levels=(0,))
    assert set(r["components"]) == {0} and set(r["kcycle_iters"]) == {0}
    assert set(r["components"][0]) == {"fine", "transfer", "smooth2",
                                       "precond", "fine:wilson-r1"}
    assert all(ms > 0 for ms in r["components"][0].values())
    assert r["outer_iters"] > 0


@pytest.mark.parametrize("warmup", [True, False])
def test_best_s_rounds(warmup):
    """``kcycle.best_s`` (attrib's and bench --chain's timer): one
    warm-up round or none, then ``reps`` rounds in turn."""
    from qmg_tpu_torch.kcycle import best_s
    calls = []
    best = best_s([lambda: calls.append("a"), lambda: calls.append("b")],
                  "cpu", 3, warmup=warmup)
    assert calls == ["a", "b"] * (4 if warmup else 3)
    assert len(best) == 2 and all(0 <= t < 1 for t in best)
