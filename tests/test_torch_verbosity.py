"""Port vs qmg_tpu on solver verbosity: test_verbosity.py's five tests on
the port's 16^2 hierarchy, the lines of a DETAIL solve against qmg_tpu's
on the same hierarchy (handed over by checkpoint), and a silent solve
against a verbose one (the same bits, counts and dispatched operations)."""

import collections
import contextlib
import io
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu.operators.wilson import Wilson2D as JWilson2D
from qmg_tpu import checkpoint as jcheckpoint
from qmg_tpu import u1 as ju1
from qmg_tpu.rng import QMGRandom as JQMGRandom
from qmg_tpu.solvers import VerboseMG as JVerboseMG, Verbosity as JVerbosity

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.operators.wilson import Wilson2D
from qmg_tpu_torch.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu_torch import checkpoint, solvers
from qmg_tpu_torch.solvers import VerboseMG, Verbosity

torch.set_num_threads(1)

L = 16
MASS = -0.06


@pytest.fixture(scope="module")
def mg16():
    """test_verbosity.py's hierarchy, built by the port: two refinements
    to coarse_dof 4, GCR coarsest."""
    rng = JQMGRandom(1337)
    g = ju1.gauss_gauge_u1(JLattice2D(L, L, 2), rng, 6.0)
    lat = Lattice2D(L, L, 2)
    op = Wilson2D(lat, MASS, g, dtype=torch.complex128)
    cfg = KCycleConfig(n_refine=2, coarse_dof=4, nullvec_tol=5e-4,
                       nullvec_max_iter=200, coarsest_direct=False)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    return mg, torch.as_tensor(rng.gaussian_cv(lat)), g


def _solve_lines(mg, b, verbose):
    f = io.StringIO()
    with contextlib.redirect_stdout(f):
        res = mg.solve(b, tol=1e-5, max_iter=60, restart_freq=32,
                       verbose=verbose)
    assert bool(res.converged)
    return f.getvalue().splitlines()


# --- test_verbosity.py's five tests on the port ---

def test_verbosity_none_is_silent(mg16):
    mg, b, _ = mg16
    assert _solve_lines(mg, b, False) == []
    assert _solve_lines(mg, b, VerboseMG()) == []


def test_verbosity_summary_prints_inner_summaries(mg16):
    mg, b, _ = mg16
    lines = _solve_lines(mg, b,
                         VerboseMG(Verbosity.SUMMARY, Verbosity.SUMMARY))
    assert lines and all("summary:" in ln for ln in lines)
    l1 = [ln for ln in lines if "Level 1" in ln]
    l2 = [ln for ln in lines if "Level 2" in ln]
    assert l1 and l2
    assert l1[0].startswith("  [QMG-MG-SOLVE-INFO]: Level 1")
    assert l2[0].startswith("    [QMG-MG-SOLVE-INFO]: Level 2")
    assert any("Level 0" in ln for ln in lines)


def test_outer_detail_inner_summary(mg16):
    mg, b, _ = mg16
    lines = _solve_lines(mg, b, VerboseMG(Verbosity.DETAIL,
                                          Verbosity.SUMMARY))
    outer_iter = [ln for ln in lines if "Level 0" in ln and "iter" in ln]
    inner_iter = [ln for ln in lines
                  if "Level 0" not in ln and " iter " in ln]
    inner_sum = [ln for ln in lines
                 if "Level 0" not in ln and "summary:" in ln]
    assert outer_iter and not inner_iter and inner_sum


def test_precond_verbosity_independent(mg16):
    mg, b, _ = mg16
    lines = _solve_lines(mg, b, VerboseMG(Verbosity.NONE, Verbosity.SUMMARY))
    assert lines and all("summary:" in ln for ln in lines)
    assert not any("Level 0" in ln for ln in lines)


def test_bool_true_full_detail_back_compat(mg16):
    mg, b, _ = mg16
    lines = _solve_lines(mg, b, True)
    for lvl in ("Level 0", "Level 1", "Level 2"):
        assert any(lvl in ln and " iter " in ln for ln in lines), lvl


# --- against qmg_tpu's lines ---

_LINE = re.compile(r"^( *\[QMG-MG-SOLVE-INFO\]: Level (\d) )"
                   r"(?:iter (\d+)|(\w+) summary: (\d+) iters,) relres (\S+)$")


def _by_level(lines):
    """{level: [(prefix, kind, number, relres), ...]} in print order."""
    out = collections.defaultdict(list)
    for ln in lines:
        m = _LINE.match(ln)
        assert m, ln
        prefix, lvl, it, name, iters, rel = m.groups()
        key = ("iter", int(it)) if it else (name, int(iters))
        out[int(lvl)].append((prefix,) + key + (float(rel),))
    return out


def test_lines_match_jax(mg16, tmp_path):
    """DETAIL at every level: per level, the same prefix, the same
    sequence of solver names and iteration numbers, relres within 1e-6
    relative (or 1e-14 absolute, where a solve reached rounding)."""
    mg, b, g = mg16
    path = str(tmp_path / "mg.npz")
    checkpoint.save_hierarchy(mg, path)
    jmg = jcheckpoint.load_hierarchy(
        path, JWilson2D(JLattice2D(L, L, 2), MASS, jnp.asarray(g)))
    f = io.StringIO()
    with contextlib.redirect_stdout(f):
        jres = jmg.solve(jnp.asarray(b.numpy()), tol=1e-5, max_iter=60,
                         restart_freq=32,
                         verbose=JVerboseMG(JVerbosity.DETAIL,
                                            JVerbosity.DETAIL))
    want = _by_level(f.getvalue().splitlines())
    got = _by_level(_solve_lines(mg, b, VerboseMG(Verbosity.DETAIL,
                                                  Verbosity.DETAIL)))
    assert bool(jres.converged)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for lvl in want:
        g_rows, w_rows = got[lvl], want[lvl]
        assert [r[:3] for r in g_rows] == [r[:3] for r in w_rows], lvl
        # atol: a solve that reaches rounding (the 4-dim coarsest's exact
        # solves) prints its rounding, 1e-16 relative.
        np.testing.assert_allclose([r[3] for r in g_rows],
                                   [r[3] for r in w_rows], rtol=1e-6,
                                   atol=1e-14)
    assert got[0][-1][1] == "gcr" and got[0][-1][2] == int(jres.iters)


class _CountOps(torch.overrides.TorchFunctionMode):
    """Counts the torch functions a block dispatches."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_verbose_solve_equals_silent(mg16):
    """verbose=None and DETAIL everywhere: the same solution bit for bit,
    the same counts, and no more dispatched operations."""
    mg, b, _ = mg16
    runs = {}
    for verbose in (None, VerboseMG(Verbosity.DETAIL, Verbosity.DETAIL)):
        before = mg.tracker["counts"].copy(), mg.tracker["iters"].copy()
        ops = _CountOps()
        with contextlib.redirect_stdout(io.StringIO()) as out, ops:
            res = mg.solve(b, tol=1e-5, max_iter=60, restart_freq=32,
                           verbose=verbose)
        runs[verbose is None] = (res, mg.tracker["counts"] - before[0],
                                 mg.tracker["iters"] - before[1], ops.n,
                                 out.getvalue())
    silent, loud = runs[True], runs[False]
    assert torch.equal(silent[0].x, loud[0].x)
    assert silent[0].iters == loud[0].iters
    assert np.array_equal(silent[1], loud[1])
    assert np.array_equal(silent[2], loud[2])
    assert silent[4] == "" and loud[4]
    assert loud[3] <= silent[3], (loud[3], silent[3])


def test_string_and_bool_coercion():
    assert solvers._as_verbose(None) == VerboseMG()
    assert solvers._as_verbose(True) == VerboseMG(Verbosity.DETAIL,
                                                  Verbosity.DETAIL)
    assert solvers._as_verbose("> ") == VerboseMG(Verbosity.DETAIL,
                                                  Verbosity.NONE, "> ")
    v = VerboseMG(Verbosity.SUMMARY)
    assert solvers._as_verbose(v) is v
