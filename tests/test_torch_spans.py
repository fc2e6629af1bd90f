"""The spans of the port's solve and setup (``qmg_tpu_torch.spans``), the
read-back counter ``solvers.READBACKS`` and the n13 setup's stages, on the
CPU at 32^2 (three levels: 32^2 nc2, 8^2 nc8, 2^2 nc8), under
``torch.profiler`` with its CPU activity."""

import collections

import pytest
import torch
from torch.profiler import profile, ProfilerActivity

from qmg_tpu_torch import kcycle, solvers, spans
from qmg_tpu_torch.parallel import Mesh
from qmg_tpu_torch.rng import QMGRandom
from qmg_tpu_torch.setup_planes import gauss_seed_planes
from qmg_tpu_torch.solve import make_solver, make_batched_solver

torch.set_num_threads(1)

SIZE = 32
SOLVE = dict(tol=1e-6, max_iter=100, restart_freq=32, fine_kernel=None)
STAGES = ["operator", "L1 nullvec", "L1 transfer", "L1 coarse",
          "L2 nullvec", "L2 transfer", "L2 coarse"]


@pytest.fixture(scope="module")
def problems():
    """The n13 problem with the dense and with the GCR coarsest, and the
    n19 (Schur) problem, each built once."""
    return {"direct": kcycle.build_problem(SIZE, "cpu"),
            "gcr": kcycle.build_problem(SIZE, "cpu", direct=False),
            "schur": kcycle.build_problem(SIZE, "cpu", outer="schur")}


def qmg_spans(prof):
    """(name, start, end) of every ``qmg.`` range of a profile."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("qmg.")]


def profiled(fn):
    """fn()'s result, its spans and the read-backs it counted."""
    before = sum(solvers.READBACKS.values())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, qmg_spans(prof), sum(solvers.READBACKS.values()) - before


def solved(problem, **kw):
    """A profiled one-field solve of the problem's right-hand side:
    (result, carry, spans, read-backs)."""
    outer = kcycle.OUTERS[problem["outer"]]
    solve = make_solver(problem["mg"], outer_type=outer, **SOLVE)
    (res, carry), found, readbacks = profiled(
        lambda: solve(problem["b"], **kw))
    return res, carry, found, readbacks


def counts(found):
    return collections.Counter(name for name, _, _ in found)


def parents(found):
    """Each span's innermost enclosing span, by interval (None at the
    top)."""
    order = sorted(found, key=lambda s: (s[1], -s[2]))
    out, stack = [], []
    for name, start, end in order:
        while stack and stack[-1][2] < start:
            stack.pop()
        parent = stack[-1] if stack else None
        assert parent is None or end <= parent[2], (name, parent)
        out.append((name, parent and parent[0]))
        stack.append((name, start, end))
    return out


def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span("qmg.a") is spans.span("qmg.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("qmg.a") is not spans.span("qmg.b")


def test_no_range_opens_without_a_profiler(problems, monkeypatch):
    opened = []
    monkeypatch.setattr(spans, "_range", lambda name: opened.append(name))
    problem = problems["gcr"]
    res, _ = make_solver(problem["mg"], **SOLVE)(problem["b"])
    assert bool(res.converged) and opened == []


@pytest.mark.parametrize("coarsest", ["direct", "gcr"])
def test_apply_spans_count_the_operator_applies(problems, coarsest):
    """Every level's applies (the outer matvec, the K-cycle's smoothing and
    residual applies, the coarse solves' matvecs) are spans; a dense
    coarsest applies no operator."""
    _, carry, found, _ = solved(problems[coarsest])
    by_level = collections.Counter(name.split(".")[2] for name, _, _ in found
                                   if name.startswith("qmg.apply."))
    levels = [0, 1] if coarsest == "direct" else [0, 1, 2]
    assert {f"L{lvl}" for lvl in levels} == set(by_level)
    for lvl in levels:
        assert by_level[f"L{lvl}"] == carry["counts"][lvl].sum()


def test_kcycle_spans_count_the_outer_iterations(problems):
    res, carry, found, _ = solved(problems["gcr"])
    n = counts(found)
    assert n["qmg.kcycle.L0"] == res.iters == carry["iters"][0]
    for step in ("smooth.pre", "smooth.post", "restrict", "prolong"):
        assert n[f"qmg.{step}.L0"] == res.iters
    assert n["qmg.coarse_solve.L1"] == res.iters
    assert n["qmg.kcycle.L1"] == carry["iters"][1]
    assert n["qmg.solve"] == 1


@pytest.mark.parametrize("verbose", [False, True], ids=["silent", "verbose"])
def test_readback_spans_match_the_counter(problems, verbose, capsys):
    _, _, found, readbacks = solved(problems["gcr"], verbose=verbose)
    assert readbacks > 0
    assert counts(found)["qmg.readback"] == readbacks
    assert ("summary" in capsys.readouterr().out) == verbose


def test_spans_nest_under_one_solve(problems):
    _, _, found, _ = solved(problems["gcr"])
    edges = parents(found)
    assert [name for name, parent in edges if parent is None] == [
        "qmg.solve"]
    allowed = {
        "qmg.kcycle.L0": {"qmg.solve"},
        "qmg.kcycle.L1": {"qmg.coarse_solve.L1"},
        "qmg.coarse_solve.L1": {"qmg.kcycle.L0"},
        "qmg.coarse_solve.L2": {"qmg.kcycle.L1"},
        "qmg.smooth.pre.L1": {"qmg.kcycle.L1"},
        "qmg.restrict.L0": {"qmg.kcycle.L0"},
        "qmg.apply.L0.original": {"qmg.solve", "qmg.kcycle.L0",
                                  "qmg.smooth.pre.L0", "qmg.smooth.post.L0"},
        "qmg.apply.L2.original": {"qmg.coarse_solve.L2"},
        "qmg.readback": {"qmg.solve", "qmg.coarse_solve.L1",
                         "qmg.coarse_solve.L2"},
    }
    for name, parent in edges:
        assert parent in allowed.get(name, {parent}), (name, parent)


def test_schur_apply_spans(problems):
    _, carry, found, _ = solved(problems["schur"])
    n = counts(found)
    assert n["qmg.apply.L0.right_schur"] == carry["counts"][0].sum()
    assert n["qmg.apply.L1.right_schur"] == carry["counts"][1].sum()
    assert not any(".original" in name for name in n)


def test_batched_solve_has_the_spans_of_one_field(problems):
    problem = problems["gcr"]
    solve = make_batched_solver(problem["mg"], **SOLVE)
    B = torch.stack([problem["b"], 2 * problem["b"]])
    _, found, readbacks = profiled(lambda: solve(B))
    _, _, one, _ = solved(problem)
    assert set(counts(found)) == set(counts(one))
    assert counts(found)["qmg.readback"] == readbacks


@pytest.mark.parametrize("form", ["gcr", "schur"])
def test_answers_bitwise_equal_under_the_profiler(problems, form):
    problem = problems[form]
    solve = make_solver(problem["mg"],
                        outer_type=kcycle.OUTERS[problem["outer"]],
                        **SOLVE)
    plain, plain_carry = solve(problem["b"])
    (traced, traced_carry), found, _ = profiled(lambda: solve(problem["b"]))
    assert found
    assert torch.equal(plain.x, traced.x)
    assert (plain_carry["counts"] == traced_carry["counts"]).all()


def test_setup_stages_and_their_spans(problems):
    problem = problems["direct"]
    setup_fn = problem["setup_fn"]
    seeds = gauss_seed_planes(problem["mg"].get_lattice(0), problem["cfg"],
                              QMGRandom(3))
    _, found, _ = profiled(lambda: setup_fn(problem["gauge"], *seeds))
    labels = [label for label, _ in setup_fn.stages]
    assert labels == STAGES + ["cdinv"]
    assert all(s >= 0 for _, s in setup_fn.stages)
    assert sum(s for _, s in setup_fn.stages) == pytest.approx(
        setup_fn.seconds, rel=1e-6)
    assert [name for name, _, _ in sorted(found, key=lambda s: s[1])
            if name.startswith("qmg.setup.")] == [
        f"qmg.setup.{label}" for label in labels]


@pytest.mark.parametrize("kind", ["deflate", "mesh"])
def test_setup_stages_of_the_other_setups(kind):
    """The deflation stage, and the stages of the setup cut over an
    in-process mesh."""
    extra = (dict(deflate=4) if kind == "deflate"
             else dict(mesh=Mesh(2, 1)))
    problem = kcycle.build_problem(SIZE, "cpu", **extra)
    labels = [label for label, _ in problem["setup_fn"].stages]
    assert labels == STAGES + (["deflate"] if kind == "deflate"
                               else ["cdinv", "replicas"])


def test_prebuild_span(problems):
    problem = problems["schur"]
    _, found, _ = profiled(lambda: make_solver(
        problem["mg"], outer_type=kcycle.OUTERS["schur"], **SOLVE))
    assert counts(found)["qmg.setup.prebuild"] == 1


def test_readbacks_by_solver(problems):
    """The CG coarsest (deflated) counts its read-backs under "cg"."""
    problem = kcycle.build_problem(SIZE, "cpu", deflate=4)
    before = solvers.READBACKS.copy()
    _, _, found, readbacks = solved(problem)
    delta = solvers.READBACKS - before
    assert delta["cg"] > 0 and delta["gcr"] > 0
    assert sum(delta.values()) == readbacks == counts(found)["qmg.readback"]
