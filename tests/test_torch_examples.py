"""Port vs qmg_tpu on the two examples: ``qmg_tpu_torch.wilson_kcycle``
against examples/wilson_kcycle.py (the n13 study with its spectrum and
colinearity legs) and ``qmg_tpu_torch.wilson_tpu_solve`` against
examples/wilson_tpu_solve.py (setup, checkpoint, solve). Each example runs
in-process (``main()`` with ``sys.argv`` set, its standard output
captured); its heatbath phases and hierarchy are recorded on the way, so
that the numbers it prints rounded are compared at full precision.

The two packages build their hierarchies independently, and the
null-vector solves (BiCGstab(6) to 5e-5) amplify rounding: at 16^2 the
level-1 coarse operators differ by 4e-9 and one inner GCR solve of the
K-cycle takes one iteration more in qmg_tpu (Level 1 KRYLOV 383 against
382; PARITY.md, "Setup equivalence oracles"). So the coarse levels' counts
are compared within 1% on the two hierarchies, and exactly when the port
solves on qmg_tpu's own hierarchy, handed over by checkpoint. The same
holds for the coarse spectrum: the fine spectra agree to 1e-8 (one
operator), the coarse ones to 1e-8 on qmg_tpu's hierarchy and to 1e-4 on
the port's own (1.2e-5 apart at the top of the spectrum, 7e-9 at its low
end)."""

import contextlib
import importlib.util
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu import u1 as ju1
from qmg_tpu import setup as jsetup
from qmg_tpu import checkpoint as jcheckpoint
from qmg_tpu import native as jnative

from qmg_tpu_torch import checkpoint, wilson_kcycle, wilson_tpu_solve, eig

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
ARGS = ["16", "-0.075", "6.0", "1"]
L, MASS, BETA, N_REFINE = 16, -0.075, 6.0, 1
COLINEAR_NEV = 16
SPECTRUM_NEV = 4
# qmg_tpu's heatbath takes its native sweep where the library is built.
SWEEP = "native" if jnative.have_heatbath() else "numpy"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"qmg_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(name, argv, monkeypatch):
    """``main()`` of examples/<name>.py with ``argv``: (its return value,
    its printed lines)."""
    mod = _example(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main()
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def kcycle_runs(tmp_path_factory):
    """The example with its dense spectrum and colinear study, its heatbath
    phases and hierarchy recorded; the port with the same arguments, and
    again with the shift-invert spectrum; and qmg_tpu's hierarchy loaded
    by the port from a checkpoint."""
    mp = pytest.MonkeyPatch()
    phases, hierarchies = [], []

    def heatbath(*a, **kw):
        ph = heatbath.orig(*a, **kw)
        phases.append(np.array(ph))
        return ph
    heatbath.orig = ju1.heatbath_noncompact_update

    def build(*a, **kw):
        mg = build.orig(*a, **kw)
        hierarchies.append(mg)
        return mg
    build.orig = jsetup.build_kcycle_hierarchy
    mp.setattr(ju1, "heatbath_noncompact_update", heatbath)
    mp.setattr(jsetup, "build_kcycle_hierarchy", build)
    try:
        _, jlines = _run_example(
            "wilson_kcycle", ARGS + ["--cpu", "--spectrum", "--colinear",
                                     "--colinear-nev", str(COLINEAR_NEV)],
            mp)
    finally:
        mp.undo()
    runs = {}
    for key, kw in (("dense", dict(spectrum=True, colinear=True,
                                   colinear_nev=COLINEAR_NEV)),
                    ("nev", dict(spectrum=True,
                                 spectrum_nev=SPECTRUM_NEV))):
        lines = []
        r = wilson_kcycle.run(L, MASS, BETA, N_REFINE, device="cpu",
                              sweep=SWEEP, out=lines.append, **kw)
        runs[key] = (r, lines)
    path = str(tmp_path_factory.mktemp("n13") / "mg.npz")
    jcheckpoint.save_hierarchy(hierarchies[0], path)
    loaded = checkpoint.load_hierarchy(path, runs["dense"][0]["op"],
                                       device="cpu")
    return {"jlines": jlines, "phases": phases, "jmg": hierarchies[0],
            "port": runs, "loaded": loaded}


def _tagged(lines, tag):
    return [ln for ln in lines if ln.startswith(f"[{tag}]")]


def _eigs(lines, tag):
    vals = []
    for ln in _tagged(lines, tag):
        m = re.match(r"\[\S+\]: \d+ (\S+) \+ I (\S+)$", ln)
        vals.append(complex(float(m.group(1)), float(m.group(2))))
    return np.array(vals)


def _match(got, want, atol):
    """Each value of ``got`` has one of ``want`` within ``atol``, and the
    other way round."""
    assert len(got) == len(want)
    d = np.abs(np.asarray(got)[:, None] - np.asarray(want)[None, :])
    assert d.min(axis=1).max() <= atol
    assert d.min(axis=0).max() <= atol


def test_heatbath_and_gauge_match(kcycle_runs):
    r, lines = kcycle_runs["port"]["dense"]
    jlines = kcycle_runs["jlines"]
    lat_g = JLattice2D(L, L, 1)
    want = []
    for ph in kcycle_runs["phases"]:
        links = ju1.phases_to_links(ph)
        want.append((float(np.real(ju1.get_plaquette_u1(links, lat_g))),
                     float(ju1.get_topo_u1(links, lat_g))))
    got = [(p, t) for _, p, t in r["heatbath"]]
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose([r["plaquette"], r["topo"]], want[-1],
                               rtol=0, atol=1e-12)
    # The printed lines agree up to the sign of a rounded zero charge.
    def printed(lines):
        return [re.sub(r"-(0\.0+)$", r"\1", ln)
                for ln in _tagged(lines, "QMG-HEATBATH")]
    assert printed(lines) == printed(jlines)
    assert r["gauge_source"] == "heatbath"


def _solve_lines(lines):
    m = re.search(r"Multigrid (\w+) in (\d+) iterations",
                  "\n".join(lines))
    check = [float(ln.split()[-1]) for ln in lines
             if ln.startswith("Check tolerance")]
    return m.group(1), int(m.group(2)), check[0]


def _ops(lines):
    return [[int(v) for v in ln.split()[4::2]]
            for ln in _tagged(lines, "QMG-OPS-STATS")]


def test_solve_and_counts_match(kcycle_runs):
    r, lines = kcycle_runs["port"]["dense"]
    jlines, jmg = kcycle_runs["jlines"], kcycle_runs["jmg"]
    j_state, j_iters, j_check = _solve_lines(jlines)
    t_state, t_iters, t_check = _solve_lines(lines)
    assert j_state == t_state == "converged"
    assert t_iters == j_iters == r["iters"]
    assert j_check <= 1e-9 and t_check <= 1e-9 and r["resid"] <= 1e-9
    jops, tops = np.array(_ops(jlines)), np.array(_ops(lines))
    assert tops.tolist() == r["ops"]
    assert np.array_equal(tops[0], jops[0])          # level 0
    assert np.array_equal(tops[:, 0], jops[:, 0])    # NULLVEC
    np.testing.assert_allclose(tops[1:], jops[1:], rtol=0.01)
    javg = jmg.query_average_iterations()
    assert abs(r["avg_iters"][0] - javg[0]) <= 1e-12
    np.testing.assert_allclose(r["avg_iters"][1:], javg[1:], rtol=0.01)


def test_counts_exact_on_qmg_tpu_hierarchy(kcycle_runs):
    """qmg_tpu's hierarchy through a checkpoint: the port's solve of the
    same right-hand side takes qmg_tpu's counts at every level."""
    r, _ = kcycle_runs["port"]["dense"]
    jmg, mg = kcycle_runs["jmg"], kcycle_runs["loaded"]
    cfg = wilson_kcycle.KCycleConfig(n_refine=N_REFINE, coarse_dof=8)
    res = mg.solve(r["b"], tol=1e-10, max_iter=cfg.max_iter,
                   restart_freq=cfg.restart_freq)
    n = jmg.get_num_levels()
    want = [[jmg.get_tracker_count(t, lvl) for t in range(1, 4)]
            for lvl in range(n)]
    assert mg.tracker["counts"][:, 1:].tolist() == want
    assert res.iters == jmg.get_iterations_count(0)
    assert mg.query_average_iterations() == pytest.approx(
        jmg.query_average_iterations(), abs=1e-12)


def test_dense_spectra_match(kcycle_runs):
    r, lines = kcycle_runs["port"]["dense"]
    jlines = kcycle_runs["jlines"]
    got = {tag: _eigs(lines, tag)
           for tag in ("ORIG-SPECTRUM", "COARSE-SPECTRUM")}
    want = {tag: _eigs(jlines, tag) for tag in got}
    np.testing.assert_array_equal(got["ORIG-SPECTRUM"], r["spectra"][0])
    assert len(got["ORIG-SPECTRUM"]) == 2 * L * L
    _match(got["ORIG-SPECTRUM"], want["ORIG-SPECTRUM"], 1e-8)
    _match(got["COARSE-SPECTRUM"], want["COARSE-SPECTRUM"], 1e-4)
    # The port's dense spectrum of qmg_tpu's coarse operator.
    st = kcycle_runs["loaded"].get_stencil(1)
    evals, _ = eig.dense_eigensystem(st.get_apply_function(),
                                     st.lat.cv_shape(), device="cpu")
    _match(evals, want["COARSE-SPECTRUM"], 1e-8)


def test_shift_invert_spectra_match(kcycle_runs):
    """The port's shift-invert eigenvalues nearest 0 against the lowest
    |lambda| of qmg_tpu's dense spectra, and the fine eigenpairs'
    residuals."""
    r, lines = kcycle_runs["port"]["nev"]
    jlines = kcycle_runs["jlines"]
    for tag in ("ORIG-SPECTRUM", "COARSE-SPECTRUM"):
        got, want = _eigs(lines, tag), _eigs(jlines, tag)
        assert len(got) == SPECTRUM_NEV
        _match(got, want[np.argsort(np.abs(want))[:SPECTRUM_NEV]], 1e-8)
    assert max(r["fine_eig_res"]) <= 1e-6
    assert r["overlap"] is None


def test_overlap_matches(kcycle_runs):
    r, lines = kcycle_runs["port"]["dense"]
    jlines = kcycle_runs["jlines"]

    def rows(lines):
        out = []
        for ln in _tagged(lines, "QMG-OVERLAP"):
            f = ln.replace("|", " ").split()
            out.append((complex(float(f[2]), float(f[5])), float(f[7]),
                        float(f[8])))
        return out
    got, want = rows(lines), rows(jlines)
    assert len(got) == len(want) == COLINEAR_NEV
    for lam, pp, papa in got:
        k = int(np.argmin([abs(lam - w[0]) for w in want]))
        assert abs(lam - want[k][0]) <= 1e-8
        np.testing.assert_allclose([pp, papa], want[k][1:], rtol=0,
                                   atol=1e-6)
    assert all(row[5] for row in r["overlap"])   # coarse solves converged
    # The MG premise (test_n13_colinearity): the lowest mode lies closer
    # to the coarse space than the highest kept one.
    assert r["overlap"][0][3] < r["overlap"][-1][3]


def test_kcycle_cli(capsys):
    """The CLI with the dense coarsest inverse: one coarsest application a
    visit."""
    wilson_kcycle.main(["8", "-0.075", "6.0", "1", "--cpu", "--tol",
                        "1e-8", "--coarsest-direct"])
    out = capsys.readouterr().out
    ops = _ops(out.splitlines())
    iters = [float(v) for v in out.split("avg iterations per level")[1]
             .split("\n")[0].split()]
    assert iters[1] == 1.0 and ops[1][1] == iters[0]
    for tag in ("[QMG-NOTE]", "[QMG-HEATBATH]", "[QMG-GAUGE]",
                "[QMG-SETUP]", "Multigrid converged", "Check tolerance",
                "[QMG-TIMING]", "[QMG-OPS-STATS]: Level 1",
                "[QMG-ITER-STATS]", "[QMG-FLOPS]"):
        assert tag in out, tag


@pytest.mark.parametrize("entry", [wilson_kcycle, wilson_tpu_solve])
def test_cuda_entry_refuses_without_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["8", "-0.075", "6.0", "1"] if entry is wilson_kcycle \
        else ["8", "-0.06"]
    with pytest.raises(SystemExit, match="no CUDA device"):
        entry.main(argv)


def test_find_config(tmp_path):
    assert wilson_kcycle.find_config(16, 6.0, None) is None
    assert wilson_kcycle.find_config(16, 6.0, str(tmp_path)) is None
    path = tmp_path / "l16t16b60_heatbath.dat"
    path.write_text("0.0\n")
    assert wilson_kcycle.find_config(16, 6.0, str(tmp_path)) == str(path)
    assert wilson_kcycle.find_config(16, 6.5, str(tmp_path)) is None


# --- wilson_tpu_solve ---

def _tpu_line(lines):
    m = re.search(r"\[QMG-TPU\] solve: (\d+) outer iters, \S+ ms, true "
                  r"resid (\S+)", "\n".join(lines))
    return int(m.group(1)), float(m.group(2))


def test_tpu_solve_matches_example(monkeypatch, tmp_path):
    """32^2, one refinement, complex64: the example's outer count +-1,
    both true residuals <= 10 tol; the port's checkpoint restores to the
    same count, and the example's checkpoint loads too."""
    tol = 1e-5
    jpath = str(tmp_path / "example.npz")
    rc, jlines = _run_example(
        "wilson_tpu_solve", ["32", "-0.06", "--n-refine", "1", "--ckpt",
                             jpath], monkeypatch)
    j_iters, j_resid = _tpu_line(jlines)
    assert rc == 0 and j_resid <= 10 * tol

    tpath = str(tmp_path / "port.npz")
    lines = []
    r = wilson_tpu_solve.run(32, -0.06, n_refine=1, tol=tol, ckpt=tpath,
                             device="cpu", out=lines.append)
    assert not r["restored"] and os.path.exists(tpath)
    assert r["ok"] and r["resid"] <= 10 * tol
    assert abs(r["iters"] - j_iters) <= 1
    assert _tpu_line(lines) == (r["iters"], pytest.approx(r["resid"],
                                                          rel=1e-2))
    assert [ln.split()[1] for ln in lines] == \
        [ln.split()[1] for ln in jlines]

    again = wilson_tpu_solve.run(32, -0.06, n_refine=1, tol=tol,
                                 ckpt=tpath, device="cpu",
                                 out=lambda s: None)
    assert again["restored"] and again["iters"] == r["iters"]
    assert torch.equal(again["b"], r["b"])

    theirs = wilson_tpu_solve.run(32, -0.06, n_refine=1, tol=tol,
                                  ckpt=jpath, device="cpu",
                                  out=lambda s: None)
    assert theirs["restored"] and theirs["ok"]
    assert abs(theirs["iters"] - j_iters) <= 1


def test_tpu_solve_schur_cli(tmp_path, capsys):
    assert wilson_tpu_solve.main(["16", "-0.06", "--n-refine", "1",
                                  "--schur", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "[QMG-TPU] hierarchy setup" in out and "true resid" in out


def jax_counts(argv=None):
    """qmg_tpu's outer counts that ``chip_smoke.py`` phase 21 pins: the n13
    example at ``--n13 L`` (-0.075, beta 6, two refinements) with the dense
    coarsest inverse (the example's restarted-GCR coarsest stagnates from
    two refinements on; its own build_kcycle_hierarchy is wrapped to set
    ``coarsest_direct``), and the checkpointed-solve example at
    ``--tpu-solve L`` (-0.06, three refinements), standard and Schur."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--n13", type=int, default=None)
    p.add_argument("--tpu-solve", type=int, default=None)
    args = p.parse_args(argv)
    mp = pytest.MonkeyPatch()
    if args.n13:
        def build(lat, op, cfg, rng):
            cfg.coarsest_direct = True
            return build.orig(lat, op, cfg, rng)
        build.orig = jsetup.build_kcycle_hierarchy
        mp.setattr(jsetup, "build_kcycle_hierarchy", build)
        _, lines = _run_example("wilson_kcycle", [str(args.n13), "-0.075",
                                                  "6.0", "2", "--cpu"], mp)
        mp.undo()
        print("\n".join(ln for ln in lines if "HEATBATH" not in ln))
    if args.tpu_solve:
        for extra in ([], ["--schur"]):
            _, lines = _run_example(
                "wilson_tpu_solve",
                [str(args.tpu_solve), "-0.06", "--n-refine", "3"] + extra,
                mp)
            print(" ".join(extra), "\n".join(lines), flush=True)


if __name__ == "__main__":
    jax_counts()
