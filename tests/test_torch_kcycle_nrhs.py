"""``python -m qmg_tpu_torch.kcycle --nrhs N`` on the CPU (bench.py's
``--nrhs`` mode): the batched solve in its three schedules (adaptive,
``--fixed-schedule``, ``--calibrated``), on the Schur formulation, and the
Schur formulation over the deflated coarsest; every lane's counts and
true residuals printed, and the refusals."""

import re

import pytest
import torch

from qmg_tpu_torch.kcycle import main as kcycle_main

torch.set_num_threads(1)

TRUE_RES = 1e-4
LANE = re.compile(r"^  lane (\d+): (\d+) \((\d+)\), (\S+), (\S+), (\S+) "
                  r"\((\S+)\)$")


def lanes_of(out):
    """(lane, outer, sequential outer, true relres) of every lane line."""
    return [(int(m[1]), int(m[2]), int(m[3]), float(m[6]))
            for m in map(LANE.match, out.splitlines()) if m]


@pytest.mark.parametrize("argv", [
    [], ["--fixed-schedule", "12"], ["--calibrated"], ["--outer", "schur"]],
    ids=["adaptive", "fixed-12", "calibrated", "schur"])
def test_nrhs_mode(argv, capsys):
    kcycle_main(["--size", "16", "--device", "cpu", "--nrhs", "3"] + argv)
    out = capsys.readouterr().out
    lanes = lanes_of(out)
    assert [k for k, *_ in lanes] == [0, 1, 2]
    for _, outer, seq, true_res in lanes:
        assert true_res <= TRUE_RES
        if argv == ["--fixed-schedule", "12"]:
            assert outer == 12
        elif argv == ["--calibrated"]:
            assert outer == seq + 1 or outer == seq + 2
        else:
            assert abs(outer - seq) <= 1
    if argv == ["--calibrated"]:
        assert "calibrated contract: met" in out
    assert "batched solve ms" in out and "per rhs" in out


def test_schur_deflate(capsys):
    """``--outer schur --deflate 4`` (32^2: a 16^2 hierarchy's coarsest is
    a single site, whose deflation is F7's NaN)."""
    kcycle_main(["--size", "32", "--device", "cpu", "--outer", "schur",
                 "--deflate", "4"])
    out = capsys.readouterr().out
    assert "2x2 nc8 mdagger_m" in out and "8x8 nc8 right_schur" in out
    assert "deflated by 4 eigenpairs" in out
    true_res = float(re.search(r"true \(c128[^)]*\) (\S+)", out)[1])
    assert true_res <= TRUE_RES


@pytest.mark.parametrize("argv,match", [
    (["--fixed-schedule", "12"], "--nrhs mode"),
    (["--nrhs", "3", "--calibrated", "--fixed-schedule", "12"],
     "drop --fixed-schedule"),
    (["--nrhs", "3", "--fixed-schedule", "a,b"], "OUTER,INNER"),
    (["--nrhs", "3", "--shards", "2", "--fine-kernel", "wilson-phase"],
     "single-device"),
    (["--nrhs", "3", "--fine-kernel", "matrix"], "rhs axis"),
    (["--nrhs", "3", "--fixed-schedule", "4,2", "--no-direct"],
     "direct coarsest")])
def test_nrhs_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        kcycle_main(["--size", "16", "--device", "cpu"] + argv)
