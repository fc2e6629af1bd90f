"""The plain reference and the control: the reference is the program's
operator, flags a perturbed answer, and the control (the reference solve
in TF32) fails the limit that a float32 solve meets."""

import pytest
import torch

from benchmark import control
from benchmark.inputs import make_inputs
from benchmark.metrics import fine_apply_roofline
from benchmark.reference import wilson as ref
from benchmark.tests.conftest import small_cell


def _problem(size=16, seed=2**31 + 99):
    _, _, config, traffic = small_cell("n13-2048-rhs8", size, "gauss-rhs1")
    return config, make_inputs(config, traffic, seed, "cpu")


@pytest.mark.parametrize("w", [1.0, 1.3])
def test_reference_is_the_wilson_operator(w):
    from qmg_tpu_torch.lattice import Lattice2D
    from qmg_tpu_torch.operators.wilson import Wilson2D
    from qmg_tpu_torch.stencil import apply_M
    _, data = _problem()
    x = data["pool"][0].to(torch.complex128)
    op = Wilson2D(Lattice2D(16, 16, 2), -0.06, data["gauge"], w)
    grid = torch.stack([ref.unpack(data["gauge"][0]),
                        ref.unpack(data["gauge"][1])])
    ours = ref.pack(ref.wilson_apply(grid, ref.unpack(x), -0.06, w))
    assert float((ours - apply_M(op.coeffs, x)).abs().max()) < 1e-12


def test_pack_inverts_unpack():
    _, data = _problem()
    assert bool((ref.pack(ref.unpack(data["pool"][1]))
                 == data["pool"][1]).all())


def test_reference_flags_a_perturbed_solution():
    config, data = _problem()
    op = config["operator"]
    b = data["pool"][0]
    x, _ = control.bicgstab(control.control_apply(
        data["gauge"], op["mass"], op["wilson_coeff"], "fp32"),
        ref.unpack(b), 1e-6, 2000)
    x = ref.pack(x)
    limit = config["check"]["true_residual_limit"]
    assert ref.true_residual(data["gauge"], b, x, op["mass"]) <= limit
    bad = x.clone()
    bad[0, 3, 2, 1] += 0.05
    assert ref.true_residual(data["gauge"], b, bad, op["mass"]) > limit
    assert ref.true_residual(data["gauge"], b, x * (1 + 1e-3),
                             op["mass"]) > limit


def test_tf32_rounding():
    x = torch.tensor([1 + 2 ** -11 + 2 ** -20, -(1 + 2 ** -9)],
                     dtype=torch.float32)
    x = torch.complex(x, x)
    got = torch.view_as_real(control.to_tf32(x))[:, 0]
    assert got.tolist() == [1 + 2 ** -10, -(1 + 2 ** -9)]


def _control_run(workload, size, precision, device, mix=None):
    """A run of ``workload`` at ``size``^2 with the control's solver in the
    program's place, judged by ``run_cell``'s own check."""
    from benchmark import run
    bench, cell, config, traffic = small_cell(workload, size, mix)
    return run.run_cell(bench, cell, config, traffic, 2**31 + 5, 0.0, False,
                        device=device,
                        solver=control.control_solver(precision, 3000))


@pytest.mark.parametrize("workload,mix", [("n13-2048-rhs8", "gauss-rhs1"),
                                         ("n19-2048-rhs8", None)])
def test_control_fails_where_float32_passes(workload, mix):
    full = _control_run(workload, 32, "fp32", "cpu", mix)
    low = _control_run(workload, 32, "tf32", "cpu", mix)
    assert full["correct"] is True, full["check"]
    assert low["correct"] is False and low["failed"] > 0, low["check"]


def test_wilson_apply_bytes():
    # U_x and U_y read once (16 B), x read and y written (16 B each)
    assert fine_apply_roofline.wilson_apply_bytes(1, 1) == 48
    assert fine_apply_roofline.wilson_apply_bytes(2048 * 2048, 8) == \
        2048 * 2048 * (16 + 32 * 8)


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    """The control at 256^2 on the card, beside the same solve in float32."""
    full = _control_run("n13-2048-rhs8", 256, "fp32", card, "gauss-rhs1")
    low = _control_run("n13-2048-rhs8", 256, "tf32", card, "gauss-rhs1")
    assert full["correct"] is True and low["correct"] is False
