"""A run with the timed path broken underneath comes out not correct:
once for each fault a solve cell can have (the answer returned unchanged
from the start, half the batch left out, an answer altered where it is
produced). The harness's look for a card is skipped: ``run_cell`` runs on
the CPU at a small size."""

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import small_cell


def _state_unchanged(res):
    return res._replace(x=torch.zeros_like(res.x))


def _half_batch(res):
    x = res.x.clone()
    x[x.shape[0] // 2:] = 0
    return res._replace(x=x)


def _altered(res):
    x = res.x.clone()
    x.reshape(-1)[7] += 0.05
    return res._replace(x=x)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _altered}
CASES = [("n13-2048-rhs8", "gauss-rhs1", "state_unchanged"),
         ("n19-2048-rhs8", "gauss-rhs1", "state_unchanged"),
         ("n13-2048-rhs8", "gauss-rhs1", "answer_altered"),
         ("n19-2048-rhs8", "gauss-rhs1", "answer_altered"),
         ("n13-2048-rhs8", None, "state_unchanged"),
         ("n13-2048-rhs8", None, "half_batch"),
         ("n19-2048-rhs8", None, "half_batch"),
         ("n13-2048-rhs8", None, "answer_altered")]


def _broken(factory, fault):
    def make(*args, **kw):
        solve = factory(*args, **kw)

        def broken(b):
            res, carry = solve(b)
            return FAULTS[fault](res), carry
        return broken
    return make


@pytest.mark.parametrize("workload,mix,fault", CASES)
def test_fault_is_not_correct(workload, mix, fault, monkeypatch):
    bench, cell, config, traffic = small_cell(workload, 16, mix)
    monkeypatch.setattr(run, "make_solver", _broken(run.make_solver, fault))
    monkeypatch.setattr(run, "make_batched_solver",
                        _broken(run.make_batched_solver, fault))
    result = run.run_cell(bench, cell, config, traffic, 2**31 + 5, 0.2,
                          False, device="cpu")
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.parametrize("workload,mix", [("n13-2048-rhs8", "gauss-rhs1"),
                                         ("n19-2048-rhs8", None)])
def test_sound_run_is_correct(workload, mix):
    bench, cell, config, traffic = small_cell(workload, 16, mix)
    result = run.run_cell(bench, cell, config, traffic, 2**31 + 5, 0.2,
                          False, device="cpu")
    assert result["correct"] is True and result["failed"] == 0


def test_kept_answers_are_copies():
    """The check's sample keeps copies of single lanes, so a kept lane holds
    no other lane of its batch, and counts only its own bytes."""
    kept = run.Reservoir(3, 2**31 + 11)
    batch = torch.zeros(8, 4, dtype=torch.complex64)
    for lane in range(8):
        kept.offer(lambda lane=lane: (lane, batch[lane].clone(), True))
    assert len(kept.kept) == 3 and kept.seen == 8
    assert kept.nbytes() == 3 * 4 * 8
    ptr = batch.untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() != ptr for _, x, _ in kept.kept)


def test_setup_options_reach_the_setup(monkeypatch):
    """A configuration's ``setup_options`` go to the setup as they are: a
    CG coarsest on M^dag M deflated by 4 eigenpairs, which comes out
    correct."""
    built = []

    def recording(*args, **kw):
        setup_fn = make(*args, **kw)

        def setup(*inputs):
            built.append(setup_fn(*inputs))
            setup.seconds = setup_fn.seconds
            return built[-1]
        return setup

    make = run.make_kcycle_setup_planes
    monkeypatch.setattr(run, "make_kcycle_setup_planes", recording)
    bench, cell, config, traffic = small_cell("n13-2048-rhs8", 32,
                                              "gauss-rhs1")
    config["kcycle"].update(coarsest_stencil_app="MDAGGER_M",
                            coarsest_direct=False)
    config["setup_options"] = {"deflate_low": 4}
    result = run.run_cell(bench, cell, config, traffic, 2**31 + 29, 0.05,
                          False, device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    (mg,) = built
    assert mg.coarsest_evecs.shape[0] == 4 and mg.coarsest_dinv is None
