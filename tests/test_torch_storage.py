"""The port's ``ArrayStorageMG`` against qmg_tpu's (tests/test_storage.py):
zeroed check-outs, growth on demand, refused foreign and double
check-ins, and ``consolidate``'s floor, step for step with qmg_tpu's
pool."""

import jax.numpy as jnp
import pytest
import torch

from qmg_tpu.storage import ArrayStorageMG as JArrayStorageMG

from qmg_tpu_torch.storage import ArrayStorageMG

torch.set_num_threads(1)


def test_check_out_returns_zeroed_tensor():
    pool = ArrayStorageMG((2, 4, 2, 3), count=2, dtype=torch.complex128,
                          device="cpu")
    h, v = pool.check_out()
    assert v.shape == (2, 4, 2, 3) and v.dtype == torch.complex128
    assert v.device.type == "cpu" and float(v.abs().sum()) == 0.0
    jh, _ = JArrayStorageMG((2, 4, 2, 3), count=2,
                            dtype=jnp.complex128).check_out()
    assert h == jh
    pool.check_in(h)


def test_pool_grows_on_demand():
    pools = (ArrayStorageMG((4,), count=2, device="cpu"),
             JArrayStorageMG((4,), count=2))
    handles = [[p.check_out()[0] for _ in range(5)] for p in pools]
    assert handles[0] == handles[1]
    for p, hs in zip(pools, handles):
        assert p.get_number_allocated() == 5
        assert p.get_number_checked() == 5
        for h in hs:
            p.check_in(h)
        assert p.get_number_checked() == 0


def test_foreign_check_in_rejected():
    pool = ArrayStorageMG((4,), count=1, device="cpu")
    with pytest.raises(ValueError, match="not from this pool"):
        pool.check_in(99)


def test_double_check_in_rejected():
    pool = ArrayStorageMG((4,), count=1, device="cpu")
    h, _ = pool.check_out()
    pool.check_in(h)
    with pytest.raises(ValueError, match="double check_in"):
        pool.check_in(h)


def test_consolidate_frees_unused():
    """Free slots are dropped down to max(min_keep, checked out) on the
    first call; every later step (check-in, a second call, growth, a third
    call) leaves the same pool as qmg_tpu's, whose count from the next
    handle lets the second call go below the floor (ROADMAP F8)."""
    pools = (ArrayStorageMG((4,), count=6, device="cpu"),
             JArrayStorageMG((4,), count=6))

    def state():
        return [(p.get_number_allocated(), p.get_number_checked(),
                 sorted(p._free)) for p in pools]

    handles = [p.check_out()[0] for p in pools]
    assert handles[0] == handles[1]
    for p in pools:
        p.consolidate(min_keep=2)
    assert state()[0] == state()[1]
    assert state()[0][:2] == (2, 1)
    for p, h in zip(pools, handles):
        p.check_in(h)
    assert state()[0] == state()[1]
    for p in pools:
        p.consolidate(min_keep=2)
    assert state()[0] == state()[1]
    handles = [p.check_out()[0] for p in pools]
    assert handles[0] == handles[1]
    for p in pools:
        p.consolidate()
    assert state()[0] == state()[1]
    assert state()[0][:2] == (1, 1)
