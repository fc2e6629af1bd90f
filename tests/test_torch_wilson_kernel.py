"""The rank-1 Wilson kernel's plain twin against qmg_tpu, the wrapper's
routing and checks, and (on a CUDA machine) the kernel against its twin.

The kernel-vs-twin tests carry the ``cuda`` marker and skip where there is
no CUDA device; run them on a GPU host with
``python -m pytest tests/test_torch_wilson_kernel.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import stencil as jstencil, u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.pallas_wilson import (make_pallas_wilson_rank1_shaped,
                                   wilson_phases_from_coeffs)
from qmg_tpu.pallas_dslash import x_to_planes, x_from_planes
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.wilson_kernel import (wilson_r1_apply,
                                         wilson_r1_apply_plain,
                                         wilson_phases, bind_wilson)

torch.set_num_threads(1)

MASS = -0.06
ALPHA = 2.0 + MASS


def _jax_op(L):
    lat = Lattice2D(L, L, 2)
    g = ju1.gauss_gauge_u1(lat, JQMGRandom(1337), 6.0)
    op = JWilson2D(lat, MASS, jnp.asarray(g, jnp.complex64),
                   dtype=jnp.complex64)
    x = JQMGRandom(9).gaussian_cv(lat).astype(np.complex64)
    return lat, op, x


def _plain(op, x):
    phase = wilson_phases(torch.as_tensor(np.array(op.coeffs.hopping)))
    return wilson_r1_apply_plain(phase, torch.as_tensor(x), ALPHA).numpy()


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("L", [16, 32])
def test_plain_matches_pallas_rank1_interpret(L):
    lat, op, x = _jax_op(L)
    fn = make_pallas_wilson_rank1_shaped(lat.y_len, lat.xh, 1.0, MASS,
                                         tile=8, interpret=True)
    ph = wilson_phases_from_coeffs(op.coeffs)
    expect = np.asarray(x_from_planes(fn(ph, x_to_planes(jnp.asarray(x)))))
    assert _rel(_plain(op, x), expect) <= 2e-6


@pytest.mark.parametrize("L", [16, 32])
def test_plain_matches_jax_apply_M(L):
    _, op, x = _jax_op(L)
    expect = np.asarray(jstencil.apply_M(op.coeffs, jnp.asarray(x)))
    assert _rel(_plain(op, x), expect) <= 2e-6


def _inputs(y_len, xh, device, seed=0):
    rng = np.random.default_rng(seed)
    phase = np.exp(1j * rng.uniform(-np.pi, np.pi, (4, 2, y_len, xh)))
    x = rng.normal(size=(2, y_len, xh, 2)) \
        + 1j * rng.normal(size=(2, y_len, xh, 2))
    return (torch.as_tensor(phase, dtype=torch.complex64, device=device),
            torch.as_tensor(x, dtype=torch.complex64, device=device))


def test_cpu_wrapper_takes_plain_path_without_launch():
    phase, x = _inputs(8, 4, "cpu")
    before = wilson_r1_apply.launches
    out = wilson_r1_apply(phase, x, ALPHA)
    assert wilson_r1_apply.launches == before
    assert torch.equal(out, wilson_r1_apply_plain(phase, x, ALPHA))


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "shape"])
def test_wrapper_rejects_bad_input_cpu(bad):
    _check_rejects("cpu", bad)


def _check_rejects(device, bad):
    phase, x = _inputs(8, 4, device)
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "noncontig":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        phase = phase[:, :, :4]
    before = wilson_r1_apply.launches
    with pytest.raises((TypeError, ValueError)):
        wilson_r1_apply(phase, x, ALPHA)
    assert wilson_r1_apply.launches == before


@pytest.mark.parametrize("xh, message", [(16384, "unsupported device"),
                                         (16385, "32-bit")],
                         ids=["at_limit", "past_limit"])
def test_wrapper_index_range_guard(xh, message):
    """The kernel indexes the phases up to 8 Y Xh in int32: the wrapper
    refuses a lattice past that (shape-only meta tensors; at the limit the
    check passes and the meta device is refused instead)."""
    y_len = 16384
    phase = torch.empty((4, 2, y_len, xh), dtype=torch.complex64,
                        device="meta")
    x = torch.empty((2, y_len, xh, 2), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match=message):
        wilson_r1_apply(phase, x, ALPHA)


def test_bound_apply_is_the_wrapper_on_cpu():
    """bind_wilson's function gives the wrapper's result and counts no
    launch on the CPU."""
    phase, x = _inputs(8, 4, "cpu", seed=2)
    before = wilson_r1_apply.launches
    apply = bind_wilson(wilson_r1_apply, phase, x.shape, ALPHA)
    assert torch.equal(apply(x), wilson_r1_apply(phase, x, ALPHA))
    assert wilson_r1_apply.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "noncontig", "conj"])
def test_bound_apply_holds_x_to_what_it_was_bound_to(bad):
    phase, x = _inputs(8, 4, "cpu")
    apply = bind_wilson(wilson_r1_apply, phase, x.shape, ALPHA)
    x = {"shape": x[:, :4], "dtype": x.to(torch.complex128),
         "noncontig": x.transpose(1, 2).contiguous().transpose(1, 2),
         "conj": torch.conj(x)}[bad]
    with pytest.raises(ValueError, match="was bound to x of shape"):
        apply(x)


@pytest.mark.parametrize("bad, message", [
    ("meta", "unsupported device"), ("phase_shape", "phases must be"),
    ("x_shape", "x must be"), ("phase_dtype", "complex64"),
    ("scalars", "takes alpha"), ("too_large", "32-bit")])
def test_bind_wilson_checks_once(bad, message):
    """The wrapper's checks are made when it is bound."""
    device = "meta" if bad in ("meta", "too_large") else "cpu"
    y_len, xh = (16384, 16385) if bad == "too_large" else (8, 4)
    phase = torch.empty((4, 2, y_len, xh), dtype=torch.complex64,
                        device=device)
    x_shape, scalars = (2, y_len, xh, 2), (ALPHA,)
    if bad == "phase_shape":
        phase = phase[:, :, :4]
    elif bad == "x_shape":
        x_shape = (2, 2, y_len // 2, xh, 2)
    elif bad == "phase_dtype":
        phase = phase.to(torch.complex128)
    elif bad == "scalars":
        scalars = (1.0, ALPHA)
    with pytest.raises((TypeError, ValueError), match=message):
        bind_wilson(wilson_r1_apply, phase, x_shape, *scalars)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8), (48, 32), (512, 256)],
                         ids=["16x8", "64x48", "512x512"])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    y_len, xh = shape
    phase, x = _inputs(y_len, xh, cuda_device, seed=y_len)
    before = wilson_r1_apply.launches
    got = wilson_r1_apply(phase, x, ALPHA)
    torch.cuda.synchronize()
    assert wilson_r1_apply.launches == before + 1
    expect = wilson_r1_apply_plain(phase, x, ALPHA)
    err = float((got - expect).abs().max() / expect.abs().max())
    assert err <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "noncontig", "shape"])
def test_wrapper_rejects_bad_input_on_card(cuda_device, bad):
    _check_rejects(cuda_device, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8), (512, 256)],
                         ids=["16x8", "512x512"])
def test_bound_apply_is_the_kernel_on_card(cuda_device, shape):
    """The bound apply launches the wrapper's kernel (bit-equal output,
    one launch counted a call) and refuses a misaligned x."""
    y_len, xh = shape
    phase, x = _inputs(y_len, xh, cuda_device, seed=y_len)
    apply = bind_wilson(wilson_r1_apply, phase, x.shape, ALPHA)
    before = wilson_r1_apply.launches
    got = apply(x)
    torch.cuda.synchronize()
    assert wilson_r1_apply.launches == before + 1
    assert torch.equal(got, wilson_r1_apply(phase, x, ALPHA))
    # the bound apply owns the phases: the caller's reference may go, and
    # a new tensor must not land in their memory
    shape = phase.shape
    del phase
    junk = torch.zeros(shape, dtype=torch.complex64, device=cuda_device)
    assert torch.equal(apply(x), got) and not junk.any()
    flat = torch.empty(x.numel() + 1, dtype=torch.complex64,
                       device=cuda_device)
    with pytest.raises(ValueError, match="was bound to x of shape"):
        apply(flat[1:].view(x.shape))
