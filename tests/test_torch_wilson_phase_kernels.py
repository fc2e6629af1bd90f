"""The any-w Wilson kernel's and the split rank-1 kernel's plain twins
against qmg_tpu (its Pallas kernels in interpret mode and its
``apply_M``), the phase functions, the wrappers' routing and checks, and
(on a CUDA machine) the kernels against their twins and against the
rank-1 kernel.

The kernel tests carry the ``cuda`` marker and skip where there is no CUDA
device; run them on a GPU host with
``python -m pytest tests/test_torch_wilson_phase_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import stencil as jstencil, u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.pallas_wilson import (make_pallas_wilson_shaped,
                                   make_pallas_wilson_split_shaped,
                                   wilson_phases_from_coeffs,
                                   wilson_phases_split as jphases_split)
from qmg_tpu.pallas_dslash import (x_to_planes, x_from_planes,
                                   x_to_planes_split, x_from_planes_split)
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.dslash_kernel import x_to_split, x_from_split
from qmg_tpu_torch.wilson_kernel import (
    wilson_r1_apply, wilson_r1_apply_plain, wilson_phase_apply,
    wilson_phase_apply_plain, wilson_split_apply, wilson_split_apply_plain,
    wilson_phases, wilson_phases_split, bind_wilson)

torch.set_num_threads(1)

# (mass, Wilson coefficient)
PARAMS = [(-0.07, 1.0), (0.1, 1.3)]
SIZES = [16, 32]


def _jax_op(L, mass, w):
    lat = Lattice2D(L, L, 2)
    g = ju1.gauss_gauge_u1(lat, JQMGRandom(1337), 6.0)
    op = JWilson2D(lat, mass, jnp.asarray(g, jnp.complex64), wilson_coeff=w,
                   dtype=jnp.complex64)
    x = JQMGRandom(9).gaussian_cv(lat).astype(np.complex64)
    return lat, op, x


def _phases(op, w):
    return wilson_phases(torch.as_tensor(np.array(op.coeffs.hopping)), w)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# --- the any-w kernel's twin ---

def _phase_plain(op, x, mass, w):
    return wilson_phase_apply_plain(_phases(op, w), torch.as_tensor(x), w,
                                    2.0 * w + mass).numpy()


@pytest.mark.parametrize("mass, w", PARAMS)
@pytest.mark.parametrize("L", SIZES)
def test_phase_plain_matches_pallas_interpret(L, mass, w):
    lat, op, x = _jax_op(L, mass, w)
    fn = make_pallas_wilson_shaped(lat.y_len, lat.xh, w, mass, tile=8,
                                   interpret=True)
    ph = wilson_phases_from_coeffs(op.coeffs, w)
    expect = np.asarray(x_from_planes(fn(ph, x_to_planes(jnp.asarray(x)))))
    assert _rel(_phase_plain(op, x, mass, w), expect) <= 2e-6


@pytest.mark.parametrize("mass, w", PARAMS)
@pytest.mark.parametrize("L", SIZES)
def test_phase_plain_matches_jax_apply_M(L, mass, w):
    _, op, x = _jax_op(L, mass, w)
    expect = np.asarray(jstencil.apply_M(op.coeffs, jnp.asarray(x)))
    assert _rel(_phase_plain(op, x, mass, w), expect) <= 2e-6


@pytest.mark.parametrize("L", SIZES)
def test_phase_plain_at_w1_equals_rank1_plain(L):
    _, op, x = _jax_op(L, -0.07, 1.0)
    ph, xt = _phases(op, 1.0), torch.as_tensor(x)
    a = wilson_phase_apply_plain(ph, xt, 1.0, 2.0 - 0.07).numpy()
    b = wilson_r1_apply_plain(ph, xt, 2.0 - 0.07).numpy()
    assert _rel(a, b) <= 1e-6


# --- the split rank-1 kernel's twin ---

def _split_plain(op, x, mass):
    ph = wilson_phases_split(_phases(op, 1.0))
    out = wilson_split_apply_plain(ph, x_to_split(torch.as_tensor(x)),
                                   2.0 + mass)
    return x_from_split(out).numpy()


@pytest.mark.parametrize("L", SIZES)
def test_split_plain_matches_pallas_interpret(L):
    mass = -0.07
    lat, op, x = _jax_op(L, mass, 1.0)
    fn = make_pallas_wilson_split_shaped(lat.y_len, lat.xh, 1.0, mass,
                                         tile=8, interpret=True)
    ph = jphases_split(wilson_phases_from_coeffs(op.coeffs))
    expect = np.asarray(x_from_planes_split(
        fn(ph, x_to_planes_split(jnp.asarray(x)))))
    assert _rel(_split_plain(op, x, mass), expect) <= 2e-6


@pytest.mark.parametrize("L", SIZES)
def test_split_plain_matches_jax_apply_M(L):
    mass = -0.07
    _, op, x = _jax_op(L, mass, 1.0)
    expect = np.asarray(jstencil.apply_M(op.coeffs, jnp.asarray(x)))
    assert _rel(_split_plain(op, x, mass), expect) <= 2e-6


def test_split_plain_equals_rank1_plain_in_its_layout():
    phase, x = _inputs(8, 4, "cpu")
    a = x_from_split(wilson_split_apply_plain(wilson_phases_split(phase),
                                              x_to_split(x), 1.94))
    assert torch.equal(a, wilson_r1_apply_plain(phase, x, 1.94))


# --- the phase functions ---

@pytest.mark.parametrize("mass, w", PARAMS)
def test_phases_match_qmg_tpu(mass, w):
    _, op, _ = _jax_op(16, mass, w)
    jp = np.asarray(wilson_phases_from_coeffs(op.coeffs, w))
    jsplit = np.asarray(jphases_split(jnp.asarray(jp)))
    ph = _phases(op, w)
    assert ph.is_contiguous() and ph.dtype == torch.complex64
    assert np.max(np.abs(ph.numpy() - (jp[:, :, 0] + 1j * jp[:, :, 1]))) \
        <= 1e-7
    sp = wilson_phases_split(ph)
    assert sp.is_contiguous() and tuple(sp.shape) == (4, 2, 2, 8, 8)
    assert np.max(np.abs(sp.numpy()
                         - (jsplit[:, :, :, 0] + 1j * jsplit[:, :, :, 1]))) \
        <= 1e-7
    # |U_d / 2| = 1/2 at any w
    assert float((ph.abs() - 0.5).abs().max()) <= 1e-6


def test_phases_refuse_w_zero_and_odd_y():
    hopping = torch.zeros((4, 2, 3, 4, 2, 2), dtype=torch.complex64)
    with pytest.raises(ValueError, match="w = 0"):
        wilson_phases(hopping, 0.0)
    with pytest.raises(ValueError, match="even Y"):
        wilson_phases_split(wilson_phases(hopping, 1.3))
    with pytest.raises(ValueError, match="even Y"):
        x_to_split(torch.zeros((2, 3, 4, 2), dtype=torch.complex64))


# --- the wrappers ---

def _inputs(y_len, xh, device, seed=0):
    rng = np.random.default_rng(seed)
    phase = 0.5 * np.exp(1j * rng.uniform(-np.pi, np.pi, (4, 2, y_len, xh)))
    x = rng.normal(size=(2, y_len, xh, 2)) \
        + 1j * rng.normal(size=(2, y_len, xh, 2))
    return (torch.as_tensor(phase, dtype=torch.complex64, device=device),
            torch.as_tensor(x, dtype=torch.complex64, device=device))


def _call(kind, phase, x, w=1.3):
    """The wrapper ``kind`` on interleaved inputs (converted for the
    split kernel); its result in the interleaved layout."""
    if kind == "phase":
        return wilson_phase_apply(phase, x, w, 2.0 * w - 0.06)
    return x_from_split(wilson_split_apply(wilson_phases_split(phase),
                                           x_to_split(x), 1.94))


@pytest.mark.parametrize("kind", ["phase", "split"])
def test_cpu_wrapper_takes_plain_path_without_launch(kind):
    phase, x = _inputs(8, 4, "cpu")
    fn = wilson_phase_apply if kind == "phase" else wilson_split_apply
    before = fn.launches
    out = _call(kind, phase, x)
    assert fn.launches == before
    if kind == "phase":
        expect = wilson_phase_apply_plain(phase, x, 1.3, 2.6 - 0.06)
    else:
        expect = wilson_r1_apply_plain(phase, x, 1.94)
    assert torch.equal(out, expect)


def _check_rejects(device, kind, bad):
    phase, x = _inputs(8, 4, device)
    if kind == "split":
        phase, x = wilson_phases_split(phase), x_to_split(x)
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "noncontig":
        x = x.transpose(-3, -2).contiguous().transpose(-3, -2)
    elif bad == "phase_shape":
        phase = phase[..., :2, :]
    elif bad == "layout":      # the other kernel's layout
        x = x_from_split(x) if kind == "split" else x_to_split(x)
    else:                      # lazy conj
        x = torch.conj(x)
    fn = wilson_phase_apply if kind == "phase" else wilson_split_apply
    args = (1.3, 2.54) if kind == "phase" else (1.94,)
    before = fn.launches
    with pytest.raises((TypeError, ValueError)):
        fn(phase, x, *args)
    assert fn.launches == before


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "phase_shape",
                                 "layout", "conj"])
@pytest.mark.parametrize("kind", ["phase", "split"])
def test_wrapper_rejects_bad_input_cpu(kind, bad):
    _check_rejects("cpu", kind, bad)


@pytest.mark.parametrize("xh, message", [(16384, "unsupported device"),
                                         (16385, "32-bit")],
                         ids=["at_limit", "past_limit"])
@pytest.mark.parametrize("kind", ["phase", "split"])
def test_wrapper_index_range_guard(kind, xh, message):
    """The kernels index the phases up to 8 Y Xh in int32: the wrappers
    refuse a lattice past that (shape-only meta tensors; at the limit the
    check passes and the meta device is refused instead)."""
    y_len = 16384
    if kind == "phase":
        shape, fn, args = (2, y_len, xh, 2), wilson_phase_apply, (1.3, 2.54)
    else:
        shape, fn, args = ((2, 2, y_len // 2, xh, 2), wilson_split_apply,
                           (1.94,))
    phase = torch.empty((4,) + shape[:-1], dtype=torch.complex64,
                        device="meta")
    x = torch.empty(shape, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match=message):
        fn(phase, x, *args)


# --- the bound applies ---

def _bound(kind, phase, x, w=1.3):
    """(bind_wilson's apply, its x, the wrapper's result) for ``kind``."""
    if kind == "phase":
        alpha = 2.0 * w - 0.06
        return (bind_wilson(wilson_phase_apply, phase, x.shape, w, alpha), x,
                wilson_phase_apply(phase, x, w, alpha))
    ps, xs = wilson_phases_split(phase), x_to_split(x)
    return (bind_wilson(wilson_split_apply, ps, xs.shape, 1.94), xs,
            wilson_split_apply(ps, xs, 1.94))


@pytest.mark.parametrize("kind, w", [("phase", 1.0), ("phase", 1.3),
                                     ("split", 1.0)])
def test_bound_apply_is_the_wrapper_on_cpu(kind, w):
    phase, x = _inputs(8, 4, "cpu", seed=4)
    fn = wilson_phase_apply if kind == "phase" else wilson_split_apply
    before = fn.launches
    apply, arg, expect = _bound(kind, phase, x, w)
    assert torch.equal(apply(arg), expect)
    assert fn.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "noncontig", "conj",
                                 "layout"])
@pytest.mark.parametrize("kind", ["phase", "split"])
def test_bound_apply_holds_x_to_what_it_was_bound_to(kind, bad):
    phase, x = _inputs(8, 4, "cpu")
    apply, arg, _ = _bound(kind, phase, x)
    arg = {"shape": arg[..., :2, :], "dtype": arg.to(torch.complex128),
           "noncontig": arg.transpose(-3, -2).contiguous().transpose(-3, -2),
           "conj": torch.conj(arg),
           "layout": x if kind == "split" else x_to_split(x)}[bad]
    with pytest.raises(ValueError, match="was bound to x of shape"):
        apply(arg)


@pytest.mark.parametrize("kind", ["phase", "split"])
@pytest.mark.parametrize("bad, message", [
    ("meta", "unsupported device"), ("phase_shape", "phases must be"),
    ("layout", "x must be"), ("scalars", "takes")])
def test_bind_wilson_checks_once(kind, bad, message):
    device = "meta" if bad == "meta" else "cpu"
    phase = torch.empty((4, 2, 8, 4), dtype=torch.complex64, device=device)
    x_shape = (2, 8, 4, 2)
    if kind == "split":
        phase, x_shape = wilson_phases_split(phase), (2, 2, 4, 4, 2)
    fn = wilson_phase_apply if kind == "phase" else wilson_split_apply
    scalars = (1.3, 2.54) if kind == "phase" else (1.94,)
    if bad == "phase_shape":
        phase = phase[..., :2, :]
    elif bad == "layout":
        x_shape = (2, 2, 4, 4, 2) if kind == "phase" else (2, 8, 4, 2)
    elif bad == "scalars":
        scalars = scalars[:-1] if kind == "phase" else scalars + (1.0,)
    with pytest.raises((TypeError, ValueError), match=message):
        bind_wilson(fn, phase, x_shape, *scalars)


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _err(got, expect):
    return float((got - expect).abs().max() / expect.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1.0, 1.3])
@pytest.mark.parametrize("shape", [(8, 8), (48, 32), (512, 256)],
                         ids=["16x8", "64x48", "512x512"])
def test_phase_kernel_matches_plain_on_card(cuda_device, shape, w):
    y_len, xh = shape
    phase, x = _inputs(y_len, xh, cuda_device, seed=y_len)
    alpha = 2.0 * w - 0.06
    before = wilson_phase_apply.launches
    got = wilson_phase_apply(phase, x, w, alpha)
    torch.cuda.synchronize()
    assert wilson_phase_apply.launches == before + 1
    assert _err(got, wilson_phase_apply_plain(phase, x, w, alpha)) <= 1e-5
    if w == 1.0:
        assert _err(got, wilson_r1_apply(phase, x, alpha)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8), (48, 32), (512, 256)],
                         ids=["16x8", "64x48", "512x512"])
def test_split_kernel_matches_plain_on_card(cuda_device, shape):
    y_len, xh = shape
    phase, x = _inputs(y_len, xh, cuda_device, seed=y_len)
    ps, xs = wilson_phases_split(phase), x_to_split(x)
    before = wilson_split_apply.launches
    got = wilson_split_apply(ps, xs, 1.94)
    torch.cuda.synchronize()
    assert wilson_split_apply.launches == before + 1
    assert _err(got, wilson_split_apply_plain(ps, xs, 1.94)) <= 1e-5
    assert _err(x_from_split(got), wilson_r1_apply(phase, x, 1.94)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "noncontig", "phase_shape",
                                 "layout", "conj"])
@pytest.mark.parametrize("kind", ["phase", "split"])
def test_wrapper_rejects_bad_input_on_card(cuda_device, kind, bad):
    _check_rejects(cuda_device, kind, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, w", [("phase", 1.0), ("phase", 1.3),
                                     ("split", 1.0)])
@pytest.mark.parametrize("shape", [(8, 8), (512, 256)],
                         ids=["16x8", "512x512"])
def test_bound_apply_is_the_kernel_on_card(cuda_device, shape, kind, w):
    y_len, xh = shape
    phase, x = _inputs(y_len, xh, cuda_device, seed=y_len)
    fn = wilson_phase_apply if kind == "phase" else wilson_split_apply
    apply, arg, expect = _bound(kind, phase, x, w)
    before = fn.launches
    got = apply(arg)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, expect)
