"""The small-lattice kernel's interleaved entry
(``dslash_small_interleaved_apply``, the layout the solve's fields have):
its twin against the split entry's twin, against qmg_tpu's ``apply_M`` and
against qmg_tpu's ``_dslash_small_kernel`` in interpret mode, its refusals
(those of ``small_fits``, on every device), its bound apply, the benchmark
chain through both entries, and (on a CUDA machine) the kernel against its
twin and against the split entry.

qmg_tpu's kernel runs in interpret mode at nc = 2 only: at nc = 8 its
tracing takes 23-60 s a call on the CPU, so there the twin is held to
qmg_tpu's ``apply_M``, the function the kernel computes.

The kernel tests carry the ``cuda`` marker and skip where there is no CUDA
device.
"""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import stencil as jstencil, u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.pallas_dslash import (make_pallas_dslash_small_shaped,
                                   _channels_from_coeffs_split,
                                   x_to_planes_split, x_from_planes_split)
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.stencil import make_coeffs as tmake_coeffs
from qmg_tpu_torch import dslash_kernel as dk

torch.set_num_threads(1)

REL_TOL = 1e-6      # x max|expected|: complex64 sums of at most 80 terms
small = dk.dslash_small_interleaved_apply


def _cfield(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _inputs(nc, y_len, xh, device="cpu", bf16=False, seed=0):
    """Random interleaved channels and x."""
    rng = np.random.default_rng(seed + 100 * nc + y_len + xh)
    ch = torch.as_tensor(_cfield(rng, (5, 2, y_len, xh, nc, nc)),
                         device=device)
    x = torch.as_tensor(_cfield(rng, (2, y_len, xh, nc)), device=device)
    if bf16:
        ch = torch.view_as_real(ch).to(torch.bfloat16).contiguous()
    return ch, x


def _rel(got, expect):
    return float(np.max(np.abs(got - expect)) / np.max(np.abs(expect)))


SHAPES = [(1, 8, 4), (2, 8, 4), (2, 16, 8), (2, 64, 32), (8, 8, 4),
          (8, 32, 16), (8, 64, 32), (8, 2, 1), (16, 8, 32), (4, 6, 3)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("nc, y_len, xh", SHAPES)
def test_twin_equals_split_twin_exactly(nc, y_len, xh, bf16):
    """The interleaved entry's twin gives, element for element, what the
    split entry's twin gives after ``x_from_split``: the two layouts
    gather the same neighbours and sum them in the same order."""
    ch, x = _inputs(nc, y_len, xh, bf16=bf16)
    got = small(ch, x)
    split = dk.dslash_small_apply_plain(dk.channels_to_split(ch),
                                        dk.x_to_split(x))
    assert got.shape == x.shape and got.dtype == torch.complex64
    assert torch.equal(got, dk.x_from_split(split))


def _operator(op, x_len, y_len):
    """(qmg_tpu coefficients, port coefficients, x) on the same numbers:
    Wilson at nc = 2, random coefficients at nc = 1 or 8."""
    nc = {"wilson2": 2, "rand1": 1, "rand8": 8}[op]
    lat = Lattice2D(x_len, y_len, nc)
    rng = np.random.default_rng(x_len + 3 * y_len + nc)
    if op == "wilson2":
        g = ju1.gauss_gauge_u1(lat, JQMGRandom(1337), 6.0)
        jc = JWilson2D(lat, -0.07, jnp.asarray(g, jnp.complex64),
                       dtype=jnp.complex64).coeffs
        arrays = dict(clover=np.asarray(jc.clover),
                      hopping=np.asarray(jc.hopping))
        shifts = dict(shift=-0.07)
    else:
        arrays = dict(clover=_cfield(rng, lat.cm_shape()),
                      hopping=_cfield(rng, (4,) + lat.cm_shape()))
        shifts = dict(shift=-0.075, eo_shift=0.0, dof_shift=0.0)
        jc = jstencil.make_coeffs(
            lat, **{k: jnp.asarray(v) for k, v in arrays.items()},
            dtype=jnp.complex64, **shifts)
    tc = tmake_coeffs(TLattice2D(x_len, y_len, nc),
                      **{k: torch.as_tensor(v) for k, v in arrays.items()},
                      dtype=torch.complex64, **shifts)
    return jc, tc, _cfield(rng, lat.cv_shape())


@pytest.mark.parametrize("op, x_len, y_len", [
    ("wilson2", 16, 16), ("wilson2", 64, 64), ("wilson2", 16, 8),
    ("rand1", 8, 8), ("rand8", 8, 8), ("rand8", 32, 32), ("rand8", 64, 64),
    ("rand8", 2, 2)])
def test_twin_matches_qmg_tpu_apply_M(op, x_len, y_len):
    jc, tc, x = _operator(op, x_len, y_len)
    expect = np.asarray(jstencil.apply_M(jc, jnp.asarray(x)))
    got = small(dk.stencil_channels(tc), torch.as_tensor(x)).numpy()
    assert _rel(got, expect) <= REL_TOL


@pytest.mark.parametrize("x_len, y_len", [(16, 16), (8, 8), (2, 2), (16, 8)])
def test_twin_matches_qmg_tpu_small_kernel_interpret(x_len, y_len):
    """Against qmg_tpu's ``_dslash_small_kernel`` itself (interpret mode,
    through ``x_to_planes_split``) on a Wilson operator, nc = 2."""
    jc, tc, x = _operator("wilson2", x_len, y_len)
    fn = make_pallas_dslash_small_shaped(2, y_len, x_len // 2,
                                         interpret=True)
    ck, hk = _channels_from_coeffs_split(jc)
    expect = np.asarray(x_from_planes_split(
        fn(ck, hk, x_to_planes_split(jnp.asarray(x)))))
    got = small(dk.stencil_channels(tc), torch.as_tensor(x)).numpy()
    assert _rel(got, expect) <= REL_TOL


def test_bf16_twin_rounds_like_the_split_entry():
    """bf16 coefficient pairs: within bf16 rounding of the complex64
    result (the exact equality with the split twin is tested above)."""
    ch, x = _inputs(8, 8, 4)
    exact = small(ch, x)
    got = small(torch.view_as_real(ch).to(torch.bfloat16).contiguous(), x)
    assert float((got - exact).abs().max() / exact.abs().max()) <= 3e-2


# --- routing and refusals ---

def test_cpu_wrapper_takes_the_twin_and_shares_the_split_counter():
    ch, x = _inputs(8, 8, 4)
    before = dk.dslash_small_apply.launches
    assert torch.equal(small(ch, x), dk.dslash_apply_plain(ch, x))
    assert dk.dslash_small_apply.launches == before
    assert not hasattr(small, "launches")
    assert dk._BINDINGS[small].counter is dk.dslash_small_apply
    assert dk._BINDINGS[small].launcher == "dslash_small_interleaved_launch"


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("nc, y_len, xh, bf16", [
    (8, 128, 64, False), (2, 512, 256, False), (8, 7, 4, False),
    (8, 256, 64, True)])
def test_refuses_what_small_fits_refuses(nc, y_len, xh, bf16, device):
    """Too large or odd in Y: refused on every device, at the call and at
    bind time, as the split entry refuses it."""
    assert not dk.small_fits(nc, y_len, xh, torch.bfloat16 if bf16 else None)
    x = torch.empty((2, y_len, xh, nc), dtype=torch.complex64, device=device)
    ch = torch.empty((5, 2, y_len, xh, nc, nc) + ((2,) if bf16 else ()),
                     dtype=torch.bfloat16 if bf16 else torch.complex64,
                     device=device)
    with pytest.raises(ValueError, match="exceed"):
        small(ch, x)
    with pytest.raises(ValueError, match="exceed"):
        dk.bind_apply(small, ch, x.shape)


@pytest.mark.parametrize("nc, y_len, xh", [(8, 64, 32), (2, 256, 128),
                                           (16, 8, 32)])
def test_meta_device_is_refused_where_the_shape_fits(nc, y_len, xh):
    assert dk.small_fits(nc, y_len, xh)
    x = torch.empty((2, y_len, xh, nc), dtype=torch.complex64, device="meta")
    ch = torch.empty((5, 2, y_len, xh, nc, nc), dtype=torch.complex64,
                     device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        small(ch, x)
    with pytest.raises(ValueError, match="unsupported device"):
        dk.bind_apply(small, ch, x.shape)


@pytest.mark.parametrize("bad", ["nc3", "dtype", "noncontig", "shape",
                                 "layout", "conj", "ch_dtype"])
def test_refuses_bad_input(bad):
    ch, x = _inputs(3 if bad == "nc3" else 2, 8, 4)
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "noncontig":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        ch = ch[:4]
    elif bad == "layout":
        x = dk.x_to_split(x)
    elif bad == "conj":
        x = torch.conj(x)
    elif bad == "ch_dtype":
        ch = ch.to(torch.complex128)
    with pytest.raises((TypeError, ValueError)):
        small(ch, x)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_bound_apply_is_the_wrapper_on_cpu(bf16):
    ch, x = _inputs(8, 8, 4, bf16=bf16, seed=3)
    before = dk.dslash_small_apply.launches
    apply = dk.bind_apply(small, ch, x.shape)
    assert torch.equal(apply(x), small(ch, x))
    assert dk.dslash_small_apply.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "noncontig", "conj"])
def test_bound_apply_holds_x_to_what_it_was_bound_to(bad):
    ch, x = _inputs(2, 8, 4)
    apply = dk.bind_apply(small, ch, x.shape)
    x = {"shape": x[:1], "dtype": x.to(torch.complex128),
         "noncontig": x.transpose(1, 2).contiguous().transpose(1, 2),
         "conj": torch.conj(x)}[bad]
    with pytest.raises(ValueError, match="bound to x of shape"):
        apply(x)


# --- the benchmark chain ---

@pytest.mark.parametrize("kernel", ["small", "small-split"])
@pytest.mark.parametrize("nc, size", [(8, 16), (2, 32)])
def test_dslash_chain_through_both_entries(capsys, kernel, nc, size):
    from qmg_tpu_torch.dslash import main, run
    main(["--size", str(size), "--kernel", kernel, "--nc", str(nc),
          "--iters", "3", "--device", "cpu"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["device"] == "cpu" and "gbs" not in r
    plain = run(size, "plain", nc, iters=3, device="cpu")["checksum"]
    assert abs(r["checksum"] - plain) <= 1e-5 * plain


def test_dslash_chain_small_split_refuses():
    from qmg_tpu_torch.dslash import main
    with pytest.raises(ValueError, match="exceed"):
        main(["--size", "128", "--kernel", "small-split", "--nc", "8",
              "--iters", "1", "--device", "cpu"])


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("nc, y_len, xh", SHAPES + [(4, 48, 32), (16, 2, 1)])
def test_kernel_matches_twin_and_split_entry_on_card(cuda_device, nc, y_len,
                                                     xh, bf16):
    ch, x = _inputs(nc, y_len, xh, cuda_device, bf16, seed=7)
    before = dk.dslash_small_apply.launches
    got = small(ch, x)
    torch.cuda.synchronize()
    assert dk.dslash_small_apply.launches == before + 1
    expect = dk.dslash_apply_plain(ch, x)
    assert float((got - expect).abs().max() / expect.abs().max()) <= 1e-5
    split = dk.dslash_small_apply(dk.channels_to_split(ch), dk.x_to_split(x))
    assert torch.equal(dk.x_from_split(split), got)
    assert torch.equal(dk.bind_apply(small, ch, x.shape)(x), got)
    assert dk.dslash_small_apply.launches == before + 3


@pytest.mark.cuda
def test_grid_fills_the_card(cuda_device):
    """At least as many blocks as SMs at 32^2 nc8, at least 8 at 8^2 nc8."""
    blocks, threads, sms = dk.small_grid(8, 32, 16)
    assert blocks >= sms and threads % 32 == 0
    assert blocks * threads >= 2 * 32 * 16 * 8 * 4
    assert dk.small_grid(8, 8, 4)[0] >= 8
    dk.empty_launch()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_misaligned_x_is_refused_on_card(cuda_device):
    ch, x = _inputs(1, 8, 4, cuda_device)
    flat = torch.empty(x.numel() + 1, dtype=torch.complex64,
                       device=cuda_device)
    shifted = flat[1:].view(x.shape).copy_(x)    # 8 bytes past 16 B alignment
    before = dk.dslash_small_apply.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        small(ch, shifted)
    with pytest.raises(ValueError, match="bound to x of shape"):
        dk.bind_apply(small, ch, x.shape)(shifted)
    assert dk.dslash_small_apply.launches == before
