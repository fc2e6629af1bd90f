"""The generic stencil kernels' twins (K4 matrix, K5 split, K6 small)
against qmg_tpu's Pallas kernels, their channels and layouts, the
wrappers' routing and refusals, and (on a CUDA machine) the kernels
against their twins.

qmg_tpu's kernels run in interpret mode, whose tracing costs 2-6 s a
call at nc <= 2 and 23-60 s at nc = 8 on the CPU. So the twins meet the
Pallas kernels at nc <= 2 on every lattice but 32x32, and elsewhere
qmg_tpu's ``stencil.apply_M``, the function the kernels compute, to which
qmg_tpu's own tests hold its Pallas kernels at nc = 8
(tests/test_pallas_dslash.py). ``apply_M`` also serves where qmg_tpu's
kernel refuses a shape for a TPU reason (Y/2 % 8 for K5).

The kernel-vs-twin tests carry the ``cuda`` marker and skip where there
is no CUDA device.
"""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu import stencil as jstencil, u1 as ju1
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu.pallas_dslash import (
    make_pallas_dslash_shaped, make_pallas_dslash_split_shaped,
    make_pallas_dslash_small_shaped, _channels_from_coeffs,
    _channels_from_coeffs_split, x_to_planes, x_from_planes,
    x_to_planes_split, x_from_planes_split)
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D as TLattice2D
from qmg_tpu_torch.stencil import make_coeffs as tmake_coeffs
from qmg_tpu_torch import dslash_kernel as dk

torch.set_num_threads(1)

TOL = 5e-5          # x max|expected|, the bound of qmg_tpu's own tests
BF16_TOL = 1e-5     # relative: both packages round the same values
LATTICES = {"16x16": (16, 16), "32x32": (32, 32), "16x8": (16, 8),
            "2x2": (2, 2), "8x8": (8, 8)}
WRAPPERS = {"K4": dk.dslash_apply, "K5": dk.dslash_split_apply,
            "K6": dk.dslash_small_apply}


def _cfield(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _operator(op: str, lattice: str, clover=True):
    """(qmg_tpu coefficients, port coefficients, x) on the same numbers:
    Wilson at nc = 2, or random coefficients at nc = 1 or 8."""
    x_len, y_len = LATTICES[lattice]
    nc = {"wilson2": 2, "rand1": 1, "rand8": 8}[op]
    lat = Lattice2D(x_len, y_len, nc)
    rng = np.random.default_rng(sum(map(ord, op + lattice)))
    if op == "wilson2":
        g = ju1.gauss_gauge_u1(lat, JQMGRandom(1337), 6.0)
        jc = JWilson2D(lat, -0.07, jnp.asarray(g, jnp.complex64),
                       dtype=jnp.complex64).coeffs
        arrays = dict(clover=np.asarray(jc.clover),
                      hopping=np.asarray(jc.hopping))
        shifts = dict(shift=-0.07)
    else:
        arrays = dict(clover=_cfield(rng, lat.cm_shape()) if clover else None,
                      hopping=_cfield(rng, (4,) + lat.cm_shape()))
        shifts = dict(shift=-0.075, eo_shift=0.0, dof_shift=0.0)
        jc = jstencil.make_coeffs(
            lat, **{k: (None if v is None else jnp.asarray(v))
                    for k, v in arrays.items()},
            dtype=jnp.complex64, **shifts)
    tc = tmake_coeffs(TLattice2D(x_len, y_len, nc),
                      **{k: (None if v is None else torch.as_tensor(v))
                         for k, v in arrays.items()},
                      dtype=torch.complex64, **shifts)
    x = _cfield(rng, lat.cv_shape())
    return jc, tc, x


def _pallas_out(kind, jc, x, coeff_dtype=jnp.float32):
    """qmg_tpu's Pallas kernel (interpret mode) on x, complex (2, Y, Xh,
    nc); None where the kernel refuses the shape."""
    lat = jc.lat
    tile = 16 if coeff_dtype == jnp.bfloat16 else 8
    try:
        if kind == "K4":
            fn = make_pallas_dslash_shaped(lat.nc, lat.y_len, lat.xh,
                                           tile=tile, interpret=True,
                                           coeff_dtype=coeff_dtype)
        elif kind == "K5":
            fn = make_pallas_dslash_split_shaped(lat.nc, lat.y_len, lat.xh,
                                                 tile=tile, interpret=True,
                                                 coeff_dtype=coeff_dtype)
        else:
            fn = make_pallas_dslash_small_shaped(lat.nc, lat.y_len, lat.xh,
                                                 interpret=True,
                                                 coeff_dtype=coeff_dtype)
    except ValueError:
        return None
    if kind == "K4":
        ck, hk = _channels_from_coeffs(jc)
        to, back = x_to_planes, x_from_planes
    else:
        ck, hk = _channels_from_coeffs_split(jc)
        to, back = x_to_planes_split, x_from_planes_split
    out = fn(ck.astype(coeff_dtype), hk.astype(coeff_dtype),
             to(jnp.asarray(x)))
    return np.asarray(back(out))


def _port_out(kind, tc, x, coeff_dtype=None):
    """The port's wrapper on CPU tensors (its plain twin), (2, Y, Xh, nc)."""
    xt = torch.as_tensor(x)
    if kind == "K4":
        return dk.dslash_apply(dk.stencil_channels(tc, coeff_dtype),
                               xt).numpy()
    ch = dk.stencil_channels_split(tc, coeff_dtype)
    return dk.x_from_split(WRAPPERS[kind](ch, dk.x_to_split(xt))).numpy()


def _cases():
    for kind in ("K4", "K5", "K6"):
        lattices = ["16x16", "32x32", "16x8"] + (
            ["2x2", "8x8"] if kind == "K6" else [])
        for op in ("wilson2", "rand1", "rand8"):
            for lattice in lattices:
                yield kind, op, lattice


@pytest.mark.parametrize("kind, op, lattice", list(_cases()))
def test_twin_matches_qmg_tpu(kind, op, lattice):
    jc, tc, x = _operator(op, lattice)
    expect = None
    if op != "rand8" and lattice != "32x32":
        expect = _pallas_out(kind, jc, x)
    if expect is None:
        expect = np.asarray(jstencil.apply_M(jc, jnp.asarray(x)))
    got = _port_out(kind, tc, x)
    np.testing.assert_allclose(got, expect,
                               atol=TOL * np.max(np.abs(expect)))


@pytest.mark.parametrize("kind, lattice", [
    ("K4", "16x16"), ("K5", "32x32"), ("K6", "8x8"), ("K6", "2x2")])
def test_bf16_twin_matches_qmg_tpu(kind, lattice):
    """bf16 coefficient streams at nc = 2: the twin against qmg_tpu's bf16
    interpret kernel (the same rounded values, float32 accumulation), and
    within bf16 rounding of the exact apply."""
    jc, tc, x = _operator("wilson2", lattice)
    expect = _pallas_out(kind, jc, x, jnp.bfloat16)
    got = _port_out(kind, tc, x, torch.bfloat16)
    scale = np.max(np.abs(expect))
    assert np.max(np.abs(got - expect)) <= BF16_TOL * scale
    exact = np.asarray(jstencil.apply_M(jc, jnp.asarray(x)))
    assert np.max(np.abs(got - exact)) <= 3e-2 * scale


@pytest.mark.parametrize("op, clover", [("wilson2", True), ("rand8", True),
                                        ("rand1", False)])
def test_channels_match_qmg_tpu(op, clover):
    """stencil_channels equals _channels_from_coeffs exactly at
    complex64 (and bit for bit in bf16), in both layouts; a missing
    clover leaves the mass pattern."""
    jc, tc, _ = _operator(op, "16x16", clover=clover)

    def complex_of(planes, ri_axis):
        p = np.moveaxis(np.asarray(planes), ri_axis, -1)
        return p[..., 0] + 1j * p[..., 1]

    ck, hk = _channels_from_coeffs(jc)
    # (2, nc, nc, Y, Xh) -> (2, Y, Xh, nc, nc), likewise for hopping
    expect = np.concatenate([
        np.moveaxis(complex_of(ck, 3), (1, 2), (3, 4))[None],
        np.moveaxis(complex_of(hk, 4), (2, 3), (4, 5))])
    ch = dk.stencil_channels(tc)
    assert ch.dtype == torch.complex64 and ch.is_contiguous()
    np.testing.assert_array_equal(ch.numpy(), expect)

    cks, hks = _channels_from_coeffs_split(jc)
    expect_s = np.concatenate([
        np.moveaxis(complex_of(cks, 4), (2, 3), (4, 5))[None],
        np.moveaxis(complex_of(hks, 5), (3, 4), (5, 6))])
    np.testing.assert_array_equal(dk.stencil_channels_split(tc).numpy(),
                                  expect_s)

    bf = dk.stencil_channels(tc, torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and bf.shape == ch.shape + (2,)
    jbf = np.asarray(ck.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(
        bf[0].float().numpy(), np.moveaxis(jbf, (1, 2, 3), (3, 4, 5)))


def test_split_layout_round_trip():
    x = torch.as_tensor(_cfield(np.random.default_rng(5), (2, 12, 6, 8)))
    xs = dk.x_to_split(x)
    assert xs.shape == (2, 2, 6, 6, 8) and xs.is_contiguous()
    assert torch.equal(dk.x_from_split(xs), x)
    # row y = 2m + r of parity p is xs[p, r, m]
    assert torch.equal(xs[1, 1, 4], x[1, 9])
    planes = np.asarray(x_to_planes_split(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(
        np.moveaxis(planes[:, :, :, 0] + 1j * planes[:, :, :, 1], 2, -1),
        xs.numpy())
    with pytest.raises(ValueError, match="even Y"):
        dk.x_to_split(x[:, :5])


@pytest.mark.parametrize("nc, y_len, xh, bf16", [
    (8, 32, 16, False), (8, 64, 32, False), (8, 128, 64, False),
    (8, 128, 32, True), (8, 8, 4, False), (2, 256, 128, False),
    (2, 512, 256, False), (2, 2, 1, False), (16, 8, 32, False),
    (1, 6, 4, False), (8, 7, 4, False)])
def test_small_fits_matches_qmg_tpu(nc, y_len, xh, bf16):
    """small_fits accepts exactly what make_pallas_dslash_small_shaped
    accepts in interpret mode (which skips the TPU lane rule)."""
    try:
        make_pallas_dslash_small_shaped(
            nc, y_len, xh, interpret=True,
            coeff_dtype=jnp.bfloat16 if bf16 else jnp.float32)
        accepted = True
    except ValueError:
        accepted = False
    assert dk.small_fits(nc, y_len, xh,
                         torch.bfloat16 if bf16 else None) == accepted


def test_cpu_wrappers_take_the_twin_without_launch():
    _, tc, x = _operator("rand8", "8x8")
    xt = torch.as_tensor(x)
    ch, chs = dk.stencil_channels(tc), dk.stencil_channels_split(tc)
    before = [w.launches for w in WRAPPERS.values()]
    assert torch.equal(dk.dslash_apply(ch, xt), dk.dslash_apply_plain(ch, xt))
    xs = dk.x_to_split(xt)
    assert torch.equal(dk.dslash_split_apply(chs, xs),
                       dk.dslash_split_apply_plain(chs, xs))
    assert torch.equal(dk.dslash_small_apply(chs, xs),
                       dk.dslash_small_apply_plain(chs, xs))
    assert [w.launches for w in WRAPPERS.values()] == before


def _inputs(kind, nc, y_len, xh, device, bf16=False, seed=0):
    rng = np.random.default_rng(seed)
    ch = torch.as_tensor(_cfield(rng, (5, 2, y_len, xh, nc, nc)),
                         device=device)
    x = torch.as_tensor(_cfield(rng, (2, y_len, xh, nc)), device=device)
    if bf16:
        ch = torch.view_as_real(ch).to(torch.bfloat16).contiguous()
    if kind != "K4":
        ch, x = dk.channels_to_split(ch), dk.x_to_split(x)
    return ch, x


@pytest.mark.parametrize("kind", ["K4", "K5", "K6"])
@pytest.mark.parametrize("bad", ["nc3", "dtype", "noncontig", "shape",
                                 "layout"])
def test_wrappers_refuse_bad_input(kind, bad):
    nc = 3 if bad == "nc3" else 2
    ch, x = _inputs(kind, nc, 8, 4, "cpu")
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "noncontig":
        x = x.transpose(-2, -3).contiguous().transpose(-2, -3)
    elif bad == "shape":
        ch = ch[:4]
    elif bad == "layout":
        x = dk.x_from_split(x) if kind != "K4" else dk.x_to_split(x)
    with pytest.raises((TypeError, ValueError)):
        WRAPPERS[kind](ch, x)


@pytest.mark.parametrize("kind, shape, message", [
    ("K4", (2, 8192, 4096, 2), "unsupported device"),
    ("K4", (2, 8192, 4096, 8), "32-bit"),
    ("K5", (2, 2, 8192, 8192, 8), "32-bit"),
    ("K6", (2, 2, 64, 64, 8), "exceed"),
    ("K6", (2, 2, 16, 16, 8), "unsupported device")],
    ids=["K4_at_range", "K4_past_range", "K5_past_range", "K6_too_big",
         "K6_fits"])
def test_wrapper_size_guards(kind, shape, message):
    """Shape-only meta tensors: the 32-bit index guard and the small
    kernel's operand budget refuse on every device; shapes that pass meet
    the device check instead."""
    nc = shape[-1]
    x = torch.empty(shape, dtype=torch.complex64, device="meta")
    ch = torch.empty((5,) + shape + (nc,), dtype=torch.complex64,
                     device="meta")
    with pytest.raises(ValueError, match=message):
        WRAPPERS[kind](ch, x)


@pytest.mark.parametrize("kind", ["K4", "K5", "K6"])
def test_bound_apply_is_the_wrapper_on_cpu(kind):
    """bind_apply's function gives the wrapper's result, launches nothing
    on the CPU, and refuses an x of another shape."""
    ch, x = _inputs(kind, 2, 8, 4, "cpu", seed=3)
    before = WRAPPERS[kind].launches
    apply = dk.bind_apply(WRAPPERS[kind], ch, x.shape)
    assert torch.equal(apply(x), WRAPPERS[kind](ch, x))
    assert WRAPPERS[kind].launches == before
    with pytest.raises(ValueError, match="bound to x of shape"):
        apply(x[:1])


@pytest.mark.parametrize("kind, nc, y_len, xh, device, message", [
    ("K4", 3, 8, 4, "cpu", "nc=3"),
    ("K5", 2, 8, 4, "meta", "unsupported device"),
    ("K6", 8, 128, 64, "meta", "exceed")],
    ids=["nc3", "meta_device", "K6_too_big"])
def test_bind_apply_checks_once(kind, nc, y_len, xh, device, message):
    """bind_apply makes the wrapper's checks when it binds."""
    x = torch.empty((2, y_len, xh, nc), dtype=torch.complex64, device=device)
    ch = torch.empty((5, 2, y_len, xh, nc, nc), dtype=torch.complex64,
                     device=device)
    if kind != "K4":
        ch, x = dk.channels_to_split(ch), dk.x_to_split(x)
    with pytest.raises(ValueError, match=message):
        dk.bind_apply(WRAPPERS[kind], ch, x.shape)


TWIN_SHAPES = {"2x2": (2, 1), "16x8": (8, 8), "64x48": (48, 32),
               "ragged": (6, 5)}


@functools.lru_cache(maxsize=None)
def _exact_in_bf16(nc, y_len, xh):
    """(port coefficients, x, qmg_tpu's apply_M(x)) for random clover and
    hopping whose real and imaginary parts bf16 holds exactly, with no
    shifts: the bf16 channels are then the complex64 ones."""
    x_len = 2 * xh
    lat = Lattice2D(x_len, y_len, nc)
    rng = np.random.default_rng(100 * nc + 10 * y_len + xh)

    def exact(shape):
        parts = torch.view_as_real(torch.as_tensor(_cfield(rng, shape)))
        return torch.view_as_complex(parts.to(torch.bfloat16).float())

    clover, hopping = exact(lat.cm_shape()), exact((4,) + lat.cm_shape())
    jc = jstencil.make_coeffs(lat, clover=jnp.asarray(clover.numpy()),
                              hopping=jnp.asarray(hopping.numpy()),
                              dtype=jnp.complex64)
    tc = tmake_coeffs(TLattice2D(x_len, y_len, nc), clover=clover,
                      hopping=hopping, dtype=torch.complex64)
    x = _cfield(rng, lat.cv_shape())
    return tc, x, np.asarray(jstencil.apply_M(jc, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["K4", "K5"])
@pytest.mark.parametrize("nc", list(dk.SUPPORTED_NC))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(TWIN_SHAPES.values()),
                         ids=list(TWIN_SHAPES))
def test_twin_matches_apply_m_at_every_nc(kind, nc, bf16, shape):
    """K4's and K5's twins (what their wrappers run on the CPU, and what
    the card tests hold the kernels to) against qmg_tpu's ``apply_M`` at
    every nc, with complex64 and bf16 channels, on the card tests' shapes
    (2x2, 16x8, 64x48 and the ragged 10x6, an odd Xh)."""
    tc, x, expect = _exact_in_bf16(nc, *shape)
    got = _port_out(kind, tc, x, torch.bfloat16 if bf16 else None)
    np.testing.assert_allclose(got, expect,
                               atol=TOL * np.max(np.abs(expect)))


def test_apply_bytes_is_the_documented_count():
    """192 B a site at nc = 2 and 2688 B at nc = 8 with complex64
    coefficients, 112 B at nc = 2 with bf16 ones."""
    assert dk.apply_bytes(2, 1) == 192 and dk.apply_bytes(8, 1) == 2688
    assert dk.apply_bytes(2, 10, torch.bfloat16) == 1120


@pytest.mark.parametrize("kernel, nc", [("matrix", 2), ("split", 2),
                                        ("small", 8), ("wilson-r1", 2),
                                        ("plain", 8)])
def test_dslash_cli_on_cpu(capsys, kernel, nc):
    """The benchmark entry point on the CPU: every apply gives the plain
    chain's checksum; a CPU run reports no device metric."""
    import json
    from qmg_tpu_torch.dslash import main, run
    main(["--size", "16", "--kernel", kernel, "--nc", str(nc), "--iters",
          "3", "--device", "cpu"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["device"] == "cpu" and "gbs" not in r
    plain = run(16, "plain", nc, iters=3, device="cpu")["checksum"]
    assert abs(r["checksum"] - plain) <= 1e-5 * plain


def test_dslash_cli_refuses():
    from qmg_tpu_torch.dslash import main
    with pytest.raises(ValueError, match="exceed"):
        main(["--size", "128", "--kernel", "small", "--nc", "8",
              "--iters", "1", "--device", "cpu"])
    with pytest.raises(ValueError, match="nc = 2"):
        main(["--size", "16", "--kernel", "wilson-r1", "--nc", "8",
              "--iters", "1", "--device", "cpu"])
    with pytest.raises(ValueError, match="matrix kernels"):
        main(["--size", "16", "--kernel", "plain", "--coeff-dtype",
              "bfloat16", "--iters", "1", "--device", "cpu"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K4", "K5", "K6"])
@pytest.mark.parametrize("nc", list(dk.SUPPORTED_NC))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 8), (48, 32), (2, 1), (8, 32), (6, 5)],
                         ids=["16x8", "64x48", "2x2", "64x8", "ragged"])
def test_kernel_matches_twin_on_card(cuda_device, kind, nc, bf16, shape):
    y_len, xh = shape
    if kind == "K6" and not dk.small_fits(
            nc, y_len, xh, torch.bfloat16 if bf16 else None):
        pytest.skip("the small kernel does not take this shape")
    ch, x = _inputs(kind, nc, y_len, xh, cuda_device, bf16, seed=nc + y_len)
    wrapper = WRAPPERS[kind]
    before = wrapper.launches
    got = wrapper(ch, x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    plain = {"K4": dk.dslash_apply_plain, "K5": dk.dslash_split_apply_plain,
             "K6": dk.dslash_small_apply_plain}[kind]
    expect = plain(ch, x)
    err = float((got - expect).abs().max() / expect.abs().max())
    assert err <= 1e-5, err
    bound = dk.bind_apply(wrapper, ch, x.shape)
    assert torch.equal(bound(x), got)
    assert wrapper.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K4", "K5", "K6"])
@pytest.mark.parametrize("operand", ["x", "channels"])
def test_kernel_refuses_misaligned_view_on_card(cuda_device, kind, operand):
    """A contiguous view 8 bytes past a 16-byte boundary: the wrapper and
    bind_apply raise and launch nothing."""
    ch, x = _inputs(kind, 2, 8, 4, cuda_device, seed=7)
    t = x if operand == "x" else ch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
    view = buf[1:].view(t.shape).copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    if operand == "x":
        x = view
    else:
        ch = view
    wrapper = WRAPPERS[kind]
    before = wrapper.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        wrapper(ch, x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dk.bind_apply(wrapper, ch, x.shape)(x)
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K4", "K5"])
@pytest.mark.parametrize("nc, bf16", [(1, False), (1, True), (8, False)],
                         ids=["nc1-f32", "nc1-bf16", "nc8-f32"])
def test_rows_body_takes_element_aligned_views_on_card(cuda_device, kind,
                                                       nc, bf16):
    """Where a thread takes an output row (nc = 1, and nc = 8 with
    complex64 channels), K4 and K5 need one element's alignment: x 8 bytes
    and channels 8 (bf16: 4) bytes past a 16-byte boundary give what
    aligned copies give, through the wrapper and bind_apply."""
    ch, x = _inputs(kind, nc, 8, 4, cuda_device, bf16=bf16, seed=11)

    def shifted(t, elems):
        buf = torch.empty(t.numel() + elems, dtype=t.dtype,
                          device=cuda_device)
        return buf[elems:].view(t.shape).copy_(t)

    xv, chv = shifted(x, 1), shifted(ch, 2 if bf16 else 1)
    assert xv.data_ptr() % 16 == 8
    assert chv.data_ptr() % 16 == (4 if bf16 else 8)
    wrapper = WRAPPERS[kind]
    want = wrapper(ch, x)
    before = wrapper.launches
    assert torch.equal(wrapper(chv, xv), want)
    assert torch.equal(dk.bind_apply(wrapper, chv, xv.shape)(xv), want)
    assert wrapper.launches == before + 2
