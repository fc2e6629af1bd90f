"""Port vs qmg_tpu on Stencil2D's helpers: clear_stencils, prune_stencils,
try_prune_stencils and print_stencil_site, on a Wilson operator."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D as JLattice2D
from qmg_tpu.operators import Wilson2D as JWilson2D
from qmg_tpu import u1 as ju1
from qmg_tpu.rng import QMGRandom as JQMGRandom

from qmg_tpu_torch.lattice import Lattice2D
from qmg_tpu_torch.operators import Wilson2D

torch.set_num_threads(1)

L = 8
MASS = -0.06
VARIANTS = ("original", "dagger", "rbjacobi", "rbj_dagger")


def _pair():
    """qmg_tpu's and the port's Wilson operator on one gauge field, with
    every derived set built."""
    gauge = ju1.gauss_gauge_u1(JLattice2D(L, L, 1), JQMGRandom(1337), 6.0)
    jop = JWilson2D(JLattice2D(L, L, 2), MASS, jnp.asarray(gauge))
    top = Wilson2D(Lattice2D(L, L, 2), MASS, gauge)
    for op in (jop, top):
        op.build_dagger_stencil()
        op.build_rbj_dagger_stencil()
    return jop, top


def _x():
    rng = np.random.default_rng(3)
    shape = Lattice2D(L, L, 2).cv_shape()
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _applies_agree(jop, top):
    x = _x()
    want = np.asarray(jop.apply_M(jnp.asarray(x)))
    got = top.apply_M(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    return got


def _derived_dropped(op):
    return not (op.built_dagger or op.built_rbjacobi or op.built_rbj_dagger)


def test_clear_stencils_matches_jax():
    jop, top = _pair()
    assert not _derived_dropped(top)
    jop.clear_stencils()
    top.clear_stencils()
    assert _derived_dropped(top) and _derived_dropped(jop)
    got = _applies_agree(jop, top)
    # Only the shifts are left: M x = m x on every site.
    np.testing.assert_allclose(got, complex(top.coeffs.shift) * _x(),
                               rtol=0, atol=1e-14)
    assert float(top.coeffs.clover.abs().max()) == 0.0


@pytest.mark.parametrize("clover, hopping",
                         [(True, False), (False, True), (True, True)])
def test_prune_stencils_matches_jax(clover, hopping):
    jop, top = _pair()
    jop.prune_stencils(clover=clover, hopping=hopping)
    top.prune_stencils(clover=clover, hopping=hopping)
    assert _derived_dropped(top)
    assert (top.coeffs.clover is None) == clover
    assert (top.coeffs.hopping is None) == hopping
    _applies_agree(jop, top)


def test_prune_nothing_keeps_derived_sets():
    _, top = _pair()
    top.prune_stencils()
    assert top.built_dagger and top.built_rbj_dagger


@pytest.mark.parametrize("side", [0.5, 2.0])
def test_try_prune_stencils_on_each_side(side):
    """A tolerance just below a piece's max keeps it, just above drops
    it; both packages agree."""
    jop, top = _pair()
    hop_max = float(top.coeffs.hopping.abs().max())
    clover_max = float(top.coeffs.clover.abs().max())
    tol = side * hop_max
    jop.try_prune_stencils(tol, clover=False)
    top.try_prune_stencils(tol, clover=False)
    assert (top.coeffs.hopping is None) == (side > 1)
    assert (jop.coeffs.hopping is None) == (side > 1)
    assert top.coeffs.clover is not None
    assert _derived_dropped(top) == (side > 1)
    _applies_agree(jop, top)
    top.try_prune_stencils(side * clover_max)
    assert (top.coeffs.clover is None) == (side > 1)


_NUM = re.compile(r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|nan|inf)j?")


def _printed(op, which, x, y):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        op.print_stencil_site(x, y, prefix="> ", which=which)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("which", VARIANTS)
@pytest.mark.parametrize("site", [(0, 0), (3, 6)])
def test_print_stencil_site_matches_jax(which, site):
    """The same lines: the same labels in the same order, and the same
    numbers to 1e-12."""
    jop, top = _pair()
    want = _printed(jop, which, *site)
    got = _printed(top, which, *site)
    assert len(got) == len(want) and len(got) > 5
    for g, w in zip(got, want):
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        gv = [complex(v) for v in re.findall(r"\([^)]*\)", g)]
        wv = [complex(v) for v in re.findall(r"\([^)]*\)", w)]
        assert len(gv) == len(wv)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-12)
    if which.startswith("rbj"):
        assert got[-3] == "> Right Block Jacobi Inv Clover"
    else:
        assert got[0].startswith("> Shift")


def test_print_stencil_site_refuses_unknown_variant():
    _, top = _pair()
    with pytest.raises(ValueError, match="variant"):
        top.print_stencil_site(0, 0, which="schur")
