"""Named ranges of the solve and the setup on the profiler's clock.

``span(name)`` is a context manager: while a ``torch.profiler`` session
collects on this thread, a host range ``name`` in its trace, beside the
operations and the device kernels that the range launches; otherwise one
shared no-op context, so a span costs one check of the profiler's state.
Nothing switches spans on but a profiler: ``kcycle --profile``, the
benchmark's ``--trace 1`` or a caller's own ``torch.profiler.profile``.

The ranges are recorded at function scope, as operators are, and not as
user annotations (``torch.profiler.record_function``): a user annotation
is also drawn on the device's timeline as a range over its kernels, which
a reader of device events would count as device work. A span changes no
arithmetic.

Names are fixed strings, built when the solver or K-cycle is made, with
levels indexed from 0, the finest:

  qmg.solve                     one whole (batched) solve
  qmg.apply.L{l}.{type}         an apply of level l's operator of
                                ``StencilType`` ``type`` (lower case)
  qmg.kcycle.L{l}               one K-cycle visit at level l
  qmg.smooth.pre.L{l}, qmg.smooth.post.L{l}
                                the smoothers
  qmg.restrict.L{l}, qmg.prolong.L{l}
                                the transfers, with the coarse level's
                                prepare and reconstruct
  qmg.coarse_solve.L{l}         the solve of level l in the K-cycle of
                                level l - 1: all of levels >= l
  qmg.readback                  a host read-back (``solvers.READBACKS``)
  qmg.setup.{stage}             a stage of the setup
  qmg.mesh.halo, qmg.mesh.sum, qmg.mesh.gather, qmg.mesh.digest
                                a collective of ``parallel.Mesh``: a ring
                                halo exchange, the ``all_reduce`` of an
                                inner product, the ``all_gather`` of a
                                coarse slab, the digest check of the
                                replicated levels
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span", "spanned"]

_OFF = contextlib.nullcontext()
_on = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """The range ``name`` while a profiler collects, else a shared
    no-op."""
    return _range(name) if _on() else _OFF


def spanned(name: str, fn):
    """``fn`` with each call inside ``span(name)``."""
    def run(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return run
