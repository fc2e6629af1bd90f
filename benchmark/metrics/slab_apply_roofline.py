"""Level 0's apply inside the K-cycle on a mesh, as a share of its HBM
roofline on one card: the compulsory bytes of the slab applies that the
card's profiled solves needed, over the card's HBM peak, over the device
time of the kernels that implement the apply (their names in
``slab_apply_roofline.json``).

The applies are the K-cycle's level-0 count (``carry["counts"]`` of level
0, smoothing and residual applies), as ``fine_apply_roofline`` counts
them; the outer GCR's exact matvec stays plain and is not counted. Bytes
are ``fine_apply_roofline.wilson_apply_bytes`` on the card's sites, plus,
where the mesh cuts y, both halo rows of each field: a row is 2 parities
x Xh sites x 16 B, read once. The count is the same whatever implements
the apply."""

import json
import os

from benchmark.metrics.fine_apply_roofline import (FIELD_BYTES,
                                                   wilson_apply_bytes)


def halo_bytes(xh: int) -> int:
    """Bytes of the two halo rows of one field: 2 rows x 2 parities x
    ``xh`` sites, one spinor each."""
    return 2 * 2 * xh * FIELD_BYTES


def kernel_names() -> list:
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "slab_apply_roofline.json")) as f:
        return json.load(f)["kernels"]


def read(facts: dict):
    prof, peaks, mesh = facts["profile"], facts["peaks"], facts["mesh"]
    if not prof or not peaks or not mesh:
        return None
    names = kernel_names()
    seconds = sum(s for name, s in prof["kernel_s"].items()
                  if any(n in name for n in names))
    profiled = [s for s in facts["solves"] if s["profiled"]]
    # One launch a slab applies every lane: the phases are read once.
    field_applies = sum(sum(s["level0_applies"]) for s in profiled)
    batch_applies = sum(max(s["level0_applies"]) for s in profiled)
    if not seconds or not field_applies:
        return None
    ny, nx = mesh
    sites = facts["sites"]
    slabs = ny * nx // facts["chips"]
    xh = facts["config"]["lattice"]["x"] // 2 // nx
    per_field = (wilson_apply_bytes(sites, 1) - wilson_apply_bytes(sites, 0)
                 + (slabs * halo_bytes(xh) if ny > 1 else 0))
    nbytes = (batch_applies * wilson_apply_bytes(sites, 0)
              + field_applies * per_field)
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / seconds
