"""Level 0's Wilson apply inside the K-cycle as a share of its HBM
roofline: the compulsory bytes of the applies the profiled solves needed,
over the card's HBM peak, over the device time of the kernels that
implement the apply (their names in ``fine_apply_roofline.json``).

The applies are the K-cycle's level-0 count (``carry["counts"]`` of level
0, smoothing and residual applies; the outer GCR's exact matvec stays
plain and is not counted). Bytes are the benchmark's own count,
``wilson_apply_bytes``, the same whatever implements the apply: each
input byte read once, each output byte written once. The inputs are the
two U(1) links of a site (U_x, U_y) and the field; a -x or -y hop reads
the neighbour's links, so a layout that stores four phases a site (K1's)
reads more than this count, by design."""

import json
import os

# The U(1) links of a site, U_x and U_y, complex64.
LINK_BYTES = 2 * 8
# One field's site: 2 spin components, complex64.
FIELD_BYTES = 2 * 8


def wilson_apply_bytes(sites: int, nrhs: int = 1) -> int:
    """Compulsory bytes of one Wilson apply to ``nrhs`` fields at once:
    the links read once, each field's x read once and y written once."""
    return sites * (LINK_BYTES + 2 * FIELD_BYTES * nrhs)


def kernel_names() -> list:
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "fine_apply_roofline.json")) as f:
        return json.load(f)["kernels"]


def read(facts: dict):
    prof, peaks = facts["profile"], facts["peaks"]
    if not prof or not peaks:
        return None
    names = kernel_names()
    seconds = sum(s for name, s in prof["kernel_s"].items()
                  if any(n in name for n in names))
    profiled = [s for s in facts["solves"] if s["profiled"]]
    # One launch per batched apply reads the links once for all lanes.
    field_applies = sum(sum(s["level0_applies"]) for s in profiled)
    batch_applies = sum(max(s["level0_applies"]) for s in profiled)
    if not seconds or not field_applies:
        return None
    sites = facts["sites"]
    nbytes = (batch_applies * wilson_apply_bytes(sites, 0)
              + field_applies * (wilson_apply_bytes(sites, 1)
                                 - wilson_apply_bytes(sites, 0)))
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / seconds
