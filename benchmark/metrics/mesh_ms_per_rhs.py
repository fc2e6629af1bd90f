"""Device time of the mesh's collectives a right-hand side: the device
operations launched under the program's ``qmg.mesh.*`` spans (halo
exchanges, inner-product sums, coarse-slab gathers; ``parallel.Mesh``) in
this card's profiled solves, waits for the other cards included, over
the fields those solves solved."""

from benchmark.spans import table

PREFIX = "qmg.mesh."


def read(facts: dict):
    events = facts["spans"]
    n_rhs = facts["nrhs"] * sum(s["profiled"] for s in facts["solves"])
    if not events or not n_rhs:
        return None
    rows = table(events["spans"], events["device"], events["launches"])[
        "rows"]
    seconds = sum(r["device_s"] for name, r in rows.items()
                  if name.startswith(PREFIX))
    return 1e3 * seconds / n_rhs if seconds else None
