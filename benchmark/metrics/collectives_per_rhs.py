"""Collectives this card launched a right-hand side: the program's
``qmg.mesh.*`` spans in its profiled solves, one a collective of
``parallel.Mesh``, summed over the kinds, over the fields those solves
solved."""

import collections

PREFIX = "qmg.mesh."


def by_kind(events) -> dict:
    """Kind (``halo``, ``sum``, ``gather``, ...) -> spans of that kind."""
    return dict(collections.Counter(
        name[len(PREFIX):] for name, _, _ in events["spans"]
        if name.startswith(PREFIX)))


def read(facts: dict):
    events = facts["spans"]
    n_rhs = facts["nrhs"] * sum(s["profiled"] for s in facts["solves"])
    if not events or not n_rhs:
        return None
    n = sum(by_kind(events).values())
    return n / n_rhs if n else None
