"""Outer flexible-GCR iterations per right-hand side: ``res.iters`` (per
lane in a batch), the mean over every field the window solved."""


def read(facts: dict):
    iters = [n for s in facts["solves"] for n in s["outer_iters"]]
    return sum(iters) / len(iters) if iters else None
