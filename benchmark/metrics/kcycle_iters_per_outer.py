"""Krylov iterations of the K-cycle's levels below the outer one
(``carry["iters"]`` on levels >= 1, summed) per outer iteration, over
every field the window solved."""


def read(facts: dict):
    inner = sum(n for s in facts["solves"] for n in s["coarse_iters"])
    outer = sum(n for s in facts["solves"] for n in s["outer_iters"])
    return inner / outer if outer else None
