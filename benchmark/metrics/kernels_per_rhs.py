"""Device kernels (copies and fills left out) in the profiled solves, over
the right-hand sides they solved."""


def read(facts: dict):
    prof = facts["profile"]
    n_rhs = facts["nrhs"] * sum(s["profiled"] for s in facts["solves"])
    if not prof or not prof["n_kernels"] or not n_rhs:
        return None
    return prof["n_kernels"] / n_rhs
