"""Every input of a run, made on the device from ``--seed`` with one
``torch.Generator``, in a fixed order: the gauge field, the null-vector
seeds of each level, then the pool of right-hand sides. A configuration
that states ``setup_seed`` draws the gauge field and the null-vector
seeds from that seed instead, so that every run builds the same
hierarchy on the same gauge configuration, and ``--seed`` draws only the
pool. The same seed gives the same inputs; nothing is read from disk or
drawn on the host."""

from __future__ import annotations

import math

import torch


def _gaussian(gen, shape, dtype, device) -> torch.Tensor:
    """Complex gaussians of ``dtype`` with each real component N(0, 1)."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    return torch.view_as_complex(torch.randn(
        tuple(shape) + (2,), dtype=real, generator=gen, device=device))


def level_shapes(config: dict) -> list:
    """cv shape (2, Y, X/2, nc) of each level's lattice, finest first."""
    lat, kc = config["lattice"], config["kcycle"]
    x, y, nc = lat["x"], lat["y"], lat["nc"]
    shapes = [(2, y, x // 2, nc)]
    for _ in range(kc["n_refine"]):
        x, y, nc = x // kc["x_block"], y // kc["y_block"], kc["coarse_dof"]
        shapes.append((2, y, x // 2, nc))
    return shapes


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """gauge (2, 2, Y, X/2) complex128 U(1) links with phases N(0, 1/beta);
    seeds: per refinement, (coarse_dof / 2, *cv shape of the level above)
    complex128; pool (traffic["pool"], 2, Y, X/2, 2) complex64 sources.
    The gauge and the seeds come from ``config["setup_seed"]`` where the
    configuration states one, else from ``seed``."""
    if traffic["source"] != "gaussian":
        raise ValueError(f"unknown source kind {traffic['source']!r}")
    if traffic["pool"] % traffic["nrhs"]:
        raise ValueError("the pool must hold whole batches")
    setup_seed = config.get("setup_seed")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed if setup_seed is None else setup_seed))
    lat = config["lattice"]
    phases = torch.randn((2, 2, lat["y"], lat["x"] // 2),
                         dtype=torch.float64, generator=gen, device=device)
    phases *= 1.0 / math.sqrt(abs(config["operator"]["beta"]))
    gauge = torch.polar(torch.ones_like(phases), phases)
    shapes = level_shapes(config)
    n_half = config["kcycle"]["coarse_dof"] // 2
    seeds = [_gaussian(gen, (n_half,) + shapes[i], torch.complex128, device)
             for i in range(config["kcycle"]["n_refine"])]
    if setup_seed is not None:
        gen.manual_seed(int(seed))
    pool = _gaussian(gen, (traffic["pool"],) + shapes[0], torch.complex64,
                     device)
    return {"gauge": gauge, "seeds": seeds, "pool": pool}
