"""Save and load a multigrid hierarchy (port of qmg_tpu/checkpoint.py, in
its version-3 ``.npz`` format, so that each package loads the other's
files).

One ``.npz`` holds every level's coefficients (``clover{l}``,
``hopping{l}``, ``shifts{l}``), the blocked null vectors ``nvb{l}`` in the
(nvec, 2c, B, Yc, Xhc) layout, the dense coarsest inverse
(``coarsest_dinv``), the deflation pairs (``coarsest_evals`` /
``coarsest_evecs``), a transfer's blocked restriction vectors
(``rnvb{l}``, asymmetric transfers) and saved block decompositions
(``chol{l}``, ``blockL{l}``, ``blockU{l}``) where it has them, all as
complex arrays, and ``__meta__``: a JSON record of the lattices, the
chirality of each level, the doubling of each transfer and the level and
coarsest solve configs. Versions 1 and 2 held the null vectors (and
restriction vectors) block-minor, (nvec, 2c, Yc, Xhc, B); they are
converted on load.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .lattice import Lattice2D
from .stencil import Stencil2D, StencilType, DefaultChirality, make_coeffs
from .transfer import TransferMG, DoublingType
from .stateful import StatefulMultigridMG, LevelSolveMG, CoarsestSolveMG
from .operators.coarse import CoarseOperator2D

__all__ = ["FORMAT_VERSION", "save_hierarchy", "load_hierarchy"]

FORMAT_VERSION = 3
# A transfer's optional arrays, by key prefix.
TRANSFER_EXTRAS = (("rnvb", "_restrict_nvb"), ("chol", "block_cholesky"),
                   ("blockL", "block_L"), ("blockU", "block_U"))


def _np(t):
    return t.detach().cpu().numpy()


def _config(obj) -> dict:
    return {k: (int(v) if isinstance(v, (StencilType, bool)) else v)
            for k, v in dataclasses.asdict(obj).items()}


def save_hierarchy(mg: StatefulMultigridMG, path: str):
    """Write ``mg`` to ``path`` (.npz, compressed)."""
    arrays = {}
    meta = {"version": FORMAT_VERSION, "n_levels": mg.get_num_levels(),
            "lattices": [], "level_solves": [], "chirality": []}
    for lvl in range(mg.get_num_levels()):
        lat = mg.get_lattice(lvl)
        meta["lattices"].append([lat.x_len, lat.y_len, lat.nc])
        st = mg.get_stencil(lvl)
        c = st.coeffs
        if c.clover is not None:
            arrays[f"clover{lvl}"] = _np(c.clover)
        if c.hopping is not None:
            arrays[f"hopping{lvl}"] = _np(c.hopping)
        arrays[f"shifts{lvl}"] = np.asarray(
            [complex(c.shift), complex(c.eo_shift), complex(c.dof_shift)])
        meta["chirality"].append(
            [bool(getattr(st, "is_chiral", False)),
             int(st.get_default_chirality()) if lvl > 0 else -1])
    for lvl in range(mg.get_num_levels() - 1):
        t = mg.get_transfer(lvl)
        arrays[f"nvb{lvl}"] = _np(t._nvb)
        for key, attr in TRANSFER_EXTRAS:
            if getattr(t, attr) is not None:
                arrays[f"{key}{lvl}"] = _np(getattr(t, attr))
        meta.setdefault("doubling", []).append(int(t.get_doubling()))
        meta["level_solves"].append(_config(mg.get_level_solve(lvl)))
    meta["coarsest"] = _config(mg.get_coarsest_solve())
    if mg.coarsest_dinv is not None:
        arrays["coarsest_dinv"] = _np(mg.coarsest_dinv)
    if mg.coarsest_evecs is not None:
        arrays["coarsest_evals"] = _np(mg.coarsest_evals)
        arrays["coarsest_evecs"] = _np(mg.coarsest_evecs)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_hierarchy(path: str, fine_stencil: Stencil2D, *, device="cuda"
                   ) -> StatefulMultigridMG:
    """Rebuild the hierarchy in ``path`` on ``device`` (the card unless the
    caller asks for another) around ``fine_stencil``, the caller's level-0
    operator (it owns the gauge field), which must live there and match
    the file's fine lattice. The coarse levels take their saved
    coefficients (no Galerkin build) in the fine stencil's dtype: qmg_tpu
    with 64-bit types on saves a complex64 hierarchy with some arrays in
    complex128 (the null vectors, a level's clover, the dense inverse),
    and one tensor dtype serves every level's fields."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["version"] not in (1, 2, FORMAT_VERSION):
        raise ValueError(f"checkpoint version {meta['version']} not in "
                         f"(1, 2, {FORMAT_VERSION})")
    device = torch.device(device)
    fine_dev = fine_stencil.coeffs.ref.device
    if fine_dev.type != device.type or (
            device.index is not None and fine_dev.index != device.index):
        raise ValueError(f"the fine stencil lives on {fine_dev}, the "
                         f"hierarchy is loaded on {device}")
    legacy_nvb = meta["version"] < 3
    lat0 = Lattice2D(*meta["lattices"][0])
    if lat0 != fine_stencil.lat:
        raise ValueError("fine stencil lattice does not match checkpoint")

    dtype = fine_stencil.coeffs.ref.dtype

    def tensor(key):
        return torch.as_tensor(data[key]).to(device=device, dtype=dtype)

    cs = CoarsestSolveMG(**{
        **meta["coarsest"],
        "coarsest_stencil_app": StencilType(
            meta["coarsest"]["coarsest_stencil_app"])})
    mg = StatefulMultigridMG(lat0, fine_stencil, cs)
    for lvl in range(1, meta["n_levels"]):
        lat = Lattice2D(*meta["lattices"][lvl])
        extras = {attr: tensor(f"{key}{lvl - 1}")
                  for key, attr in TRANSFER_EXTRAS
                  if f"{key}{lvl - 1}" in data}
        nvb = tensor(f"nvb{lvl - 1}")
        rnvb = extras.pop("_restrict_nvb", None)
        if legacy_nvb:
            nvb = torch.movedim(nvb, -1, 2).contiguous()
            if rnvb is not None:
                rnvb = torch.movedim(rnvb, -1, 2).contiguous()
        t = TransferMG.from_blocked(
            mg.get_lattice(lvl - 1), lat, nvb,
            doubling=DoublingType(meta["doubling"][lvl - 1]), rnvb=rnvb,
            **extras)
        shifts = data[f"shifts{lvl}"]
        clover = tensor(f"clover{lvl}") if f"clover{lvl}" in data else None
        coeffs = make_coeffs(
            lat, clover=clover,
            hopping=(tensor(f"hopping{lvl}") if f"hopping{lvl}" in data
                     else None),
            shift=shifts[0], eo_shift=shifts[1], dof_shift=shifts[2],
            dtype=dtype)
        is_chiral, dc = meta["chirality"][lvl]
        st = CoarseOperator2D.from_coeffs(coeffs, t, is_chiral=is_chiral)
        st._default_chirality = DefaultChirality(dc)
        lsd = dict(meta["level_solves"][lvl - 1])
        lsd["fine_stencil_app"] = StencilType(lsd["fine_stencil_app"])
        mg.push_level(lat, t, LevelSolveMG(**lsd), stencil=st)
    if "coarsest_dinv" in data:
        mg.coarsest_dinv = tensor("coarsest_dinv")
    if "coarsest_evecs" in data:
        mg.coarsest_evals = tensor("coarsest_evals")
        mg.coarsest_evecs = tensor("coarsest_evecs")
    return mg
