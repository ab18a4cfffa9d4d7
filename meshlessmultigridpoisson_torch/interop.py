"""Carry multigrid operators and state across packages as numpy trees.

``hierarchy_from_numpy`` / ``state_from_numpy`` rebuild the port's
``Hierarchy`` / ``MGState`` from nested dicts of numpy arrays — the field
layout of the reference package's dataclasses (``Hierarchy`` -> levels,
restrict, prolong; ``LevelOperator`` -> A, bound, cond, ...; ``EllMatrix``
-> vals, lcols, win_start, diag + meta fields).  A reference hierarchy
converted leaf by leaf to numpy and then to dicts (``dataclasses.asdict``)
becomes a port hierarchy holding the SAME operators, so the port's solvers
can be held against the reference independently of setup parity.
``hierarchy_to_numpy`` / ``state_to_numpy`` go the other way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meshlessmultigridpoisson_torch.mg.vcycle import Hierarchy, MGState
from meshlessmultigridpoisson_torch.ops.ell import EllMatrix
from meshlessmultigridpoisson_torch.stencil.operators import CompactRows, LevelOperator


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _ell(d: dict) -> EllMatrix:
    return EllMatrix(
        vals=_t(d["vals"]), lcols=_t(d["lcols"]).to(torch.int32),
        win_start=_t(d["win_start"]).to(torch.int32), diag=_t(d["diag"]),
        nrows=int(d["nrows"]), ncols=int(d["ncols"]),
        block_rows=int(d["block_rows"]), win_size=int(d["win_size"]),
    )


def _compact(d: dict) -> CompactRows:
    return CompactRows(rows=_t(d["rows"]).to(torch.int32), ell=_ell(d["ell"]),
                       nrows=int(d["nrows"]))


_LEVEL_VECTORS = ("lag_col", "lag_row", "omega_scale", "smooth_mask",
                  "dirichlet_mask", "neumann_mask", "dirichlet_values",
                  "neumann_values")


def _level(d: dict) -> LevelOperator:
    return LevelOperator(
        A=_ell(d["A"]), bound=_compact(d["bound"]), cond=_compact(d["cond"]),
        **{k: _t(d[k]) for k in _LEVEL_VECTORS},
        row_map=_t(d["row_map"]).to(torch.int32),
        has_lagrange=bool(d["has_lagrange"]), implicit=bool(d["implicit"]),
        omega=float(d["omega"]), iters=int(d["iters"]),
        class_size=int(d["class_size"]), n=int(d["n"]),
    )


def hierarchy_from_numpy(tree: dict) -> Hierarchy:
    """Port ``Hierarchy`` (host tensors) from a nested dict of numpy arrays."""
    return Hierarchy(
        levels=tuple(_level(d) for d in tree["levels"]),
        restrict=tuple(_ell(d) for d in tree["restrict"]),
        prolong=tuple(_ell(d) for d in tree["prolong"]),
    )


def state_from_numpy(tree: dict) -> MGState:
    """Port ``MGState`` from a dict with x, x_lag, b, b_lag sequences."""
    return MGState(**{k: tuple(_t(v) for v in tree[k])
                      for k in ("x", "x_lag", "b", "b_lag")})


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return tuple(_to_numpy(v) for v in obj)
    return obj


def hierarchy_to_numpy(hier: Hierarchy) -> dict:
    """Nested dict of numpy arrays (the inverse of hierarchy_from_numpy)."""
    return _to_numpy(hier)


def state_to_numpy(state: MGState) -> dict:
    return _to_numpy(state)
