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

``sharded_to_numpy`` gives the port's row-sharded hierarchy the same way.
``fracstep_problem_from_numpy`` / ``fracstep_state_from_numpy`` do the same
for the fractional-step problem and state (the reference package's
``FracStepProblem`` / ``FracStepState`` fields), so both packages step
identical operators.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meshlessmultigridpoisson_torch.config import FracStepConfig
from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud
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


def fracstep_state_from_numpy(tree: dict):
    """Port ``FracStepState`` from a dict of its fields (``mg``: as for
    ``state_from_numpy``)."""
    from meshlessmultigridpoisson_torch.models.fracstep import FracStepState

    return FracStepState(
        mg=state_from_numpy(tree["mg"]),
        **{k: _t(tree[k]) for k in ("u", "v", "u_old", "v_old", "u_hat", "v_hat")})


def fracstep_problem_from_numpy(tree: dict):
    """Port ``FracStepProblem`` from a dict of its fields: ``hierarchy`` /
    ``dx`` / ``dy`` / ``lap`` / ``state0`` as nested dicts of numpy arrays,
    ``clouds`` as dicts of PointCloud fields, ``config`` as a dict of
    FracStepConfig fields."""
    from meshlessmultigridpoisson_torch.models.fracstep import FracStepProblem

    clouds = [PointCloud(points=np.array(c["points"]),
                         boundaries=[np.array(b) for b in c["boundaries"]],
                         normals=np.array(c["normals"]), geomtype=c["geomtype"])
              for c in tree["clouds"]]
    return FracStepProblem(
        hierarchy=hierarchy_from_numpy(tree["hierarchy"]),
        clouds=clouds,
        dx=_ell(tree["dx"]), dy=_ell(tree["dy"]), lap=_ell(tree["lap"]),
        **{k: _t(tree[k]) for k in ("bmask", "u_bc", "v_bc", "normals")},
        config=FracStepConfig(**tree["config"]),
        state0=fracstep_state_from_numpy(tree["state0"]),
        compatible_ppe=bool(tree["compatible_ppe"]),
        lap_scale=float(tree["lap_scale"]),
    )


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


def sharded_to_numpy(shier) -> dict:
    """A ``parallel.partition.ShardedHierarchy`` as a nested dict of numpy
    arrays (its fields; ``sharded`` a tuple of level dicts, ``coarse`` and
    ``fine_op_cpu`` as ``hierarchy_to_numpy`` gives them) — the layout of
    the reference's ``ShardedHierarchy`` fields, for the tests."""
    return _to_numpy(shier)


def fracstep_state_to_numpy(state) -> dict:
    """Dict of a ``FracStepState``'s fields (``mg`` as ``state_to_numpy``;
    the inverse of fracstep_state_from_numpy)."""
    return _to_numpy(state)
