"""Setup bundles, the solve's setup cache and solver checkpoints; txt vectors.

A file is one uncompressed ``np.savez``: every array of a tree of dicts,
lists and arrays under its path in the tree (``hierarchy/levels/0/A/vals``),
and under ``__manifest__`` a JSON document (its UTF-8 bytes as uint8)
holding the tree's structure, its scalar fields, the file's kind and, on a
setup bundle or cache, its ``build_config`` stamp: the arguments that
determine its contents.  Files load with ``np.load(allow_pickle=False)``.
The trees are those of ``interop`` (``hierarchy_to_numpy``,
``state_to_numpy``, ``fracstep_state_to_numpy``), so a file holds host
arrays whatever device its tensors were on, and loads as host tensors.

The reference package pickles a JAX treedef into its files
(``io/bundle.py:23-39`` there); neither package reads the other's files.
It only warns on a bundle without a stamp; loading here refuses one, as it
refuses a stamp that differs from the caller's arguments (``StampError``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from meshlessmultigridpoisson_torch import interop

MANIFEST = "__manifest__"
FORMAT = "meshlessmultigridpoisson_torch tree 1"


class StampError(ValueError):
    """A setup bundle stamped for other arguments, or not stamped at all."""


def npz_path(path: str) -> str:
    """``np.savez`` appends ``.npz`` to a path without it: save and load
    agree on the one name."""
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(obj, path: str, arrays: dict):
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        arrays[path] = obj
        return {"array": path}
    if isinstance(obj, dict):
        return {"dict": {k: _flatten(v, f"{path}/{k}", arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"list": [_flatten(v, f"{path}/{i}", arrays) for i, v in enumerate(obj)]}
    if isinstance(obj, np.generic):
        obj = obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"value": obj}
    raise TypeError(f"{path}: {type(obj).__name__} is not a tree leaf")


def _unflatten(node: dict, data):
    if "array" in node:
        return data[node["array"]]
    if "dict" in node:
        return {k: _unflatten(v, data) for k, v in node["dict"].items()}
    if "list" in node:
        return [_unflatten(v, data) for v in node["list"]]
    return node["value"]


def save_tree(path: str, kind: str, tree, build_config: dict | None = None) -> str:
    """Write ``tree`` as a file of ``kind``; returns the path written."""
    arrays: dict = {}
    manifest = {"format": FORMAT, "kind": kind, "build_config": build_config,
                "tree": _flatten(tree, kind, arrays)}
    arrays[MANIFEST] = np.frombuffer(json.dumps(manifest).encode(), np.uint8)
    path = npz_path(path)
    np.savez(path, **arrays)
    return path


def _read(path: str, build_config: dict | None):
    """(kind, tree) of a file; ``build_config``: the stamp it must carry."""
    path = npz_path(path)
    with np.load(path, allow_pickle=False) as data:
        if MANIFEST not in data.files:
            raise ValueError(f"{path} has no {MANIFEST}: not a file of this package")
        m = json.loads(bytes(data[MANIFEST]).decode())
        if m.get("format") != FORMAT:
            raise ValueError(f"{path} is in format {m.get('format')!r}, not {FORMAT!r}")
        if build_config is not None:
            _check_stamp(path, m["build_config"], build_config)
        return m["kind"], _unflatten(m["tree"], data)


def load_tree(path: str, kind: str, build_config: dict | None = None):
    """The tree of a file of ``kind``.  ``build_config``: the stamp the
    file must carry (``StampError`` if it has another or none)."""
    got, tree = _read(path, build_config)
    if got != kind:
        raise ValueError(f"{npz_path(path)} holds a {got!r}, not a {kind!r}")
    return tree


def _check_stamp(path: str, saved: dict | None, want: dict) -> None:
    want = json.loads(json.dumps(want))  # as the manifest holds it
    if saved is None:
        raise StampError(f"{path} carries no build_config stamp, so it cannot be "
                         f"validated against the arguments {want}: rebuild it")
    if saved != want:
        raise StampError(f"{path} was built for a different problem:\n  cached: {saved}\n"
                         f"  args:   {want}\nDelete it or point elsewhere.")


def _clouds_to_tree(clouds) -> list:
    return [dict(points=c.points, boundaries=list(c.boundaries), normals=c.normals,
                 geomtype=c.geomtype) for c in clouds]


def _clouds_from_tree(tree: list) -> list:
    from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud

    return [PointCloud(points=c["points"], boundaries=list(c["boundaries"]),
                       normals=c["normals"], geomtype=c["geomtype"]) for c in tree]


def save_bundle(path: str, hierarchy, clouds=None, *, build_config: dict) -> str:
    """Persist a host ``Hierarchy`` (and the ordered clouds) with its stamp."""
    return save_tree(path, "bundle", dict(
        hierarchy=interop.hierarchy_to_numpy(hierarchy),
        clouds=None if clouds is None else _clouds_to_tree(clouds)), build_config)


def load_bundle(path: str, build_config: dict):
    """(hierarchy, clouds or None) of a bundle stamped ``build_config``."""
    t = load_tree(path, "bundle", build_config)
    clouds = None if t["clouds"] is None else _clouds_from_tree(t["clouds"])
    return interop.hierarchy_from_numpy(t["hierarchy"]), clouds


def save_problem(path: str, prob, *, build_config: dict) -> str:
    """The setup cache: a host ``PoissonProblem`` (hierarchy, clouds, start
    state, exact solution, source) with its stamp."""
    return save_tree(path, "poisson_problem", dict(
        hierarchy=interop.hierarchy_to_numpy(prob.hierarchy),
        clouds=_clouds_to_tree(prob.clouds), state0=interop.state_to_numpy(prob.state0),
        exact=prob.exact, source=prob.source, neumann=prob.neumann,
        geomtype=prob.geomtype, k1=prob.k1, k2=prob.k2), build_config)


def load_problem(path: str, build_config: dict):
    """The ``PoissonProblem`` of a setup cache stamped ``build_config``."""
    from meshlessmultigridpoisson_torch.models.poisson import PoissonProblem

    t = load_tree(path, "poisson_problem", build_config)
    return PoissonProblem(
        hierarchy=interop.hierarchy_from_numpy(t["hierarchy"]),
        clouds=_clouds_from_tree(t["clouds"]),
        state0=interop.state_from_numpy(t["state0"]),
        exact=t["exact"], source=t["source"], neumann=t["neumann"],
        geomtype=t["geomtype"], k1=t["k1"], k2=t["k2"])


def save_state(path: str, state) -> str:
    """Checkpoint an ``MGState`` or a ``FracStepState`` (host arrays)."""
    from meshlessmultigridpoisson_torch.models.fracstep import FracStepState

    if isinstance(state, FracStepState):
        return save_tree(path, "FracStepState", interop.fracstep_state_to_numpy(state))
    return save_tree(path, "MGState", interop.state_to_numpy(state))


def load_state(path: str):
    """The ``MGState`` or ``FracStepState`` of a checkpoint, on the host."""
    kind, tree = _read(path, None)
    if kind == "FracStepState":
        return interop.fracstep_state_from_numpy(tree)
    if kind == "MGState":
        return interop.state_from_numpy(tree)
    raise ValueError(f"{npz_path(path)} holds a {kind!r}, not a solver state")


def write_vector_txt(vec, path: str) -> None:
    """One value a line (writeVectorToTxt, fileReadingFunctions.cpp:70-79)."""
    np.savetxt(path, np.asarray(vec).reshape(-1))


def read_vector_txt(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(-1)
