"""A checkout root holding small copies of the benchmark's cells, for tests.

``tiny_root(path)`` writes ``BENCHMARK.json`` with the real file's metrics
and three small cells (``tiny.dirichlet``, ``tiny.neumann`` on a 3-level
square-with-hole ladder at degree 4, ``tiny3d.dirichlet`` on a 2-level
cube), their configurations, and copies of the mixes, drivers and metric
readers, so ``Spec(path)`` finds everything the way a run does.
"""

from __future__ import annotations

import json
import os
import shutil

from benchmark.spec import ROOT

CELLS = ("tiny.dirichlet", "tiny.neumann", "tiny3d.dirichlet")


def tiny_root(path: str) -> str:
    path = str(path)
    bench = os.path.join(ROOT, "benchmark")
    for sub in ("traffic", "metrics", "drivers"):
        shutil.copytree(os.path.join(bench, sub), os.path.join(path, "benchmark", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(path, "benchmark", "configs"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        d = json.load(f)
    by_name = {c["name"]: c for c in d["configs"]}
    small = {"tiny": ("square_hole-150k", dict(sizes=[176, 640, 2532], block_rows=256),
                      dict(fine_poly_deg=4)),
             "tiny3d": ("box3d-1m", dict(sizes=[500, 2600], block_rows=256), {})}
    d["configs"] = []
    for name, (base, over, mg) in small.items():
        with open(os.path.join(ROOT, by_name[base]["file"])) as f:
            cfg = json.load(f)
        cfg.update(over)
        cfg["multigrid"] = dict(cfg["multigrid"], **mg)
        rel = f"benchmark/configs/{name}.json"
        with open(os.path.join(path, rel), "w") as f:
            json.dump(cfg, f)
        d["configs"].append(dict(by_name[base], name=name, file=rel, reduced=[]))
    d["workloads"] = [
        {"name": "tiny.dirichlet", "config": "tiny", "traffic": "dirichlet-rhs-stream",
         "chips": 1, "why": "test"},
        {"name": "tiny.neumann", "config": "tiny", "traffic": "neumann-rhs-stream",
         "chips": 1, "why": "test"},
        {"name": "tiny3d.dirichlet", "config": "tiny3d", "traffic": "dirichlet-rhs-stream",
         "chips": 1, "why": "test"}]
    for m in d["end_to_end"] + d["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w.replace("square_hole-150k", "tiny").replace("box3d-1m", "tiny3d")
                              for w in m["workloads"]]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(d, f, indent=1)
    return path
