"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``benchmark/configs/<config>.json`` (the
``file`` of its ``configs`` entry), its traffic mix
``benchmark/traffic/<traffic>.json``, the mix's driver
``benchmark/drivers/<driver>.py``, and each metric's reader
``benchmark/metrics/<metric name>.py`` with a ``read(ctx)`` that returns
the metric's number or None where the run holds nothing to read.  A new
cell, configuration, mix, driver or metric is new files and new entries:
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Spec:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.root, "benchmark", "traffic", f"{name}.json"))

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer ones
        (True): those whose ``workloads`` list it, or with no such list,
        every cell's (a per-layer metric: every cell that reports the
        end-to-end metric it moves)."""
        e2e = [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in names else [])]

    def reader(self, metric: str):
        return _module(os.path.join(self.root, "benchmark", "metrics", f"{metric}.py"),
                       "metric_" + metric)

    def driver(self, name: str):
        return _module(os.path.join(self.root, "benchmark", "drivers", f"{name}.py"),
                       "driver_" + name)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    mod_name = "benchmark_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod
