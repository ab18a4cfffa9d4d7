"""Structured solve metrics (observability subsystem, SURVEY.md section 5).

The reference records residual histories in memory and prints them
(multigrid.cpp:66-69) or dumps txt files (testing_functions.cpp:311-327).
Here every run produces a structured record — residual history, cycle
counts, wall times, solve configuration — serializable to JSON, in the
reference package's schema.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import numpy as np


@dataclasses.dataclass
class SolveRecord:
    name: str
    config: dict[str, Any] = dataclasses.field(default_factory=dict)
    residual_history: list[float] = dataclasses.field(default_factory=list)
    cycles: int = 0
    wall_time_s: float = 0.0
    final_residual: float = float("nan")
    l1_error: float | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, default=_np_default)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
