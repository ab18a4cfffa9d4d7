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


def bordered_residual(op, b, b_lag, x, x_lag) -> float:
    """Relative L1 residual of the bordered fine system, recomputed from
    (x, x_lag) with the plain f64 gather-sum SpMV on ``x``'s device (an
    independent check of a solve's reported residual):
    (||b - A x - lag_col x_lag||_1 + |b_lag - lag_row.x - x_lag|)
    / (||b||_1 + |b_lag|), Dirichlet rows as identity rows x = g.  ``op`` is
    the host f64 LevelOperator; without a border the border terms vanish."""
    import torch

    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops.ell import global_cols

    dev = x.device

    def f(v):
        return torch.as_tensor(v).to(device=dev, dtype=torch.float64)

    dmask = op.dirichlet_mask.to(dev) > 0
    b, b_lag, x_lag = torch.where(dmask, f(op.dirichlet_values), f(b)), f(b_lag), f(x_lag)
    y = gk.ell_spmv_plain(f(op.A.vals), global_cols(op.A).to(dev), x)
    r_lag = torch.zeros((), dtype=torch.float64, device=dev)
    if op.has_lagrange:
        y = y + f(op.lag_col) * x_lag
        r_lag = b_lag - (f(op.lag_row) * x).sum() - x_lag
    y = torch.where(dmask, x, y)
    return float(((b - y).abs().sum() + r_lag.abs())
                 / (b.abs().sum() + b_lag.abs()))
