"""Card tests of the benchmark: the control comes out not correct, the
program correct, at a size a test run holds.

    python -m pytest benchmark/tests/test_benchmark_cuda.py -q -m cuda

Each drives ``benchmark.calibrate`` on a small cell: the program's stream on
three seeds and the control (the f64 outer pass lowered to float32) on
three others, every answer judged by the reference.  Without a card they
skip.
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import calibrate
from benchmark.tests.tiny import tiny_root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.dirichlet", "tiny.neumann", "tiny3d.dirichlet"])
def test_control_fails_where_the_program_passes(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    out = tmp_path / "readings.json"
    rc = calibrate.main(["--root", tiny_root(tmp_path / "root"), "--workload", cell,
                         "--seeds", "1", "2", "3", "--solves", "6",
                         "--control-seeds", "4", "5", "6", "--control-solves", "3",
                         "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert got["lower"] <= got["tol"] < got["upper"]
    assert got["upper"] >= 3 * got["lower"]
