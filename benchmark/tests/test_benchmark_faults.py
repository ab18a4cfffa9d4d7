"""A run whose timed path is broken underneath comes out not correct.

Each test drives a whole run of a small cell on the CPU (the harness's look
for a card skipped) with the port's ``solve_mixed_stepped`` replaced by a
faulty one, and sees ``correct`` come out false: a solve that returns its
state unchanged; an answer altered where it is produced (one interior
unknown by a millionth of the largest); every other solve
left out (its input returned), the first, third, ... call: set-up's
warm-up makes four, so the window's first solve is among them.  A cell on one card has no exchange between
chips to leave out.
"""

from __future__ import annotations

import pytest
import torch

from benchmark.run import execute
from benchmark.spec import Spec
from benchmark.tests.tiny import tiny_root


def _unchanged(real):
    def solve(op64, hd, x0, xl0, b, bl, **kw):
        return x0.clone(), xl0.clone(), 1, 0.0
    return solve


def _altered(real):
    def solve(op64, *a, **kw):
        x, xl, it, res = real(op64, *a, **kw)
        x = x.clone()
        i = int(torch.argmax(x.abs() * op64.smooth_mask))  # an interior unknown
        x[i] += 1e-6 * float(x.abs().max())
        return x, xl, it, res
    return solve


def _every_other_left_out(real):
    calls = [0]

    def solve(op64, hd, x0, xl0, b, bl, **kw):
        calls[0] += 1
        if calls[0] % 2 == 0:
            return real(op64, hd, x0, xl0, b, bl, **kw)
        return x0.clone(), xl0.clone(), 1, 0.0
    return solve


@pytest.mark.parametrize("cell", ["tiny.dirichlet", "tiny.neumann"])
@pytest.mark.parametrize("fault", [_unchanged, _altered, _every_other_left_out])
def test_a_broken_solve_is_not_correct(tmp_path, monkeypatch, cell, fault):
    from meshlessmultigridpoisson_torch.mg import mixed

    monkeypatch.setattr(mixed, "solve_mixed_stepped", fault(mixed.solve_mixed_stepped))
    line = execute(Spec(tiny_root(tmp_path)), cell, 11, 1.5, False, torch.device("cpu"))
    assert line["correct"] is False
    c = line["checks"]["residual_max"]
    assert not c["value"] <= c["limit"]
