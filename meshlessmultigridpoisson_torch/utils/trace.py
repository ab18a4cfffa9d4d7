"""The program's own spans and counters: set-up stages, one record a solve,
and the V-cycle's profiler ranges by level.

* ``SPANS``: host seconds of each stage of the last hierarchy build
  (``mg.setup.build_hierarchy``; ``SETUP_STAGES``, each summed over levels)
  and of the last repack (``REPACK_STAGES``: ``gpu_hierarchy``'s levels and
  transfers, the matvec-only outer operator, ``mixed.defect_hierarchy``).
  A new build replaces the last build's stages, a new ``gpu_hierarchy`` the
  last repack's.  Always on.
* ``SOLVES``: a ring of the last ``RING`` ``SolveTrace`` records, one a
  ``mg.mixed`` solve (``solve_mixed_stepped`` or ``solve_mixed``).  Always
  on: a record only wraps the device reads the solve already makes, with
  no device work, synchronisation or device allocation of its own.
* ``level_range``: a ``torch.profiler`` range around each level's part of
  a V-cycle, only while ``gpu_kernels.SHAPES`` is a dict (the program's one
  switch of profiler ranges), its name registered there as the launch
  shapes' are, its ends marked on the card by an empty kernel
  (``MARK_KERNEL``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time

import torch

from meshlessmultigridpoisson_torch.ops import gpu_kernels

SETUP_STAGES = ("setup.order", "setup.stencils", "setup.stabilize", "setup.transfers")
REPACK_STAGES = ("repack.levels", "repack.transfers", "repack.outer64", "repack.defect")
SPANS: dict[str, float] = {}

# a 51-s window of 2.5-ms solves (100 times a 0.25-s solve's rate) is 20,400
RING = 1 << 15


@dataclasses.dataclass(slots=True)
class SolveTrace:
    passes: int = 0  # outer defect-correction passes
    iters: int = 0  # BiCGStab iterations, summed over the passes
    escalations: int = 0  # inner solves escalated (tolerance / 10, cap x 2)
    rejected: int = 0  # passes rolled back: they made the residual worse
    capped: int = 0  # inner solves stopped at their cap above their tolerance
    vcycles: int = 0
    syncs: int = 0  # host reads of device values (``host_read``, ``input_copy``)
    blocked_s: float = 0.0  # host seconds spent in those reads
    wall_s: float = 0.0
    profiled: bool = False  # a torch.profiler was recording
    shapes: bool = False  # ``gpu_kernels.SHAPES`` was on


SOLVES: collections.deque = collections.deque(maxlen=RING)
_open: SolveTrace | None = None
_staged = [0, 0.0]  # input copies made before the next solve opened its record


def begin(stages) -> None:
    """A new build or repack: its stages start again from 0."""
    for name in stages:
        SPANS[name] = 0.0


def add(name: str, seconds: float) -> None:
    SPANS[name] = SPANS.get(name, 0.0) + seconds


@contextlib.contextmanager
def span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def solve():
    """The record of one solve, appended to ``SOLVES`` when it ends; it
    takes the input copies made since the last solve (``input_copy``)."""
    global _open
    rec = SolveTrace(syncs=_staged[0], blocked_s=_staged[1],
                     profiled=torch._C._autograd._profiler_enabled(),
                     shapes=gpu_kernels.SHAPES is not None)
    _staged[:] = [0, 0.0]
    outer, _open = _open, rec
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec.wall_s = time.perf_counter() - t0
        _open = outer
        SOLVES.append(rec)


def recorded(fn):
    """``fn`` (a solve) inside its own record (``solve``)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with solve():
            return fn(*args, **kwargs)
    return wrapper


def inner_pass(iters: int, capped: bool = False, rejected: bool = False) -> None:
    """One outer pass of the open solve, ``iters`` BiCGStab iterations;
    ``capped``: its inner solve stopped at its cap above its tolerance;
    ``rejected``: the pass was rolled back."""
    if _open is not None:
        _open.passes += 1
        _open.iters += iters
        _open.capped += capped
        _open.rejected += rejected


def escalation() -> None:
    """The open solve's inner solve escalated."""
    if _open is not None:
        _open.escalations += 1


def _blocked(seconds: float) -> None:
    if _open is None:
        _staged[0] += 1
        _staged[1] += seconds
    else:
        _open.syncs += 1
        _open.blocked_s += seconds


def host_read(t: torch.Tensor, as_type=float):
    """``as_type(t)``: a read of a device value, which waits for the device;
    counted and timed in the open solve's record."""
    if _open is None:
        return as_type(t)
    t0 = time.perf_counter()
    v = as_type(t)
    _blocked(time.perf_counter() - t0)
    return v


def input_copy(src: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``src.to(like)``.  From host memory to a card it is a pageable copy,
    which waits for the device: counted and timed in the open solve's
    record, or before any solve in the next one's."""
    if src.device == like.device:
        return src.to(like)
    t0 = time.perf_counter()
    out = src.to(like)
    _blocked(time.perf_counter() - t0)
    return out


def vcycle() -> None:
    if _open is not None:
        _open.vcycles += 1


def level_range(level: int, part: str, device):
    """The profiler range "vcycle L{level} {part}" (part: down, coarse or
    up) while ``gpu_kernels.SHAPES`` is a dict, else nothing.

    The profiler shows a range on the device from the first to the last
    kernel launched in it outside any range nested in it, and a level's
    first and last launches (its smoother calls, its transfers) are inside
    their own launch-shape ranges.  So on a card the range launches a
    kernel that returns at once (``MARK_KERNEL``) as it opens and as it
    closes: its projection then spans every kernel of the level's part."""
    shapes = gpu_kernels.SHAPES
    if shapes is None:
        return contextlib.nullcontext()
    name = f"vcycle L{level} {part}"
    shapes[name] = shapes.get(name, 0) + 1
    return _marked_range(name, torch.device(device).type == "cuda")


MARK_KERNEL = "spin_kernel"  # ``torch.cuda._sleep``'s kernel: not the solve's work


@contextlib.contextmanager
def _marked_range(name: str, cuda: bool):
    with torch.profiler.record_function(name):
        if cuda:
            torch.cuda._sleep(0)
        yield
        if cuda:
            torch.cuda._sleep(0)
