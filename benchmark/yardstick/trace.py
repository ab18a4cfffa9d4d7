"""Reading a ``torch.profiler`` trace of the card.

The busy share follows ``meshlessmultigridpoisson_torch/apps/cli.py``'s
``_device_profile`` at commit 57ee902 (CPU and CUDA activities; every event
on the device is device work), except that busy time is the union of the
device intervals, not their sum.  Also here: the device operations that
took most time, the idle gaps between device work by the host operation
that was running in them, and the device kernels launched inside named
profiler ranges (the program's launch-shape ranges).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

NAME_CHARS = 96  # kernel names are long C++ signatures


def profiled(fn):
    """Run ``fn()`` under the profiler; returns (its events, host seconds).
    ``fn`` ends with its own device synchronisation."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    return prof.events(), wall


def split(events):
    """(device intervals, host intervals): (name, start_us, end_us) each."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            dev.append(row)
        elif e.device_type == DeviceType.CPU and not e.is_async:
            host.append(row)
    return dev, host


def merged(intervals):
    """The union of (name, start, end) intervals as sorted (start, end)."""
    out = []
    for _, a, b in sorted(intervals, key=lambda r: r[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(dev) -> float:
    return sum(b - a for a, b in merged(dev)) / 1e6


def top_ops(dev, n: int = 10) -> list:
    """[[name, seconds], ...]: the ``n`` device operations with the most
    time, summed by name."""
    tot = defaultdict(float)
    for name, a, b in dev:
        tot[name[:NAME_CHARS]] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev, host, n: int = 10) -> list:
    """[[host operation, seconds], ...]: the time between device intervals,
    from the first device operation to the last, summed by the innermost
    host operation running at each gap's middle ("python" where none is),
    the ``n`` largest."""
    busy = merged(dev)
    host = sorted(host, key=lambda r: r[1])
    tot = defaultdict(float)
    stack, j = [], 0  # the host operations open at the sweep's point, nested
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        while j < len(host) and host[j][1] <= mid:
            while stack and stack[-1][2] < host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0][:NAME_CHARS] if stack else "python"
        tot[label] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def range_kernels(events, names) -> dict:
    """{range name: [(kernel name, device us), ...]}: the device work each
    occurrence of a profiler range named in ``names`` launched.  The
    profiler shows a range on the device too, from its first kernel's start
    to its last one's end: the kernels inside that interval are its own
    (one stream).  (The kernels it links to the range's host event are
    none: the program launches through ctypes, not through an operator.)"""
    from torch.autograd import DeviceType

    spans, kernels = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            row = (e.time_range.start, e.time_range.end, e.name)
            (spans if e.name in names else kernels).append(row)
    kernels.sort()
    starts = [k[0] for k in kernels]
    out = {}
    for a, b, name in spans:
        j = bisect.bisect_left(starts, a)
        while j < len(kernels) and kernels[j][0] <= b:
            if kernels[j][1] <= b:
                out.setdefault(name, []).append((kernels[j][2], kernels[j][1] - kernels[j][0]))
            j += 1
    return out
