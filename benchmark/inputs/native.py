"""The native Bridson sampler of the frozen cloud generators.

Frozen from ``meshlessmultigridpoisson_torch/geometry/native.py`` at commit
57ee902 (``poisson_disk_native`` only).  ``fastgeom.cpp`` beside this file is
built with g++ into ``benchmark/build/`` (git-ignored, a fixed path inside
the checkout), once per checkout.  Unlike the program's copy there is no
pure-Python fallback: its random stream differs from the native one, so a
fallback would hand the program other clouds than the seed names.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "fastgeom.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
LIB = os.path.join(BUILD_DIR, "libfastgeom.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(LIB) or os.path.getmtime(LIB) < os.path.getmtime(SRC):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{LIB}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, LIB)  # atomic: two processes may build at once
    lib = ctypes.CDLL(LIB)
    d, i64 = ctypes.c_double, ctypes.c_int64
    pd = ctypes.POINTER(ctypes.c_double)
    lib.fg_poisson_disk.restype = i64
    lib.fg_poisson_disk.argtypes = [d, ctypes.c_uint64, pd, i64, d, d, d, d, d, d, pd, i64]
    _lib = lib
    return lib


def poisson_disk_native(r: float, seed: int, boundary_pts: np.ndarray | None,
                        clearance: float, hole=(0.0, 0.0, -1.0),
                        annulus=(-1.0, -1.0)) -> np.ndarray:
    """Blue-noise samples [n, 2] in the unit square (min spacing ``r``),
    outside ``hole`` (cx, cy, radius; radius <= 0: none) and inside
    ``annulus`` (r_in, r_out; r_out <= 0: none), ``clearance`` away from
    ``boundary_pts``."""
    lib = _load()
    bp = np.ascontiguousarray(
        boundary_pts if boundary_pts is not None else np.zeros((0, 2)), dtype=np.float64)
    cap = int(3.0 / (r * r)) + 1024
    out = np.empty((cap, 2), dtype=np.float64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    n = lib.fg_poisson_disk(r, seed, ptr(bp), bp.shape[0], clearance, hole[0], hole[1],
                            hole[2], annulus[0], annulus[1], ptr(out), cap)
    return out[:n].copy()
