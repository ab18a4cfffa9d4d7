"""ctypes bindings for the C++ geometry kernels (root ``csrc/fastgeom.cpp``).

Builds the shared source with g++ on first use into this package's own
git-ignored ``build/`` directory (the JAX package keeps its library next to
the source; the two packages never share or overwrite a build).  Every entry
point has a pure-Python fallback, so a missing compiler degrades to the slow
path, never to a failure.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
SRC = os.path.join(os.path.dirname(_PKG), "csrc", "fastgeom.cpp")


def _build_and_load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = os.path.join(BUILD_DIR, "libfastgeom.so")
        if not os.path.exists(SRC):
            return None
        try:
            if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(SRC):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SRC, "-o", tmp],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, out)  # atomic: parallel test workers may race
            lib = ctypes.CDLL(out)
        except Exception as e:  # no toolchain / build failure -> fallback
            print(f"fastgeom native build unavailable ({e}); using Python paths",
                  file=sys.stderr)
            return None

        lib.fg_poisson_disk.restype = ctypes.c_int64
        lib.fg_poisson_disk.argtypes = [
            ctypes.c_double, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        lib.fg_knn.restype = None
        lib.fg_knn.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fg_block_color.restype = ctypes.c_int64
        lib.fg_block_color.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library built and loaded."""
    return _build_and_load() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def poisson_disk_native(
    r: float,
    seed: int,
    boundary_pts: np.ndarray | None,
    clearance: float,
    hole=(0.0, 0.0, -1.0),
    annulus=(-1.0, -1.0),
) -> np.ndarray | None:
    lib = _build_and_load()
    if lib is None:
        return None
    bp = np.ascontiguousarray(
        boundary_pts if boundary_pts is not None else np.zeros((0, 2)),
        dtype=np.float64,
    )
    cap = int(3.0 / (r * r)) + 1024
    out = np.empty((cap, 2), dtype=np.float64)
    n = lib.fg_poisson_disk(
        r, seed, _dptr(bp), bp.shape[0], clearance,
        hole[0], hole[1], hole[2], annulus[0], annulus[1],
        _dptr(out), cap,
    )
    return out[:n].copy()


def knn_native(
    points: np.ndarray,
    queries: np.ndarray,
    k: int,
    candidate_mask: np.ndarray | None = None,
) -> np.ndarray | None:
    """The ``k`` nearest of ``points`` [N, 2] to each of ``queries`` [M, 2]
    (int32 [M, k], nearest first, from the library's cell-grid search;
    only the points where ``candidate_mask`` is set, when given), or None
    without the library or for points that are not 2D."""
    lib = _build_and_load()
    if lib is None or points.shape[1] != 2:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    qry = np.ascontiguousarray(queries, dtype=np.float64)
    out = np.empty((qry.shape[0], k), dtype=np.int32)
    mask_p = None
    if candidate_mask is not None:
        cm = np.ascontiguousarray(candidate_mask.astype(np.uint8))
        mask_p = cm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib.fg_knn(
        _dptr(pts), pts.shape[0], _dptr(qry), qry.shape[0], k, mask_p,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def block_color_native(
    indptr: np.ndarray, indices: np.ndarray, n: int,
    block_rows: int, class_size: int,
) -> tuple[np.ndarray, int] | None:
    lib = _build_and_load()
    if lib is None:
        return None
    ip = np.ascontiguousarray(indptr, dtype=np.int64)
    ix = np.ascontiguousarray(indices, dtype=np.int32)
    perm = np.empty(n, dtype=np.int64)
    conflicts = lib.fg_block_color(
        ip.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ix.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, block_rows, class_size,
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return perm, int(conflicts)
