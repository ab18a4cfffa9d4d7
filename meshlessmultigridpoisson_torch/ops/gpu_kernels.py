"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Two kernels (sources in ``meshlessmultigridpoisson_torch/csrc/``) replace
the four Pallas TPU kernels on the Dirichlet solve path of the reference
package:

=================================  ===========================================
CUDA kernel (role counter)         TPU kernel it replaces
=================================  ===========================================
``ell_spmv`` (``spmv6``)           ops/kernels6.py ``spmv_tpu6``: coarsest
                                   matvec, restrictions, prolongations
``ell_spmv`` (``spmv8``)           ops/kernels8.py ``spmv_tpu8``: fine-level
                                   matvec (and the f64 outer residual)
``block_oneshot_sweep`` (sweep7)   ops/kernels6.py ``sor_sweep_tpu7``:
                                   storage-order block GS (coarsest level)
``block_oneshot_sweep`` (sweep8)   ops/kernels8.py ``sor_sweep_tpu8``:
                                   colored block GS (fine levels)
=================================  ===========================================

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
with a plain C interface (``build()``), at first launch, into this package's
git-ignored ``build/`` directory; loaded with ctypes.  Nothing here imports
a CUDA toolchain or touches the device at import time.

Wrapper discipline: a wrapper takes its kernel's plain PyTorch version only
when handed CPU tensors; for CUDA tensors it checks device, dtype, shape and
contiguity, launches on ``torch.cuda.current_stream()``, raises on a
non-zero ``cudaGetLastError()``, and adds one to its role's entry in
``COUNTS`` per launch.  There is no fallback from a failed launch.

Also here: the host-side prep ported from the reference package —
``build_oneshot_K`` (ops/kernels4.py) and ``color_blocks`` (ops/kernels8.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from meshlessmultigridpoisson_torch.ops.ell import EllMatrix, global_cols

LANES = 128  # rows per sweep block

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libmmp_kernels.so")
SOURCES = ("ell_spmv.cu", "block_oneshot_sweep.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launches per TPU-kernel role; reset with reset_counts()
COUNTS = {"spmv6": 0, "spmv8": 0, "sweep7": 0, "sweep8": 0}

_lock = threading.Lock()
_lib = None


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from source at first use")


def build(verbose: bool = False) -> str:
    """Compile the kernel library if missing or older than its sources.

    Returns the library path; ``verbose`` passes ``-Xptxas -v`` and returns
    after printing the compiler's register/shared-memory report.
    """
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    fresh = os.path.exists(LIB_PATH) and all(
        os.path.getmtime(LIB_PATH) >= os.path.getmtime(s) for s in srcs)
    if fresh and not verbose:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, LIB_PATH)  # atomic: concurrent processes may race
    return LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            for name in ("mmp_ell_spmv_f32", "mmp_ell_spmv_f64"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p, p, i, i, p, p, p]
            for name in ("mmp_block_sweep_f32", "mmp_block_sweep_f64"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p, p, i, p, p, p, p, p, i, i, p, p]
            _lib = lib
    return _lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name: str, t: torch.Tensor, device, dtype=None, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# ell_spmv
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceEll:
    """Row-major ELL with global int32 columns (padding: value 0).

    ``role`` names the TPU kernel whose part this matrix plays ("spmv6" for
    the coarsest level and the transfers, "spmv8" for colored levels).
    """

    vals: torch.Tensor  # [nrows_pad, width] f32 or f64
    cols: torch.Tensor  # [nrows_pad, width] int32
    ncols: int  # length of the x it multiplies
    role: str

    @property
    def nrows_pad(self) -> int:
        return self.vals.shape[0]

    @property
    def width(self) -> int:
        return self.vals.shape[1]


def device_ell(ell: EllMatrix, dtype, device, role: str) -> DeviceEll:
    if role not in ("spmv6", "spmv8"):
        raise ValueError(f"unknown SpMV role {role!r}")
    return DeviceEll(
        vals=ell.vals.to(device=device, dtype=dtype).contiguous(),
        cols=global_cols(ell).to(device=device, dtype=torch.int32).contiguous(),
        ncols=ell.ncols,
        role=role,
    )


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor):
    """Plain version of ``ell_spmv``: gather and sum."""
    return (vals * x[cols.long()]).sum(dim=1)


def ell_spmv(A: DeviceEll, x: torch.Tensor) -> torch.Tensor:
    """y = A x, [nrows_pad]; the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu" and A.vals.device.type == "cpu":
        return ell_spmv_plain(A.vals, A.cols, x)
    dev = A.vals.device
    if dev.type != "cuda" or A.vals.dtype not in _SUFFIX:
        raise ValueError(f"ell_spmv takes f32/f64 CUDA tensors, got "
                         f"{A.vals.dtype} on {dev}")
    _check("cols", A.cols, dev, torch.int32, A.vals.shape)
    _check("vals", A.vals, dev)
    _check("x", x, dev, A.vals.dtype, (A.ncols,))
    y = torch.empty(A.nrows_pad, dtype=x.dtype, device=dev)
    fn = getattr(_load(), f"mmp_ell_spmv_{_SUFFIX[x.dtype]}")
    rc = fn(A.vals.data_ptr(), A.cols.data_ptr(), A.width, A.nrows_pad,
            x.data_ptr(), y.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _launch_ok(rc, "ell_spmv")
    COUNTS[A.role] += 1
    return y


# ---------------------------------------------------------------------------
# block_oneshot_sweep
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockSweep:
    """Tables of one level's block Gauss-Seidel sweep.

    Phase p updates blocks ``order[phase_ptr[p]:phase_ptr[p+1]]``.  Colored
    (``serial=False``): one phase per color, blocks of a phase independent.
    Storage order (``serial=True``): one phase holding every block, walked
    in order, each block seeing the previous block's result.
    """

    A: DeviceEll  # the level's square matrix
    kT: torch.Tensor  # [nb, 128, 128] transposed one-shot matrices
    lagc: torch.Tensor  # [n_pad] Lagrange column
    order: torch.Tensor  # [nb] int32 block ids in execution order
    phase_ptr: tuple
    serial: bool
    role: str  # "sweep7" (storage order) or "sweep8" (colored)

    @property
    def nphases(self) -> int:
        return len(self.phase_ptr) - 1

    def phase(self, p: int) -> torch.Tensor:
        return self.order[self.phase_ptr[p]:self.phase_ptr[p + 1]]


def _oneshot_update(sw: BlockSweep, x, x_lag, b, ids: torch.Tensor) -> None:
    rows = (ids.long()[:, None] * LANES
            + torch.arange(LANES, device=ids.device)).reshape(-1)
    y = (sw.A.vals[rows] * x[sw.A.cols[rows].long()]).sum(dim=1)
    t = b[rows] - y - sw.lagc[rows] * x_lag
    dx = torch.bmm(t.view(-1, 1, LANES), sw.kT[ids.long()]).reshape(-1)
    x[rows] = x[rows] + dx


def block_oneshot_sweep_plain(sw: BlockSweep, x, x_lag, b) -> torch.Tensor:
    """Plain version: per phase a batched gather-sum, then ``torch.bmm``
    with the K blocks; the storage-order chain one block at a time.
    Updates ``x`` in place and returns it."""
    for p in range(sw.nphases):
        ids = sw.phase(p)
        if sw.serial:
            for j in range(ids.shape[0]):
                _oneshot_update(sw, x, x_lag, b, ids[j:j + 1])
        else:
            _oneshot_update(sw, x, x_lag, b, ids)
    return x


def block_oneshot_sweep(sw: BlockSweep, x, x_lag, b) -> torch.Tensor:
    """One full sweep (every phase) on ``x``, in place; returns ``x``."""
    if x.device.type == "cpu" and sw.kT.device.type == "cpu":
        return block_oneshot_sweep_plain(sw, x, x_lag, b)
    dev, dt = sw.kT.device, sw.kT.dtype
    if dev.type != "cuda" or dt not in _SUFFIX:
        raise ValueError(f"block_oneshot_sweep takes f32/f64 CUDA tensors, "
                         f"got {dt} on {dev}")
    n_pad = sw.A.nrows_pad
    nb = n_pad // LANES
    _check("kT", sw.kT, dev, dt, (nb, LANES, LANES))
    _check("vals", sw.A.vals, dev, dt)
    _check("cols", sw.A.cols, dev, torch.int32, sw.A.vals.shape)
    _check("lagc", sw.lagc, dev, dt, (n_pad,))
    _check("order", sw.order, dev, torch.int32, (nb,))
    _check("x", x, dev, dt, (n_pad,))
    _check("b", b, dev, dt, (n_pad,))
    xl = torch.as_tensor(x_lag, dtype=dt, device=dev).reshape(())
    _check("x_lag", xl, dev, dt, ())
    fn = getattr(_load(), f"mmp_block_sweep_{_SUFFIX[dt]}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for p in range(sw.nphases):
        ids = sw.phase(p)
        rc = fn(sw.A.vals.data_ptr(), sw.A.cols.data_ptr(), sw.A.width,
                b.data_ptr(), sw.lagc.data_ptr(), xl.data_ptr(),
                sw.kT.data_ptr(), ids.data_ptr(), ids.shape[0],
                int(sw.serial), x.data_ptr(), stream)
        _launch_ok(rc, "block_oneshot_sweep")
        COUNTS[sw.role] += 1
    return x


# ---------------------------------------------------------------------------
# host prep (ported from the reference package's numpy code)
# ---------------------------------------------------------------------------


def build_oneshot_K(
    ell: EllMatrix,
    omega_row: np.ndarray,
    smooth_mask: np.ndarray,
    class_size: int = 8,
) -> np.ndarray:
    """[nb, 128, 128] transposed one-shot matrices K^T (f64 host math).

    One (block, class, slot) GS sweep of a 128-row block is
    x += M^-1 (b - A x) with M = D/omega + L (L the strictly-lower
    class-block part of the in-block coupling); K = M^-1 per block, rows the
    smoother does not update zeroed (ops/kernels4.py:build_oneshot_K).
    """
    n_pad = ell.nrows_pad
    nb = n_pad // LANES
    gc = global_cols(ell).numpy().astype(np.int64)
    vv = ell.vals.numpy().astype(np.float64)
    diag = ell.diag.numpy().astype(np.float64)
    w = np.ones(n_pad)
    w[: omega_row.shape[0]] = np.asarray(omega_row, dtype=np.float64)
    m = np.zeros(n_pad, dtype=bool)
    m[: smooth_mask.shape[0]] = np.asarray(smooth_mask) > 0

    rows = np.arange(n_pad)[:, None]
    own = (gc >> 7) == (rows >> 7)
    in_mask = own & (gc != rows)
    abb = np.zeros((nb, LANES, LANES))
    bi, wi = np.nonzero(in_mask)
    np.add.at(abb, (bi >> 7, bi & 127, gc[bi, wi] & 127), vv[bi, wi])

    lane = np.arange(LANES)
    lower = (lane[:, None] // class_size) > (lane[None, :] // class_size)
    m2 = m.reshape(nb, LANES)
    diag2 = diag.reshape(nb, LANES)
    w2 = w.reshape(nb, LANES)
    K = np.empty((nb, LANES, LANES), dtype=np.float64)
    step = 512  # bounds the f64 temporaries at large nb
    for c0 in range(0, nb, step):
        c1 = min(c0 + step, nb)
        M = abb[c0:c1] * lower[None] * m2[c0:c1, :, None] * m2[c0:c1, None, :]
        M[:, lane, lane] = np.where(
            m2[c0:c1], diag2[c0:c1] / np.maximum(w2[c0:c1], 1e-30), 1.0
        )
        K[c0:c1] = torch.linalg.inv(torch.from_numpy(M)).numpy().transpose(0, 2, 1)
    K *= m2[:, None, :]  # masked rows never move (K is transposed)
    return K


def block_patches(gcols: np.ndarray, nb: int) -> np.ndarray:
    """[nb, gmax] x-patch (128-row block) lists read by each 128-row block.

    Built from every stored ELL entry, padding entries included, and padded
    by repeating the first patch — the same sets as the reference's
    ``prepare_kernel_ell6`` pids, so ``color_blocks`` gives the same colors.
    """
    pat = (np.asarray(gcols, dtype=np.int64) >> 7).reshape(nb, -1)
    lists = [np.unique(p) for p in pat]
    gmax = max(len(u) for u in lists)
    out = np.empty((nb, gmax), dtype=np.int64)
    for i, u in enumerate(lists):
        out[i, : u.size] = u
        out[i, u.size:] = u[0]
    return out


def color_blocks(pids: np.ndarray, nb: int) -> np.ndarray:
    """Greedy-color the block-coupling graph in storage order.

    ``pids``: [nb, gmax] per-block x-patch lists (padding slots repeat a
    real patch).  Blocks a, b conflict iff a reads x rows written by b or
    vice versa; the symmetric closure makes every color an independent set,
    so same-color blocks can be updated from a common snapshot with
    exact-GS semantics (ops/kernels8.py:color_blocks).
    """
    adj: list[set] = [set() for _ in range(nb)]
    for b in range(nb):
        for p in np.unique(pids[b]):
            p = int(p)
            if p != b and p < nb:
                adj[b].add(p)
                adj[p].add(b)  # symmetric closure
    colors = np.full(nb, -1, dtype=np.int64)
    for b in range(nb):  # storage (KD-tile) order keeps colors spatial
        used = {int(colors[a]) for a in adj[b] if colors[a] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[b] = c
    return colors


def colored_order(colors: np.ndarray) -> tuple[np.ndarray, tuple]:
    """Execution order (colors ascending, storage order within a color) and
    the phase offsets — the reference's ``ColoredSweep.block_order()`` with
    its duplicate padding dropped."""
    order = np.argsort(colors, kind="stable")
    counts = np.bincount(colors)
    ptr = (0, *np.cumsum(counts).tolist())
    return order, tuple(int(p) for p in ptr)
