"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Twelve kernels (seven sources in ``meshlessmultigridpoisson_torch/csrc/``)
replace fourteen Pallas TPU kernels of the reference package and eight of
its timing probes:

=================================  ===========================================
CUDA kernel (role counter)         TPU kernel it replaces
=================================  ===========================================
``ell_spmv`` (``spmv6``)           ops/kernels6.py ``spmv_tpu6``: coarsest
                                   matvec, restrictions, prolongations (and
                                   every matvec of ``--sweep-order exact``);
                                   ``ell_spmv_blk``: a CTA a 128-row block,
                                   each row read to ``lens``, i32 or u16
                                   columns
``ell_spmv`` (``spmv8``)           ops/kernels8.py ``spmv_tpu8``: fine-level
                                   matvec (and the f64 outer residual)
``ell_spmv`` (``spmv_rowwarp``)    the parent design of the SpMV roles (a
                                   warp a row over the full width, 8 rows a
                                   CTA; timing only: ``chip_smoke.py``)
``storage_chain`` (``sweep6``)     ops/kernels6.py:515 ``sor_sweep_tpu6``:
                                   storage-order block GS on levels whose
                                   8-block union exceeds 32 x patches; one
                                   CTA, K and ELL rows fetched ahead
``block_oneshot_sweep``            the parent design of ``sweep6``, the
(``sweep6_chain``)                 single-CTA chain (timing only)
``storage_chain``'s cluster        ops/kernels6.py:812 ``sor_sweep_tpu7(
kernel (``sweep7_stale``)          stale_program=True)``: storage-order
                                   block GS whose groups of 8 blocks read
                                   x as the group began (``stale_sweep``;
                                   ``probes.rho``; no solve runs it); 8
                                   CTAs, CTA j a group's block j
``storage_chain`` mode kStale      the parent design of ``sweep7_stale``:
(``sweep7_stale_walk``)            one CTA walks a group's blocks in turn
                                   (timing only)
``coarse_smooth`` (sweep7)         ops/kernels6.py:812 ``sor_sweep_tpu7``:
                                   storage-order block GS (coarsest level);
                                   a smoother call in one CTA, the level in
                                   shared memory (``block_smooth``)
``colored_smooth`` (sweep8)        ops/kernels8.py:428 ``sor_sweep_tpu8``:
                                   colored block GS (fine levels); a
                                   smoother call in one cooperative launch
                                   (``block_smooth``)
``block_oneshot_sweep``            ops/kernels8.py:428 ``sor_sweep_tpu8`` as
(``sweep8_percolor``)              the parent design ran it, one launch per
                                   color (timing only: the bench and
                                   ``chip_smoke.py``)
``compact_rows`` (``bound2``)      ops/kernels.py ``spmv_tpu2``: Neumann
                                   boundary-row re-solve where no fused
                                   smoother launch holds it (a Krylov or
                                   outer solve's last; the V-cycle's on a
                                   ``smooth_loop`` level), rows read to
                                   ``lens``
``compact_rows`` (``push2``)       ops/kernels.py ``spmv_tpu2``: condensation
                                   pushdown of the right-hand side
``ppe_tail`` (``ppe2``)            ops/kernels.py ``spmv_tpu2``: the compatible
                                   NS pressure matvec's Neumann rows
                                   (models/fracstep_tpu.py ``_mv32``) and the
                                   rest of the matvec after its SpMVs, one
                                   launch (``csrc/compact_rows.cu``)
``compact_rows``                   the parent design of ``ppe2``: the rows'
(``ppe2_scatter``)                 scatter alone, the rest in separate
                                   launches (``ppe_tail_loop``; timing only)
``stream_ceiling`` (``stream14``)  bench.py:118 ``stream_ceiling``: the
                                   kernel bench's device-memory stream probe
``class_sor_sweep`` (``sweep2``)   ops/kernels.py:586 ``sor_sweep_tpu2``: the
                                   v2-fallback level smoother (no K); one
                                   CTA, a chain warp on shared memory,
                                   the bulk terms a window ahead
``class_sor_sweep``                the parent design of the class-sweep
(``sweep2_tilewalk``)              roles (one warp a row, every load on
                                   the chain; timing only)
``class_sor_sweep`` (``sweep4``)   ops/kernels4.py:464 ``sor_sweep_tpu4``:
                                   the same class sweep (``probes.ktime``)
``ell_spmv`` (``spmv2``)           ops/kernels.py:510 ``spmv_tpu2``: the
                                   v2-fallback level matvec and transfers
``ell_spmv`` (``spmv4``)           ops/kernels4.py:383 ``spmv_tpu4``
                                   (``probes.ktime``)
``storage_chain`` (``sweep5``)     ops/kernels4.py:620 ``sor_sweep_tpu5``:
                                   the storage-order one-shot sweep at
                                   128-row blocks (``probes.ktime``)
``ell_spmv`` (``spmv1``)           ops/kernels.py:222 ``spmv_tpu``: the v1
                                   windowed class-interleaved ELL
                                   (``probes.kexp``)
``ell_spmv`` (``spmv3``)           ops/kernels.py:669 ``spmv_tpu3``: patch
                                   tables gathered outside the kernel on
                                   the TPU, inside it here (``probes.kexp``)
``class_sor_sweep`` (``sweep1``)   ops/kernels.py:303 ``sor_sweep_tpu``: the
                                   v1 (block, class) GS, kernel 7's function
                                   (``probes.kexp``)
``storage_chain``                  scripts/ksweepprobe.py:110
(``probe_base``, ``probe_hoist``,  ``make_sweep_variant``: the
``probe_nodot``,                   storage-order sweep (``sweep6``'s f32
``probe_nogather``)                instance), the stale sweep (``probe_hoist``,
                                   ``sweep7_stale``'s f32 instance) and the
                                   timing-only variants (``sweep_probe``;
                                   ``probes.ksweepprobe``)
``stream_ceiling``                 scripts/kstream.py:61 ``make_stream``: the
(``kstream_f32i32``,               stream over four table mixes
``kstream_f32f32``,                (``stream_probe``; ``probes.kstream``)
``kstream_f32``,
``kstream_f32i16``)
``stream_ceiling``                 scripts/kprobe.py:54 ``stream_bench``
(``kprobe_stream``)                (``probes.kprobe``)
``stream_ceiling``                 scripts/chaintime.py:104 ``make_stream``
(``chain_stream``)                 (``probes.chaintime``)
``ell_spmv`` (``spmvp_base``,      scripts/kprobe.py:138 ``spmv4_variant``:
``spmvp_nogather``,                the SpMV and its timing-only variants
``spmvp_noreduce``,                without the x gather, the row reduction
``spmvp_neither``)                 or both (``spmv_probe``; ``probes.kprobe``)
``ell_spmv`` u16 / i32 columns,    scripts/kiso6.py:98 ``spmv_var``: i16 or
id table padded with -1, guarded   i32 columns, ``pl.when``-guarded or
or unguarded (``kiso6_i16_*``,     unguarded padded blocks (``kiso_spmv``;
``kiso6_i32_*``)                   ``probes.kiso6``)
``ell_spmv`` affine or id-table    scripts/kiso7.py:86 ``spmv_var``: affine
rows (``kiso7_affine``,            block ids or ids from a prefetched table
``kiso7_ids``)                     (``kiso_spmv``; ``probes.kiso7``)
``ell_rowsum_mma`` 2 / 1 TF32      scripts/kiso8.py:136 ``spmv_var``: row
passes (``kiso8_mxu``,             sums by the MXU at HIGHEST / DEFAULT,
``kiso8_mxudef``); ``ell_spmv``    or by VPU rolls (``kiso_spmv``;
(``kiso8_vpu``)                    ``probes.kiso8``)
``ell_rowsum_mma`` parent design   the same two (rows read straight from
(``kiso8_mxu_v1``,                 device memory; timing only)
``kiso8_mxudef_v1``)
=================================  ===========================================

The sweep takes K in f32, f64, or bf16 with f32 vectors (``--fast-k``) in
all its roles.  A smoother call (``mg.gpu_backend.smooth``: ``iters``
sweeps, each followed by the Lagrange relax and the Neumann re-solve; on
request the V-cycle's re-solve and Dirichlet pin before the first sweep
and one more re-solve after the last) on a ``sweep8`` or ``sweep7`` level
is one launch of ``block_smooth``; its plain version is ``smooth_loop``
over the plain kernels, the loop of separate launches that still runs
``sweep6`` (one ``storage_chain`` launch a sweep) and the class sweeps.

``ell_spmv`` reads each row only to ``DeviceEll.lens`` (one past its last
nonzero); a table no sweep reads (the transfers, the f64 outer operator)
holds u16 column offsets from a per-block base where every 128-row block
spans at most 65,535 columns (``device_ell(..., u16=True)``), int32
columns otherwise.  The SpMV probes (``spmvp_*``, ``kiso*``) time the
parent design.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a``, one process per
source started together, linked into a shared library with a plain C
interface (``build()``), at first launch, into this package's
git-ignored ``build/`` directory; loaded with ctypes.  Nothing here imports
a CUDA toolchain or touches the device at import time.

Wrapper discipline: a wrapper takes its kernel's plain PyTorch version only
when handed CPU tensors; for CUDA tensors it checks device, dtype, shape and
contiguity, launches on ``torch.cuda.current_stream()``, raises on a
non-zero ``cudaGetLastError()``, and adds one to its role's entry in
``COUNTS`` per launch.  There is no fallback from a failed launch.

Also here: the host-side prep ported from the reference package —
``build_oneshot_K`` (ops/kernels4.py), ``color_blocks`` (ops/kernels8.py),
``union_slots`` (the kind rule of ops/kernels6.py's union tables) and
``v6_supported`` (the rule by which ops/kernels6.py's layout takes or
refuses an operator, which decides v6 or v2-fallback) and
``colored_refusal`` (ops/kernels8.py ``prepare_colored_sweep``'s refusals,
which decide colored or storage order).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from meshlessmultigridpoisson_torch.ops.ell import EllMatrix, global_cols

LANES = 128  # rows per sweep block
MAX_ENTRIES = 2**31 - 1  # the SpMV and chain kernels' int32 entry offsets

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libmmp_kernels.so")
SOURCES = ("ell_spmv.cu", "block_oneshot_sweep.cu", "compact_rows.cu",
           "stream_ceiling.cu", "class_sor_sweep.cu", "block_smooth.cu",
           "storage_chain.cu")
HEADERS = ("block_sweep_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# launches per TPU-kernel role; reset with reset_counts()
COUNTS = {"spmv6": 0, "spmv8": 0, "sweep6": 0, "sweep7": 0, "sweep8": 0,
          "sweep8_percolor": 0, "spmv_rowwarp": 0, "sweep6_chain": 0,
          "sweep7_stale": 0, "sweep7_stale_walk": 0,
          "bound2": 0, "push2": 0, "ppe2": 0, "ppe2_scatter": 0, "stream14": 0,
          "sweep2": 0,
          "sweep2_tilewalk": 0,
          "sweep4": 0, "spmv2": 0, "spmv4": 0, "sweep5": 0, "spmv1": 0,
          "spmv3": 0, "sweep1": 0, "probe_base": 0, "probe_hoist": 0,
          "probe_nodot": 0, "probe_nogather": 0, "kstream_f32i32": 0,
          "kstream_f32f32": 0, "kstream_f32": 0, "kstream_f32i16": 0,
          "kprobe_stream": 0, "chain_stream": 0, "spmvp_base": 0,
          "spmvp_nogather": 0, "spmvp_noreduce": 0, "spmvp_neither": 0,
          "kiso6_i16_guarded": 0, "kiso6_i16_unguarded": 0, "kiso6_i32_guarded": 0,
          "kiso6_i32_unguarded": 0, "kiso7_affine": 0, "kiso7_ids": 0,
          "kiso8_mxu": 0, "kiso8_mxudef": 0, "kiso8_vpu": 0,
          "kiso8_mxu_v1": 0, "kiso8_mxudef_v1": 0}
SPMV_ROLES = ("spmv6", "spmv8", "spmv2", "spmv4", "spmv1", "spmv3")
SPMV_PARENT = "spmv_rowwarp"  # the parent SpMV design: timing only

# launches of the solve's kernels by "role rows x cols" (the rows a launch
# writes, the length of the vector it reads; a fused smoother launch adds
# "x sweeps", its iterations): None, or, during a measurement
# run (``apps.cli``'s ``--profile``), a dict; each launch then also runs
# inside a ``torch.profiler`` range of that name (``_call``)
SHAPES: dict | None = None

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
        os.path.getmtime(LIB_PATH) >= os.path.getmtime(s)
        for s in srcs + [os.path.join(CSRC, h) for h in HEADERS])
    if fresh and not verbose:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    nvcc, flags = _nvcc(), [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    # one nvcc per source, all started together, then one link
    objs = [f"{os.path.join(BUILD_DIR, os.path.basename(s))}.{os.getpid()}.o"
            for s in srcs]
    procs = []
    try:
        for s, o in zip(srcs, objs):
            procs.append(subprocess.Popen([nvcc, *flags, "-c", "-o", o, s],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        # every process is waited for before any failure is raised
        report = [pr.communicate()[1] for pr in procs]
        for s, pr, err in zip(srcs, procs, report):
            if pr.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(s)} "
                                   f"({pr.returncode}):\n{err}")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print("".join(report), end="")
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
            for name in ("mmp_ell_spmv_blk_f32", "mmp_ell_spmv_blk_f64"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p, p, p, p, i, i, p, p, i, p]
            for name in ("mmp_storage_chain_f32", "mmp_storage_chain_f64",
                         "mmp_storage_chain_f32_bf16k", "mmp_storage_chain_stale_f32",
                         "mmp_storage_chain_stale_f64",
                         "mmp_storage_chain_stale_f32_bf16k", "mmp_stale_cluster_f32",
                         "mmp_stale_cluster_f64", "mmp_stale_cluster_f32_bf16k"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p, p, p, i, p, p, p, p, p, i, p, p, ctypes.POINTER(i)]
            for name in ("mmp_block_sweep_f32", "mmp_block_sweep_f64",
                         "mmp_block_sweep_f32_bf16k"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p, p, i, p, p, p, p, p, i, i, p, p]
            for name in ("mmp_compact_rows_f32", "mmp_compact_rows_f64"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p, p, p, i, i, p, p, i, p, p, p, i, p]
            for name in ("mmp_ppe_tail_f32", "mmp_ppe_tail_f64"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p, p, p, i, i, p, p, p, p, p, p, p, p, p, i, p]
            lib.mmp_stream_probe.restype = i
            lib.mmp_stream_probe.argtypes = [p, p, i, i, i, i, p,
                                             ctypes.POINTER(i), p]
            lib.mmp_spmv_probe_f32.restype = i
            lib.mmp_spmv_probe_f32.argtypes = [p, p, i, i, p, p, i, p]
            lib.mmp_kiso_spmv_f32.restype = i
            lib.mmp_kiso_spmv_f32.argtypes = [p, p, p, p, i, i, p, p, i, p]
            for name in ("mmp_block_smooth_f32", "mmp_block_smooth_f64",
                         "mmp_block_smooth_f32_bf16k"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [i, p, p, p, p, p, i, i, i, p, p, p, p, p, i, i, i,
                               ctypes.c_double,
                               p, p, p, p, p, p, p, p, p, i, i, p, p, i, i, p, p, p,
                               p, ctypes.POINTER(i)]
            lib.mmp_chain_probe_f32.restype = i
            lib.mmp_chain_probe_f32.argtypes = [p, p, p, i, p, p, p, p, p, i, i, p, p,
                                                ctypes.POINTER(i)]
            for name in ("mmp_class_sweep_f32", "mmp_class_sweep_f64"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p, p, p, p, p,
                               ctypes.POINTER(i)]
            for name in ("mmp_class_tilewalk_f32", "mmp_class_tilewalk_f64"):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p, p, i, i, i, p, p, p, p, p, p, p, p]
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


def _call(role: str, rows: int, cols: int, fn, *args, sweeps: int | None = None) -> int:
    """``fn(*args)``, a kernel's C entry; while ``SHAPES`` is a dict, inside
    a profiler range "role rows x cols" ("role rows x cols x sweeps" for a
    fused smoother launch), counted there."""
    if SHAPES is None:
        return fn(*args)
    key = f"{role} {rows}x{cols}" + ("" if sweeps is None else f"x{sweeps}")
    SHAPES[key] = SHAPES.get(key, 0) + 1
    with torch.profiler.record_function(key):
        return fn(*args)


def _launch_ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# ell_spmv
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceEll:
    """Row-major ELL (padding: value 0) with, per row, ``lens``: one past
    its last nonzero, where ``ell_spmv`` stops reading it.

    Columns: global int32 (``col_base`` None), or (``col_format`` "u16")
    int16 tensors holding each entry's unsigned 16-bit offset from
    ``col_base`` of its 128-row block, the format of tables no sweep reads
    (``device_ell(..., u16=True)``).  ``role`` names the TPU kernel whose
    part this matrix plays ("spmv6" for the coarsest level and the
    transfers, "spmv8" for colored levels, "spmv2" for v2-fallback levels
    and transfers the v6 layout refuses, "spmv4" in ``probes.ktime``,
    "spmv1" and "spmv3" in ``probes.kexp``), "spmv_rowwarp" for the parent
    design (timing only), or, made by ``spmv_probe_ell`` for
    ``spmv_probe`` only, a ``SPMV_PROBE_MODES`` role (``probes.kprobe``).
    """

    vals: torch.Tensor  # [nrows_pad, width] f32 or f64
    cols: torch.Tensor  # [nrows_pad, width] int32, or int16 (u16 offsets)
    ncols: int  # length of the x it multiplies
    role: str
    lens: torch.Tensor | None = None  # [nrows_pad] int32; None: full rows
    col_base: torch.Tensor | None = None  # [nrows_pad / 128] int32 (u16)

    def __post_init__(self):
        """The tables are checked once, here (a launch checks only x): one
        device, contiguous, the column dtype of the format, the shapes,
        and entry offsets within the kernels' int32."""
        dev, shape = self.vals.device, tuple(self.vals.shape)
        u16 = self.col_base is not None
        _check("vals", self.vals, dev)
        _check("cols", self.cols, dev, torch.int16 if u16 else torch.int32, shape)
        if self.lens is not None:
            _check("lens", self.lens, dev, torch.int32, shape[:1])
        if u16:
            _check("col_base", self.col_base, dev, torch.int32,
                   (-(-shape[0] // KISO_BLOCK),))
        if self.vals.numel() > MAX_ENTRIES:
            raise ValueError(f"{self.vals.numel()} entries overflow the kernels' int32")

    @property
    def nrows_pad(self) -> int:
        return self.vals.shape[0]

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def col_format(self) -> str:
        return "i32" if self.col_base is None else "u16"

    def global_cols(self) -> torch.Tensor:
        """[nrows_pad, width] int64 global columns, whatever the format."""
        if self.col_base is None:
            return self.cols.long()
        off = (self.cols.long() & 0xFFFF).view(-1, KISO_BLOCK, self.width)
        return (off + self.col_base.long()[:, None, None]).view(self.cols.shape)


def row_lens(vals: torch.Tensor) -> torch.Tensor:
    """[nrows] int32: one past each row's last nonzero (0 for a row of
    zeros).  The last nonzero, not a count: an interior weight that is
    exactly zero does not cut the row short."""
    k = torch.arange(1, vals.shape[1] + 1, device=vals.device)
    return torch.where(vals != 0, k, 0).amax(dim=1).to(torch.int32)


def u16_span(cols: torch.Tensor) -> int | None:
    """The largest column span of a 128-row block of global columns
    ``cols`` [nrows, width] (every stored entry), or None where the rows are
    not whole blocks."""
    nr = cols.shape[0]
    if nr == 0 or nr % KISO_BLOCK:
        return None
    cb = cols.reshape(nr // KISO_BLOCK, -1)
    return int((cb.max(dim=1).values - cb.min(dim=1).values).max())


def device_ell(ell: EllMatrix, dtype, device, role: str, u16: bool = False) -> DeviceEll:
    """The kernel's tables of host ``ell`` on ``device``: values in
    ``dtype``, ``lens`` from them, and int32 columns; or, given ``u16`` (a
    table no sweep reads), u16 offsets from a per-block base where every
    128-row block spans at most ``U16_MAX_SPAN`` columns (the rule; int32
    otherwise).  ``DeviceEll.col_format`` says which was taken."""
    if role not in SPMV_ROLES and role != SPMV_PARENT:
        raise ValueError(f"unknown SpMV role {role!r}")
    vals = ell.vals.to(dtype=dtype)
    cols = global_cols(ell).to(torch.int32)
    col_base = None
    if u16 and role != SPMV_PARENT:
        span = u16_span(cols)
        if span is not None and span <= U16_MAX_SPAN:
            cols, col_base = u16_offsets(cols)

    def dev(t):
        return None if t is None else t.to(device=device).contiguous()

    return DeviceEll(vals=dev(vals), cols=dev(cols), ncols=ell.ncols, role=role,
                     lens=dev(row_lens(vals)), col_base=dev(col_base))


def rowwarp_ell(A: DeviceEll) -> DeviceEll:
    """``A`` as the parent SpMV design's matrix (role "spmv_rowwarp",
    int32 columns), for the A/B timing of ``chip_smoke.py``."""
    if A.col_base is not None:
        A = dataclasses.replace(A, cols=A.global_cols().to(torch.int32).contiguous(),
                                col_base=None)
    return dataclasses.replace(A, role=SPMV_PARENT)


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor):
    """Plain version of the parent ``ell_spmv`` (every stored entry):
    gather and sum."""
    return (vals * x[cols.long()]).sum(dim=1)


def ell_spmv_lens_plain(A: DeviceEll, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``ell_spmv``: row r sums entries ``[0, lens[r])``
    only, through global columns (u16: base + offset)."""
    if A.lens is None:
        return ell_spmv_plain(A.vals, A.global_cols(), x)
    w = int(A.lens.max()) if A.lens.numel() else 0
    k = torch.arange(w, device=A.vals.device)
    prod = A.vals[:, :w] * x[A.global_cols()[:, :w]]
    return torch.where(k < A.lens[:, None], prod, 0).sum(dim=1)


def ell_spmv(A: DeviceEll, x: torch.Tensor) -> torch.Tensor:
    """y = A x, [nrows_pad]; the CUDA kernel for CUDA tensors: ``ell_spmv_blk``
    (each row to ``lens``, i32 or u16 columns) for a solve role, the parent
    design for "spmv_rowwarp"."""
    parent = A.role == SPMV_PARENT
    if A.role not in SPMV_ROLES and not parent:
        raise ValueError(f"ell_spmv takes a solve SpMV role, not {A.role!r}")
    if x.device.type == "cpu" and A.vals.device.type == "cpu":
        return ell_spmv_plain(A.vals, A.cols, x) if parent else ell_spmv_lens_plain(A, x)
    dev = A.vals.device
    if dev.type != "cuda" or A.vals.dtype not in _SUFFIX:
        raise ValueError(f"ell_spmv takes f32/f64 CUDA tensors, got "
                         f"{A.vals.dtype} on {dev}")
    _check("x", x, dev, A.vals.dtype, (A.ncols,))  # the tables: __post_init__
    u16 = A.col_base is not None
    y = torch.empty(A.nrows_pad, dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if parent:
        if u16:
            raise ValueError("the parent SpMV design takes int32 columns (rowwarp_ell)")
        fn = getattr(_load(), f"mmp_ell_spmv_{_SUFFIX[x.dtype]}")
        rc = _call(A.role, A.nrows_pad, A.ncols, fn, A.vals.data_ptr(), A.cols.data_ptr(),
                   A.width, A.nrows_pad, x.data_ptr(), y.data_ptr(), stream)
    else:
        if A.lens is None:
            raise ValueError("ell_spmv needs the rows' lens (device_ell builds them)")
        fn = getattr(_load(), f"mmp_ell_spmv_blk_{_SUFFIX[x.dtype]}")
        rc = _call(A.role, A.nrows_pad, A.ncols, fn, A.vals.data_ptr(), A.cols.data_ptr(),
                   A.col_base.data_ptr() if u16 else None, A.lens.data_ptr(), A.width,
                   A.nrows_pad, x.data_ptr(), y.data_ptr(), int(u16), stream)
    _launch_ok(rc, "ell_spmv")
    COUNTS[A.role] += 1
    return y


# The timing-only variants of the SpMV (the reference's scripts/kprobe.py
# spmv4_variant), by role: the kernel's compile-time mode.  Only
# "spmvp_base" computes y = A x; the others compute other functions and
# never reach a solve.
SPMV_PROBE_MODES = {"spmvp_base": 0, "spmvp_nogather": 1, "spmvp_noreduce": 2,
                    "spmvp_neither": 3}
NOGATHER_SCALE = 1e-9  # "spmvp_nogather": acc += v * float(col) * 1e-9


def spmv_probe_ell(A: DeviceEll, mode: str) -> DeviceEll:
    """``A`` as the matrix of SpMV probe mode ``mode`` (a
    ``SPMV_PROBE_MODES`` role), for ``spmv_probe`` alone."""
    if mode not in SPMV_PROBE_MODES:
        raise ValueError(f"{mode!r} is not an SpMV probe role")
    return dataclasses.replace(A, role=mode)


def spmv_probe_plain(A: DeviceEll, x: torch.Tensor) -> torch.Tensor:
    """Plain version of each SpMV probe mode (``A.role``), [nrows_pad]:
    per entry ``v * x[col]`` ("spmvp_base", "spmvp_noreduce") or ``v *
    float(col) * 1e-9`` ("spmvp_nogather", "spmvp_neither": no x read);
    then the row's sum ("spmvp_base", "spmvp_nogather") or, for row r, the
    partial of warp lane ``r % 32`` alone: the sum of the entries ``k = r
    % 32, r % 32 + 32, ...`` ("spmvp_noreduce", "spmvp_neither")."""
    mode = A.role
    if mode not in SPMV_PROBE_MODES:
        raise ValueError(f"{mode!r} is not an SpMV probe role")
    if mode in ("spmvp_base", "spmvp_noreduce"):
        prod = A.vals * x[A.cols.long()]
    else:
        prod = A.vals * A.cols.to(A.vals.dtype) * NOGATHER_SCALE
    if mode in ("spmvp_base", "spmvp_nogather"):
        return prod.sum(dim=1)
    n, w = prod.shape
    lanes = torch.nn.functional.pad(prod, (0, -w % 32)).view(n, -1, 32).sum(dim=1)
    r = torch.arange(n, device=prod.device)
    return lanes[r, r % 32]


def spmv_probe(A: DeviceEll, x: torch.Tensor) -> torch.Tensor:
    """One launch of an SpMV probe mode (``A.role``) of ``ell_spmv``, f32,
    [nrows_pad].  Timing only: the modes other than "spmvp_base" compute
    other functions."""
    if A.role not in SPMV_PROBE_MODES:
        raise ValueError(f"{A.role!r} is not an SpMV probe role")
    if x.device.type == "cpu" and A.vals.device.type == "cpu":
        return spmv_probe_plain(A, x)
    dev, f32 = A.vals.device, torch.float32
    if dev.type != "cuda" or A.vals.dtype != f32:
        raise ValueError(f"spmv_probe takes f32 CUDA tensors, got {A.vals.dtype} on {dev}")
    _check("cols", A.cols, dev, torch.int32, A.vals.shape)
    _check("vals", A.vals, dev)
    _check("x", x, dev, f32, (A.ncols,))
    y = torch.empty(A.nrows_pad, dtype=f32, device=dev)
    rc = _load().mmp_spmv_probe_f32(A.vals.data_ptr(), A.cols.data_ptr(), A.width,
                                    A.nrows_pad, x.data_ptr(), y.data_ptr(),
                                    SPMV_PROBE_MODES[A.role],
                                    torch.cuda.current_stream(dev).cuda_stream)
    _launch_ok(rc, "ell_spmv probe")
    COUNTS[A.role] += 1
    return y


# ---------------------------------------------------------------------------
# the kiso probes: ell_spmv's column formats and row sources, ell_rowsum_mma
# ---------------------------------------------------------------------------

# role -> the variant of the C entry ``mmp_kiso_spmv_f32``.  The reference's
# scripts/kiso6.py:98 (i16 or i32 columns; pl.when-guarded or unguarded
# padded blocks), kiso7.py:86 (affine block ids or ids from a table) and
# kiso8.py:136 (row sums by the MXU at HIGHEST or DEFAULT, or VPU rolls).
# "kiso7_affine" and "kiso8_vpu" are the production instance of
# ``ell_spmv`` under their own roles.  Timing probes only: the solve's
# ``device_ell`` and ``ell_spmv`` refuse these roles.
KISO_ROLES = {"kiso6_i16_guarded": 0, "kiso6_i16_unguarded": 1,
              "kiso6_i32_guarded": 2, "kiso6_i32_unguarded": 3,
              "kiso7_affine": 4, "kiso7_ids": 5, "kiso8_mxu": 6,
              "kiso8_mxudef": 7, "kiso8_vpu": 4, "kiso8_mxu_v1": 8,
              "kiso8_mxudef_v1": 9}
KISO_U16 = ("kiso6_i16_guarded", "kiso6_i16_unguarded")
KISO_PADDED_IDS = KISO_U16 + ("kiso6_i32_guarded", "kiso6_i32_unguarded")
KISO_GUARDED = ("kiso6_i16_guarded", "kiso6_i32_guarded")
# role -> TF32 passes; the "_v1" roles run the parent design (timing only)
KISO_MMA = {"kiso8_mxu": 2, "kiso8_mxudef": 1, "kiso8_mxu_v1": 2, "kiso8_mxudef_v1": 1}
KISO_BLOCK = 128  # rows of an id-table block and of a u16 base column
KISO_ID_PAD = 8  # id tables pad to a multiple of 8 blocks (the reference's MB)
KISO_MMA_K = 8  # entries a row per mma chunk: the mma widths pad to it
U16_MAX_SPAN = 65535  # largest column span of a block in the u16 format


@dataclasses.dataclass(frozen=True)
class KisoEll:
    """Row-major ELL of a kiso role (``device_kiso``).

    ``cols``: global int32 columns, or (``KISO_U16`` roles) int16 tensors
    holding each entry's unsigned 16-bit offset from ``col_base`` of its
    128-row block.  ``ids`` (``KISO_PADDED_IDS`` and "kiso7_ids"): y block
    j is A block ``ids[j]``; -1 marks a padded block.  ``KISO_MMA`` roles
    carry a width padded with zero values and a valid column to a multiple
    of 8.
    """

    vals: torch.Tensor  # [nrows_pad, width] f32
    cols: torch.Tensor  # [nrows_pad, width] int32, or int16 (u16 offsets)
    col_base: torch.Tensor | None  # [nrows_pad / 128] int32
    ids: torch.Tensor | None  # [output blocks] int32
    ncols: int
    role: str

    @property
    def nrows_pad(self) -> int:
        return self.vals.shape[0]

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def nrows_out(self) -> int:
        """Rows the kernel's output holds (the id table's blocks)."""
        return self.nrows_pad if self.ids is None else self.ids.numel() * KISO_BLOCK


def u16_offsets(cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int16 tensor of the unsigned offsets, [nb] int32 base columns) of
    global int32 columns ``cols`` [nb * 128, width]: base = the block's
    least column, offset = column - base.  Raises for a block whose columns
    span more than 65,535 (the format never wraps)."""
    nr = cols.shape[0]
    if nr % KISO_BLOCK:
        raise ValueError(f"u16 columns need a multiple of {KISO_BLOCK} rows, got {nr}")
    cb = cols.reshape(nr // KISO_BLOCK, -1).to(torch.int32)
    base = cb.min(dim=1).values
    span = cb.max(dim=1).values - base
    if span.numel() and int(span.max()) > U16_MAX_SPAN:
        blk = int(span.argmax())
        raise ValueError(f"block {blk} spans {int(span[blk])} columns, more than "
                         f"the u16 format's {U16_MAX_SPAN}")
    off = cb - base[:, None]
    off = torch.where(off > 32767, off - 65536, off).to(torch.int16)
    return off.reshape(cols.shape).contiguous(), base.contiguous()


def kiso_ids(nb: int, padded: bool) -> torch.Tensor:
    """The id table: blocks 0 .. nb - 1, then (``padded``) -1 up to a
    multiple of 8 blocks."""
    ids = torch.arange(nb, dtype=torch.int32)
    if padded:
        ids = torch.cat([ids, torch.full((-nb % KISO_ID_PAD,), -1, dtype=torch.int32)])
    return ids


def device_kiso(ell: EllMatrix, device, role: str) -> KisoEll:
    """Host prep of a kiso role (f32): global columns, then the role's u16
    offsets and base columns, padded id table or mma width."""
    if role not in KISO_ROLES:
        raise ValueError(f"{role!r} is not a kiso role")
    vals = ell.vals.to(torch.float32)
    cols = global_cols(ell).to(torch.int32)
    col_base = ids = None
    if role in KISO_MMA:
        pad = -vals.shape[1] % KISO_MMA_K
        vals = torch.nn.functional.pad(vals, (0, pad))
        cols = torch.cat([cols, cols[:, -1:].expand(-1, pad)], dim=1)
    if role in KISO_U16:
        cols, col_base = u16_offsets(cols)
    if role in KISO_PADDED_IDS or role == "kiso7_ids":
        if vals.shape[0] % KISO_BLOCK:
            raise ValueError(f"id tables need a multiple of {KISO_BLOCK} rows")
        ids = kiso_ids(vals.shape[0] // KISO_BLOCK, role in KISO_PADDED_IDS)

    def dev(t):
        return None if t is None else t.to(device).contiguous()

    return KisoEll(vals=dev(vals), cols=dev(cols), col_base=dev(col_base), ids=dev(ids),
                   ncols=ell.ncols, role=role)


def kiso_global_cols(A: KisoEll) -> torch.Tensor:
    """[nrows_pad, width] int64 global columns (u16: base + offset)."""
    if A.col_base is None:
        return A.cols.long()
    off = A.cols.long() & 0xFFFF
    return (off.view(-1, KISO_BLOCK, A.width) + A.col_base.long()[:, None, None]).view(
        A.cols.shape)


def tf32_rna(p: torch.Tensor) -> torch.Tensor:
    """f32 ``p`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero, on the 13 low mantissa bits (finite values)."""
    b = p.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def kiso_spmv_plain(A: KisoEll, x: torch.Tensor, out: torch.Tensor | None = None):
    """Plain version of each kiso role, as ``kiso_spmv`` returns it.

    Per entry ``v * x[col]``; "kiso8_mxudef" rounds each product to TF32
    (``tf32_rna``) before the f32 row sum, the other roles sum the f32
    products.  The id roles: output block j is A block ``ids[j]``'s; a
    padded block (id -1) is left as it was (guarded: ``out``'s values, or 0)
    or takes block 0's rows (unguarded: ``max(id, 0)``)."""
    if A.role not in KISO_ROLES:
        raise ValueError(f"{A.role!r} is not a kiso role")
    prod = A.vals * x[kiso_global_cols(A)]
    if KISO_MMA.get(A.role) == 1:
        prod = tf32_rna(prod)
    rows = prod.sum(dim=1)
    if A.ids is None:
        y = rows
    else:
        ids = A.ids.long()
        y = torch.zeros(A.nrows_out, dtype=rows.dtype, device=rows.device) \
            if out is None else out.clone()
        take = ids >= 0 if A.role in KISO_GUARDED else torch.ones_like(ids, dtype=torch.bool)
        yb, rb = y.view(-1, KISO_BLOCK), rows.view(-1, KISO_BLOCK)
        yb[take] = rb[ids.clamp(min=0)[take]]
    if out is not None:
        out.copy_(y)
        return out
    return y[:A.nrows_pad]


def kiso_spmv(A: KisoEll, x: torch.Tensor, out: torch.Tensor | None = None):
    """One launch of a kiso role's kernel, f32.  Returns y[:nrows_pad]; or
    writes all ``A.nrows_out`` rows into ``out`` and returns it, padded
    blocks included (guarded: untouched)."""
    if A.role not in KISO_ROLES:
        raise ValueError(f"{A.role!r} is not a kiso role")
    if x.device.type == "cpu" and A.vals.device.type == "cpu":
        return kiso_spmv_plain(A, x, out)
    dev, f32 = A.vals.device, torch.float32
    if dev.type != "cuda" or A.vals.dtype != f32:
        raise ValueError(f"kiso_spmv takes f32 CUDA tensors, got {A.vals.dtype} on {dev}")
    _check("vals", A.vals, dev)
    _check("cols", A.cols, dev, torch.int16 if A.role in KISO_U16 else torch.int32,
           A.vals.shape)
    _check("x", x, dev, f32, (A.ncols,))
    if A.role in KISO_U16:
        _check("col_base", A.col_base, dev, torch.int32, (A.nrows_pad // KISO_BLOCK,))
    if A.ids is not None:
        _check("ids", A.ids, dev, torch.int32)
    y = torch.empty(A.nrows_out, dtype=f32, device=dev) if out is None else out
    _check("out", y, dev, f32, (A.nrows_out,))
    nrows = A.nrows_pad if A.ids is None else A.ids.numel()
    rc = _load().mmp_kiso_spmv_f32(
        A.vals.data_ptr(), A.cols.data_ptr(),
        None if A.col_base is None else A.col_base.data_ptr(),
        None if A.ids is None else A.ids.data_ptr(), A.width, nrows, x.data_ptr(),
        y.data_ptr(), KISO_ROLES[A.role], torch.cuda.current_stream(dev).cuda_stream)
    _launch_ok(rc, f"kiso {A.role}")
    COUNTS[A.role] += 1
    return y if out is not None else y[:A.nrows_pad]


# ---------------------------------------------------------------------------
# block_oneshot_sweep
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockPatches:
    """The x patches of a colored sweep's blocks (``colored_smooth`` copies
    them into shared memory before a block's gather): block b reads x rows
    ``pids[b, s] * 128 + l`` for its ``npid[b]`` slots s (patch ids in
    ascending order; padding slots repeat the first), and ``lcols[row, k] =
    s * 128 + l`` is each ELL entry's place among them (int16: at most 256
    patches a block, the v6 layout's bound)."""

    pids: torch.Tensor  # [nb, npmax] int32
    npid: torch.Tensor  # [nb] int32
    lcols: torch.Tensor  # [n_pad, width] int16


@dataclasses.dataclass(frozen=True)
class BlockSweep:
    """Tables of one level's block Gauss-Seidel sweep.

    Phase p updates blocks ``order[phase_ptr[p]:phase_ptr[p+1]]``.  Colored
    (``serial=False``): one phase per color, blocks of a phase independent.
    Storage order (``serial=True``): one phase holding every block (or a
    subset: a shard's interior blocks), walked in order, each block seeing
    the previous block's result.  ``kT`` is in the vectors' dtype, or bf16
    with f32 vectors (the fast-K instance).
    """

    A: DeviceEll  # the level's square matrix
    kT: torch.Tensor  # [nb, 128, 128] transposed one-shot matrices
    lagc: torch.Tensor  # [n_pad] Lagrange column
    order: torch.Tensor  # [nb] int32 block ids in execution order
    phase_ptr: tuple
    serial: bool
    # "sweep5"/"sweep6"/"sweep7" (storage order), "sweep8" (colored),
    # "sweep8_percolor" (colored) and "sweep6_chain" (storage order), the
    # parent designs (timing only), or a PROBE_MODES role (``sweep_probe``
    # only)
    role: str
    # role "sweep8": its blocks' x patches (``block_patch_tables``)
    patches: BlockPatches | None = None

    @property
    def nphases(self) -> int:
        return len(self.phase_ptr) - 1

    def phase(self, p: int) -> torch.Tensor:
        return self.order[self.phase_ptr[p]:self.phase_ptr[p + 1]]


# (vector dtype, K dtype) -> C entry suffix
_SWEEP_SUFFIX = {(torch.float32, torch.float32): "f32",
                 (torch.float64, torch.float64): "f64",
                 (torch.float32, torch.bfloat16): "f32_bf16k"}


def _oneshot_update(sw: BlockSweep, x, x_lag, b, ids: torch.Tensor, gather: bool = True,
                    dot: bool = True) -> None:
    """The blocks ``ids`` gather from x as it stands and add K t to their
    rows; the probe modes drop the gather (t = b - lag_col x_lag) or the
    K product (add t)."""
    rows = (ids.long()[:, None] * LANES
            + torch.arange(LANES, device=ids.device)).reshape(-1)
    y = (sw.A.vals[rows] * x[sw.A.cols[rows].long()]).sum(dim=1) if gather else 0.0
    t = b[rows] - y - sw.lagc[rows] * x_lag
    if dot:
        k = sw.kT[ids.long()]
        if k.dtype != x.dtype:  # bf16 K: t rounded to bf16, products exact in f32
            t, k = t.to(k.dtype).to(x.dtype), k.to(x.dtype)
        t = torch.bmm(t.view(-1, 1, LANES), k).reshape(-1)
    x[rows] = x[rows] + t


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


# roles of csrc/storage_chain.cu: one CTA walks a storage-order phase
CHAIN_ROLES = ("sweep5", "sweep6")
# role -> (1 if the ELL rows were staged in shared memory else 0, shared
# bytes) of its last launch: the kernel stages them where they fit; for
# "sweep7_stale", (K tiles a CTA, shared bytes a CTA)
CHAIN_INFO: dict[str, tuple] = {}


def storage_chain(sw: BlockSweep, x, x_lag, b) -> torch.Tensor:
    """One storage-order sweep (role "sweep6" or "sweep5") on ``x``, in
    place, one ``storage_chain`` launch a phase; returns ``x``.  CPU
    tensors: ``block_oneshot_sweep_plain``."""
    if sw.role not in CHAIN_ROLES or not sw.serial:
        raise ValueError(f"storage_chain walks a storage-order sweep of roles "
                         f"{CHAIN_ROLES}, not {sw.role!r} (serial={sw.serial})")
    if x.device.type == "cpu" and sw.kT.device.type == "cpu":
        return block_oneshot_sweep_plain(sw, x, x_lag, b)
    dev, dt, kdt = _check_block_sweep(sw, x, b, "storage_chain")
    if sw.A.lens is None:
        raise ValueError("storage_chain needs the rows' lens (device_ell builds them)")
    xl = torch.as_tensor(x_lag, dtype=dt, device=dev).reshape(())
    _check("x_lag", xl, dev, dt, ())
    for name, t in (("kT", sw.kT), ("vals", sw.A.vals), ("cols", sw.A.cols)):
        if t.data_ptr() % 16:  # cp.async.bulk copies 16-byte-aligned tiles
            raise ValueError(f"storage_chain: {name} is not 16-byte aligned")
    n_pad = sw.A.nrows_pad
    fn = getattr(_load(), f"mmp_storage_chain_{_SWEEP_SUFFIX[(dt, kdt)]}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    info = (ctypes.c_int * 2)()
    for p in range(sw.nphases):
        ids = sw.phase(p)
        rc = _call(sw.role, ids.shape[0] * LANES, n_pad, fn, sw.A.vals.data_ptr(),
                   sw.A.cols.data_ptr(), sw.A.lens.data_ptr(), sw.A.width, b.data_ptr(),
                   sw.lagc.data_ptr(), xl.data_ptr(), sw.kT.data_ptr(), ids.data_ptr(),
                   ids.shape[0], x.data_ptr(), stream, info)
        _launch_ok(rc, "storage_chain")
        COUNTS[sw.role] += 1
    CHAIN_INFO[sw.role] = tuple(info)
    return x


# the stale-program sweep (csrc/storage_chain.cu): the reference's
# sor_sweep_tpu7(stale_program=True); "sweep7_stale" its cluster kernel,
# "sweep7_stale_walk" the first design, mode kStale of the one-CTA chain
# (timing only)
STALE_ROLE = "sweep7_stale"
STALE_WALK = "sweep7_stale_walk"
STALE_ROLES = (STALE_ROLE, STALE_WALK)
STALE_GROUP = 8  # blocks a group, sharing x as the group began (its MB)


def stale_sweep_of(sw: BlockSweep, role: str = STALE_ROLE) -> BlockSweep:
    """``sw``'s tables as a stale-program sweep of ``role`` (``STALE_ROLES``).
    Refuses (one host read of the order) all but one storage-order phase of
    consecutive block ids starting at a multiple of ``STALE_GROUP``: the
    reference's groups follow block ids (its segments are MB-aligned), not
    list positions."""
    if role not in STALE_ROLES:
        raise ValueError(f"a stale-program sweep has a role of {STALE_ROLES}, not {role!r}")
    ids = sw.order.cpu().long()
    n = ids.shape[0]
    if (not sw.serial or sw.phase_ptr != (0, n) or n == 0 or int(ids[0]) % STALE_GROUP
            or not torch.equal(ids, ids[0] + torch.arange(n))):
        raise ValueError("the stale sweep walks one storage-order phase of consecutive "
                         f"blocks from a multiple of {STALE_GROUP}")
    return dataclasses.replace(sw, role=role)


def _stale_groups(sw: BlockSweep, x, x_lag, b) -> torch.Tensor:
    """Per group of ``STALE_GROUP`` consecutive entries of ``sw.order``,
    every row gathers from x as the group began, then each block adds K t
    to its own rows (as they were at the group's start)."""
    ids = sw.order
    for g in range(0, ids.shape[0], STALE_GROUP):
        _oneshot_update(sw, x, x_lag, b, ids[g:g + STALE_GROUP])
    return x


def stale_sweep_plain(sw: BlockSweep, x, x_lag, b) -> torch.Tensor:
    """Plain version of ``stale_sweep``: x in place, returned."""
    if sw.role not in STALE_ROLES:
        raise ValueError(f"stale_sweep runs roles {STALE_ROLES} (stale_sweep_of), "
                         f"not {sw.role!r}")
    return _stale_groups(sw, x, x_lag, b)


def stale_sweep(sw: BlockSweep, x, x_lag, b) -> torch.Tensor:
    """One stale-program sweep (from ``stale_sweep_of``) on ``x``, in place,
    one launch; returns ``x``.  Role "sweep7_stale": the cluster kernel (8
    CTAs, CTA j a group's block j); "sweep7_stale_walk": ``storage_chain``'s
    mode kStale on one CTA.  f32, f64, or bf16 K with f32 vectors.  CPU
    tensors: ``stale_sweep_plain``."""
    if (sw.role not in STALE_ROLES or not sw.serial
            or sw.phase_ptr != (0, sw.order.shape[0])):
        raise ValueError(f"stale_sweep runs one phase of roles {STALE_ROLES} "
                         f"(stale_sweep_of), not {sw.role!r}")
    if x.device.type == "cpu" and sw.kT.device.type == "cpu":
        return stale_sweep_plain(sw, x, x_lag, b)
    dev, dt, kdt = _check_block_sweep(sw, x, b, "stale_sweep")
    if sw.A.lens is None:
        raise ValueError("stale_sweep needs the rows' lens (device_ell builds them)")
    if sw.kT.data_ptr() % 16:  # cp.async.bulk copies 16-byte-aligned K tiles
        raise ValueError("stale_sweep: kT is not 16-byte aligned")
    xl = torch.as_tensor(x_lag, dtype=dt, device=dev).reshape(())
    _check("x_lag", xl, dev, dt, ())
    entry = "mmp_stale_cluster" if sw.role == STALE_ROLE else "mmp_storage_chain_stale"
    fn = getattr(_load(), f"{entry}_{_SWEEP_SUFFIX[(dt, kdt)]}")
    ids = sw.order
    info = (ctypes.c_int * 2)()
    rc = _call(sw.role, ids.shape[0] * LANES, sw.A.nrows_pad, fn, sw.A.vals.data_ptr(),
               sw.A.cols.data_ptr(), sw.A.lens.data_ptr(), sw.A.width, b.data_ptr(),
               sw.lagc.data_ptr(), xl.data_ptr(), sw.kT.data_ptr(), ids.data_ptr(),
               ids.shape[0], x.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
               info)
    _launch_ok(rc, "stale_sweep")
    COUNTS[sw.role] += 1
    CHAIN_INFO[sw.role] = tuple(info)
    return x


def block_oneshot_sweep(sw: BlockSweep, x, x_lag, b) -> torch.Tensor:
    """One full sweep (every phase) on ``x``, in place; returns ``x``.

    Roles "sweep8" and "sweep7" launch the fused smoother (``block_smooth``)
    once with one sweep and no relax or re-solve; "sweep6" and "sweep5"
    the single-CTA ``storage_chain``; "sweep6_chain" (the parent design of
    "sweep6") and "sweep8_percolor" (one launch per color, the parent design
    of "sweep8") launch ``block_oneshot_sweep.cu`` once per phase."""
    if sw.role in PROBE_MODES:
        raise ValueError(f"role {sw.role!r} is a timing probe: sweep_probe runs it")
    if sw.role in STALE_ROLES:
        raise ValueError(f"role {sw.role!r} computes another sweep: stale_sweep runs it")
    if x.device.type == "cpu" and sw.kT.device.type == "cpu":
        return block_oneshot_sweep_plain(sw, x, x_lag, b)
    if sw.role in FUSED_SWEEP_ROLES:
        return block_smooth(sw, x, x_lag, b, iters=1, inplace=True)[0]
    if sw.role in CHAIN_ROLES:
        return storage_chain(sw, x, x_lag, b)
    dev, dt, kdt = _check_block_sweep(sw, x, b, "block_oneshot_sweep")
    n_pad = sw.A.nrows_pad
    xl = torch.as_tensor(x_lag, dtype=dt, device=dev).reshape(())
    _check("x_lag", xl, dev, dt, ())
    fn = getattr(_load(), f"mmp_block_sweep_{_SWEEP_SUFFIX[(dt, kdt)]}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for p in range(sw.nphases):
        ids = sw.phase(p)
        rc = _call(sw.role, ids.shape[0] * LANES, n_pad, fn, sw.A.vals.data_ptr(),
                   sw.A.cols.data_ptr(), sw.A.width, b.data_ptr(), sw.lagc.data_ptr(),
                   xl.data_ptr(), sw.kT.data_ptr(), ids.data_ptr(), ids.shape[0],
                   int(sw.serial), x.data_ptr(), stream)
        _launch_ok(rc, "block_oneshot_sweep")
        COUNTS[sw.role] += 1
    return x


def _check_block_sweep(sw: BlockSweep, x, b, what: str):
    """(device, vector dtype, K dtype) of a sweep on CUDA tensors; raises on
    a device, dtype, shape or layout the kernels do not take."""
    dev, dt, kdt = sw.kT.device, sw.A.vals.dtype, sw.kT.dtype
    if dev.type != "cuda" or (dt, kdt) not in _SWEEP_SUFFIX:
        raise ValueError(f"{what} takes f32/f64 CUDA tensors with K in their dtype "
                         f"or bf16 K with f32, got {dt} with {kdt} K on {dev}")
    n_pad = sw.A.nrows_pad
    nb = n_pad // LANES
    _check("kT", sw.kT, dev, kdt, (nb, LANES, LANES))
    _check("vals", sw.A.vals, dev, dt)
    _check("cols", sw.A.cols, dev, torch.int32, sw.A.vals.shape)
    _check("lagc", sw.lagc, dev, dt, (n_pad,))
    # a storage-order sweep may walk a subset of the blocks (a shard's
    # interior pass, parallel/sharded.py); a colored one walks them all
    n_order = sw.order.shape[0] if sw.serial else nb
    if n_order > nb:
        raise ValueError(f"order lists {n_order} blocks, the level has {nb}")
    _check("order", sw.order, dev, torch.int32, (n_order,))
    _check("x", x, dev, dt, (n_pad,))
    _check("b", b, dev, dt, (n_pad,))
    return dev, dt, kdt


# ---------------------------------------------------------------------------
# block_smooth: a smoother call in one launch (csrc/block_smooth.cu)
# ---------------------------------------------------------------------------

# role -> kernel of block_smooth.cu: 0 colored_smooth (one cooperative
# launch, a grid barrier between colors), 1 coarse_smooth (one CTA, the
# level in shared memory)
FUSED_SWEEP_ROLES = {"sweep8": 0, "sweep7": 1}
SMEM_OPTIN = 232_448  # shared memory a CTA may opt in to on an H100 (227 KB)
# role -> (grid, K buffers, ELL buffers, shared bytes) of its last launch
SMOOTH_INFO: dict[str, tuple] = {}
_ES = {torch.float32: 4, torch.float64: 8, torch.bfloat16: 2}


def _al128(v: int) -> int:
    return -(-v // 128) * 128


def smooth_smem_bytes(nk: int, ne: int, width: int, dtype, k_dtype, n_vec: int = 0,
                      m: int = 0, cbytes: int = 4, npx: int = 0) -> int:
    """Shared bytes of a ``block_smooth`` launch with ``nk`` K buffers and
    ``ne`` ELL buffers of columns of ``cbytes`` each (block_smooth.cu's
    ``make_layout``): the mbarriers, the buffers, ``colored_smooth``'s
    ``npx`` patch values (its columns are int16, ``cbytes`` 2), t, the
    product's partial sums, the reduction scratch and, for
    ``coarse_smooth``, four level vectors of ``n_vec`` rows and ``m``
    boundary rows' diagonals and targets."""
    es, ks = _ES[dtype], _ES[k_dtype]
    return (128 + nk * LANES * LANES * ks + ne * _al128(LANES * width * (es + cbytes))
            + _al128(npx * es) + _al128(LANES * es) + _al128(512 * es) + _al128(17 * es)
            + _al128(4 * n_vec * es) + _al128(m * es) + _al128(4 * m))


def coarse_smooth_fits(n_pad: int, dtype, k_dtype, bound_rows: int) -> bool:
    """Whether ``coarse_smooth`` takes a storage-order level: one K tile, its
    four vectors (x, b, Lagrange column and row) and its ``bound_rows``
    boundary rows' diagonals and targets within ``SMEM_OPTIN`` (f32: up to
    ~10,200 rows, f64 ~2,990).  The repack gives a level over it role
    "sweep6"."""
    return smooth_smem_bytes(1, 0, 0, dtype, k_dtype, n_pad, bound_rows) <= SMEM_OPTIN


def block_patch_tables(gcols: np.ndarray, nb: int, device) -> BlockPatches:
    """``BlockPatches`` of global int32 columns ``gcols`` [nb * 128, width]
    (padding entries included), on ``device``; raises past 256 patches a
    block."""
    gc = np.asarray(gcols, dtype=np.int64).reshape(nb, -1)
    lists = [np.unique(r >> 7) for r in gc]
    npmax = max(u.size for u in lists)
    if npmax > V6_MAX_PATCHES:
        raise ValueError(f"a block reads {npmax} x patches, more than {V6_MAX_PATCHES}")
    pids = np.empty((nb, npmax), dtype=np.int32)
    lcols = np.empty(gc.shape, dtype=np.int16)
    for b, u in enumerate(lists):
        pids[b, : u.size] = u
        pids[b, u.size:] = u[0]
        lcols[b] = (np.searchsorted(u, gc[b] >> 7) << 7) | (gc[b] & 127)
    npid = np.array([u.size for u in lists], dtype=np.int32)
    return BlockPatches(pids=torch.from_numpy(pids).to(device),
                        npid=torch.from_numpy(npid).to(device),
                        lcols=torch.from_numpy(lcols.reshape(np.shape(gcols))).to(device))


@functools.lru_cache(maxsize=256)
def _phase_ptr(ptr: tuple, device: torch.device) -> torch.Tensor:
    """A BlockSweep's phase offsets as an int32 tensor on ``device``, made
    once per (offsets, device)."""
    return torch.tensor(ptr, dtype=torch.int32, device=device)


def smooth_loop(sw, x, x_lag, b, b_lag, iters: int, omega: float = 1.0, lag_row=None,
                bound: DeviceCompact | None = None, plain: bool = False, start=None,
                resolve_last: bool = False):
    """``iters`` times: one sweep (``block_oneshot_sweep``, or
    ``class_sor_sweep`` for a ClassSweep), then, given ``lag_row``, the
    Lagrange relax x_lag = (1 - omega) x_lag + omega (b_lag - lag_row . x),
    then, given a non-empty "bound2" table, the boundary re-solve
    (``compact_rows``): the reference's ``tpu_backend.smooth`` scan as a
    loop of launches, on a copy of ``x``.  Given ``start`` (mask, values),
    before the first sweep the boundary rows are re-solved, then x = values
    where mask > 0 (the V-cycle's start: the re-solve, then
    ``apply_dirichlet``); given ``resolve_last``, after the last they are
    re-solved once more (the preconditioner's); each a launch of its own.
    Returns (x, x_lag).  ``plain`` runs the kernels' plain versions: the
    plain version of ``block_smooth``."""
    if isinstance(sw, ClassSweep):
        sweep = class_sor_sweep_plain if plain else class_sor_sweep
    else:
        sweep = block_oneshot_sweep_plain if plain else block_oneshot_sweep
    resolve = compact_rows_plain if plain else compact_rows
    rows = bound is not None and bound.nrows > 0
    x = x.clone()
    if start is not None:
        if rows:
            resolve(bound, x, b)
        x = torch.where(start[0] > 0, start[1], x)
    for _ in range(iters):
        sweep(sw, x, x_lag, b)
        if lag_row is not None:
            # border row: A_NN = 1 (grid.cpp:573); an elementwise product
            # and a sum, no cuBLAS
            x_lag = (1.0 - omega) * x_lag + omega * (b_lag - (lag_row * x).sum())
        if rows:
            resolve(bound, x, b)
    if resolve_last and rows:
        resolve(bound, x, b)
    return x, x_lag


def block_smooth_plain(sw: BlockSweep, x, x_lag, b, b_lag=None, iters: int = 1,
                       omega: float = 1.0, lag_row=None, bound=None, start=None,
                       resolve_last: bool = False):
    """Plain version of ``block_smooth``: ``smooth_loop`` over the plain
    sweep, relax and re-solves; returns new (x, x_lag)."""
    return smooth_loop(sw, x, x_lag, b, b_lag, iters, omega, lag_row, bound, plain=True,
                       start=start, resolve_last=resolve_last)


def block_smooth(sw: BlockSweep, x, x_lag, b, b_lag=None, iters: int = 1,
                 omega: float = 1.0, lag_row=None, bound: DeviceCompact | None = None,
                 inplace: bool = False, start=None, resolve_last: bool = False):
    """``iters`` x (sweep, Lagrange relax given ``lag_row``, boundary
    re-solve given a non-empty "bound2" table) in ONE launch of the fused
    kernel of ``sw.role`` ("sweep8": colored_smooth, "sweep7":
    coarse_smooth); counted once.  ``start`` and ``resolve_last`` as in
    ``smooth_loop``, inside the same launch.
    Returns new (x, x_lag); ``inplace`` (the one-sweep call of
    ``block_oneshot_sweep``, no relax) updates ``x`` and returns (x,
    None).  CPU tensors: ``block_smooth_plain``."""
    if sw.role not in FUSED_SWEEP_ROLES:
        raise ValueError(f"block_smooth takes roles {sorted(FUSED_SWEEP_ROLES)}, "
                         f"not {sw.role!r}")
    if bound is not None and bound.role != "bound2":
        raise ValueError(f"block_smooth re-solves a bound2 table, not {bound.role!r}")
    if bound is not None and not bound.nrows:
        bound = None
    if iters < 1 or (inplace and (lag_row is not None or bound is not None or iters != 1
                                  or start is not None or resolve_last)):
        raise ValueError("block_smooth: iters >= 1; in place only one bare sweep")
    if x.device.type == "cpu" and sw.kT.device.type == "cpu":
        if inplace:
            return block_oneshot_sweep_plain(sw, x, x_lag, b), None
        return block_smooth_plain(sw, x, x_lag, b, b_lag, iters, omega, lag_row, bound,
                                  start, resolve_last)
    dev, dt, kdt = _check_block_sweep(sw, x, b, "block_smooth")
    n_pad, nb = sw.A.nrows_pad, sw.A.nrows_pad // LANES
    for name, t in (("kT", sw.kT), ("vals", sw.A.vals), ("cols", sw.A.cols)):
        if t.data_ptr() % 16:  # cp.async.bulk copies 16-byte-aligned tiles
            raise ValueError(f"block_smooth: {name} is not 16-byte aligned")
    coarse = FUSED_SWEEP_ROLES[sw.role]
    m = bound.m_pad if bound is not None else 0
    if coarse and not coarse_smooth_fits(n_pad, dt, kdt, m):
        raise ValueError(f"coarse_smooth: a level of {n_pad} rows ({m} boundary rows) "
                         f"in {dt} does not fit {SMEM_OPTIN} B of shared memory")
    pt = sw.patches
    if not coarse:
        if pt is None:
            raise ValueError("colored_smooth needs the blocks' x patches "
                             "(BlockSweep.patches: block_patch_tables)")
        _check("lcols", pt.lcols, dev, torch.int16, sw.A.vals.shape)
        _check("pids", pt.pids, dev, torch.int32, (nb, pt.pids.shape[1]))
        _check("npid", pt.npid, dev, torch.int32, (nb,))
        if pt.lcols.data_ptr() % 16:
            raise ValueError("block_smooth: lcols is not 16-byte aligned")
        need = smooth_smem_bytes(1, 0, sw.A.width, dt, kdt, cbytes=2,
                                 npx=pt.pids.shape[1] * LANES)
        if need > SMEM_OPTIN:
            raise ValueError(f"colored_smooth: {pt.pids.shape[1]} x patches a block in "
                             f"{dt} do not fit {SMEM_OPTIN} B of shared memory")
    xl = torch.as_tensor(x_lag, dtype=dt, device=dev).reshape(())
    _check("x_lag", xl, dev, dt, ())
    if lag_row is not None:
        _check("lag_row", lag_row, dev, dt, (n_pad,))
        bl = torch.as_tensor(b_lag, dtype=dt, device=dev).reshape(())
        _check("b_lag", bl, dev, dt, ())
    if bound is not None:
        _check("bound vals", bound.vals, dev, dt)
        _check("bound cols", bound.cols, dev, torch.int32, bound.vals.shape)
        _check("bound lens", bound.lens, dev, torch.int32, (m,))
        _check("bound rows", bound.rows, dev, torch.int32, (m,))
        _check("bound diag", bound.diag, dev, dt, (m,))
        if bound.n_pad != n_pad:
            raise ValueError(f"bound table reads {bound.n_pad} rows, the level has {n_pad}")
    if start is not None:
        _check("start mask", start[0], dev, dt, (n_pad,))
        _check("start values", start[1], dev, dt, (n_pad,))
    ptr = _phase_ptr(sw.phase_ptr, dev)
    max_phase = max(b - a for a, b in zip(sw.phase_ptr, sw.phase_ptr[1:]))
    x_out = x if inplace else torch.empty_like(x)
    xl_out = None if inplace else torch.empty((), dtype=dt, device=dev)
    partials = None if coarse else torch.empty(2 * nb, dtype=dt, device=dev)
    info = (ctypes.c_int * 4)()

    def ptr_of(t):
        return None if t is None else t.data_ptr()

    fn = getattr(_load(), f"mmp_block_smooth_{_SWEEP_SUFFIX[(dt, kdt)]}")
    rc = _call(sw.role, n_pad, n_pad, fn, coarse, sw.A.vals.data_ptr(), sw.A.cols.data_ptr(),
               *((None, None, None, 0) if coarse else
                 (pt.lcols.data_ptr(), pt.pids.data_ptr(), pt.npid.data_ptr(),
                  pt.pids.shape[1])),
               sw.A.width, n_pad, b.data_ptr(), sw.lagc.data_ptr(), sw.kT.data_ptr(),
               sw.order.data_ptr(), ptr.data_ptr(), sw.nphases, max_phase, iters,
               float(omega), ptr_of(lag_row), None if lag_row is None else bl.data_ptr(),
               xl.data_ptr(), ptr_of(xl_out),
               *((bound.vals.data_ptr(), bound.cols.data_ptr(), bound.lens.data_ptr(),
                  bound.rows.data_ptr(), bound.diag.data_ptr(), bound.width, m)
                 if bound is not None else (None, None, None, None, None, 0, 0)),
               *((start[0].data_ptr(), start[1].data_ptr()) if start is not None
                 else (None, None)),
               int(start is not None), int(resolve_last),
               x.data_ptr(), x_out.data_ptr(), ptr_of(partials),
               torch.cuda.current_stream(dev).cuda_stream, info, sweeps=iters)
    _launch_ok(rc, f"block_smooth {sw.role}")
    COUNTS[sw.role] += 1
    SMOOTH_INFO[sw.role] = tuple(info)
    return x_out, xl_out


# The timing-only variants of the storage-order chain (the reference's
# scripts/ksweepprobe.py make_sweep_variant), by role: storage_chain.cu's
# compile-time mode.  "probe_base" is the production f32 instance (role
# "sweep6"'s kernel) and computes the sweep; "probe_hoist" is the stale
# sweep's f32 instance (role "sweep7_stale"); the others compute other
# functions and never reach a solve.
PROBE_MODES = {"probe_base": 0, "probe_hoist": 1, "probe_nodot": 2,
               "probe_nogather": 3}
PROBE_GROUP = STALE_GROUP  # blocks per "probe_hoist" group


def sweep_probe_plain(sw: BlockSweep, x, x_lag, b) -> torch.Tensor:
    """Plain version of each probe mode, on ``x`` in place: "probe_base"
    the storage-order sweep; "probe_nodot" x_blk += t block by block;
    "probe_nogather" x_blk += K (b - lag_col x_lag) for every block at
    once (nothing reads x); "probe_hoist" the stale sweep (per group of
    ``PROBE_GROUP`` consecutive entries of ``sw.order``, every row gathers
    from x as the group began, then each block adds K t)."""
    mode = sw.role
    if mode not in PROBE_MODES:
        raise ValueError(f"{mode!r} is not a probe role")
    ids = sw.order
    if mode == "probe_base":
        return block_oneshot_sweep_plain(sw, x, x_lag, b)
    if mode == "probe_nogather":
        _oneshot_update(sw, x, x_lag, b, ids, gather=False)
    elif mode == "probe_hoist":
        _stale_groups(sw, x, x_lag, b)
    else:
        for j in range(ids.shape[0]):
            _oneshot_update(sw, x, x_lag, b, ids[j:j + 1], dot=False)
    return x


def sweep_probe(sw: BlockSweep, x, x_lag, b) -> torch.Tensor:
    """One launch of a probe mode (``sw.role``) of ``storage_chain``: f32,
    one serial phase over every block (``sw.order``), one CTA, each row
    read to ``lens``; ``x`` in place.  "probe_base" launches the production
    f32 instance itself, "probe_hoist" the stale sweep's (``stale_sweep``).
    Timing only: "probe_nodot" and "probe_nogather" compute other
    functions."""
    nb = sw.A.nrows_pad // LANES
    if sw.role not in PROBE_MODES:
        raise ValueError(f"{sw.role!r} is not a probe role")
    if not sw.serial or sw.phase_ptr != (0, nb):
        raise ValueError("the sweep probes walk one storage-order phase")
    if x.device.type == "cpu" and sw.kT.device.type == "cpu":
        return sweep_probe_plain(sw, x, x_lag, b)
    dev, f32 = sw.kT.device, torch.float32
    if dev.type != "cuda" or sw.A.vals.dtype != f32 or sw.kT.dtype != f32:
        raise ValueError(f"sweep_probe takes f32 CUDA tensors, got {sw.A.vals.dtype} "
                         f"with {sw.kT.dtype} K on {dev}")
    _check("kT", sw.kT, dev, f32, (nb, LANES, LANES))
    _check("vals", sw.A.vals, dev, f32)
    _check("cols", sw.A.cols, dev, torch.int32, sw.A.vals.shape)
    _check("lagc", sw.lagc, dev, f32, (sw.A.nrows_pad,))
    _check("order", sw.order, dev, torch.int32, (nb,))
    _check("x", x, dev, f32, (sw.A.nrows_pad,))
    _check("b", b, dev, f32, (sw.A.nrows_pad,))
    if sw.A.lens is None:
        raise ValueError("sweep_probe needs the rows' lens (device_ell builds them)")
    for name, t in (("kT", sw.kT), ("vals", sw.A.vals), ("cols", sw.A.cols)):
        if t.data_ptr() % 16:  # cp.async.bulk copies 16-byte-aligned tiles
            raise ValueError(f"sweep_probe: {name} is not 16-byte aligned")
    xl = torch.as_tensor(x_lag, dtype=f32, device=dev).reshape(())
    rc = _load().mmp_chain_probe_f32(
        sw.A.vals.data_ptr(), sw.A.cols.data_ptr(), sw.A.lens.data_ptr(), sw.A.width,
        b.data_ptr(), sw.lagc.data_ptr(), xl.data_ptr(), sw.kT.data_ptr(),
        sw.order.data_ptr(), nb, PROBE_MODES[sw.role], x.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, None)
    _launch_ok(rc, "storage_chain probe")
    COUNTS[sw.role] += 1
    return x


# ---------------------------------------------------------------------------
# class_sor_sweep
# ---------------------------------------------------------------------------

CLASS_SWEEP_ROLES = ("sweep2", "sweep4", "sweep1")
CLASS_PARENT = "sweep2_tilewalk"  # the parent class-sweep design: timing only
# rows a window of the class sweep (whole tiles): its chain reads the
# previous window and its own earlier tiles from shared memory; every other
# term is summed one window ahead, off the chain
CLASS_WINDOW = 128
CLASS_MAX_SIZE = 32  # the kernel's largest tile (32 chain lanes)
# role -> (ring slots, shared bytes, tiles a slot) of its last launch
CLASS_INFO: dict[str, tuple] = {}


@dataclasses.dataclass(frozen=True)
class ClassSweep:
    """Tables of one level's class SOR sweep (no K): tiles of
    ``class_size`` rows walked in storage order, each tile's rows gathering
    from the same x.  Row vectors are ``[n_pad]``; padding rows carry
    diag 1 and mask 0, so they never move.  ``A``'s rows are reordered for
    the sweep's windows (``class_window_tables``): each row's first ``seg``
    entries are its chain entries.  ``A`` may be rectangular: the sweep
    updates the first ``n_pad`` rows of an x of ``A.ncols >= n_pad`` (a
    shard's frontier rows over its extended vector, ``parallel.sharded``);
    the rows past ``n_pad`` are read, never written."""

    A: DeviceEll  # the rows swept [n_pad, width] over an x of A.ncols
    diag: torch.Tensor
    mask: torch.Tensor  # smooth mask: rows with mask > 0 are updated
    omega: torch.Tensor  # per-row omega (omega * omega_scale)
    lagc: torch.Tensor  # Lagrange column
    class_size: int
    # "sweep2" (v2-fallback levels), "sweep4" (probes.ktime), "sweep1"
    # (probes.kexp) or "sweep2_tilewalk" (the parent design, timing only)
    role: str
    seg: torch.Tensor  # [n_pad] int16: each row's chain entries

    @property
    def window(self) -> int:
        return class_window(self.class_size)

    @property
    def xring(self) -> int:
        """The kernel's shared x ring: a power of two >= 3 windows."""
        return 1 << (3 * self.window - 1).bit_length()


def class_window(class_size: int) -> int:
    """Rows a window: the most whole tiles in ``CLASS_WINDOW`` rows."""
    return max(CLASS_WINDOW // class_size, 1) * class_size


def class_window_tables(A: DeviceEll, class_size: int) -> tuple:
    """(``A`` with each row's nonzero prefix reordered, seg): for row i of
    window w0 = i // R * R (R = ``class_window(class_size)``), its chain
    entries (columns in [w0 - R, its tile's first row)) first, in their
    order, then its other entries; seg[i] (int16) counts the first.  The
    same operator in the same memory footprint (the old tables are
    dropped); ``lens`` from the new order.  A column at or past the rows
    swept (a rectangular ``A``) lies past every tile's first row, so it is
    never a chain entry."""
    if A.col_base is not None:
        raise ValueError("the class sweep takes int32 columns")
    window = class_window(class_size)
    n, w = A.nrows_pad, A.width
    dev = A.vals.device
    rows = torch.arange(n, device=dev)
    lo = (rows // window - 1) * window
    hi = rows // class_size * class_size
    lens = row_lens(A.vals) if A.lens is None else A.lens
    live = torch.arange(w, device=dev)[None, :] < lens[:, None]
    cols = A.cols.long()
    chain = live & (cols >= lo[:, None]) & (cols < hi[:, None])
    key = torch.where(chain, 0, torch.where(live, 1, 2)).to(torch.int8)
    order = torch.sort(key, dim=1, stable=True).indices
    del key, cols, live
    vals = A.vals.gather(1, order).contiguous()
    A2 = dataclasses.replace(A, vals=vals, cols=A.cols.gather(1, order).contiguous(),
                             lens=row_lens(vals))
    return A2, chain.sum(dim=1).to(torch.int16)


def class_sweep(A: DeviceEll, diag, mask, omega, lagc, class_size: int = 8,
                role: str = "sweep2") -> ClassSweep:
    """Tables from host vectors of length <= ``n_pad`` (the rest is padding:
    diag 1, mask 0, omega 1, lag_col 0) in ``A``'s dtype and device, and
    ``A`` reordered for the sweep's windows: callers that keep the matrix
    use the sweep's ``A``, one copy of it.  ``A`` square, or the first
    rows of a longer x (``A.ncols > n_pad``: a rectangular sweep)."""
    if role not in CLASS_SWEEP_ROLES + (CLASS_PARENT,):
        raise ValueError(f"unknown class-sweep role {role!r}")
    n_pad = A.nrows_pad
    if A.ncols < n_pad or n_pad % class_size:
        raise ValueError(f"class sweep needs whole tiles over an x at least as long "
                         f"as the rows: {n_pad} x {A.ncols}, class size {class_size}")
    A, seg = class_window_tables(A, class_size)

    def rows(v, fill):
        out = torch.full((n_pad,), fill, dtype=torch.float64)
        v = torch.as_tensor(v, dtype=torch.float64).reshape(-1)
        out[: v.shape[0]] = v
        return out.to(device=A.vals.device, dtype=A.vals.dtype).contiguous()

    return ClassSweep(A=A, diag=rows(diag, 1.0), mask=rows(mask, 0.0),
                      omega=rows(omega, 1.0), lagc=rows(lagc, 0.0),
                      class_size=int(class_size), role=role, seg=seg)


def class_sor_sweep_plain(sw: ClassSweep, x, x_lag, b) -> torch.Tensor:
    """Plain version: a loop over the tiles in storage order, each tile one
    batched gather-sum and the update of ``ops/smoothers._gs_sweep`` in the
    form x += [mask] omega / d (b - lag_col x_lag - A x) (the same value:
    the diagonal term of A x cancels ``(1 - omega) x``) on its first
    ``n_pad`` rows (x holds ``A.ncols``).  Updates ``x`` in place and
    returns it.  CUDA tensors stay on the card; CPU tensors are walked
    through numpy views of the same memory (a torch dispatch per tile costs
    several times more)."""
    S = sw.class_size
    n_pad = sw.A.nrows_pad
    nt = n_pad // S
    coef = torch.where(sw.mask > 0, sw.omega / sw.diag, 0.0)
    r0 = b - sw.lagc * x_lag
    tabs = [sw.A.vals.view(nt, S, -1), sw.A.cols.long().view(nt, S, -1),
            coef.view(nt, S), r0.view(nt, S), x, x[:n_pad].view(nt, S)]
    if x.device.type == "cpu":
        tabs = [t.numpy() for t in tabs]
    vals, cols, coef, r0, xf, xv = tabs
    for t in range(nt):
        xv[t] += coef[t] * (r0[t] - (vals[t] * xf[cols[t]]).sum(1))
    return x


def class_sor_sweep(sw: ClassSweep, x, x_lag, b) -> torch.Tensor:
    """One full class SOR sweep on ``x`` [``A.ncols``] (its first ``n_pad``
    rows; ``b`` [``n_pad``]), in place; returns ``x``: one launch of the
    window kernel, or of the parent design for role "sweep2_tilewalk".
    CPU tensors: ``class_sor_sweep_plain``."""
    if x.device.type == "cpu" and sw.A.vals.device.type == "cpu":
        return class_sor_sweep_plain(sw, x, x_lag, b)
    dev, dt = sw.A.vals.device, sw.A.vals.dtype
    if dev.type != "cuda" or dt not in _SUFFIX:
        raise ValueError(f"class_sor_sweep takes f32/f64 CUDA tensors, got {dt} on {dev}")
    if not 1 <= sw.class_size <= CLASS_MAX_SIZE:
        raise ValueError(f"class_sor_sweep takes tiles of 1-{CLASS_MAX_SIZE} rows, "
                         f"not {sw.class_size}")
    n_pad = sw.A.nrows_pad
    _check("vals", sw.A.vals, dev, dt)
    _check("cols", sw.A.cols, dev, torch.int32, sw.A.vals.shape)
    for name in ("diag", "mask", "omega", "lagc"):
        _check(name, getattr(sw, name), dev, dt, (n_pad,))
    _check("x", x, dev, dt, (sw.A.ncols,))
    _check("b", b, dev, dt, (n_pad,))
    xl = torch.as_tensor(x_lag, dtype=dt, device=dev).reshape(())
    _check("x_lag", xl, dev, dt, ())
    stream = torch.cuda.current_stream(dev).cuda_stream
    vecs = (sw.diag.data_ptr(), b.data_ptr(), sw.mask.data_ptr(), sw.omega.data_ptr(),
            sw.lagc.data_ptr(), xl.data_ptr(), x.data_ptr())
    if sw.role == CLASS_PARENT:
        fn = getattr(_load(), f"mmp_class_tilewalk_{_SUFFIX[dt]}")
        rc = _call(sw.role, n_pad, sw.A.ncols, fn, sw.A.vals.data_ptr(),
                   sw.A.cols.data_ptr(), sw.A.width, n_pad, sw.class_size, *vecs, stream)
    else:
        _check("lens", sw.A.lens, dev, torch.int32, (n_pad,))
        _check("seg", sw.seg, dev, torch.int16, (n_pad,))
        if (n_pad * sw.A.width) % 4 or sw.A.vals.data_ptr() % 16 or sw.A.cols.data_ptr() % 16:
            raise ValueError("class_sor_sweep stages 16-byte-aligned tiles: n_pad * width "
                             "must be a multiple of 4 and the tables 16-byte aligned")
        fn = getattr(_load(), f"mmp_class_sweep_{_SUFFIX[dt]}")
        info = (ctypes.c_int * 3)()
        rc = _call(sw.role, n_pad, sw.A.ncols, fn, sw.A.vals.data_ptr(),
                   sw.A.cols.data_ptr(), sw.A.lens.data_ptr(), sw.seg.data_ptr(),
                   sw.A.width, n_pad, sw.class_size, sw.window, sw.xring, *vecs, stream,
                   info)
        CLASS_INFO[sw.role] = tuple(info)
    _launch_ok(rc, "class_sor_sweep")
    COUNTS[sw.role] += 1
    return x


# ---------------------------------------------------------------------------
# compact_rows
# ---------------------------------------------------------------------------

# the epilogue each role runs (the kernel's ``mode`` argument)
_COMPACT_MODE = {"bound2": 0, "push2": 1, "ppe2_scatter": 2}


@dataclasses.dataclass(frozen=True)
class DeviceCompact:
    """A compact table of rows of a big operator (``CompactRows``), on a
    device: row-major ELL with global int32 columns, each row's ``lens``
    (one past its last nonzero, where the kernels stop reading it), the
    target row of each compact row in the big row space (padding slots:
    ``>= n_pad``) and the big matrix's diagonal there.  ``role``: "bound2"
    (Neumann re-solve), "push2" (condensation pushdown), "ppe2" (the
    compatible PPE matvec's tail, ``ppe_tail``) or "ppe2_scatter" (the
    scatter of the rows' products alone, its parent design)."""

    vals: torch.Tensor  # [m_pad, width]
    cols: torch.Tensor  # [m_pad, width] int32
    rows: torch.Tensor  # [m_pad] int32
    diag: torch.Tensor  # [m_pad]
    nrows: int  # true m (0: an empty table, nothing to launch)
    n_pad: int  # length of the vectors it reads and writes
    role: str
    lens: torch.Tensor | None = None  # [m_pad] int32; None: made from vals

    def __post_init__(self):
        if self.lens is None:
            object.__setattr__(self, "lens", row_lens(self.vals).contiguous())

    @property
    def m_pad(self) -> int:
        return self.vals.shape[0]

    @property
    def width(self) -> int:
        return self.vals.shape[1]


def device_compact(c, dtype, device, role: str) -> DeviceCompact:
    """Repack a host ``CompactRows`` (stencil/operators.py) for the kernel."""
    if role not in _COMPACT_MODE and role != "ppe2":
        raise ValueError(f"unknown compact-row role {role!r}")
    return DeviceCompact(
        vals=c.ell.vals.to(device=device, dtype=dtype).contiguous(),
        cols=global_cols(c.ell).to(device=device, dtype=torch.int32).contiguous(),
        rows=c.rows.to(device=device, dtype=torch.int32).contiguous(),
        diag=c.ell.diag.to(device=device, dtype=dtype).contiguous(),
        nrows=c.nrows,
        n_pad=c.ell.ncols,
        role=role,
    )


def _compact_sum_plain(C: DeviceCompact, x: torch.Tensor) -> torch.Tensor:
    """(C x)_i over entries [0, lens[i]) of each row, in the full-width
    gather-sum's order (what lies past lens is zero)."""
    k = torch.arange(C.width, device=C.vals.device)
    prod = C.vals * x[C.cols.long()]
    return torch.where(k < C.lens[:, None], prod, 0).sum(dim=1)


def compact_rows_plain(C: DeviceCompact, x: torch.Tensor, b: torch.Tensor):
    """Plain version of ``compact_rows``: gather-sum to ``lens``, then the
    role's epilogue through index ops (sentinel rows dropped)."""
    y = _compact_sum_plain(C, x)
    rows = C.rows.long()
    keep = rows < C.n_pad
    r = rows[keep]
    if C.role == "bound2":
        d = C.diag[keep]
        x[r] = (b[r] - (y[keep] - d * x[r])) / d
        return x
    if C.role == "ppe2_scatter":
        b[r] = y[keep]
        return b
    out = b.clone()
    out[r] = b[r] - y[keep]
    return out


def _compact_tables_ok(C: DeviceCompact, dev, dt, what: str) -> None:
    if dev.type != "cuda" or dt not in _SUFFIX:
        raise ValueError(f"{what} takes f32/f64 CUDA tensors, got {dt} on {dev}")
    _check("cols", C.cols, dev, torch.int32, C.vals.shape)
    _check("vals", C.vals, dev)
    _check("lens", C.lens, dev, torch.int32, (C.m_pad,))
    _check("rows", C.rows, dev, torch.int32, (C.m_pad,))
    _check("diag", C.diag, dev, dt, (C.m_pad,))


def compact_rows(C: DeviceCompact, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The table's epilogue over y = C x, each row read to ``lens``.

    "bound2": re-solve each target row for its own unknown, IN PLACE on
    ``x``; returns ``x``.  "push2": returns a new vector, ``b`` with
    ``b[r] - (C x)_i`` at the target rows (callers pass ``x = b``).
    "ppe2_scatter": writes ``(C x)_i`` into ``b[r]`` IN PLACE (``b`` is the
    matvec's output, never ``x``) and returns ``b``.
    An empty table (``nrows == 0``) launches nothing.
    """
    if C.role not in _COMPACT_MODE:
        raise ValueError(f"compact_rows runs roles {sorted(_COMPACT_MODE)}, not "
                         f"{C.role!r} (ppe_tail runs role ppe2)")
    if x.device.type == "cpu" and C.vals.device.type == "cpu":
        return compact_rows_plain(C, x, b)
    dev, dt = C.vals.device, C.vals.dtype
    _compact_tables_ok(C, dev, dt, "compact_rows")
    _check("x", x, dev, dt, (C.n_pad,))
    _check("b", b, dev, dt, (C.n_pad,))
    mode = _COMPACT_MODE[C.role]
    if mode == 2 and x.data_ptr() == b.data_ptr():
        raise ValueError("compact_rows ppe2_scatter: the output must not alias x")
    out = b.clone() if mode == 1 else (x if mode == 0 else b)
    if C.nrows == 0:
        return out
    fn = getattr(_load(), f"mmp_compact_rows_{_SUFFIX[dt]}")
    # the scatter reads no b: hand it x, so no read pointer aliases out
    b_in = x if mode == 2 else b
    rc = _call(C.role, C.m_pad, C.n_pad, fn, C.vals.data_ptr(), C.cols.data_ptr(),
               C.lens.data_ptr(), C.width, C.m_pad, C.rows.data_ptr(), C.diag.data_ptr(),
               C.n_pad, x.data_ptr(), b_in.data_ptr(), out.data_ptr(), mode,
               torch.cuda.current_stream(dev).cuda_stream)
    _launch_ok(rc, "compact_rows")
    COUNTS[C.role] += 1
    return out


@dataclasses.dataclass(frozen=True)
class PpeTail:
    """What the compatible PPE matvec does after its four SpMVs, as
    ``ppe_tail`` takes it: the fine level's boundary rows ``C`` (role
    "ppe2"), ``slot[r]`` the compact row whose target is row r (-1: none),
    the rows ``live`` (smoothed or Neumann; the others are identity rows)
    and the Lagrange column.  ``ppe_tail_table`` makes it."""

    C: DeviceCompact
    slot: torch.Tensor  # [n_pad] int32
    live: torch.Tensor  # [n_pad] bool
    lag_col: torch.Tensor  # [n_pad]

    @functools.cached_property
    def scatter(self) -> DeviceCompact:
        """``C`` as the parent design's standalone scatter ("ppe2_scatter")."""
        return dataclasses.replace(self.C, role="ppe2_scatter")


def ppe_tail_table(C: DeviceCompact, live: torch.Tensor, lag_col: torch.Tensor) -> PpeTail:
    """The tail of the compatible matvec over boundary table ``C`` (its
    tensors shared), the row -> compact-row map made on the host."""
    rows = C.rows.cpu().long()
    i = torch.nonzero((rows >= 0) & (rows < C.n_pad)).flatten()
    slot = torch.full((C.n_pad,), -1, dtype=torch.int32)
    slot[rows[i]] = i.to(torch.int32)
    return PpeTail(C=dataclasses.replace(C, role="ppe2"),
                   slot=slot.to(C.rows.device), live=live.contiguous(),
                   lag_col=lag_col.contiguous())


def ppe_tail_loop(T: PpeTail, p, q, x, x_lag, plain: bool = False) -> torch.Tensor:
    """y = p + q, the boundary rows' products scattered over it
    (``compact_rows`` "ppe2_scatter"), x on the rows not ``live``, plus
    ``lag_col`` x_lag: the matvec's tail as separate launches (the parent
    design; ``plain``: the plain scatter, the plain version of
    ``ppe_tail``)."""
    y = p + q
    y = (compact_rows_plain if plain else compact_rows)(T.scatter, x, y)
    y = torch.where(T.live, y, x)
    return y + T.lag_col * x_lag


def ppe_tail(T: PpeTail, p, q, x, x_lag) -> torch.Tensor:
    """The compatible PPE matvec's tail (``ppe_tail_loop``'s function) in
    ONE launch of ``csrc/compact_rows.cu``'s ``ppe_tail`` (role "ppe2"):
    p = dx(dx x) and q = dy(dy x) from the SpMVs, ``x_lag`` a scalar
    tensor; returns a new y.  CPU tensors: the plain version."""
    if x.device.type == "cpu" and T.C.vals.device.type == "cpu":
        return ppe_tail_loop(T, p, q, x, x_lag, plain=True)
    C = T.C
    dev, dt = C.vals.device, C.vals.dtype
    _compact_tables_ok(C, dev, dt, "ppe_tail")
    n = C.n_pad
    for name, t in (("p", p), ("q", q), ("x", x), ("lag_col", T.lag_col)):
        _check(name, t, dev, dt, (n,))
    _check("slot", T.slot, dev, torch.int32, (n,))
    _check("live", T.live, dev, torch.bool, (n,))
    xl = torch.as_tensor(x_lag, dtype=dt, device=dev).reshape(())
    y = torch.empty_like(x)
    fn = getattr(_load(), f"mmp_ppe_tail_{_SUFFIX[dt]}")
    rc = _call("ppe2", n, n, fn, C.vals.data_ptr(), C.cols.data_ptr(), C.lens.data_ptr(),
               C.width, C.m_pad, C.rows.data_ptr(), T.slot.data_ptr(), T.live.data_ptr(),
               T.lag_col.data_ptr(), xl.data_ptr(), p.data_ptr(), q.data_ptr(),
               x.data_ptr(), y.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    _launch_ok(rc, "ppe_tail")
    COUNTS["ppe2"] += 1
    return y


# ---------------------------------------------------------------------------
# stream_ceiling
# ---------------------------------------------------------------------------

STREAM_COLS = 128
STREAM_OUT_ROWS = 8  # output rows per tile (the reference's (8, 128) block)
STREAM_MAX_TILE = (1 << 19) - 1  # the f32i16 never-true test holds below 2^19 rows
# table mix -> (the kernel's mix argument, c's dtype; None: no c)
STREAM_MIXES = {"f32i32": (0, torch.int32), "f32f32": (1, torch.float32),
                "f32": (2, None), "f32i16": (3, torch.int16)}
# role -> the mix it streams: the bench's probe, the reference's
# scripts/kstream.py (four mixes), scripts/kprobe.py and scripts/chaintime.py
STREAM_ROLES = {"stream14": "f32i32", "kstream_f32i32": "f32i32",
                "kstream_f32f32": "f32f32", "kstream_f32": "f32",
                "kstream_f32i16": "f32i16", "kprobe_stream": "f32i32",
                "chain_stream": "f32i32"}
STREAM_CTAS: dict[str, int] = {}  # role -> the CTAs of its last launch


def stream_probe_plain(v: torch.Tensor, c, mix: str, tile_rows: int):
    """Plain version of the stream kernel (one pass): per tile the column
    sums of ``v`` plus, by ``mix``, the int32 column sums of ``c`` as f32
    ("f32i32"), the column sums of f32 ``c`` ("f32f32"), nothing ("f32",
    ``c`` None), or ``where(c[0] > 0, v[0], 0)`` of the tile's first row
    of i16 ``c`` ("f32i16"); each tile's row of sums repeated in 8 output
    rows."""
    nt = v.shape[0] // tile_rows

    def tiles(t):
        return t.view(nt, tile_rows, STREAM_COLS)

    s = tiles(v).sum(dim=1)
    if mix == "f32i32":
        s = s + tiles(c).sum(dim=1, dtype=torch.int32).to(v.dtype)
    elif mix == "f32f32":
        s = s + tiles(c).sum(dim=1)
    elif mix == "f32i16":
        s = s + torch.where(tiles(c)[:, 0] > 0, tiles(v)[:, 0], 0.0)
    elif mix != "f32":
        raise ValueError(f"unknown stream mix {mix!r}")
    return s[:, None, :].expand(nt, STREAM_OUT_ROWS, STREAM_COLS).reshape(-1, STREAM_COLS)


def stream_ceiling_plain(v: torch.Tensor, c: torch.Tensor, tile_rows: int):
    """Plain version of ``stream_ceiling``: the "f32i32" mix."""
    return stream_probe_plain(v, c, "f32i32", tile_rows)


def stream_probe(v: torch.Tensor, c, role: str, tile_rows: int = 4096,
                 reps: int = 1) -> torch.Tensor:
    """Stream [rows, 128] f32 ``v`` and, by the mix of ``role``
    (``STREAM_ROLES``), ``c`` (None for "f32") ``reps`` times in one
    launch; returns the [rows / tile_rows * 8, 128] f32 tile sums.  The
    "f32i16" value (one row of ``c`` enters it) serves timing: the kernel
    still reads all of ``c``.  The launch's CTA count (min(tiles, CTAs
    resident at once)) is left in ``STREAM_CTAS[role]``."""
    if role not in STREAM_ROLES:
        raise ValueError(f"unknown stream role {role!r}")
    mix = STREAM_ROLES[role]
    mix_id, cdt = STREAM_MIXES[mix]
    rows = v.shape[0]
    if (tile_rows <= 0 or tile_rows > STREAM_MAX_TILE or rows % tile_rows
            or reps < 1 or (c is None) != (cdt is None)):
        raise ValueError(f"stream {role}: {rows} rows in tiles of {tile_rows}, "
                         f"reps={reps}, c {'absent' if c is None else 'given'}")
    if v.device.type == "cpu" and (c is None or c.device.type == "cpu"):
        return stream_probe_plain(v, c, mix, tile_rows)
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"stream {role} takes CUDA tensors, got {dev}")
    _check("v", v, dev, torch.float32, (rows, STREAM_COLS))
    if c is not None:
        _check("c", c, dev, cdt, (rows, STREAM_COLS))
    nt = rows // tile_rows
    out = torch.empty(nt * STREAM_OUT_ROWS, STREAM_COLS, dtype=torch.float32,
                      device=dev)
    ctas = ctypes.c_int(0)
    rc = _load().mmp_stream_probe(v.data_ptr(), None if c is None else c.data_ptr(),
                                  mix_id, nt, tile_rows, reps, out.data_ptr(),
                                  ctypes.byref(ctas),
                                  torch.cuda.current_stream(dev).cuda_stream)
    _launch_ok(rc, f"stream {role}")
    COUNTS[role] += 1
    STREAM_CTAS[role] = ctas.value
    return out


def stream_ceiling(v: torch.Tensor, c: torch.Tensor, tile_rows: int = 4096,
                   reps: int = 1) -> torch.Tensor:
    """The kernel bench's probe (role ``stream14``): [rows, 128] f32 ``v``
    and int32 ``c`` streamed ``reps`` times in one launch."""
    return stream_probe(v, c, "stream14", tile_rows, reps)


# ---------------------------------------------------------------------------
# host prep (ported from the reference package's numpy code)
# ---------------------------------------------------------------------------


def build_oneshot_K(
    ell: EllMatrix,
    omega_row: np.ndarray,
    smooth_mask: np.ndarray,
    class_size: int = 8,
    duplicates: str = "sum",
) -> np.ndarray:
    """[nb, 128, 128] transposed one-shot matrices K^T (f64 host math).

    One (block, class, slot) GS sweep of a 128-row block is
    x += M^-1 (b - A x) with M = D/omega + L (L the strictly-lower
    class-block part of the in-block coupling); K = M^-1 per block, rows the
    smoother does not update zeroed (ops/kernels4.py:build_oneshot_K).
    ``duplicates``: "sum" adds every entry of a row that names one column
    twice (the port's rule: the sweep is then exact block GS); "reference"
    keeps one of them, as the reference's fancy-index ``+=`` does (its
    records were measured with that K; ``probes.rho`` reproduces them).
    """
    if duplicates not in ("sum", "reference"):
        raise ValueError(f"duplicates {duplicates!r} is not 'sum' or 'reference'")
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
    if duplicates == "sum":
        np.add.at(abb, (bi >> 7, bi & 127, gc[bi, wi] & 127), vv[bi, wi])
    else:
        abb[bi >> 7, bi & 127, gc[bi, wi] & 127] += vv[bi, wi]

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


V6_MAX_PATCHES = 256  # prepare_kernel_ell6's max_patches (i16 slot packing)


def v6_supported(ell: EllMatrix) -> bool:
    """Whether the reference's v6 layout takes this operator.

    ops/kernels6.py prepare_kernel_ell6 raises (and tpu_backend falls back
    to the v2 kernels) when the assembly blocks are not whole 128-row blocks
    or when a 128-row block reads more than 256 distinct x patches, padding
    entries included (the sets of ``block_patches``).
    """
    if ell.block_rows % LANES:
        return False
    nb = ell.nrows_pad // LANES
    return block_patches(global_cols(ell).numpy(), nb).shape[1] <= V6_MAX_PATCHES


UNION_MB = 8  # consecutive blocks per union group (kernels6.py MB)
UNION_MAX_SLOTS = 32  # the v7 sweep's scratch bound (union_sweep_tables)


def union_slots(pids: np.ndarray, nb: int) -> int:
    """x-patch slots the reference's union-scratch (v7) sweep would need.

    Per group of ``UNION_MB`` consecutive blocks: its own ``UNION_MB``
    slots plus the distinct patches the group reads outside itself, rounded
    up to 8; the maximum over groups (ops/kernels6.py union_sweep_tables,
    which groups the block range rounded up to whole groups).  A
    storage-order level is "v6-oneshot" when this exceeds
    ``UNION_MAX_SLOTS``, else "v7-exact"; on the card both launch the same
    single-CTA chain.
    """
    pids = np.asarray(pids).reshape(nb, -1)
    nmb = -(-nb // UNION_MB)
    max_others = 0
    for g in range(nmb):
        lo, hi = g * UNION_MB, (g + 1) * UNION_MB
        u = np.unique(pids[lo:min(hi, nb)])
        max_others = max(max_others, int(((u < lo) | (u >= hi)).sum()))
    return UNION_MB + -(-max(max_others, 1) // 8) * 8


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


COLORED_MIN_BLOCKS = 32  # below this the colored sweep loses to the chain
COLORED_MB = (8, 4, 2)  # blocks per program, in the order they are tried
COLORED_MAX_EXPAND = 2.0  # duplicate-padding expansion bound
COLORED_MAX_SLOTS = 96  # scratch slots of a program, first tier
COLORED_MAX_SLOTS_WIDE = 256  # second tier (i16 slot packing)


def colored_refusal(pids: np.ndarray, nb: int, colors: np.ndarray,
                    min_blocks: int = COLORED_MIN_BLOCKS,
                    max_expand: float = COLORED_MAX_EXPAND) -> str | None:
    """Why the reference's colored sweep would refuse this level, or None.

    Mirrors ops/kernels8.py ``prepare_colored_sweep`` on the single-segment
    v6 layout (``prepare_kernel_ell6``'s default): fewer than 32 blocks;
    otherwise for each ``mb`` of 8, 4, 2, the colors' block lists padded to
    whole programs of ``mb`` blocks (``_color_chunks``) must not expand the
    block count past 2.0, and a program's scratch, ``mb`` own slots plus
    the patches its blocks read outside it rounded up to 8, must fit 96
    slots; failing that, any ``mb`` within 256 slots (the wide tier).
    ``min_blocks`` and ``max_expand`` replace the 32 blocks and the 2.0
    (the reference's arguments of those names; ``probes.rho`` passes its
    ``scripts/rho_colored.py``'s 2 and 3.0).
    The block order and the math are the port's own either way: this only
    decides whether the level runs colored ("v8-colored") or in storage
    order ("v7-exact"/"v6-oneshot"), as the reference does.  At ``mb`` 2 a
    color pads by at most one block, so the expansion alone never refuses.
    """
    if nb < min_blocks:
        return f"colored sweep loses below {min_blocks} blocks (nb={nb})"
    pids = np.asarray(pids).reshape(nb, -1)
    by_color = [np.flatnonzero(colors == c) for c in range(int(colors.max()) + 1)]
    why, wide = None, False
    for mb in COLORED_MB:
        order = np.concatenate([np.concatenate([b, np.repeat(b[-1], -b.size % mb)])
                                for b in by_color])
        if order.size / nb > max_expand:
            why = f"expansion {order.size / nb:.2f} > {max_expand} at mb={mb}"
            continue
        max_others = 0
        for prog in order.reshape(-1, mb):
            u = np.unique(pids[prog])
            max_others = max(max_others, int((~np.isin(u, prog)).sum()))
        g8max = -(-(mb + -(-max(max_others, 1) // 8) * 8) // 8) * 8
        if g8max <= COLORED_MAX_SLOTS:
            return None
        wide = wide or g8max <= COLORED_MAX_SLOTS_WIDE
        why = f"{g8max} scratch slots > {COLORED_MAX_SLOTS} at mb={mb}"
    return None if wide else why


def colored_order(colors: np.ndarray) -> tuple[np.ndarray, tuple]:
    """Execution order (colors ascending, storage order within a color) and
    the phase offsets — the reference's ``ColoredSweep.block_order()`` with
    its duplicate padding dropped."""
    order = np.argsort(colors, kind="stable")
    counts = np.bincount(colors)
    ptr = (0, *np.cumsum(counts).tolist())
    return order, tuple(int(p) for p in ptr)
