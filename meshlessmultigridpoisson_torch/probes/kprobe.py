"""Stream ceiling and the SpMV's gather/reduction split (card only).

    python -m meshlessmultigridpoisson_torch.probes.kprobe [n] [iters]

Port of the reference package's ``scripts/kprobe.py`` (default n 262,144).

1. The stream kernel (``gpu_kernels.stream_probe``, role
   ``kprobe_stream``; the bench's f32 + int32 function) over two [2^19,
   128] tables (512 MiB), one pass a launch, at 64, 256, 1024 and 4096 tile
   rows (8,192 to 128 tiles, walked by at most the CTAs resident at once;
   each row gives its CTA count).  The tables hold small integers from
   ``seed``: each tile size is held against its plain version, tolerance 0,
   then timed (``utils.profiling.chain_time``: ``iters`` launches between
   CUDA events, the median of three).
2. The SpMV on ``bench.synthetic_banded_csr(n, 70, 512, seed)`` in the
   port's row-major ELL at 128-row blocks (the reference's v4 window
   layout is a TPU constraint; ``probes.ktime`` runs the same ELL for v4),
   in the four modes of ``gpu_kernels.spmv_probe``:

   * ``spmvp_base``: y = A x (``ell_spmv``'s production code);
   * ``spmvp_nogather``: x not read, each entry v * col * 1e-9 (the
     reference: v * its packed local column * 1e-9);
   * ``spmvp_noreduce``: no warp-shuffle reduction, lane ``row % 32``'s
     partial written (the reference: a plain sum over tile rows in place of
     its MXU row sum);
   * ``spmvp_neither``: both.

   All but ``spmvp_base`` are timing only.  x from seed 1.  Each mode is
   held against its plain version (``TOL`` of max |plain output|), then
   timed as the stream; beside ``spmvp_base`` a ``torch.sparse`` CSR
   matvec (``profiling.library_csr``, timed, never called by the port).

Each row gives ms, the bound of its own work (``profiling.stream_bytes``,
``spmv_probe_bytes``: the no-gather modes read no x) and its share, the
plain version's ms; the SpMV rows Gnnz/s with nnz = n * 70 (the
reference's count) and GB/s over the ELL table (values and columns, padding
included).  The JSON line that ends the output splits ``spmvp_base``'s
time: gather = base - nogather, reduction = base - noreduce.  Without a
card it exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

N, ITERS = 262_144, 20
K, BAND = 70, 512
STREAM_ROWS = 1 << 19
STREAM_TILES = (64, 256, 1024, 4096)
MODES = ("spmvp_base", "spmvp_nogather", "spmvp_noreduce", "spmvp_neither")
# kernel vs plain, relative to max |plain output|: ~70 f32 products summed in
# another order (a warp-shuffle tree against torch's sum)
TOL = 1e-5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_operator(n: int = N, seed: int = 0):
    """Host side: the banded operator's ELL at 128-row blocks."""
    from meshlessmultigridpoisson_torch.bench import synthetic_banded_csr
    from meshlessmultigridpoisson_torch.ops.ell import ell_from_csr

    return ell_from_csr(synthetic_banded_csr(n, K, BAND, seed), block_rows=128)


def run(n: int = N, iters: int = ITERS, seed: int = 0, ell=None) -> dict:
    """Build, check and time; returns the result line as a dict.  ``ell``:
    the operator's ELL (``build_operator``), built by the caller."""
    if not torch.cuda.is_available():
        raise SystemExit("the kprobe probe times on the card: "
                         "torch.cuda.is_available() is False")
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.probes.kstream import held, tables
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    info = pf.card()
    log(f"card {info['name']}, power limit {info['power_limit']}")
    rows = {}

    def row(label, role, ms, plain_ms, err, scale, nbytes, flops, **extra):
        b_ms, by = pf.bound_ms(nbytes, flops, f32, info["name"])
        rows[label] = dict(role=role, ms=ms, plain_ms=plain_ms, max_abs_err=err,
                           rel_err=err / scale, bound_ms=b_ms, bound_by=by,
                           pct_of_bound=100.0 * b_ms / ms, **extra)
        lib = extra.get("library_ms")
        log(f"  {label:<24s} {ms:.4f} ms  bound {b_ms:.4f} ms ({by}, "
            f"{100.0 * b_ms / ms:.1f}%)  plain {plain_ms:.4f} ms"
            + ("" if lib is None else f"  library {lib:.4f} ms"))

    log(f"-- stream, f32 + i32 tables [{STREAM_ROWS}, 128], one pass a launch --")
    v, c = tables("f32i32", STREAM_ROWS, dev, seed)
    for tpp in STREAM_TILES:
        err = held("kprobe_stream", v, c, tpp, reps=(1,))
        ms = pf.chain_time(lambda _: gk.stream_probe(v, c, "kprobe_stream", tpp), v,
                           k=iters, reps=3) * 1e3
        plain_ms = pf.chain_time(lambda _: gk.stream_probe_plain(v, c, "f32i32", tpp),
                                 v, k=3, reps=1) * 1e3
        nbytes = pf.stream_bytes(v, c, tpp)
        row(f"stream tpp={tpp}", "kprobe_stream", ms, plain_ms, err, 1.0, nbytes,
            pf.stream_flops(v, c, tpp), tile_rows=tpp,
            ctas=gk.STREAM_CTAS["kprobe_stream"],
            gb_s=nbytes / ms / 1e6, library_ms=None)
    del v, c

    t0 = time.perf_counter()
    if ell is None:
        ell = build_operator(n, seed)
    setup_s = time.perf_counter() - t0
    n = ell.nrows
    nnz = n * K
    log(f"host setup {setup_s:.1f} s: n {n}, k {K}, band {BAND}, ELL width {ell.width}")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(ell.ncols)).to(dev, f32)
    A0 = gk.device_ell(ell, f32, dev, "spmv4")
    for role in MODES:
        A = gk.spmv_probe_ell(A0, role)
        ref = gk.spmv_probe_plain(A, x)
        err, scale = float((gk.spmv_probe(A, x) - ref).abs().max()), float(ref.abs().max())
        if not err <= TOL * scale:
            raise AssertionError(f"{role}: kernel vs plain {err / scale:.3e} > {TOL:.0e}")
        del ref
        ms = pf.chain_time(lambda v: gk.spmv_probe(A, v), x, k=iters, reps=3) * 1e3
        plain_ms = pf.chain_time(lambda v: gk.spmv_probe_plain(A, v), x, k=3,
                                 reps=1) * 1e3
        lib = None
        if role == "spmvp_base":
            csr = pf.library_csr(A.vals, A.cols, A.ncols)
            lib = pf.chain_time(lambda v: csr @ v, x, k=iters, reps=3) * 1e3
            del csr
        table = A.vals.nbytes + A.cols.nbytes
        row(role, role, ms, plain_ms, err, scale, pf.spmv_probe_bytes(A),
            pf.spmv_probe_flops(A), gnnz_s=nnz / ms / 1e6, table_gb_s=table / ms / 1e6,
            library_ms=lib)
        del A
    del A0
    ms = {r: rows[r]["ms"] for r in MODES}
    split = {"base_ms": ms["spmvp_base"],
             "gather_ms": ms["spmvp_base"] - ms["spmvp_nogather"],
             "reduction_ms": ms["spmvp_base"] - ms["spmvp_noreduce"],
             "neither_ms": ms["spmvp_neither"]}
    log("spmv split: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return {"probe": "kprobe", "n": n, "k": K, "band": BAND, "nnz": nnz,
            "width": ell.width, "iters": iters, "seed": seed, "card": info["name"],
            "power_limit": info["power_limit"], "host_setup_s": setup_s,
            "kernels": rows, "spmv_split": split}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else N
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    print(json.dumps(run(n, iters)), flush=True)


if __name__ == "__main__":
    main()
