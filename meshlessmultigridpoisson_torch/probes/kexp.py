"""SpMV and sweep experiment on the bench's synthetic operator (card only).

    python -m meshlessmultigridpoisson_torch.probes.kexp [n] [iters]

Port of the reference package's ``scripts/kexp.py`` (defaults 1,048,576
rows and its 20 repetitions).  On ``bench.synthetic_banded_csr(n, 70, 512,
seed 0)``, at 128- and 256-row ELL blocks, it times:

* the reference's rows: the v2 SpMV (``spmv_tpu2``, ``ell_spmv`` role
  ``spmv2``) and the v3 SpMV (``spmv_tpu3``, role ``spmv3``; the TPU
  gathers its patch tables outside the kernel, the port's kernel gathers
  x itself);
* rows of the port's own (the reference script has none): the v1 SpMV
  (``spmv_tpu``, role ``spmv1``) and, at 128-row blocks, the v1 (block,
  class) GS sweep (``sor_sweep_tpu``, ``class_sor_sweep`` role ``sweep1``;
  omega 1.4, every row smoothed, b from seed 2, no Lagrange column, x_lag
  0, as in ``probes.ktime``).

The three SpMV roles run one kernel on one layout: the reference's v1,
v2 and v3 differ only in how Mosaic stages x.  Per block size it prints G
(the most x patches of 128 rows one block reads, the reference's
``num_patches``) and the ELL width.  Before it is timed, each kernel is
held against its plain version on the same inputs (``TOL``, relative to
max |plain output|).  Each row gives ms per call (``utils.profiling.
chain_time``: ``iters`` calls, the median of three), Gnnz/s with nnz = n *
k (the reference's count), the bound (``utils.profiling.bound_ms``), the
plain version's ms and, for an SpMV, a ``torch.sparse`` CSR matvec's ms
(timed, never called by the port).  One JSON line ends the output.
Without a card it exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

N, ITERS = 1_048_576, 20
K, BAND = 70, 512
OMEGA = 1.4
BLOCK_ROWS = (128, 256)
# kernel vs plain, relative to max |plain output|: an SpMV sums ~70
# products in another order (f32); the sweep adds the update's few
# operations on top
TOL = {"spmv": 1e-5, "sweep": 1e-4}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_operator(n: int = N, seed: int = 0, a=None) -> dict:
    """Host side: the operator (``a``: a prebuilt CSR of it, as the bench
    builds) and its ELL, its G and its width at 128- and 256-row blocks."""
    from meshlessmultigridpoisson_torch.bench import synthetic_banded_csr
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops.ell import ell_from_csr, global_cols

    a = synthetic_banded_csr(n, K, BAND, seed) if a is None else a
    ells, g = {}, {}
    for br in BLOCK_ROWS:
        ells[br] = ell_from_csr(a, block_rows=br)
        g[br] = gk.block_patches(global_cols(ells[br]).numpy(),
                                 ells[br].nrows_pad // br).shape[1]
    return dict(a=a, ells=ells, g=g)


def run(n: int = N, iters: int = ITERS, seed: int = 0, a=None) -> dict:
    """Build, check and time; returns the result line as a dict.  ``a``:
    the operator's CSR, built by the caller (``bench.build_operator``)."""
    if not torch.cuda.is_available():
        raise SystemExit("the kexp probe times on the card: "
                         "torch.cuda.is_available() is False")
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    info = pf.card()
    log(f"card {info['name']}, power limit {info['power_limit']}")
    t0 = time.perf_counter()
    op = build_operator(n, seed, a)
    setup_s = time.perf_counter() - t0
    n = op["a"].shape[0]
    nnz = n * K
    log(f"host setup {setup_s:.1f} s: n {n}, k {K}, stored nnz {op['a'].nnz}")
    n_max = op["ells"][max(BLOCK_ROWS)].nrows_pad
    x_all = torch.from_numpy(np.random.default_rng(1).standard_normal(n_max)).to(dev, f32)
    b_all = torch.from_numpy(np.random.default_rng(2).standard_normal(n_max)).to(dev, f32)
    zl = torch.zeros((), dtype=f32, device=dev)
    rows, blocks = {}, {}

    def row(label, role, ms, plain_ms, err, scale, nbytes, flops, library_ms=None,
            own=False):
        b_ms, by = pf.bound_ms(nbytes, flops, f32, info["name"])
        rows[label] = dict(role=role, ms=ms, gnnz_s=nnz / ms / 1e6, plain_ms=plain_ms,
                           max_abs_err=err, rel_err=err / scale, bound_ms=b_ms,
                           bound_by=by, pct_of_bound=100.0 * b_ms / ms,
                           library_ms=library_ms, port_own=own)
        log(f"  {label:<24s} [{role}] {ms:.4f} ms  {nnz / ms / 1e6:.2f} Gnnz/s  bound "
            f"{b_ms:.4f} ms ({by}, {100.0 * b_ms / ms:.2f}%)  plain {plain_ms:.4f} ms  "
            f"rel err {err / scale:.2e}"
            + ("" if library_ms is None else f"  library {library_ms:.4f} ms")
            + ("  (the port's own row)" if own else ""))

    def held(kind, label, out, ref):
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        if not err <= TOL[kind] * scale:
            raise AssertionError(f"{label}: kernel vs plain {err / scale:.3e} > "
                                 f"{TOL[kind]:.0e}")
        return err, scale

    for br in BLOCK_ROWS:
        ell = op["ells"][br]
        blocks[br] = dict(g=op["g"][br], width=ell.width, n_pad=ell.nrows_pad)
        log(f"br={br} G={op['g'][br]} width={ell.width} n_pad={ell.nrows_pad}")
        x = x_all[: ell.ncols].contiguous()
        for role, name, own in (("spmv2", "v2", False), ("spmv3", "v3", False),
                                ("spmv1", "v1", True)):
            A = gk.device_ell(ell, f32, dev, role)
            label = f"spmv {name} (br={br})"
            ref = gk.ell_spmv_plain(A.vals, A.cols, x)
            err, scale = held("spmv", label, gk.ell_spmv(A, x), ref)
            plain_ms = pf.chain_time(lambda v: gk.ell_spmv_plain(A.vals, A.cols, v), x,
                                     k=iters, reps=1) * 1e3
            ms = pf.chain_time(lambda v: gk.ell_spmv(A, v), x, k=iters, reps=3) * 1e3
            csr = pf.library_csr(A.vals, A.cols, A.ncols)
            lib = pf.chain_time(lambda v: csr @ v, x, k=iters, reps=3) * 1e3
            del csr
            row(label, role, ms, plain_ms, err, scale, pf.spmv_bytes(A),
                pf.spmv_flops(A), lib, own)
        if br != 128:
            continue
        n_pad = ell.nrows_pad
        sw = gk.class_sweep(gk.device_ell(ell, f32, dev, "spmv1"), ell.diag, np.ones(n),
                            np.full(n_pad, OMEGA), np.zeros(n_pad), role="sweep1")
        x0, b = x_all[:n_pad], b_all[:n_pad].contiguous()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = gk.class_sor_sweep_plain(sw, x0.clone(), zl, b)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        label = "sweep v1 (br=128)"
        err, scale = held("sweep", label, gk.class_sor_sweep(sw, x0.clone(), zl, b), ref)
        xs = torch.zeros_like(x0)  # chained from x = 0, as in probes.ktime
        ms = pf.chain_time(lambda v: gk.class_sor_sweep(sw, v, zl, b), xs, k=iters,
                           reps=3) * 1e3
        row(label, "sweep1", ms, plain_ms, err, scale, pf.sweep_bytes(sw),
            pf.sweep_flops(sw), own=True)
    return {"probe": "kexp", "n": n, "k": K, "band": BAND, "nnz": nnz, "iters": iters,
            "seed": seed, "card": info["name"], "power_limit": info["power_limit"],
            "host_setup_s": setup_s, "blocks": blocks, "kernels": rows}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else N
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    print(json.dumps(run(n, iters)), flush=True)


if __name__ == "__main__":
    main()
