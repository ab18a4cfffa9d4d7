"""The kiso probes' shared operator and check-and-time loop (card only).

``probes.kiso6``, ``probes.kiso7`` and ``probes.kiso8`` each run a few
roles of ``gpu_kernels.kiso_spmv`` on the reference scripts' operator,
``bench.synthetic_banded_csr(n, 70, 512, seed)`` at 128-row blocks (the
port's row-major ELL, ``probes.kprobe``'s operator), x from seed 1.  Each
role is held against its plain version (``TOL`` of max |plain output|),
then timed with ``utils.profiling.chain_time`` (``iters`` launches between
CUDA events, the median of three).  Each row gives ms, the plain version's
ms, the bound of the role's own work (``profiling.kiso_bytes`` /
``kiso_flops``) and its share, Gnnz/s with nnz = n * 70 (the reference's
count), GB/s over the role's tables, its distance from an f64 SpMV of the
same x (``f64_rel_err``), and, for the roles that compute y = A x, the
time of a ``torch.sparse`` CSR matvec (``profiling.library_csr``, a call
the port never makes).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# the host side: kprobe's banded operator, its ELL at 128-row blocks
from meshlessmultigridpoisson_torch.probes.kprobe import BAND, K, build_operator

N, ITERS = 262_144, 20
# kernel vs plain, relative to max |plain output|: ~70 f32 products summed in
# another order (a warp-shuffle tree or the tensor cores' adds against
# torch's sum); "kiso8_mxudef" and "kiso8_mxudef_v1" against their TF32
# plain version (the same rounded products)
TOL = 1e-5
# one TF32 pass: not y = A x to f32, no library row
APPROX = ("kiso8_mxudef", "kiso8_mxudef_v1")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def refuse_cpu(name: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit(f"the {name} probe times on the card: "
                         "torch.cuda.is_available() is False")


def run_roles(name: str, roles, n: int, iters: int, seed: int, ell=None,
              stock: str | None = None) -> dict:
    """Build ``ell`` if not given, check and time each role (and, with
    ``stock``, the production ``ell_spmv`` under that role); returns the
    result line as a dict."""
    refuse_cpu(name)
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    dev, f32 = torch.device("cuda", 0), torch.float32
    info = pf.card()
    log(f"card {info['name']}, power limit {info['power_limit']}")
    t0 = time.perf_counter()
    if ell is None:
        ell = build_operator(n, seed)
    setup_s = time.perf_counter() - t0
    n = ell.nrows
    nnz = n * K
    log(f"host setup {setup_s:.1f} s: n {n}, k {K}, band {BAND}, ELL width {ell.width}")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(ell.ncols)).to(dev, f32)
    A0 = gk.device_ell(ell, f32, dev, stock or "spmv4")
    y64 = gk.ell_spmv_plain(A0.vals.double(), A0.cols, x.double())
    csr = pf.library_csr(A0.vals, A0.cols, A0.ncols)
    lib_ms = pf.chain_time(lambda v: csr @ v, x, k=iters, reps=3) * 1e3
    del csr
    rows = {}

    def row(role, A, launch, plain, nbytes, flops, table):
        ref = plain(A, x)
        out = launch(A, x)
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        if not err <= TOL * scale:
            raise AssertionError(f"{role}: kernel vs plain {err / scale:.3e} > {TOL:.0e}")
        f64_err = float((out.double() - y64).abs().max()) / float(y64.abs().max())
        del ref, out
        ms = pf.chain_time(lambda v: launch(A, v), x, k=iters, reps=3) * 1e3
        plain_ms = pf.chain_time(lambda v: plain(A, v), x, k=3, reps=1) * 1e3
        b_ms, by = pf.bound_ms(nbytes, flops, f32, info["name"])
        lib = None if role in APPROX else lib_ms
        rows[role] = dict(role=role, ms=ms, plain_ms=plain_ms, max_abs_err=err,
                          rel_err=err / scale, f64_rel_err=f64_err, bound_ms=b_ms,
                          bound_by=by, pct_of_bound=100.0 * b_ms / ms,
                          gnnz_s=nnz / ms / 1e6, table_gb_s=table / ms / 1e6,
                          library_ms=lib)
        log(f"  {role:<22s} {ms:.4f} ms  bound {b_ms:.4f} ms ({by}, "
            f"{100.0 * b_ms / ms:.1f}%)  plain {plain_ms:.4f} ms  "
            f"err {err / scale:.2e}  vs f64 {f64_err:.2e}"
            + ("" if lib is None else f"  library {lib:.4f} ms"))

    if stock is not None:
        row(stock, A0, gk.ell_spmv, lambda A, v: gk.ell_spmv_plain(A.vals, A.cols, v),
            pf.spmv_bytes(A0), pf.spmv_flops(A0), A0.vals.nbytes + A0.cols.nbytes)
    del A0
    for role in roles:
        A = gk.device_kiso(ell, dev, role)
        table = sum(t.nbytes for t in (A.vals, A.cols, A.col_base, A.ids) if t is not None)
        row(role, A, gk.kiso_spmv, gk.kiso_spmv_plain, pf.kiso_bytes(A), pf.kiso_flops(A),
            table)
        del A
    return {"probe": name, "n": n, "k": K, "band": BAND, "nnz": nnz, "width": ell.width,
            "iters": iters, "seed": seed, "card": info["name"],
            "power_limit": info["power_limit"], "host_setup_s": setup_s,
            "library_ms": lib_ms, "kernels": rows}


def main(run, argv=None) -> None:
    """``python -m ...probes.kisoN [n] [iters]``: one JSON line."""
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else N
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    print(json.dumps(run(n, iters)), flush=True)
