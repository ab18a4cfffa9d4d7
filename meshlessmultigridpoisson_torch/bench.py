"""Kernel bench of the port: prints ONE JSON line.

    python -m meshlessmultigridpoisson_torch.bench [--seed 0]

Port of the reference package's root ``bench.py``.  It times the hot
kernels of every solve — the one-shot block Gauss-Seidel sweep and the ELL
SpMV — on a 1,048,576-row, 70-wide banded operator with RBF-FD-like
sparsity (``synthetic_banded_csr``, made from ``--seed``), on the card,
with CUDA events (``utils.profiling.chain_time``).  Beside them:

* ``stream_ceiling`` (the reference's Pallas stream probe, bench.py:118,
  here a CUDA kernel): two [2^18, 128] tables streamed ``reps`` times in
  one launch; a pass is the delta of 9 and 1 passes over 8;
* the torch elementwise stream ``v * 1.0000001`` over the ELL values, the
  independent calibration that no byte model enters (read + write);
* the plain gather SpMV on 131,072 rows (``vs_baseline``) and the library
  yardstick, a ``torch.sparse`` CSR matvec of the whole operator (timed
  here, never called by the port).

Each kernel's time stands beside its bound: the least time the card could
take for the same work (``utils.profiling.bound_ms``: the bytes the
function needs, counted once with ELL padding and K's zeros left out, over
the card's published memory rate, or operations over its arithmetic rate,
from the card's name).  Before it is timed, the stream probe is held
against its plain version at the timed depth, and each timed sweep
(storage order, colored, bf16 K) against ``block_oneshot_sweep_plain`` on
the same inputs (``SWEEP_TOL``).  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N, K, BAND = 1_048_576, 70, 512
N_BASE = 131_072  # rows of the plain gather SpMV (per-nnz cost is row-count independent)
STREAM_ROWS, STREAM_TILE = 1 << 18, 4096  # the reference probe's tables
OMEGA = 1.4
STREAM_REPS = 9  # passes of the timed stream probe launch
# each timed sweep against its plain version on the same inputs, before it
# is timed: f32 within 1e-4 of max |output| (another summation order under
# the 128-term K product), bf16 K within 1e-2 of max |dx| (both round t to
# bf16; a t element on the other side of a rounding boundary moves its
# column's contribution by one bf16 ulp, 2^-8)
SWEEP_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synthetic_banded_csr(n, k, band, seed=0):
    """RBF-FD-like sparsity: k nnz/row within +-band after RCM ordering."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    offs = rng.integers(-band, band + 1, size=(n, k - 1))
    cols = np.clip(np.arange(n)[:, None] + offs, 0, n - 1)
    cols = np.concatenate([np.arange(n)[:, None], cols], axis=1)
    vals = rng.standard_normal((n, k))
    vals[:, 0] = k + 1.0
    rows = np.repeat(np.arange(n), k)
    a = sp.coo_matrix((vals.ravel(), (rows, cols.ravel())), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def build_operator(n=N, k=K, band=BAND, seed=0) -> dict:
    """Host side: the CSR operator, its 128-row ELL, the one-shot K
    (omega 1.4, every row smoothed), the per-block x-patch lists, the
    colored block order and the union-slot count of the storage order."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops.ell import ell_from_csr, global_cols

    a = synthetic_banded_csr(n, k, band, seed)
    ell = ell_from_csr(a, block_rows=128)
    nb = ell.nrows_pad // gk.LANES
    kT = gk.build_oneshot_K(ell, np.full(ell.nrows_pad, OMEGA), np.ones(ell.nrows_pad))
    pids = gk.block_patches(global_cols(ell).numpy(), nb)
    order, ptr = gk.colored_order(gk.color_blocks(pids, nb))
    return dict(a=a, ell=ell, kT=kT, order=order, phase_ptr=ptr,
                union_slots=gk.union_slots(pids, nb))


def _kernel_row(name, ms, nbytes, flops, dtype, card):
    from meshlessmultigridpoisson_torch.utils.profiling import bound_ms

    b_ms, by = bound_ms(nbytes, flops, dtype, card)
    return dict(name=name, ms=ms, bytes=int(nbytes), gb_s=nbytes / ms / 1e6,
                bound_ms=b_ms, bound_by=by, pct_of_bound=100.0 * b_ms / ms)


def run(seed: int = 0) -> dict:
    """Build, time and check; returns the result line as a dict."""
    if not torch.cuda.is_available():
        raise SystemExit("the kernel bench times on the card: "
                         "torch.cuda.is_available() is False")
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    dev = torch.device("cuda", 0)
    info = pf.card()
    peak = pf.peaks(info["name"])
    log(f"card {info['name']}, power limit {info['power_limit']}")
    t0 = time.perf_counter()
    log(f"building synthetic operator n={N} k={K} band={BAND} seed={seed}")
    op = build_operator(N, K, BAND, seed)
    a, ell = op["a"], op["ell"]
    nb = ell.nrows_pad // gk.LANES
    nnz = int(a.nnz)
    setup_s = time.perf_counter() - t0
    log(f"host setup {setup_s:.1f} s: nnz {nnz}, {nb} blocks, "
        f"{len(op['phase_ptr']) - 1} colors, union slots {op['union_slots']}")

    f32 = torch.float32
    A = gk.device_ell(ell, f32, dev, "spmv6")
    kT32 = torch.from_numpy(op["kT"]).to(device=dev, dtype=f32)
    kTbf = kT32.to(torch.bfloat16)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal(ell.nrows_pad)).to(dev, f32)
    b = torch.from_numpy(np.random.default_rng(seed + 2).standard_normal(
        ell.nrows_pad)).to(dev, f32)
    zl = torch.zeros((), dtype=f32, device=dev)
    lagc = torch.zeros(ell.nrows_pad, dtype=f32, device=dev)
    storage = torch.arange(nb, dtype=torch.int32, device=dev)
    colored = torch.from_numpy(op["order"].astype(np.int32)).to(dev)

    def sweep(kt, order, ptr, serial, role):
        return gk.BlockSweep(A=A, kT=kt, lagc=lagc, order=order, phase_ptr=ptr,
                             serial=serial, role=role)

    rows = {}

    # --- stream_ceiling (kernel 14): a pass is the delta of 9 and 1 passes
    g = torch.Generator(device=dev).manual_seed(seed)
    sv = torch.randint(0, 4, (STREAM_ROWS, gk.STREAM_COLS), generator=g,
                       device=dev).to(f32)
    sc = torch.randint(0, 4, (STREAM_ROWS, gk.STREAM_COLS), generator=g,
                       device=dev, dtype=torch.int32)
    s_ref = gk.stream_ceiling_plain(sv, sc, STREAM_TILE)
    for r in (1, STREAM_REPS):
        s_err = float((gk.stream_ceiling(sv, sc, STREAM_TILE, r) - s_ref).abs().max())
        if s_err != 0.0:
            raise AssertionError(f"stream_ceiling ({r} passes) differs from its "
                                 f"plain version: {s_err}")

    def passes(reps):
        return pf.chain_time(lambda _: gk.stream_ceiling(sv, sc, STREAM_TILE, reps),
                             sv, k=3, reps=5)

    t_stream = (passes(STREAM_REPS) - passes(1)) / (STREAM_REPS - 1)
    s_bytes = sv.nbytes + sc.nbytes + STREAM_ROWS // STREAM_TILE * 8 * gk.STREAM_COLS * 4
    rows["stream14"] = _kernel_row("stream_ceiling", t_stream * 1e3, s_bytes,
                                   2 * sv.numel(), f32, info["name"])

    # --- torch elementwise stream over the ELL values (no byte model)
    t_ts = pf.chain_time(lambda v: v * 1.0000001, A.vals, k=9)
    torch_stream_gb_s = 2 * A.vals.nbytes / t_ts / 1e9

    # --- ell_spmv with the spot check against the f64 plain SpMV
    y = gk.ell_spmv(A, x)[:4096].double()
    yref = torch.from_numpy(a[:4096] @ x.double().cpu().numpy()).to(dev)
    spot = float((y - yref).abs().max() / yref.abs().max())
    log(f"spmv spot-check rel err vs f64: {spot:.2e}")
    if not spot < 1e-4:
        raise AssertionError(f"ell_spmv spot check {spot:.3e} >= 1e-4")
    t = pf.chain_time(lambda xx: gk.ell_spmv(A, xx), x)
    rows["spmv6"] = _kernel_row("ell_spmv", t * 1e3, pf.spmv_bytes(A),
                                pf.spmv_flops(A), f32, info["name"])

    # --- sweeps: storage order, colored, bf16 K of the faster kind; each
    # held against its plain version before it is timed
    sweep_err = {}

    def check_sweep(key, sw):
        out = gk.block_oneshot_sweep(sw, x.clone(), zl, b)
        ref = gk.block_oneshot_sweep_plain(sw, x.clone(), zl, b)
        bf = sw.kT.dtype == torch.bfloat16
        rel = float((out - ref).abs().max() / (ref - x if bf else ref).abs().max())
        log(f"{key} vs plain: rel err {rel:.2e}")
        if not rel <= SWEEP_TOL[sw.kT.dtype]:
            raise AssertionError(f"{key}: relative error {rel:.3e} against the plain "
                                 f"sweep > {SWEEP_TOL[sw.kT.dtype]:.0e}")
        sweep_err[key] = rel

    xs = x.clone()
    sw6 = sweep(kT32, storage, (0, nb), True, "sweep6")
    sw8 = sweep(kT32, colored, op["phase_ptr"], False, "sweep8")
    for key, sw, kk in (("sweep6", sw6, 2), ("sweep8", sw8, 16)):
        check_sweep(key, sw)
        t = pf.chain_time(lambda xx: gk.block_oneshot_sweep(sw, xx, zl, b), xs, k=kk,
                          reps=3)
        rows[key] = _kernel_row(f"block_oneshot_sweep [{key}]", t * 1e3,
                                pf.sweep_bytes(sw), pf.sweep_flops(sw), f32, info["name"])
    kind = "v8-colored" if rows["sweep8"]["ms"] < rows["sweep6"]["ms"] else "v6-oneshot"
    swbf = (sweep(kTbf, colored, op["phase_ptr"], False, "sweep8") if kind == "v8-colored"
            else sweep(kTbf, storage, (0, nb), True, "sweep6"))
    check_sweep("sweep_bf16k", swbf)
    t = pf.chain_time(lambda xx: gk.block_oneshot_sweep(swbf, xx, zl, b), xs,
                      k=16 if kind == "v8-colored" else 2, reps=3)
    rows["sweep_bf16k"] = _kernel_row(f"block_oneshot_sweep bf16 K [{swbf.role}]",
                                      t * 1e3, pf.sweep_bytes(swbf),
                                      pf.sweep_flops(swbf), f32, info["name"])

    # --- plain gather SpMV (baseline) and the torch.sparse CSR yardstick
    vb, cb = A.vals[:N_BASE].contiguous(), A.cols[:N_BASE].contiguous()
    t_plain = pf.chain_time(lambda xx: gk.ell_spmv_plain(vb, cb, xx), x, k=9)
    plain_nnz_s = N_BASE * ell.width / t_plain
    csr = pf.library_csr(A.vals, A.cols, A.ncols)
    t_lib = pf.chain_time(lambda xx: csr @ xx, x)
    rows["spmv6"]["library_ms"] = t_lib * 1e3

    best = min(rows["sweep6"]["ms"], rows["sweep8"]["ms"]) / 1e3
    sweep_nnz_s = nnz / best
    modelled = {key: r["gb_s"] for key, r in rows.items() if key != "stream14"}
    over = {key: v for key, v in modelled.items() if v > 1.05 * torch_stream_gb_s}
    warning = (f"modelled bandwidth above 105% of the measured torch stream "
               f"({torch_stream_gb_s:.0f} GB/s): {over}" if over else None)
    if warning:
        log(f"WARNING: {warning}")
    for key, r in rows.items():
        log(f"{r['name']:<40s} {r['ms']:.4f} ms  {r['gb_s']:.0f} GB/s  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) = {r['pct_of_bound']:.1f}%")
    return {
        "metric": "fused_sor_sweep_throughput_1M_k70",
        "value": sweep_nnz_s / 1e9,
        "unit": "Gnnz/s",
        "vs_baseline": sweep_nnz_s / plain_nnz_s,
        "extra": {
            "card": info["name"],
            "power_limit": info["power_limit"],
            "peak_gb_s": peak["bytes"] / 1e9,
            "kernels_ms": {key: r for key, r in rows.items()},
            "sweep_kind": kind,
            "spmv_gnnz_s": nnz / rows["spmv6"]["ms"] * 1e3 / 1e9,
            "spmv_spot_check_rel_err": spot,
            "sweep_vs_plain_rel_err": sweep_err,
            "stream_gb_s": rows["stream14"]["gb_s"],
            "torch_stream_gb_s": torch_stream_gb_s,
            "ceiling_gb_s": torch_stream_gb_s,
            "ceiling_source": "torch elementwise stream v * 1.0000001 (independent calibration)",
            "warning": warning,
            "plain_gather_spmv_gnnz_s": plain_nnz_s / 1e9,
            "library": ("kernels_ms.spmv6.library_ms: torch.sparse CSR matvec of the "
                        "whole operator (yardstick, not used by the port)"),
            "kernels": ("one storage-order kernel serves v7 and v6 (role sweep6, "
                        f"{op['union_slots']} union slots here), so the v7 and v6 "
                        "timings are the same; colored sweep role sweep8"),
            "host_setup_s": setup_s,
            "n": N, "k": K, "band": BAND, "seed": seed, "nnz": nnz,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="meshlessmultigridpoisson_torch.bench")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(seed=args.seed)), flush=True)


if __name__ == "__main__":
    main()
