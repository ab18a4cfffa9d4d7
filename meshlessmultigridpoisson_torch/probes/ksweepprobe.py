"""Cost attribution of the storage-order one-shot sweep (card only).

    python -m meshlessmultigridpoisson_torch.probes.ksweepprobe [iters]

Port of the reference package's ``scripts/ksweepprobe.py``.  One link of
the production storage-order chain (``storage_chain``, role ``sweep6``:
the gather and row sums of a 128-row block against x, its ELL rows staged
in shared memory ahead, barrier, the 128 x 128 K product from the staged K
tile, barrier) is split by compile-time variants of that kernel
(``gpu_kernels.sweep_probe``), each of which drops one part:

* ``probe_base``: the production ``sweep6`` f32 instance itself, the
  reference;
* ``probe_nogather``: no gather and row sum (no ELL rows staged or
  prefetched), t = b - lag_col * x_lag;
* ``probe_nodot``: no K product (no K staged or prefetched), x_blk += t
  (on A / 128, so that the chain stays finite);
* ``probe_hoist``: the stale-program sweep's first design, its f32
  instance itself (role ``sweep7_stale_walk``, a one-CTA walk computing
  the reference's ``sor_sweep_tpu7(stale_program=True)``):
  the blocks of each group of 8 consecutive blocks all gather x as it
  stood when the group began (their rows read from device memory,
  prefetched into L2), then the group's 8 products run on two K buffers,
  so no x load waits on an update of its group.  It stands for the
  reference's "stale x loads" variant, whose output depends on the TPU's
  patch-table layout.

``probe_base`` and ``probe_hoist`` compute the exact and the stale sweep
(each held bit for bit against its production role, the JSON line's
``instances``); the other two are timing only and never reach a solve.  The
operator is the kernel bench's (``bench.build_operator()``: 1,048,576
rows, k 70, band 512, 8,192 blocks, one-shot K at omega 1.4, the
reference's ``scripts/kcache.py build`` operator); x from seed 1, b from
seed 2, no Lagrange column, x_lag 0.  Each mode is held against its plain
version (``gpu_kernels.sweep_probe_plain``) on the same inputs (``TOL``,
relative to max |plain output|), ``probe_base`` also bit for bit against a
``sweep6`` sweep (``gpu_kernels.storage_chain``) and ``probe_hoist``
against a ``sweep7_stale_walk`` one (``gpu_kernels.stale_sweep``), then timed:
``iters`` sweeps chained in place from x, between CUDA events
(``utils.profiling.chain_time``, each run from a fresh copy of x), the
median of three runs.  Each line gives ms per sweep, us per block, the
bound of the mode's own work (``profiling.probe_bytes`` / ``probe_flops``)
and the plain version's ms; the JSON line that ends the output splits
``probe_base``'s time per block into the gather (base - nogather) and the
K product (base - nodot), and gives ``probe_hoist``'s time per block
beside base's.  Base minus hoist is not the wait of x loads on the chain:
hoist runs another loop with costs of its own that no mode separates (no
ELL tile, so its rows come from L2; the group's 8 blocks gathered one
after another, each block's loads issued after the previous block's row
sums; a barrier pair a product), so that wait stays unmeasured.
Without a card it exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

ITERS = 5
MODES = ("probe_base", "probe_hoist", "probe_nodot", "probe_nogather")
# the modes that launch a production role's kernel instance
INSTANCES = {"probe_base": "the sweep6 f32 instance",
             "probe_hoist": "the sweep7_stale_walk f32 instance"}
# kernel vs plain, relative to max |plain output|: the 128-term K product
# and the ~70-term row sums in another order (f32)
TOL = 1e-4
# probe_nodot runs on A / 128 (a power of two: the same digits): with A
# itself, x_blk += b - A x multiplies x by ~70 on every row and carries it
# down the chain, and one sweep overflows f32; the kernel's work is the same
NODOT_SCALE = 128.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def probe_sweep(op: dict, role: str, device, dtype=torch.float32):
    """A ``BlockSweep`` of probe role ``role`` over the bench operator
    ``op`` (``bench.build_operator``): storage order, no Lagrange column;
    ``probe_nodot`` on A / ``NODOT_SCALE``."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    ell = op["ell"]
    nb = ell.nrows_pad // gk.LANES
    A = gk.device_ell(ell, dtype, device, "spmv6")
    if role == "probe_nodot":
        A = dataclasses.replace(A, vals=A.vals / NODOT_SCALE)
    return gk.BlockSweep(
        A=A,
        kT=torch.from_numpy(op["kT"]).to(device=device, dtype=dtype),
        lagc=torch.zeros(ell.nrows_pad, dtype=dtype, device=device),
        order=torch.arange(nb, dtype=torch.int32, device=device),
        phase_ptr=(0, nb), serial=True, role=role)


def run(iters: int = ITERS, seed: int = 0, op: dict | None = None) -> dict:
    """Build, check and time; returns the result line as a dict.  ``op``:
    ``bench.build_operator()``'s output, built by the caller."""
    if not torch.cuda.is_available():
        raise SystemExit("the sweep probe times on the card: "
                         "torch.cuda.is_available() is False")
    from meshlessmultigridpoisson_torch import bench
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    info = pf.card()
    log(f"card {info['name']}, power limit {info['power_limit']}")
    t0 = time.perf_counter()
    op = bench.build_operator(seed=seed) if op is None else op
    setup_s = time.perf_counter() - t0
    n_pad = op["ell"].nrows_pad
    nb = n_pad // gk.LANES
    log(f"host setup {setup_s:.1f} s: {n_pad} rows, {nb} blocks")
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(n_pad)).to(dev, f32)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(n_pad)).to(dev, f32)
    zl = torch.zeros((), dtype=f32, device=dev)
    rows = {}
    for role in MODES:
        sw = probe_sweep(op, role, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = gk.sweep_probe_plain(sw, x0.clone(), zl, b)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        out = gk.sweep_probe(sw, x0.clone(), zl, b)
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        if not err <= TOL * scale:
            raise AssertionError(f"{role}: kernel vs plain {err / scale:.3e} > {TOL:.0e}")
        if role in INSTANCES:  # the production role's instance, bit for bit
            prod_sw = dataclasses.replace(sw, role="sweep6")
            prod = (gk.storage_chain(prod_sw, x0.clone(), zl, b) if role == "probe_base"
                    else gk.stale_sweep(gk.stale_sweep_of(prod_sw, gk.STALE_WALK),
                                        x0.clone(), zl, b))
            if not torch.equal(prod, out):
                raise AssertionError(f"{role} is not {INSTANCES[role]}")
            del prod
        del out, ref
        ms = pf.chain_time(lambda v: gk.sweep_probe(sw, v, zl, b), x0, k=iters, reps=3,
                           restart=True) * 1e3
        b_ms, by = pf.bound_ms(pf.probe_bytes(sw), pf.probe_flops(sw), f32, info["name"])
        rows[role] = dict(role=role, ms=ms, us_per_block=ms * 1e3 / nb, plain_ms=plain_ms,
                          max_abs_err=err, rel_err=err / scale, bound_ms=b_ms,
                          bound_by=by, pct_of_bound=100.0 * b_ms / ms, library_ms=None)
        log(f"  {role:<16s} {ms:.4f} ms/sweep  {ms * 1e3 / nb:.3f} us/block  bound "
            f"{b_ms:.4f} ms ({by})  plain {plain_ms:.1f} ms  rel err {err / scale:.2e}")
        del sw
    us = {r: rows[r]["us_per_block"] for r in MODES}
    split = {"gather_us": us["probe_base"] - us["probe_nogather"],
             "k_product_us": us["probe_base"] - us["probe_nodot"],
             "base_us": us["probe_base"], "hoist_us": us["probe_hoist"]}
    log("per block: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return {"probe": "ksweepprobe", "n": n_pad, "blocks": nb, "iters": iters,
            "seed": seed, "card": info["name"], "power_limit": info["power_limit"],
            "host_setup_s": setup_s, "kernels": rows, "split_per_block": split,
            "instances": INSTANCES}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    print(json.dumps(run(int(argv[0]) if argv else ITERS)), flush=True)


if __name__ == "__main__":
    main()
