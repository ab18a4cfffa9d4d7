"""Smoother contraction rates by power iteration (host f64, and on the card).

    python -m meshlessmultigridpoisson_torch.probes.rho [--kinds delta colored stale]
        [--device cuda|cpu] [--iters 120] [--burn 60] [--out results/rho_torch_h100.json]

Port of the reference's ``scripts/rho_delta.py``, ``rho_colored.py`` and
``rho_stale.py``.  Each measures the asymptotic contraction factor rho of
one production smoother iteration on its error map (b = 0): from x drawn
by ``numpy.random.default_rng(0)`` and x_lag 0.7, ``iters`` times one
sweep, then the Lagrange-row relax x_lag = (1 - omega) x_lag - omega
lag_row . x, then the Neumann boundary rows' re-solve, each time the L1
norm |x|_1 + |x_lag| taken and both divided by it; rho is the geometric
mean of the norms after the first ``burn``.  Three comparisons, each on
the configurations of its record (``CONFIGS``; the operator of
``build_op``: the level operator of the cloud at that size and degree,
RCM-ordered, boundary data 0.1):

* ``delta`` (``results/rho_delta_r2.json``): the class-parallel sweep
  (``ops.smoothers``' tiles of ``class_size`` rows, each tile from the
  current x) against exact sequential SOR in the same row order (the
  reference's ``tests/test_reference_parity.reference_sor_sweep`` with the
  per-row omega; this module's own ``exact_sor``);
* ``colored`` (``results/rho_colored_r4.json``): the block one-shot sweep
  in the colored block order (``gpu_kernels.colored_order``, refused as
  the reference's ``prepare_colored_sweep(..., max_expand=3.0,
  min_blocks=2)`` refuses: ``gpu_kernels.colored_refusal``) against
  storage order;
* ``stale`` (``results/rho_stale_r3.json``): the stale-program sweep
  (``gpu_kernels.stale_sweep``: each group of 8 blocks from x as the group
  began, the reference's ``sor_sweep_tpu7(stale_program=True)``) against
  the block-sequential one.

Host mode (always): f64 on the CPU through the kernels' plain versions
(the exact SOR through one sparse triangular factorization).  Card mode
(``--device cuda``): each sweep one launch of the port's kernel in f64 on
the same operator (``class_sor_sweep``, role ``sweep2``, for ``delta``'s
class-parallel side, whose exact side has no kernel; ``colored_smooth``
``sweep8`` and ``storage_chain`` ``sweep6`` for ``colored``; the stale
mode ``sweep7_stale`` and ``sweep6`` for ``stale``), the relax in torch
and the re-solve a ``compact_rows`` launch.  Each row prints the record's
value beside the host's (and the card's); the card's name and power limit
stand in the output.  Without a card, ``--device cuda`` exits non-zero.
``--undamped`` runs every row at the full omega: the records were made
before the reference damped the rows of in-block coloring conflicts to
omega 1.0 (``stencil/operators.py``'s ``omega_scale``), and reproduce so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import warnings

import numpy as np
import torch

ITERS, BURN = 120, 60  # the reference scripts' defaults
RECORDS = {"delta": "results/rho_delta_r2.json",
           "colored": "results/rho_colored_r4.json",
           "stale": "results/rho_stale_r3.json"}
# (geom, n, deg, neumann): each script's own list
CONFIGS = {
    "delta": (("square", 2500, 6, True), ("square", 2500, 6, False),
              ("square", 10000, 6, True), ("square_with_circle", 2532, 6, True)),
    "colored": (("square", 2500, 6, True), ("square", 2500, 6, False),
                ("square", 10000, 6, True), ("square_with_circle", 2532, 6, True),
                ("square_with_circle", 10197, 6, True)),
    "stale": (("square", 10000, 6, True), ("square", 10000, 6, False),
              ("square", 2500, 4, True), ("square_with_circle", 10000, 6, True)),
}
# each kind's two sides: (key of the side under test, key of its baseline)
SIDES = {"delta": ("rho_framework", "rho_exact_gs"),
         "colored": ("rho_colored", "rho_storage"),
         "stale": ("rho_stale_program", "rho_exact_blockseq")}
COLORED_MAX_EXPAND, COLORED_MIN_BLOCKS = 3.0, 2  # rho_colored.py's prepare_colored_sweep
CARD_TOL = 1e-3  # |card rho - host rho|: both f64, apart only by summation order
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_op(geom: str, n: int, deg: int, neumann: bool, seed: int = 0):
    """(level operator, conflicting pairs left by the in-block coloring) of
    the reference scripts' ``build_op``: the cloud, RCM order, boundary
    data 0.1 on every boundary (all Neumann or all Dirichlet)."""
    from meshlessmultigridpoisson_torch.config import GridConfig
    from meshlessmultigridpoisson_torch.geometry.pointclouds import make_cloud
    from meshlessmultigridpoisson_torch.mg.setup import order_cloud
    from meshlessmultigridpoisson_torch.stencil.operators import (
        bc_flags_from_cloud,
        build_level_operator,
    )

    cloud = make_cloud(geom, n, seed=seed)
    cfg = GridConfig(poly_deg=deg)
    oc = order_cloud(cloud, cfg.stencil_size, neumann)
    flags = bc_flags_from_cloud(oc, ["neumann" if neumann else "dirichlet"]
                                * len(oc.boundaries))
    gvals = np.where(flags != 0, 0.1, 0.0)
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        op = build_level_operator(oc, flags, gvals, cfg)
    conflicts = 0
    for w in wl:
        msg = str(w.message)
        if "conflicting pairs" in msg:
            conflicts = int(msg.split("left ")[1].split(" conflicting")[0])
    return op, conflicts


def power_rho(step, x: torch.Tensor, x_lag: torch.Tensor, iters: int = ITERS,
              burn: int = BURN) -> float:
    """Geometric mean of the L1 norms after ``burn`` of ``iters`` steps of
    the normalised map ``step(x, x_lag) -> (x, x_lag)``; the norms stay on
    ``x``'s device until the end."""
    norms = []
    for _ in range(iters):
        x, x_lag = step(x, x_lag)
        nn = x.abs().sum() + x_lag.abs()
        norms.append(nn)
        x, x_lag = x / nn, x_lag / nn
    tail = torch.stack(norms[burn:]).double().cpu()
    return float(torch.exp(torch.log(tail).mean()))


def start(n_pad: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The scripts' start: x ~ default_rng(0).standard_normal, x_lag 0.7."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n_pad))
    return x.to(device), torch.tensor(0.7, dtype=torch.float64, device=device)


def level_step(lv, sweep):
    """One smoother iteration on GpuLevel ``lv`` (b = 0): ``sweep(x, x_lag,
    zero)`` updates x in place, then the Lagrange relax, then the boundary
    re-solve (``compact_rows``: its plain version on CPU tensors)."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    zero = torch.zeros(lv.n_pad, dtype=torch.float64, device=lv.lag_row.device)

    def step(x, x_lag):
        x = x.clone()
        sweep(x, x_lag, zero)
        if lv.has_lagrange:
            x_lag = (1.0 - lv.omega) * x_lag + lv.omega * (0.0 - (lv.lag_row * x).sum())
        if lv.bound.nrows:
            gk.compact_rows(lv.bound, x, zero)
        return x, x_lag

    return step


def exact_sor(op):
    """Exact sequential SOR in the stored row order on host LevelOperator
    ``op`` with its per-row omega (omega * omega_scale), rows off the smooth
    mask left as they are: ``sweep(x, x_lag, b)`` in place on f64 CPU
    tensors.  Row i of the mask solves (d_i / w_i) x_i + sum_{j<i} a_ij
    x_j' = b_i - lag_col_i x_lag - sum_{j>i} a_ij x_j + (1 / w_i - 1) d_i
    x_i: one lower-triangular solve a sweep, factorized once."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from meshlessmultigridpoisson_torch.ops.ell import ell_to_csr

    A = ell_to_csr(op.A).tocsr()
    A.sum_duplicates()
    d = A.diagonal()
    m = op.smooth_mask.numpy() > 0
    w = op.omega * op.omega_scale.numpy()
    mf = m.astype(np.float64)
    T = sp.diags(np.where(m, d / np.where(m, w, 1.0), 1.0)) + sp.diags(mf) @ sp.tril(A, -1)
    lu = spla.splu(T.tocsc(), permc_spec="NATURAL", diag_pivot_thresh=0.0)
    U = sp.diags(mf) @ sp.triu(A, 1).tocsr()
    lagc = op.lag_col.numpy()
    relax = np.where(m, (1.0 / np.where(m, w, 1.0) - 1.0) * d, 0.0)

    def sweep(x, x_lag, b):
        xn = x.numpy()
        rhs = np.where(m, b.numpy() - lagc * float(x_lag) - U @ xn + relax * xn, xn)
        xn[:] = lu.solve(rhs)
        return x

    return sweep


def sweeps(kind: str, op, device, k_rule: str = "reference") -> dict:
    """The two sides of ``kind`` on host LevelOperator ``op`` in f64 on
    ``device``: {"level": GpuLevel, side key: sweep(x, x_lag, b) or None
    where a side has no kernel there, "refused": why the colored order was
    refused (colored), "ncolors"}.  The block sweeps take K by ``k_rule``
    (``gpu_kernels.build_oneshot_K``'s ``duplicates``: "reference" the
    reference's K, with which its records were measured; "sum" the port's
    own, the solve's).  On CPU tensors every kernel runs its plain
    version."""
    from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_level_from_operator
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops.ell import global_cols

    f64 = torch.float64
    device = torch.device(device)
    test, base = SIDES[kind]
    if kind == "delta":
        lv = gpu_level_from_operator(op, device, f64, use_v6=False)
        out = {"level": lv, test: lambda x, xl, b: gk.class_sor_sweep(lv.sweep, x, xl, b),
               base: exact_sor(op) if device.type == "cpu" else None}
        return out
    lv = gpu_level_from_operator(op, device, f64, sweep_order="exact")
    nb = lv.n_pad // gk.LANES
    kT = gk.build_oneshot_K(op.A, op.omega * op.omega_scale.numpy(), op.smooth_mask.numpy(),
                            class_size=op.class_size, duplicates=k_rule)
    storage = dataclasses.replace(
        lv.sweep, kT=torch.from_numpy(kT).to(device), phase_ptr=(0, nb), serial=True,
        order=torch.arange(nb, dtype=torch.int32, device=device), role="sweep6",
        patches=None)
    out = {"level": lv, base: lambda x, xl, b: gk.storage_chain(storage, x, xl, b)}
    if kind == "stale":
        stale = gk.stale_sweep_of(storage)
        out[test] = lambda x, xl, b: gk.stale_sweep(stale, x, xl, b)
        return out
    gcols = global_cols(op.A).numpy()
    pids = gk.block_patches(gcols, nb)
    colors = gk.color_blocks(pids, nb)
    out["ncolors"] = int(colors.max()) + 1
    out["refused"] = gk.colored_refusal(pids, nb, colors, min_blocks=COLORED_MIN_BLOCKS,
                                        max_expand=COLORED_MAX_EXPAND)
    order, ptr = gk.colored_order(colors)
    colored = dataclasses.replace(
        storage, order=torch.from_numpy(order.astype(np.int32)).to(device),
        phase_ptr=ptr, serial=False, role="sweep8",
        patches=gk.block_patch_tables(gcols, nb, device))
    out[test] = lambda x, xl, b: gk.block_oneshot_sweep(colored, x, xl, b)
    return out


def rho_pair(kind: str, op, device="cpu", iters: int = ITERS, burn: int = BURN,
             k_rule: str = "reference") -> dict:
    """{side key: rho} of ``kind`` on ``op`` in f64 on ``device`` (a side
    without a kernel on the card is left out), with "ncolors" and "refused"
    for ``colored`` (no rho where refused); K by ``k_rule``."""
    s = sweeps(kind, op, device, k_rule)
    out = {k: s[k] for k in ("ncolors", "refused") if k in s}
    if s.get("refused"):
        return out
    lv = s["level"]
    for side in SIDES[kind]:
        if s[side] is not None:
            out[side] = power_rho(level_step(lv, s[side]), *start(lv.n_pad, lv.lag_row.device),
                                  iters, burn)
    return out


def _record(kind: str, cfg: tuple) -> dict | None:
    path = os.path.join(REPO, RECORDS[kind])
    if not os.path.exists(path):
        return None
    geom, n, deg, neumann = cfg
    with open(path) as f:
        rows = json.load(f)
    for r in rows:
        if (r.get("kind") is None and (r["geom"], r["n"], r["deg"], r["neumann"])
                == (geom, n, deg, neumann)):
            return r
    return None


# the K rules a row measures: the reference's first (the records' and the
# scripts' K), then the port's own, for the kinds whose sweeps take a K
K_RULES = {"delta": ("reference",), "colored": ("reference", "sum"),
           "stale": ("reference", "sum")}


def measure(kind: str, cfg: tuple, device: str = "cpu", iters: int = ITERS,
            burn: int = BURN, built=None, undamped: bool = False) -> dict:
    """One row: ``kind`` at ``cfg`` = (geom, n, deg, neumann), host f64
    always and, with ``device`` "cuda", the card's f64 kernels, each with
    the reference's K ("host", "card") and, for the block sweeps, the
    port's ("host_port_k", "card_port_k"); the record's values beside
    them, and "launches" of the card side (counts set to 0 before it, read
    after).  ``built``: ``build_op(*cfg)``'s result, to reuse.
    ``undamped``: every row at the full omega (``omega_scale`` 1), the
    operator as the reference built it before it damped the rows of
    in-block coloring conflicts to omega 1.0, when its records were made."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    geom, n, deg, neumann = cfg
    t0 = time.perf_counter()
    op, conflicts = built or build_op(geom, n, deg, neumann)
    if undamped:
        op = dataclasses.replace(op, omega_scale=torch.ones_like(op.omega_scale))
    row = dict(kind=kind, geom=geom, n=n, deg=deg, neumann=neumann, n_pad=op.n_pad,
               iters=iters, burn=burn, conflict_pairs=conflicts, undamped=undamped,
               host_setup_s=time.perf_counter() - t0)
    test, base = SIDES[kind]
    sides = [("host", "cpu")] + ([("card", device)] if device != "cpu" else [])
    for where, dev in sides:
        if where == "card":
            gk.reset_counts()
        t0 = time.perf_counter()
        for rule in K_RULES[kind]:
            key = where + ("" if rule == "reference" else "_port_k")
            r = row[key] = rho_pair(kind, op, dev, iters, burn, rule)
            if base in r and test in r:
                r["rho_delta"] = r[test] - r[base]
        if where == "card":
            torch.cuda.synchronize()
            row["launches"] = {k: v for k, v in gk.COUNTS.items() if v}
        row[f"{where}_s"] = time.perf_counter() - t0
    if "card" in row:
        row["card_minus_host"] = {
            f"{k}{sfx}": row["card" + sfx][k] - row["host" + sfx][k]
            for sfx in ("", "_port_k") if "card" + sfx in row
            for k in SIDES[kind] if k in row["card" + sfx] and k in row["host" + sfx]}
    rec = _record(kind, cfg)
    if rec is not None:
        row["record"] = {k: rec[k] for k in (*SIDES[kind], "rho_delta") if k in rec}
        row["host_minus_record"] = {k: row["host"][k] - rec[k] for k in SIDES[kind]
                                    if k in row["host"] and k in rec}
    return row


def summary(row: dict) -> str:
    """One line: each side's host (card) value and the record's."""
    parts = []
    for side in SIDES[row["kind"]]:
        vals = [(name, row.get(key, {}).get(side))
                for name, key in (("host", "host"), ("card", "card"),
                                  ("host, port's K", "host_port_k"),
                                  ("card, port's K", "card_port_k"),
                                  ("record", "record"))]
        parts.append(f"{side} " + ", ".join(f"{name} {v:.9f}" for name, v in vals
                                            if v is not None))
    refused = row["host"].get("refused")
    return (f"{row['kind']} {row['geom']} n={row['n']} deg={row['deg']} "
            f"neumann={row['neumann']}: " + ("; ".join(parts) if not refused
                                             else f"colored order refused ({refused})"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kinds", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--burn", type=int, default=BURN)
    ap.add_argument("--out", default=None)
    ap.add_argument("--undamped", action="store_true",
                    help="every row at the full omega: the operator of the records' time")
    args = ap.parse_args(argv)
    info = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("probes.rho: --device cuda needs a card (torch.cuda.is_available() "
                  "is False); --device cpu runs the host mode", file=sys.stderr)
            return 1
        from meshlessmultigridpoisson_torch.utils.profiling import card

        info = card()
        print(f"card {info['name']}, power limit {info['power_limit']}", flush=True)
    rows, bad = [], []
    for kind in args.kinds:
        for cfg in CONFIGS[kind]:
            row = measure(kind, cfg, args.device, args.iters, args.burn,
                          undamped=args.undamped)
            if info is not None:
                row.update(card_name=info["name"], power_limit=info["power_limit"])
                off = {k: v for k, v in row["card_minus_host"].items()
                       if not (math.isfinite(v) and abs(v) <= CARD_TOL)}
                if off:
                    bad.append(f"{summary(row)}: card minus host {off}")
            rows.append(row)
            print(summary(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    for b in bad:
        print(f"probes.rho: card and host apart by more than {CARD_TOL}: {b}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
