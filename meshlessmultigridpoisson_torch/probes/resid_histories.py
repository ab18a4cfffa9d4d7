"""Per-cycle V-cycle residual histories on a slice of the parameter sweep,
beside the lexicographic-SOR oracle's and the card's.

    python -m meshlessmultigridpoisson_torch.probes.resid_histories --device cpu \
        [--cycles 100] [--oracle-cycles 60] [--out host.json]
    python -m meshlessmultigridpoisson_torch.probes.resid_histories \
        [--host host.json] [--out results/resid_histories_torch.json]

Counterpart of the reference's ``scripts/resid_histories.py`` and
``scripts/resid_histories_oracle.py``.  The slice is theirs: three
geometries on the sweep ladder (``SWEEP_SIZES``), fine degree 4 and 6,
Dirichlet (sinsin) and Neumann (coscos), k = 1: 12 configurations, each
the raw V-cycle loop from the problem's start state (``mg/vcycle.
run_v_cycles``, not the Krylov wrapper), its relative L1 residual before
every cycle.  Raw V-cycling on small Neumann hierarchies may diverge
(PARITY.md §5: the reference never asserts convergence); histories are
recorded as they are.

* ``--device cpu`` (host mode): the host f64 hierarchy, ``--cycles``
  cycles and the manufactured solution's L1 error, and beside it the
  oracle (``oracle_v_cycles``, the port's own numpy copy of the
  reference's: the same schedule with exact sequential lexicographic SOR
  in global row order) at ``--oracle-cycles``; the history held against
  ``results/resid_histories_r3.json`` and the oracle's against
  ``resid_histories_oracle_r4.json`` (whose framework histories are r3's)
  by ``deviation``: over the cycles where the record's value is above
  ``FLOOR``, the first one past ``RTOL``; rows off are listed, not raised
  (see PERF.md).
* the card (the default): the same loop through the device V-cycle
  (``mg/gpu_backend.gpu_hierarchy``, f64 and f32: the colored order on the
  levels that take it, as a solve runs), ``--cycles`` cycles, beside the
  host rows of ``--host`` (a host-mode record) where given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import scipy.sparse as sp

SWEEP_SIZES = {  # the sweep harness ladder (cli sweep / the reference's run_tests)
    "square": [170, 600, 2500],
    "square_with_circle": [176, 640, 2532],
    "concentric_circles": [165, 650, 2530],
}
RECORD = "results/resid_histories_r3.json"
ORACLE_RECORD = "results/resid_histories_oracle_r4.json"
RTOL, FLOOR = 1e-8, 1e-12
CARD_DTYPES = ("float64", "float32")


def configs():
    """(geom, sizes, deg, neumann) of the slice, in the records' order."""
    for geom, sizes in SWEEP_SIZES.items():
        for deg in (4, 6):
            for neumann in (False, True):
                yield geom, sizes, deg, neumann


def problem(geom, sizes, deg, neumann, undamped: bool = False):
    """The configuration's problem; ``undamped``: every row of every level
    at the full omega (``omega_scale`` 1), the operator as the reference
    built it before it damped the rows of in-block coloring conflicts to
    omega 1.0 (``stencil/operators.py``)."""
    import dataclasses

    import torch

    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem

    prob = make_poisson_problem(geom, sizes=list(sizes), poly_deg=deg, k1=1,
                                neumann=neumann)
    if undamped:
        h = prob.hierarchy
        levels = tuple(dataclasses.replace(op, omega_scale=torch.ones_like(op.omega_scale))
                       for op in h.levels)
        prob = dataclasses.replace(prob, hierarchy=dataclasses.replace(h, levels=levels))
    return prob


# ---------------------------------------------------------------------------
# the oracle: the reference's scripts/resid_histories_oracle.py:50-180
# ---------------------------------------------------------------------------


def _csr(ell) -> sp.csr_matrix:
    from meshlessmultigridpoisson_torch.ops.ell import ell_to_csr

    return ell_to_csr(ell).tocsr()


def _level_ctx(op):
    """Numpy context for one level: CSR A, the Neumann rows, per-row omega."""
    n_pad = op.n_pad
    A = _csr(op.A)
    A.sum_duplicates()
    if op.bound.nrows:
        rows = np.asarray(op.bound.rows)[: op.bound.nrows]
        coo = _csr(op.bound.ell).tocoo()
        A_bd = sp.coo_matrix((coo.data, (rows[coo.row], coo.col)),
                             shape=(n_pad, n_pad)).tocsr()
        bd_diag = np.asarray(op.bound.ell.diag)[: op.bound.nrows]
        bd_rows = rows
    else:
        A_bd, bd_rows, bd_diag = None, np.array([], int), np.array([])
    return dict(
        op=op, A=A, A_bd=A_bd, bd_rows=bd_rows, bd_diag=bd_diag,
        smask=np.asarray(op.smooth_mask) > 0,
        dmask=np.asarray(op.dirichlet_mask) > 0,
        nmask=np.asarray(op.neumann_mask) > 0,
        dvals=np.asarray(op.dirichlet_values),
        lagc=np.asarray(op.lag_col), lagr=np.asarray(op.lag_row),
        omega_row=op.omega * np.asarray(op.omega_scale),
        indptr=A.indptr, indices=A.indices, data=A.data,
    )


def _bound_eval(c, x, b):
    if c["A_bd"] is not None and len(c["bd_rows"]):
        y = (c["A_bd"] @ x)[c["bd_rows"]]
        x[c["bd_rows"]] = (b[c["bd_rows"]] - (y - c["bd_diag"] * x[c["bd_rows"]])
                           ) / c["bd_diag"]
    return x


def _lex_sweep(c, x, xl, b):
    """One exact sequential lexicographic SOR sweep (grid.cpp:112-145)."""
    indptr, indices, data = c["indptr"], c["indices"], c["data"]
    smask, lagc, w_row = c["smask"], c["lagc"], c["omega_row"]
    for i in range(x.size):
        if not smask[i]:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        cols = indices[sl]
        vals = data[sl]
        own = cols == i
        diag = vals[own].sum()
        acc = lagc[i] * xl + vals[~own] @ x[cols[~own]]
        w = w_row[i]
        x[i] = (1 - w) * x[i] + w / diag * (b[i] - acc)
    return x


def _smooth(c, x, xl, b, bl, iters):
    op = c["op"]
    for _ in range(iters):
        x = _lex_sweep(c, x, xl, b)
        if op.has_lagrange:
            xl = (1 - op.omega) * xl + op.omega * (bl - c["lagr"] @ x)
        x = _bound_eval(c, x, b)
    return x, xl


def _residual(c, x, xl, b, bl):
    op = c["op"]
    y = c["A"] @ x + c["lagc"] * xl
    r = b - y
    r[c["dmask"]] = 0.0
    rl = (bl - (c["lagr"] @ x + xl)) if op.has_lagrange else 0.0
    return r, rl


def oracle_v_cycles(hier, b_fine, cycles: int) -> list:
    """The V-cycle schedule of ``mg/vcycle`` (multigrid.cpp:62-110: the
    pre-cycle residual recorded, descent with pre-smooth and
    Dirichlet-zeroed restriction, the coarsest smoothed twice from zero,
    ascent with prolongation and post-smooth) with the lexicographic-SOR
    smoother (per-row omega, the Lagrange border last, Neumann rows
    re-solved after each sweep); the relative L1 residual history."""
    L = len(hier.levels)
    ctxs = [_level_ctx(op) for op in hier.levels]
    R = [_csr(r) for r in hier.restrict]
    P = [_csr(p) for p in hier.prolong]
    fine = L - 1
    x = [np.zeros(op.n_pad) for op in hier.levels]
    xl = [0.0] * L
    b = [np.zeros(op.n_pad) for op in hier.levels]
    bl = [0.0] * L
    b[fine] = np.asarray(b_fine, np.float64).copy()
    hist = []
    for _ in range(cycles):
        cf = ctxs[fine]
        r, rl = _residual(cf, x[fine], xl[fine], b[fine], bl[fine])
        den = np.abs(b[fine]).sum() + abs(bl[fine])
        hist.append(float((np.abs(r).sum() + abs(rl)) / den))
        x[fine] = _bound_eval(cf, x[fine], b[fine])
        for i in range(fine, 0, -1):  # descend
            c = ctxs[i]
            op = c["op"]
            if i != fine:
                x[i][:] = 0.0
                xl[i] = 0.0
            x[i] = np.where(c["dmask"], 0.0 if i != fine else c["dvals"], x[i])
            x[i], xl[i] = _smooth(c, x[i], xl[i], b[i], bl[i], op.iters)
            r, _ = _residual(c, x[i], xl[i], b[i], bl[i])
            cc = ctxs[i - 1]
            bc = R[i - 1] @ r
            bc[cc["dmask"]] = 0.0
            if op.has_lagrange:
                bl[i - 1] = 0.0
                bc[cc["nmask"]] = 0.0
            b[i - 1] = bc
        c0 = ctxs[0]  # coarsest: zero guess, double smooth
        x[0][:] = 0.0
        xl[0] = 0.0
        x[0], xl[0] = _smooth(c0, x[0], xl[0], b[0], bl[0], c0["op"].iters)
        x[0], xl[0] = _smooth(c0, x[0], xl[0], b[0], bl[0], c0["op"].iters)
        for i in range(1, L):  # ascend
            c = ctxs[i]
            op = c["op"]
            corr = P[i - 1] @ x[i - 1]
            if not op.has_lagrange:
                corr[c["dmask"]] = 0.0
            x[i] = x[i] + corr
            x[i], xl[i] = _smooth(c, x[i], xl[i], b[i], bl[i], op.iters)
    return hist


# ---------------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------------


def host_history(prob, cycles: int):
    """(history, L1 error) of the host f64 V-cycle loop."""
    from meshlessmultigridpoisson_torch.mg.vcycle import run_v_cycles
    from meshlessmultigridpoisson_torch.models.poisson import l1_error

    state, hist = run_v_cycles(prob.hierarchy, prob.state0, cycles)
    return hist.tolist(), float(l1_error(prob, state.x[-1]))


def card_history(prob, cycles: int, device, dtype):
    """The device V-cycle loop's history (``dtype`` on ``device``)."""
    import torch

    from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_hierarchy
    from meshlessmultigridpoisson_torch.mg.vcycle import init_like, run_v_cycles

    hier = gpu_hierarchy(prob.hierarchy, device, dtype)
    s0 = prob.state0
    state = init_like(hier)
    fine = hier.num_levels - 1
    state = state.replace_level(fine, x=s0.x[fine].to(device, dtype),
                                b=s0.b[fine].to(device, dtype),
                                x_lag=s0.x_lag[fine].to(device, dtype),
                                b_lag=s0.b_lag[fine].to(device, dtype))
    _, hist = run_v_cycles(hier, state, cycles)
    return hist.double().cpu().tolist(), [lv.kernel_kind for lv in hier.levels]


def deviation(hist, ref) -> dict:
    """``hist`` against ``ref`` over the cycles where |ref| > ``FLOOR``:
    the largest relative deviation (None: no such cycle), and the first
    cycle where it passes ``RTOL`` with the record's value there (None:
    none passes), the deviation up to that cycle."""
    devs = [(i, abs(h - r) / abs(r), r) for i, (h, r) in enumerate(zip(hist, ref))
            if abs(r) > FLOOR]
    off = next(((i, d, r) for i, d, r in devs if d > RTOL), None)
    return dict(max=max(d for _, d, _ in devs) if devs else None,
                first_off=None if off is None else dict(cycle=off[0], dev=off[1],
                                                        record=off[2]),
                max_before=max((d for i, d, _ in devs if off is None or i < off[0]),
                               default=None))


def _records() -> tuple[dict, dict]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = []
    for name in (RECORD, ORACLE_RECORD):
        with open(os.path.join(root, name)) as f:
            out.append({(c["geom"], c["deg"], c["neumann"]): c for c in json.load(f)["configs"]})
    return out[0], out[1]


def host_mode(cycles: int, oracle_cycles: int, only=None, log=None,
              undamped: bool = False) -> dict:
    rec, orc = _records()
    rows = []
    for geom, sizes, deg, neumann in configs():
        if only and geom not in only:
            continue
        prob = problem(geom, sizes, deg, neumann, undamped)
        hist, l1 = host_history(prob, cycles)
        oracle = oracle_v_cycles(prob.hierarchy, np.asarray(prob.state0.b[-1]), oracle_cycles)
        key = (geom, deg, neumann)
        row = dict(geom=geom, sizes=[c.n for c in prob.clouds], deg=deg, k=1,
                   neumann=neumann, cycles=cycles, residual_history=hist,
                   final_residual=hist[-1], l1_error=l1, oracle_cycles=oracle_cycles,
                   reference_sor_history=oracle,
                   dev_vs_record=deviation(hist, rec[key]["residual_history"]),
                   dev_oracle_vs_record=deviation(oracle, orc[key]["reference_sor_history"]),
                   record_sizes=rec[key]["sizes"])
        rows.append(row)
        if log is not None:
            log(f"{geom} deg={deg} neumann={neumann}: final {hist[-1]:.3e} L1 {l1:.3e} "
                f"oracle {oracle[-1]:.3e}; first off the records: "
                f"{row['dev_vs_record']['first_off']} / "
                f"{row['dev_oracle_vs_record']['first_off']} (oracle)")
    off = [f"{r['geom']} deg {r['deg']} {'neumann' if r['neumann'] else 'dirichlet'}"
           for r in rows if any(r[k]["first_off"] is not None for k in (
               "dev_vs_record", "dev_oracle_vs_record"))]
    return dict(mode="host f64" + (", undamped" if undamped else ""), undamped=undamped,
                cycles=cycles, oracle_cycles=oracle_cycles, rtol=RTOL, floor=FLOOR,
                configs=rows, off_record=off)


def card_mode(cycles: int, host: dict | None = None, only=None, log=None) -> dict:
    import torch

    from meshlessmultigridpoisson_torch.utils.profiling import card

    dev = torch.device("cuda", torch.cuda.current_device())
    hrows = {(r["geom"], r["deg"], r["neumann"]): r for r in (host or {}).get("configs", [])}
    rows = []
    for geom, sizes, deg, neumann in configs():
        if only and geom not in only:
            continue
        prob = problem(geom, sizes, deg, neumann)
        row = dict(hrows.get((geom, deg, neumann), dict(
            geom=geom, sizes=[c.n for c in prob.clouds], deg=deg, k=1, neumann=neumann)))
        for dt in CARD_DTYPES:
            hist, kinds = card_history(prob, cycles, dev, getattr(torch, dt))
            row[f"card_{dt}_history"] = hist
            row["card_level_kernels"] = kinds
            if "residual_history" in row:
                row[f"card_{dt}_vs_host"] = deviation(hist, row["residual_history"])
        rows.append(row)
        if log is not None:
            log(f"{geom} deg={deg} neumann={neumann}: card f64 final "
                f"{row['card_float64_history'][-1]:.3e}, f32 "
                f"{row['card_float32_history'][-1]:.3e} ({row['card_level_kernels']})")
    out = dict(host or {}, configs=rows, card_cycles=cycles, card_dtypes=list(CARD_DTYPES))
    out.update(card())
    out["mode"] = "card" + (" beside host f64" if host else "")
    return out


def _log(m) -> None:
    print(m, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cycles", type=int, default=100)
    ap.add_argument("--oracle-cycles", type=int, default=60)
    ap.add_argument("--geoms", nargs="+", default=None, choices=list(SWEEP_SIZES))
    ap.add_argument("--host", default=None, help="a host-mode record to put beside")
    ap.add_argument("--undamped", action="store_true",
                    help="host mode: every row at the full omega, the operator of "
                         "the records' time")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        res = host_mode(args.cycles, args.oracle_cycles, args.geoms, _log, args.undamped)
    else:
        import torch

        if not torch.cuda.is_available():
            _log("probes.resid_histories: --device cuda needs a card (torch.cuda."
                 "is_available() is False); --device cpu runs the host mode")
            return 1
        host = None
        if args.host:
            with open(args.host) as f:
                host = json.load(f)
        res = card_mode(args.cycles, host, args.geoms, _log)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "configs"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
