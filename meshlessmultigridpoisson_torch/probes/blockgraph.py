"""Row lengths and the storage-order chain's dependency graph, per level.

    python -m meshlessmultigridpoisson_torch.probes.blockgraph [--neumann] [sizes ...]

Builds the slice's hierarchy on the host (square_with_circle, deg 6, kd-tile
order, 512-row assembly blocks; default sizes 2500 10000) and prints, per
level, one JSON line:

* the ELL table's rows, width and fill (nonzeros over stored entries), and
  the nonzeros a row holds (median, p90, the share of rows above 80): what
  ``ell_spmv`` reads once it stops at each row's last nonzero;
* the longest path of the storage-order block graph at 128-row blocks (the
  one-shot sweep's chain, ``storage_chain``) and at 8-row tiles (the class
  sweep, ``class_sor_sweep``): block j waits for every earlier block with
  which it shares a nonzero in either direction (j reads x rows that block
  writes, or that block reads x rows j writes).  A longest path equal to
  the block count means the chain is serial: running independent links side
  by side (level scheduling) gains nothing.

Host only (numpy); reads no card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def longest_path(cols: np.ndarray, nz: np.ndarray, rows_per_block: int) -> tuple[int, int]:
    """(longest path, blocks) of the storage-order dependency graph of an
    [n, width] table of global columns ``cols`` whose nonzeros are ``nz``,
    cut into blocks of ``rows_per_block`` rows (a column names the block of
    its row)."""
    n = cols.shape[0]
    nb = -(-n // rows_per_block)
    rows = np.broadcast_to(np.arange(n)[:, None], cols.shape)[nz]
    a = rows // rows_per_block
    b = cols[nz].astype(np.int64) // rows_per_block
    keep = (a != b) & (b < nb)
    lo, hi = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    pairs = np.unique(lo * nb + hi)
    pred = [[] for _ in range(nb)]
    for p in pairs.tolist():
        pred[p % nb].append(p // nb)
    depth = np.zeros(nb, dtype=np.int64)
    for j in range(nb):  # every predecessor comes earlier in storage order
        depth[j] = 1 + max((int(depth[i]) for i in pred[j]), default=0)
    return int(depth.max(initial=0)), nb


def level_stats(ell) -> dict:
    """Row lengths and the chain's longest paths of one level's table."""
    from meshlessmultigridpoisson_torch.ops.ell import global_cols

    vals = ell.vals.numpy()
    nz = vals != 0
    per_row = nz[: ell.nrows].sum(axis=1)
    cols = global_cols(ell).numpy()
    path128, nb128 = longest_path(cols, nz, 128)
    path8, nb8 = longest_path(cols, nz, 8)
    return dict(rows=ell.nrows, rows_pad=ell.nrows_pad, width=ell.width,
                fill=float(nz.sum() / max(ell.nrows * ell.width, 1)),
                nnz_per_row_median=float(np.median(per_row)),
                nnz_per_row_p90=float(np.percentile(per_row, 90)),
                rows_over_80=float((per_row > 80).mean()),
                longest_path_128=path128, blocks_128=nb128,
                longest_path_8=path8, tiles_8=nb8)


def main(argv=None) -> None:
    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem

    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", type=int, nargs="*", default=[2500, 10000])
    ap.add_argument("--neumann", action="store_true")
    ap.add_argument("--deg", type=int, default=6)
    args = ap.parse_args(argv)
    prob = make_poisson_problem("square_with_circle", sizes=args.sizes,
                                poly_deg=args.deg, neumann=args.neumann,
                                ordering="kdtile", block_rows=512, device="cpu")
    for i, op in enumerate(prob.hierarchy.levels):
        print(json.dumps(dict(level=i, neumann=args.neumann, **level_stats(op.A))),
              flush=True)


if __name__ == "__main__":
    main()
