"""Host-side domain partitioner: contiguous row blocks per rank, each shard
laid out [frontier | interior] for EXACT cross-shard Gauss-Seidel.

Port of the reference package's ``parallel/partition.py`` (host numpy/scipy,
f64).  It produces stacked ``[P, ...]`` numpy arrays, the leading axis the
shard, array for array the reference's host arrays; ``ShardedHierarchy.
shard(s)`` cuts out one rank's pieces, and ``parallel.sharded.
device_shards`` repacks them for the rank's kernels (in any dtype: the
counterpart of the reference's ``hierarchy_to_f32``).  The top
``shard_levels`` levels are row-partitioned (each with its own
frontier/interior layout); the remaining coarse tail stays replicated.

Exact distributed GS: under the SYMMETRIC coupling pattern a + a^T, any row
read across a shard boundary has a cross-shard neighbour itself, so every
cross-shard read touches a FRONTIER row.  Order the global sweep

    [frontier rows of shards s = 0 (mod C)] -> ... -> [= C-1 (mod C)]
    -> [all interior rows]

with C = (largest shard distance of any coupling) + 1.  Same-phase shards
never couple, so each frontier phase is parallel; earlier phases' values
arrive by an nf-row frontier exchange before each phase; the interior phase
reads own rows only.  Each shard stores its rows as [frontier (nf,
block-aligned, interiors borrowed to make nf uniform) | interior], both
groups (block, class)-recolored so the in-shard tile scan stays exact GS.

The reference's Pallas kernel tables (``k6_*``, ``k8_*``) are TPU layouts;
the port builds its own per-rank tables on the device instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from meshlessmultigridpoisson_torch.geometry.coloring import block_class_permutation
from meshlessmultigridpoisson_torch.mg.vcycle import Hierarchy
from meshlessmultigridpoisson_torch.ops.ell import ell_to_csr, global_cols
from meshlessmultigridpoisson_torch.stencil.operators import LevelOperator

SENTINEL = 10**6  # compact padding rows hold ns + SENTINEL (past any x_ext)

# stacked per-row / per-shard arrays of a ShardedFineLevel
LEVEL_ARRAYS = (
    "vals", "lcols_ext", "diag", "smooth_mask", "dirichlet_mask", "neumann_mask",
    "dirichlet_values", "neumann_values", "omega_w", "lag_col", "lag_row",
    "bound_rows", "bound_vals", "bound_lcols_ext", "bound_diag",
    "cond_rows", "cond_vals", "cond_lcols_ext",
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ShardedFineLevel:
    """A level split into P contiguous row shards (stacked host arrays).

    Per-shard row layout: [frontier (nf) | interior (ns - nf)].
    ``lcols_ext`` indexes the EXTENDED local vector
      x_ext = [own rows (ns) | left-1 frontier (nf) | right-1 frontier (nf)
               | left-2 | right-2 | ... hops]
    (hops = phases - 1).  Compact row sets (Neumann boundary, condensation)
    hold LOCAL row ids, ``ns + SENTINEL`` on padding slots.
    """

    vals: np.ndarray  # [P, ns, w]
    lcols_ext: np.ndarray  # [P, ns, w] int32 into x_ext
    diag: np.ndarray  # [P, ns]
    smooth_mask: np.ndarray
    dirichlet_mask: np.ndarray
    neumann_mask: np.ndarray
    dirichlet_values: np.ndarray
    neumann_values: np.ndarray
    omega_w: np.ndarray  # [P, ns] per-row omega (no seam damping)
    lag_col: np.ndarray
    lag_row: np.ndarray
    bound_rows: np.ndarray  # [P, mb] int32 local row ids (sentinel: big)
    bound_vals: np.ndarray  # [P, mb, wb]
    bound_lcols_ext: np.ndarray  # [P, mb, wb] int32
    bound_diag: np.ndarray  # [P, mb]
    cond_rows: np.ndarray  # [P, mc]
    cond_vals: np.ndarray  # [P, mc, wc]
    cond_lcols_ext: np.ndarray  # [P, mc, wc]
    n: int
    n_pad2: int
    num_shards: int
    shard_rows: int
    frontier_rows: int  # nf, uniform across shards, a multiple of block_rows
    phases: int  # C frontier phases (hops = C - 1)
    block_rows: int
    class_size: int
    width: int
    has_lagrange: bool
    omega: float
    iters: int
    has_bound: bool = False  # any shard holds a Neumann boundary row

    @property
    def halo(self) -> int:  # ext rows beyond own (both sides)
        return 2 * (self.phases - 1) * self.frontier_rows

    @property
    def ext_rows(self) -> int:
        return self.shard_rows + self.halo

    def shard(self, s: int) -> "ShardedFineLevel":
        """Shard ``s``'s rows: every stacked array's slice ``[s]`` (meta
        fields unchanged)."""
        return dataclasses.replace(self, **{k: getattr(self, k)[s] for k in LEVEL_ARRAYS})


def _compact_to_shards(rows, vals, gcols, diag, p, ns, newpos, ext_of):
    """Split compact row sets by owner shard; rows/cols in the new layout."""
    rows_new = newpos[rows]
    owner = rows_new // ns
    mmax = max(int(np.bincount(owner, minlength=p).max()) if rows.size else 0, 1)
    w = vals.shape[1]
    out_rows = np.full((p, mmax), ns + SENTINEL, dtype=np.int64)
    out_vals = np.zeros((p, mmax, w))
    out_cols = np.zeros((p, mmax, w), dtype=np.int64)
    out_diag = np.ones((p, mmax))
    for s in range(p):
        sel = np.nonzero(owner == s)[0]
        m = sel.size
        out_rows[s, :m] = rows_new[sel] - s * ns
        out_vals[s, :m] = vals[sel]
        ext = ext_of(s, newpos[gcols[sel]])
        out_cols[s, :m] = np.where(out_vals[s, :m] != 0.0, ext, 0)
        if diag is not None:
            out_diag[s, :m] = diag[sel]
    return out_rows, out_vals, out_cols, out_diag


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def partition_fine_level(op: LevelOperator, num_shards: int):
    """Split ``op`` into P shards with the frontier/interior layout.

    Returns (sharded level, newpos) where newpos[old_padded2_row] = new
    global position (the shard-local frontier/interior reorder composed
    onto the contiguous split).
    """
    p = num_shards
    b = op.A.block_rows
    n_pad = op.n_pad
    n_pad2 = _round_up(n_pad, p * b)
    ns = n_pad2 // p
    w = op.A.width

    vals0 = np.zeros((n_pad2, w))
    vals0[:n_pad] = _np(op.A.vals)
    gcols0 = np.zeros((n_pad2, w), dtype=np.int64)
    gcols0[:n_pad] = _np(global_cols(op.A))
    gcols0[n_pad:] = np.arange(n_pad, n_pad2)[:, None]  # pad rows self-point

    # --- symmetric coupling pattern on padded2 ids ---------------------------
    real = vals0 != 0.0
    rr = np.repeat(np.arange(n_pad2), w)[real.ravel()]
    cc = gcols0.ravel()[real.ravel()]
    pat = sp.coo_matrix((np.ones(rr.size), (rr, cc)), shape=(n_pad2, n_pad2)).tocsr()
    pat = (pat + pat.T).tocsr()

    row_shard = np.arange(n_pad2) // ns
    col_shard = pat.indices // ns
    reach = np.abs(col_shard - np.repeat(row_shard, np.diff(pat.indptr)))
    # frontier rows + phase count
    seg = np.zeros(n_pad2, dtype=np.int64)
    np.maximum.at(seg, np.repeat(np.arange(n_pad2), np.diff(pat.indptr)), reach)
    frontier = seg > 0
    C = int(seg.max()) + 1 if p > 1 else 1
    nf = int(frontier.reshape(p, ns).sum(axis=1).max()) if p > 1 else 0
    nf = min(_round_up(nf, b), ns) if nf else 0

    # --- per-shard reorder: [frontier (borrow interiors up to nf), interior] --
    def color(group):
        """``group`` recolored on its own pattern (in-shard tile independence)."""
        if group.size == 0:
            return group
        sub = pat[group][:, group].tocsr()
        perm, _ = block_class_permutation(sub, b, op.class_size)
        return group[perm]

    newpos = np.empty(n_pad2, dtype=np.int64)
    for s in range(p):
        lo = s * ns
        loc = np.arange(lo, lo + ns)
        fr = frontier[loc]
        fidx = loc[fr]
        iidx = loc[~fr]
        borrow = nf - fidx.size
        if borrow > 0:  # pad the frontier group with (harmless) interiors
            fidx = np.concatenate([fidx, iidx[:borrow]])
            iidx = iidx[borrow:]
        order = np.concatenate([fidx, iidx])  # old ids in new local order
        order = np.concatenate([color(order[:nf]), color(order[nf:])])
        newpos[order] = np.arange(lo, lo + ns)

    hops = C - 1

    def ext_of(s, q):
        """ext position of NEW global position(s) ``q``, seen from shard s."""
        qs = q // ns
        qloc = q - qs * ns
        d = qs - s
        base = np.where(d == 0, 0, ns + (np.abs(d) - 1) * 2 * nf + np.where(d < 0, 0, nf))
        out = np.where(d == 0, qloc, base + qloc)
        # cross-shard cols are always frontier rows (qloc < nf); clamp
        # padding junk into range
        return np.clip(out, 0, ns + 2 * hops * nf - 1)

    # --- permute row-wise arrays ----------------------------------------------
    iperm = np.argsort(newpos)  # new -> old

    def pad_rows(v, fill=0.0):
        v = _np(v)
        out = np.full(n_pad2, fill, dtype=np.float64)
        out[: v.shape[0]] = v
        return out[iperm]

    vals = vals0[iperm]
    gcols_new = newpos[gcols0[iperm]]
    rs = np.arange(n_pad2) // ns
    lcols_ext = np.empty((n_pad2, w), dtype=np.int64)
    for s in range(p):
        sl = slice(s * ns, (s + 1) * ns)
        lcols_ext[sl] = ext_of(s, gcols_new[sl])
    if p > 1:
        cross = np.abs(gcols_new // ns - rs[:, None]) > 0
        if not ((gcols_new % ns < nf) | ~cross | (vals == 0.0)).all():
            raise AssertionError("cross-shard read of a non-frontier row")

    def shard(vv):
        vv = np.asarray(vv)
        return vv.reshape(p, ns, *vv.shape[1:])

    omega_w = pad_rows(op.omega * _np(op.omega_scale), 1.0)

    def compact(c, with_diag):
        rows = _np(c.rows)[: c.nrows].astype(np.int64)
        return _compact_to_shards(
            rows, _np(c.ell.vals)[: c.nrows], _np(global_cols(c.ell))[: c.nrows].astype(
                np.int64), _np(c.ell.diag)[: c.nrows] if with_diag else None,
            p, ns, newpos, ext_of)

    br, bv, bcx, bd = compact(op.bound, True)
    cr, cv, ccx, _ = compact(op.cond, False)

    level = ShardedFineLevel(
        vals=shard(vals),
        lcols_ext=shard(lcols_ext.astype(np.int32)),
        diag=shard(pad_rows(op.A.diag, 1.0)),
        smooth_mask=shard(pad_rows(op.smooth_mask)),
        dirichlet_mask=shard(pad_rows(op.dirichlet_mask)),
        neumann_mask=shard(pad_rows(op.neumann_mask)),
        dirichlet_values=shard(pad_rows(op.dirichlet_values)),
        neumann_values=shard(pad_rows(op.neumann_values)),
        omega_w=shard(omega_w),
        lag_col=shard(pad_rows(op.lag_col)),
        lag_row=shard(pad_rows(op.lag_row)),
        bound_rows=br.astype(np.int32),
        bound_vals=bv,
        bound_lcols_ext=bcx.astype(np.int32),
        bound_diag=bd,
        cond_rows=cr.astype(np.int32),
        cond_vals=cv,
        cond_lcols_ext=ccx.astype(np.int32),
        n=op.n,
        n_pad2=n_pad2,
        num_shards=p,
        shard_rows=ns,
        frontier_rows=nf,
        phases=C,
        block_rows=b,
        class_size=op.class_size,
        width=w,
        has_lagrange=op.has_lagrange,
        omega=op.omega,
        iters=op.iters,
        has_bound=op.bound.nrows > 0,
    )
    return level, newpos


# the transfer tables of a ShardedHierarchy, stacked [P, ...]
TRANSFER_ARRAYS = ("restrict_vals", "restrict_lcols", "prolong_vals", "prolong_cols")
INTER_ARRAYS = ("inter_restrict_vals", "inter_restrict_lcols", "inter_prolong_vals",
                "inter_prolong_cols")


@dataclasses.dataclass(frozen=True)
class ShardedHierarchy:
    """Row-sharded top levels + replicated coarse tail (host arrays).

    ``sharded`` is fine-first: sharded[0] is the finest level.  Transfers
    sharded[j] -> sharded[j+1] live in inter_restrict_*/inter_prolong_*
    (index j); the LAST sharded level's transfer to the replicated tail is
    restrict_*/prolong_* (coarse side in the ORIGINAL padded layout).
    Restriction tables are split by the fine side's shard (partial products
    all-reduced to the replicated coarse source); prolongation tables hold
    each fine shard's rows with columns into the full coarse vector
    (all-gathered when the coarse level is sharded).
    """

    sharded: tuple  # tuple[ShardedFineLevel, ...], fine-first
    coarse: Hierarchy  # replicated tail (may be empty), host LevelOperators
    restrict_vals: np.ndarray  # [P, nc_pad, wR] R restricted to shard cols
    restrict_lcols: np.ndarray  # [P, nc_pad, wR] LOCAL fine rows [0, ns)
    prolong_vals: np.ndarray  # [P, ns, wP]
    prolong_cols: np.ndarray  # [P, ns, wP] coarse (replicated) cols
    inter_restrict_vals: tuple = ()
    inter_restrict_lcols: tuple = ()
    inter_prolong_vals: tuple = ()
    inter_prolong_cols: tuple = ()
    fine_op_cpu: LevelOperator = None  # for problem construction / extraction
    newpos: np.ndarray = None  # finest old padded2 position -> new position

    @property
    def fine(self) -> ShardedFineLevel:
        return self.sharded[0]

    @property
    def num_shards(self) -> int:
        return self.fine.num_shards

    def shard(self, s: int) -> "ShardedHierarchy":
        """Rank ``s``'s pieces: every level's and transfer's slice ``[s]``;
        the tail, ``fine_op_cpu`` and ``newpos`` are shared."""
        return dataclasses.replace(
            self,
            sharded=tuple(lv.shard(s) for lv in self.sharded),
            **{k: getattr(self, k)[s] for k in TRANSFER_ARRAYS},
            **{k: tuple(a[s] for a in getattr(self, k)) for k in INTER_ARRAYS})


def _split_transfers(r_csr, p_csr, newpos_f, n_pad2_f, ns_f, p, newpos_c, nc_out):
    """Split a restriction/prolongation pair by the FINE side's shards.

    ``r_csr`` [nc_pad x nf_pad], ``p_csr`` [nf_pad x nc_pad] in ORIGINAL
    layouts.  The fine axis is permuted by ``newpos_f`` (old -> new global
    position, padded to n_pad2_f); the coarse axis by ``newpos_c`` (or kept
    when None) and padded to ``nc_out``.

    Returns (rv [P, nc_out, wR], rc LOCAL fine rows, pv [P, ns, wP], pc
    full-coarse cols).
    """
    def c_of(idx):
        return newpos_c[idx] if newpos_c is not None else idx

    m = r_csr.tocoo()
    rt = sp.coo_matrix(
        (m.data, (c_of(m.row), newpos_f[m.col])), shape=(nc_out, n_pad2_f)).tocsr()
    m = p_csr.tocoo()
    pt = sp.coo_matrix(
        (m.data, (newpos_f[m.row], c_of(m.col))), shape=(n_pad2_f, nc_out)).tocsr()

    def ell_of(mat, col0, wid):
        """Rows of ``mat`` as a zero-padded ELL of width ``wid``, columns
        less ``col0``."""
        nnzr = np.diff(mat.indptr)
        rows = np.repeat(np.arange(mat.shape[0]), nnzr)
        pos = np.arange(mat.nnz) - np.repeat(mat.indptr[:-1], nnzr)
        v = np.zeros((mat.shape[0], wid))
        c = np.zeros((mat.shape[0], wid), dtype=np.int64)
        v[rows, pos] = mat.data
        c[rows, pos] = mat.indices - col0
        return v, c

    r_sh, wid = [], 1
    for s in range(p):
        mask = np.zeros(n_pad2_f, bool)
        mask[s * ns_f:(s + 1) * ns_f] = True
        rs_ = rt.multiply(mask[None, :]).tocsr()
        rs_.eliminate_zeros()
        r_sh.append(rs_)
        wid = max(wid, int(np.diff(rs_.indptr).max(initial=0)))
    rv, rc = zip(*(ell_of(rs_, s * ns_f, wid) for s, rs_ in enumerate(r_sh)))

    p_sh = [pt[s * ns_f:(s + 1) * ns_f].tocsr() for s in range(p)]
    wid = max(max(int(np.diff(ps.indptr).max(initial=0)) for ps in p_sh), 1)
    pv, pc = zip(*(ell_of(ps, 0, wid) for ps in p_sh))

    return (np.stack(rv), np.stack(rc).astype(np.int32),
            np.stack(pv), np.stack(pc).astype(np.int32))


def partition_hierarchy(hier: Hierarchy, num_shards: int,
                        shard_levels: int = 1) -> ShardedHierarchy:
    """Row-shard the top ``shard_levels`` levels of the host hierarchy
    ``hier`` (LevelOperators, coarse -> fine); replicate the rest.  Sharding
    more than the finest level splits the smoothing work of a large second
    level P ways while the transfers move one coarse-sized vector
    (all-reduce down, all-gather up)."""
    shard_levels = max(1, min(shard_levels, hier.num_levels))
    p = num_shards

    sharded, newposes = [], []
    for j in range(shard_levels):  # fine-first
        lvl, npos = partition_fine_level(hier.levels[hier.num_levels - 1 - j], p)
        sharded.append(lvl)
        newposes.append(npos)

    # transfers between consecutive sharded levels
    inter = []
    for j in range(shard_levels - 1):
        ti = hier.num_levels - 2 - j  # restrict[ti]: level ti+1 -> ti
        inter.append(_split_transfers(
            ell_to_csr(hier.restrict[ti]), ell_to_csr(hier.prolong[ti]),
            newposes[j], sharded[j].n_pad2, sharded[j].shard_rows, p,
            newposes[j + 1], sharded[j + 1].n_pad2))

    last = sharded[-1]
    tail_levels = hier.num_levels - shard_levels
    if tail_levels > 0:
        coarse = Hierarchy(levels=hier.levels[:tail_levels],
                           restrict=hier.restrict[:tail_levels - 1],
                           prolong=hier.prolong[:tail_levels - 1])
        ti = tail_levels - 1
        transfers = _split_transfers(
            ell_to_csr(hier.restrict[ti]), ell_to_csr(hier.prolong[ti]),
            newposes[-1], last.n_pad2, last.shard_rows, p, None,
            hier.levels[ti].n_pad)
    else:
        coarse = Hierarchy(levels=(), restrict=(), prolong=())
        transfers = (np.zeros((p, 1, 1)), np.zeros((p, 1, 1), dtype=np.int32),
                     np.zeros((p, last.shard_rows, 1)),
                     np.zeros((p, last.shard_rows, 1), dtype=np.int32))

    return ShardedHierarchy(
        sharded=tuple(sharded),
        coarse=coarse,
        **dict(zip(TRANSFER_ARRAYS, transfers)),
        **{k: tuple(t[i] for t in inter) for i, k in enumerate(INTER_ARRAYS)},
        fine_op_cpu=hier.levels[-1],
        newpos=newposes[0],
    )
