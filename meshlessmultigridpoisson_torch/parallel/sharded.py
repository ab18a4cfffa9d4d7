"""Per-rank sharded solve: exact cross-shard GS fine levels + replicated tail.

Port of the reference package's ``parallel/sharded.py``.  The reference runs
one ``shard_map`` program over a device mesh; here each rank is a process
that owns one shard on its device, runs the port's hand-written kernels on
its shard's tables, and talks to its peers through
``parallel.runtime.ShardGroup`` (the ``mesh`` argument).  The loops are
Python loops that read their scalar on the host once an iteration, as
``mg/krylov.py`` does.

The smoother of a sharded level is EXACT Gauss-Seidel under the frontier-
phased order built by the partitioner (parallel/partition.py docstring):

  per sweep:  for phase p in 0..C-1:
                  exchange the nf-row frontier slices with the neighbours
                  shards = p (mod C): class SOR over the frontier rows
                  (``class_sor_sweep`` on the [nf x ext] table, role sweep2)
              interior pass, no communication: the block one-shot sweep on
              the shard's own rows with the interior-masked K
              (``colored_smooth``, role sweep8, where the colored order is
              taken on every shard; ``storage_chain``, role sweep6,
              otherwise)
              Lagrange relax (all-reduced dot), Neumann re-solve
              (exchange, then ``compact_rows`` on x_ext, role bound2)

A shard level of one rank (P = 1: no frontier) is the serial level, and its
smoother call is the serial one (one ``block_smooth`` launch on a colored
level).  The fine matvec is ``ell_spmv`` on the shard's [ns x ext] table
(role spmv6), as are the transfers' partial products: restriction partial
products all-reduced (then sliced at ``rank * ns_c`` where the coarse level
is sharded too), the coarse correction all-gathered for the local
prolongation.  The replicated tail runs the port's ``mg.vcycle.v_cycle`` on
a ``gpu_hierarchy`` of the tail levels.  On CPU tensors every kernel wrapper
runs its plain version, so the tests hold this flow against the reference
over gloo on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meshlessmultigridpoisson_torch.mg import vcycle as vc
from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_hierarchy
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.ops import smoothers as sm
from meshlessmultigridpoisson_torch.ops.ell import EllMatrix
from meshlessmultigridpoisson_torch.parallel.partition import (
    ShardedFineLevel,
    ShardedHierarchy,
)
from meshlessmultigridpoisson_torch.parallel.runtime import ShardGroup


@dataclasses.dataclass(frozen=True)
class ShardLevel:
    """One rank's shard of a row-sharded level, in kernel layouts on its
    device.  Vectors are the shard's ``ns`` own rows; ``x_ext`` is
    ``[own rows | per hop d: left-d frontier, right-d frontier]``."""

    A: gk.DeviceEll  # [ns x ext] own rows over x_ext (role spmv6)
    front: gk.ClassSweep | None  # [nf x ext] frontier rows (sweep2); None: nf 0
    sweep: gk.BlockSweep  # interior pass over own rows
    bound: gk.DeviceCompact  # Neumann rows over x_ext (n_pad = ext, bound2)
    lag_col: torch.Tensor
    lag_row: torch.Tensor
    dirichlet_mask: torch.Tensor
    neumann_mask: torch.Tensor
    dirichlet_values: torch.Tensor
    ns: int
    nf: int
    phases: int
    has_lagrange: bool
    has_bound: bool  # any shard holds a Neumann row (every rank exchanges)
    omega: float
    iters: int
    kind: str  # the interior pass: "v8-colored" or "v6-oneshot"

    @property
    def ext(self) -> int:
        return self.A.ncols

    @property
    def fused(self) -> bool:
        """The smoother call is one ``block_smooth`` launch (P = 1 only)."""
        return (self.nf == 0 and isinstance(self.sweep, gk.BlockSweep)
                and self.sweep.role in gk.FUSED_SWEEP_ROLES)


def _t(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def _ell(vals, cols, ncols: int, role: str, device, dtype) -> gk.DeviceEll:
    """A DeviceEll of host (vals, int cols), ``lens`` from the f64 values."""
    v = torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float64))
    return gk.DeviceEll(vals=v.to(device=device, dtype=dtype).contiguous(),
                        cols=_t(np.asarray(cols, dtype=np.int32), device),
                        ncols=int(ncols), role=role,
                        lens=gk.row_lens(v).to(device).contiguous())


def interior_table(f: ShardedFineLevel):
    """(vals, cols) of shard ``f``'s own rows as a square [ns x ns] table for
    the interior pass: frontier rows emptied (each entry the row itself,
    value 0: they are never swept), padding entries pointed at their row.
    Interior rows read own rows only (the partitioner's frontier rule)."""
    ns, nf = f.shard_rows, f.frontier_rows
    rows = np.arange(ns)[:, None]
    vals = np.where(rows >= nf, f.vals, 0.0)
    cols = np.where(vals != 0.0, f.lcols_ext, rows)
    if (cols >= ns).any():
        raise AssertionError("an interior row reads a halo column")
    return vals, cols.astype(np.int32)


def interior_colored(f: ShardedFineLevel) -> bool:
    """Whether the interior pass of shard ``f`` runs colored (the
    reference's ``prepare_colored_sweep`` takes it: ``gk.colored_refusal``).
    Raises where no block sweep takes the shard (class size not dividing
    the 128-row block, assembly blocks not whole 128-row blocks, or a block
    reading more than 256 x patches): the port has no other interior pass."""
    ns = f.shard_rows
    if ns % gk.LANES or f.block_rows % gk.LANES or gk.LANES % f.class_size:
        raise ValueError(f"no block sweep takes this shard: {ns} rows, {f.block_rows}-row "
                         f"assembly blocks, classes of {f.class_size}")
    _, cols = interior_table(f)
    pids = gk.block_patches(cols, ns // gk.LANES)
    if pids.shape[1] > gk.V6_MAX_PATCHES:
        raise ValueError(f"no block sweep takes this shard: a block reads {pids.shape[1]} "
                         f"x patches (at most {gk.V6_MAX_PATCHES})")
    colors = gk.color_blocks(pids, ns // gk.LANES)
    return gk.colored_refusal(pids, ns // gk.LANES, colors) is None


def shard_level(f: ShardedFineLevel, device, dtype=torch.float64,
                colored: bool = False) -> ShardLevel:
    """Repack one shard ``f`` (``ShardedFineLevel.shard(s)``) for its
    rank's kernels in ``dtype`` (f32: the reference's
    ``hierarchy_to_f32``).  ``colored``: the interior pass's order (True
    colored, False storage order; see ``interior_colored``)."""
    device = torch.device(device)
    ns, nf, ext, b = f.shard_rows, f.frontier_rows, f.ext_rows, f.class_size
    A = _ell(f.vals, f.lcols_ext, ext, "spmv6", device, dtype)
    front = None
    if nf:
        front = gk.class_sweep(
            _ell(f.vals[:nf], f.lcols_ext[:nf], ext, "spmv2", device, dtype),
            torch.from_numpy(f.diag[:nf]), torch.from_numpy(f.smooth_mask[:nf]),
            torch.from_numpy(f.omega_w[:nf]), torch.from_numpy(f.lag_col[:nf]),
            class_size=b, role="sweep2")
    vals, cols = interior_table(f)
    mask = f.smooth_mask * (np.arange(ns) >= nf)
    nb = ns // gk.LANES
    ell = EllMatrix(vals=torch.from_numpy(vals), lcols=torch.from_numpy(cols),
                    win_start=torch.zeros(ns // f.block_rows, dtype=torch.int32),
                    diag=torch.from_numpy(f.diag), nrows=ns, ncols=ns,
                    block_rows=f.block_rows, win_size=ns)
    kT = gk.build_oneshot_K(ell, f.omega_w, mask, class_size=b)
    if colored:
        colors = gk.color_blocks(gk.block_patches(cols, nb), nb)
        order, ptr = gk.colored_order(colors)
        role, kind = "sweep8", "v8-colored"
    else:
        # storage order over the interior blocks only: interior rows read
        # no halo and frontier blocks would move nothing
        nfb = nf // gk.LANES
        order, ptr = np.arange(nfb, nb), (0, nb - nfb)
        role, kind = "sweep6", "v6-oneshot"
    sw = gk.BlockSweep(
        A=_ell(vals, cols, ns, "spmv8" if colored else "spmv6", device, dtype),
        kT=torch.from_numpy(kT).to(device=device, dtype=dtype),
        lagc=_t(f.lag_col, device, dtype),
        order=_t(order.astype(np.int32), device), phase_ptr=tuple(int(p) for p in ptr),
        serial=not colored, role=role,
        reads=gk.block_read_tables(cols, nb, device) if colored else None)
    nb_rows = int((f.bound_rows < ns).sum())
    bound = gk.DeviceCompact(
        vals=_t(f.bound_vals, device, dtype), cols=_t(f.bound_lcols_ext, device),
        rows=_t(f.bound_rows, device), diag=_t(f.bound_diag, device, dtype),
        nrows=nb_rows, n_pad=ext, role="bound2")
    vec = {k: _t(getattr(f, k), device, dtype) for k in (
        "lag_col", "lag_row", "dirichlet_mask", "neumann_mask", "dirichlet_values")}
    return ShardLevel(A=A, front=front, sweep=sw, bound=bound, **vec, ns=ns, nf=nf,
                      phases=f.phases, has_lagrange=f.has_lagrange,
                      has_bound=f.has_bound, omega=f.omega, iters=f.iters, kind=kind)


def _zeroed_dirichlet_hier(hier: vc.Hierarchy) -> vc.Hierarchy:
    """Pin the sub-cycle's top level to 0 (reference "coarse" pinning)."""
    if not hier.levels:
        return hier
    top = hier.levels[-1]
    top0 = dataclasses.replace(top, dirichlet_values=torch.zeros_like(top.dirichlet_values))
    return vc.Hierarchy(levels=hier.levels[:-1] + (top0,), restrict=hier.restrict,
                        prolong=hier.prolong)


@dataclasses.dataclass(frozen=True)
class DeviceShards:
    """One rank's whole sharded hierarchy on its device: the sharded levels
    (fine-first), the transfers' partial tables (``R``: [nc x ns] partial
    restriction, local fine columns; ``P``: [ns x nc] prolongation rows,
    full coarse columns), and the replicated tail as a GPU hierarchy with
    its top level's Dirichlet pin at 0."""

    levels: tuple  # ShardLevel, fine-first
    inter_R: tuple
    inter_P: tuple
    R: gk.DeviceEll | None
    P: gk.DeviceEll | None
    tail: vc.Hierarchy
    mesh: ShardGroup
    dtype: torch.dtype


def device_shards(shier: ShardedHierarchy, mesh: ShardGroup,
                  dtype=torch.float64) -> DeviceShards:
    """Repack rank ``mesh.rank``'s pieces of ``shier`` on ``mesh.device``
    in ``dtype``.  A level's interior pass runs colored where every shard
    takes the colored order (one all-reduce a level), in storage order
    otherwise (the tail's levels as ``gpu_hierarchy`` decides)."""
    if shier.num_shards != mesh.size:
        raise ValueError(f"{shier.num_shards} shards on a group of {mesh.size} ranks")
    dev, piece = mesh.device, shier.shard(mesh.rank)
    levels = []
    for f in piece.sharded:
        # the shards that refuse the colored order, counted over the group
        vote = torch.tensor([0.0 if interior_colored(f) else 1.0], dtype=torch.float64,
                            device=dev)
        colored = bool(mesh.all_reduce(vote).cpu()[0] == 0)
        levels.append(shard_level(f, dev, dtype, colored))
    inter_R = tuple(_ell(v, c, f.shard_rows, "spmv6", dev, dtype) for v, c, f in zip(
        piece.inter_restrict_vals, piece.inter_restrict_lcols, piece.sharded))
    inter_P = tuple(_ell(v, c, fc.n_pad2, "spmv6", dev, dtype) for v, c, fc in zip(
        piece.inter_prolong_vals, piece.inter_prolong_cols, piece.sharded[1:]))
    tail = _zeroed_dirichlet_hier(shier.coarse)
    R = P = None
    if tail.levels:
        last = piece.sharded[-1]
        R = _ell(piece.restrict_vals, piece.restrict_lcols, last.shard_rows, "spmv6", dev,
                 dtype)
        P = _ell(piece.prolong_vals, piece.prolong_cols, tail.levels[-1].n_pad, "spmv6",
                 dev, dtype)
        tail = gpu_hierarchy(tail, dev, dtype)
    return DeviceShards(levels=tuple(levels), inter_R=inter_R, inter_P=inter_P, R=R, P=P,
                        tail=tail, mesh=mesh, dtype=dtype)


# ---------------------------------------------------------------------------
# per-level operations (every rank calls each, in the same order)
# ---------------------------------------------------------------------------


def _frontier_exchange(lv: ShardLevel, mesh: ShardGroup, x_ext: torch.Tensor) -> None:
    """Fill x_ext's halo in place: per hop distance d the left (rank - d)
    and right (rank + d) neighbours' frontier slices, zeros off either end
    (the reference's ppermute pair per hop)."""
    nf, ns, hops = lv.nf, lv.ns, lv.phases - 1
    if nf == 0 or hops == 0:
        return
    r, xf = mesh.rank, x_ext[:nf]
    sends, recvs = [], []
    for d in range(1, hops + 1):
        off = ns + (d - 1) * 2 * nf
        for peer, slot in ((r - d, x_ext[off:off + nf]), (r + d, x_ext[off + nf:off + 2 * nf])):
            if 0 <= peer < mesh.size:
                sends.append((xf, peer))
                recvs.append((slot, peer))
            else:
                slot.zero_()
    mesh.exchange(sends, recvs)


def _extended(lv: ShardLevel, x: torch.Tensor) -> torch.Tensor:
    """A new x_ext buffer holding ``x`` in its own rows (halo unset)."""
    x_ext = torch.empty(lv.ext, dtype=x.dtype, device=x.device)
    x_ext[:lv.ns] = x
    return x_ext


def _padded(lv: ShardLevel, b: torch.Tensor) -> torch.Tensor:
    """``b`` padded with zeros to the ext length (the re-solve's b)."""
    if lv.ext == lv.ns:
        return b.contiguous()
    out = b.new_zeros(lv.ext)
    out[:lv.ns] = b
    return out


def _lag_dot(lv: ShardLevel, mesh: ShardGroup, x: torch.Tensor) -> torch.Tensor:
    return mesh.all_reduce((lv.lag_row * x).sum())


def bound_eval(lv: ShardLevel, mesh: ShardGroup, x, b) -> torch.Tensor:
    """Neumann row re-solve on the locally owned boundary rows (after a
    frontier exchange: a row may read a neighbour's frontier); returns a
    new vector."""
    if not lv.has_bound:
        return x
    x_ext = _extended(lv, x)
    _frontier_exchange(lv, mesh, x_ext)
    gk.compact_rows(lv.bound, x_ext, _padded(lv, b))
    return x_ext[:lv.ns]


def interior_sweep(lv: ShardLevel, x, x_lag, b) -> torch.Tensor:
    """The communication-free interior pass on own rows ``x``, in place."""
    return gk.block_oneshot_sweep(lv.sweep, x, x_lag, b)


def smooth(lv: ShardLevel, mesh: ShardGroup, x, x_lag, b, b_lag, iters=None):
    """``iters`` exact global GS sweeps (frontier phases, interior pass),
    each followed by the Lagrange relax and the Neumann re-solve; returns
    new (x, x_lag).  A level with no frontier on a group of one runs the
    serial smoother call (``block_smooth``: one launch on a colored
    level; ``smooth_loop`` otherwise)."""
    iters = lv.iters if iters is None else iters
    lag_row = lv.lag_row if lv.has_lagrange else None
    if mesh.size == 1:
        bound = lv.bound if lv.bound.nrows else None
        if lv.fused:
            return gk.block_smooth(lv.sweep, x, x_lag, b, b_lag, iters, lv.omega,
                                   lag_row, bound)
        return gk.smooth_loop(lv.sweep, x, x_lag, b, b_lag, iters, lv.omega, lag_row, bound)
    w, ns, nf = lv.omega, lv.ns, lv.nf
    x_ext = _extended(lv, x)
    xo = x_ext[:ns]
    bf = b[:nf]
    b_ext = _padded(lv, b) if lv.has_bound else None
    for _ in range(iters):
        for ph in range(lv.phases if nf else 0):
            _frontier_exchange(lv, mesh, x_ext)
            if mesh.rank % lv.phases == ph:
                gk.class_sor_sweep(lv.front, x_ext, x_lag, bf)
        interior_sweep(lv, xo, x_lag, b)
        if lv.has_lagrange:
            x_lag = (1.0 - w) * x_lag + w * (b_lag - _lag_dot(lv, mesh, xo))
        if lv.has_bound:
            _frontier_exchange(lv, mesh, x_ext)
            gk.compact_rows(lv.bound, x_ext, b_ext)
    return xo, x_lag


def matvec(lv: ShardLevel, mesh: ShardGroup, x, x_lag):
    """The bordered matvec on own rows: (A x_ext + lag_col x_lag,
    all-reduced lag_row . x + x_lag)."""
    if lv.ext == lv.ns:
        x_ext = x.contiguous()
    else:
        x_ext = _extended(lv, x)
        _frontier_exchange(lv, mesh, x_ext)
    y = gk.ell_spmv(lv.A, x_ext)
    if not lv.has_lagrange:
        return y, x.new_zeros(())
    return y + lv.lag_col * x_lag, _lag_dot(lv, mesh, x) + x_lag


def residual(lv: ShardLevel, mesh: ShardGroup, x, x_lag, b, b_lag):
    y, y_lag = matvec(lv, mesh, x, x_lag)
    r = torch.where(lv.dirichlet_mask > 0, torch.zeros_like(b), b - y)
    r_lag = (b_lag - y_lag) if lv.has_lagrange else x.new_zeros(())
    return r, r_lag


def rel_resid(lv: ShardLevel, mesh: ShardGroup, x, x_lag, b, b_lag) -> torch.Tensor:
    """||r||_1 / ||b||_1 over the bordered system (one all-reduce)."""
    r, r_lag = residual(lv, mesh, x, x_lag, b, b_lag)
    sums = mesh.all_reduce(torch.stack([r.abs().sum(), b.abs().sum()]))
    return (sums[0] + r_lag.abs()) / (sums[1] + torch.as_tensor(b_lag).abs())


# ---------------------------------------------------------------------------
# the V-cycle and its solvers
# ---------------------------------------------------------------------------


def _tail_solve(ds: DeviceShards, lv: ShardLevel, r) -> torch.Tensor:
    """Restrict the last sharded level's residual into the replicated tail,
    sub-cycle, return the prolonged correction."""
    bc = ds.mesh.all_reduce(gk.ell_spmv(ds.R, r))
    tail = ds.tail
    top = len(tail.levels) - 1
    opc = tail.levels[top]
    bc = sm.zero_dirichlet(opc, bc)
    if lv.has_lagrange:
        bc = torch.where(opc.neumann_mask > 0, torch.zeros_like(bc), bc)
    state = vc.init_like(tail, dtype=ds.dtype).replace_level(top, b=bc)
    state, _ = vc.v_cycle(tail, state, residual=False)
    return gk.ell_spmv(ds.P, state.x[top])


def _cycle_level(ds: DeviceShards, j: int, x, xl, b, bl, homogeneous: bool):
    mesh, lv = ds.mesh, ds.levels[j]
    last = len(ds.levels) - 1
    pin = (torch.zeros_like(x) if homogeneous else lv.dirichlet_values) if j == 0 \
        else torch.zeros_like(x)
    x = torch.where(lv.dirichlet_mask > 0, pin, x)  # boundaryOp
    if j == last and not ds.tail.levels:
        # the coarsest is sharded: the reference's double smooth
        # (multigrid.cpp:91-95); a single-level run smooths once
        x, xl = smooth(lv, mesh, x, xl, b, bl)
        if j > 0:
            x, xl = smooth(lv, mesh, x, xl, b, bl)
        return x, xl
    x, xl = smooth(lv, mesh, x, xl, b, bl)  # pre-smooth
    r, _ = residual(lv, mesh, x, xl, b, bl)
    if j == last:
        corr = _tail_solve(ds, lv, r)
    else:
        fc = ds.levels[j + 1]
        bc_full = mesh.all_reduce(gk.ell_spmv(ds.inter_R[j], r))
        bc = bc_full[mesh.rank * fc.ns:(mesh.rank + 1) * fc.ns]
        bc = torch.where(fc.dirichlet_mask > 0, torch.zeros_like(bc), bc)
        if lv.has_lagrange:
            bc = torch.where(fc.neumann_mask > 0, torch.zeros_like(bc), bc)
        zero = bc.new_zeros(())
        xc, _ = _cycle_level(ds, j + 1, torch.zeros_like(bc), zero, bc, zero, homogeneous)
        corr = gk.ell_spmv(ds.inter_P[j], mesh.all_gather(xc))
    if not lv.has_lagrange:
        corr = torch.where(lv.dirichlet_mask > 0, torch.zeros_like(corr), corr)
    x, xl = smooth(lv, mesh, x + corr, xl, b, bl)  # post-smooth
    return x, xl


def cycle(ds: DeviceShards, xf, x_lag, bf, b_lag, homogeneous: bool = False):
    """One V-cycle from (xf, x_lag): the fine re-solve, then the levels.
    ``homogeneous`` pins the fine Dirichlet rows to 0 (a linear map: the
    Krylov preconditioner's form)."""
    x = bound_eval(ds.levels[0], ds.mesh, xf, bf)
    return _cycle_level(ds, 0, x, x_lag, bf, b_lag, homogeneous)


def _scalar(v, ds: DeviceShards) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ds.dtype, device=ds.mesh.device).reshape(())


def make_sharded_vcycle(shier: ShardedHierarchy, mesh: ShardGroup, dtype=torch.float64):
    """Returns vcycle_fn(xf, x_lag, bf, b_lag) -> (xf, x_lag, resid): xf, bf
    this rank's shard [ns] (``shard_vector``), the Lagrange scalars and the
    PRE-cycle relative residual replicated (0-dim tensors).  The top
    ``len(shier.sharded)`` levels run row-sharded, the tail replicated.
    ``vcycle_fn.shards`` is the rank's repack (``device_shards``)."""
    ds = device_shards(shier, mesh, dtype)

    def vcycle_fn(xf, x_lag, bf, b_lag):
        x_lag, b_lag = _scalar(x_lag, ds), _scalar(b_lag, ds)
        resid = rel_resid(ds.levels[0], ds.mesh, xf, x_lag, bf, b_lag)
        x, xl = cycle(ds, xf, x_lag, bf, b_lag)
        return x, xl, resid

    vcycle_fn.shards = ds
    return vcycle_fn


def make_sharded_solver(shier: ShardedHierarchy, mesh: ShardGroup, max_cycles: int = 200,
                        dtype=torch.float64):
    """solve(xf, x_lag, bf, b_lag, tol) -> (xf, x_lag, cycles, resid): cycle
    while the pre-cycle residual >= tol (the first cycle outside the loop,
    as the reference; FractionalStepSim.cpp:139-142)."""
    vcycle_fn = make_sharded_vcycle(shier, mesh, dtype)

    def solve(xf, x_lag, bf, b_lag, tol):
        xf, x_lag, r = vcycle_fn(xf, x_lag, bf, b_lag)
        it, resid = 1, float(r)
        while resid >= tol and it < max_cycles:
            xf, x_lag, r = vcycle_fn(xf, x_lag, bf, b_lag)
            it, resid = it + 1, float(r)
        return xf, x_lag, it, resid

    solve.shards = vcycle_fn.shards
    return solve


def make_sharded_bicgstab(shier: ShardedHierarchy, mesh: ShardGroup, max_iters: int = 100,
                          dtype=torch.float64):
    """V-cycle-preconditioned BiCGStab on the sharded bordered fine system
    (mirrors mg/krylov.solve_bicgstab and the reference's
    ``make_sharded_bicgstab``): every dot product all-reduced, the
    preconditioner one homogeneous sharded V-cycle from zero plus the
    re-solve, Dirichlet rows carrying x_d = g (the initial guess pinned
    there first: the reference's converges only from a guess that already
    is), a breakdown keeping the previous iterate and reporting -1.

    Returns solve(xf, x_lag, bf, b_lag, tol) -> (xf, x_lag, iters, resid).
    """
    ds = device_shards(shier, mesh, dtype)
    f0, mesh = ds.levels[0], ds.mesh
    tiny = 1e-300

    def precond(v, vl):
        z, zl = cycle(ds, torch.zeros_like(v), v.new_zeros(()), v, vl, homogeneous=True)
        return bound_eval(f0, mesh, z, v), zl

    def mv(x, xl):
        y, yl = matvec(f0, mesh, x, xl)
        y = torch.where(f0.dirichlet_mask > 0, x, y)
        return y, (yl if f0.has_lagrange else xl)

    def sums(*pairs):
        """Each (u, v) pair's all-reduced u . v, in one all-reduce."""
        return mesh.all_reduce(torch.stack([(u * v).sum() for u, v in pairs]))

    def safe(v):
        return torch.where(v == 0, torch.full_like(v, tiny), v)

    def solve(xf, x_lag, bf, b_lag, tol):
        # the initial guess carries x_d = g (the reference takes it as
        # given: from a guess off g the Dirichlet rows of r never move, as
        # the preconditioner and the matvec keep them at 0)
        x = torch.where(f0.dirichlet_mask > 0, f0.dirichlet_values, xf)
        xl, b_lag = _scalar(x_lag, ds), _scalar(b_lag, ds)
        b = torch.where(f0.dirichlet_mask > 0, f0.dirichlet_values, bf)
        bnorm = mesh.all_reduce(b.abs().sum()) + b_lag.abs()
        ax, axl = mv(x, xl)
        r, rl = b - ax, b_lag - axl
        rhat, rhatl = r, rl
        p, pl = r, rl
        rho = sums((rhat, r))[0] + rhatl * rl
        resid = float((mesh.all_reduce(r.abs().sum()) + rl.abs()) / bnorm)
        it = 0
        while resid >= tol and it < max_iters:
            phat, phatl = precond(p, pl)
            v, vl = mv(phat, phatl)
            alpha = rho / safe(sums((rhat, v))[0] + rhatl * vl)
            s, sl = r - alpha * v, rl - alpha * vl
            shat, shatl = precond(s, sl)
            t, tl = mv(shat, shatl)
            ts = sums((t, t), (t, s))
            tt, omega = ts[0] + tl * tl, ts[1] + tl * sl
            omega = omega / safe(tt)
            x2 = x + alpha * phat + omega * shat
            xl2 = xl + alpha * phatl + omega * shatl
            r2, r2l = s - omega * t, sl - omega * tl
            red = mesh.all_reduce(torch.stack([(rhat * r2).sum(), r2.abs().sum()]))
            rho2 = red[0] + rhatl * r2l
            beta = (rho2 / safe(rho)) * (alpha / safe(omega))
            p2, p2l = r2 + beta * (p - omega * v), r2l + beta * (pl - omega * vl)
            resid2 = (red[1] + r2l.abs()) / bnorm
            it += 1
            # breakdown (rho/omega underflow): keep the previous iterate,
            # report the -1 sentinel, stop
            ok = bool(torch.isfinite(resid2) & torch.isfinite(rho2)
                      & torch.isfinite(mesh.all_reduce(p2.abs().sum())))
            if not ok:
                resid = -1.0
                break
            x, xl, r, rl, p, pl, rho = x2, xl2, r2, r2l, p2, p2l, rho2
            resid = float(resid2)
        x = torch.where(f0.dirichlet_mask > 0, f0.dirichlet_values, x)
        return bound_eval(f0, mesh, x, bf), xl, it, resid

    solve.shards = ds
    return solve


def comm_per_cycle(shier: ShardedHierarchy, rank: int, itemsize: int) -> dict:
    """What one ``make_sharded_vcycle`` call makes ``rank`` send, counted
    from the partition's metadata (the reference's scripts/scaling_model.py
    counts the same collectives for its flow): frontier exchanges (each
    ``nf`` rows to every neighbour within ``phases - 1`` hops) C a sweep
    and one before each re-solve and each matvec; an all-reduce for the
    Lagrange dot of each sweep and matvec, the residual norms, and each
    restriction's partial products; an all-gather of the coarse correction
    between two sharded levels.  The keys of ``ShardGroup.stats``, which
    counts the same as it happens.  A level of one rank smooths with the
    serial smoother call (no collective)."""
    P, levels = shier.num_shards, shier.sharded
    tail = bool(shier.coarse.levels)
    st = dict(all_reduce=0, all_gather=0, exchange=0, messages=0, bytes=0)

    def exchange(f):
        if f.frontier_rows == 0 or f.phases == 1:
            return
        peers = sum(0 <= rank + e * d < P for d in range(1, f.phases) for e in (-1, 1))
        st["exchange"] += 1
        st["messages"] += peers
        st["bytes"] += peers * f.frontier_rows * itemsize

    def all_reduce(n):
        st["all_reduce"] += 1
        st["bytes"] += n * itemsize

    def smooth(f):
        if P == 1:
            return
        for _ in range(f.iters):
            for _ in range(f.phases if f.frontier_rows else 0):
                exchange(f)
            if f.has_lagrange:
                all_reduce(1)
            if f.has_bound:
                exchange(f)

    def matvec(f):
        exchange(f)
        if f.has_lagrange:
            all_reduce(1)

    matvec(levels[0])  # the pre-cycle residual
    all_reduce(2)
    if levels[0].has_bound:  # the cycle's first re-solve
        exchange(levels[0])
    for j, f in enumerate(levels):
        if j == len(levels) - 1 and not tail:
            for _ in range(2 if j else 1):
                smooth(f)
            break
        smooth(f)
        matvec(f)
        if j == len(levels) - 1:
            all_reduce(shier.restrict_vals.shape[1])
        else:
            all_reduce(levels[j + 1].n_pad2)
            st["all_gather"] += 1
            st["bytes"] += levels[j + 1].shard_rows * itemsize
        smooth(f)
    return st


# ---------------------------------------------------------------------------
# vectors
# ---------------------------------------------------------------------------


def shard_vector(shier: ShardedHierarchy, mesh: ShardGroup, v_logical, dtype=torch.float64):
    """This rank's shard [ns] of a logical fine vector, on its device."""
    op = shier.fine_op_cpu
    full = np.zeros(shier.fine.n_pad2)
    full[shier.newpos[op.row_map.numpy().astype(np.int64)]] = np.asarray(v_logical)
    ns = shier.fine.shard_rows
    return _t(full[mesh.rank * ns:(mesh.rank + 1) * ns], mesh.device, dtype)


def gather_vector(mesh: ShardGroup, v_shard: torch.Tensor) -> np.ndarray:
    """Every rank's shard, concatenated: the sharded padded layout [P*ns]
    as f64 host numpy (on every rank)."""
    return mesh.all_gather(v_shard.contiguous()).double().cpu().numpy()


def unshard_vector(shier: ShardedHierarchy, v_full) -> np.ndarray:
    """The sharded padded layout [P*ns] back to logical order."""
    op = shier.fine_op_cpu
    return np.asarray(v_full)[shier.newpos[op.row_map.numpy().astype(np.int64)]]
