"""Distributed execution: the row-partitioned point axis over ranks.

Port of the reference package's ``parallel/`` (``shard_map`` over a 1-D
device mesh) to ``torch.distributed``: each rank is one process that owns
one contiguous row shard on its device and runs the port's hand-written
kernels on its shard's tables.

* the top levels' rows are split into contiguous blocks per rank, each
  reordered [frontier | interior] (frontier = rows with any cross-shard
  coupling; under the symmetric pattern only frontier rows are read
  remotely) — ``partition``;
* the exchanges move just the nf-row frontier slices between neighbouring
  ranks; the interior pass, the bulk of the sweep, is communication-free;
* the smoother is EXACT Gauss-Seidel under the frontier-phased order
  (shards = p mod C update their frontiers in phase p), so sharded solves
  converge like serial ones;
* Lagrange border dots and residual norms are all-reduces;
* the coarse tail is replicated per rank: restriction is per-shard partial
  products all-reduced, prolongation local rows times the replicated (or
  all-gathered) coarse values — ``sharded``;
* ``runtime`` brings up the process group and picks the backend from the
  topology; ``dryrun`` spawns a world of ranks (the tests' and the dry
  run's launcher).
"""

from meshlessmultigridpoisson_torch.parallel.partition import (
    ShardedFineLevel,
    ShardedHierarchy,
    partition_hierarchy,
)
from meshlessmultigridpoisson_torch.parallel.runtime import (
    init_distributed,
    solver_mesh,
    topology_summary,
)
from meshlessmultigridpoisson_torch.parallel.sharded import (
    make_sharded_bicgstab,
    make_sharded_solver,
    make_sharded_vcycle,
)

__all__ = [
    "ShardedFineLevel",
    "ShardedHierarchy",
    "partition_hierarchy",
    "init_distributed",
    "solver_mesh",
    "topology_summary",
    "make_sharded_vcycle",
    "make_sharded_solver",
    "make_sharded_bicgstab",
]
