#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``meshlessmultigridpoisson_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows its own failure):

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernel library from the package's ``csrc/*.cu`` and print the build time
   and each instance's registers; check in the library's code
   (``cuobjdump -sass``, ``probes.sassloads``) that the f32i16 stream
   instance keeps a 64-bit load of its i16 table for every 128-bit load of
   its f32 table (whole i16 table read);
2. build the slice's hierarchies (square_with_circle, deg 6, kd-tile
   ordering, 512-row assembly blocks, sizes 2500/10000/35000/150000;
   Dirichlet, then Neumann) and hold every kernel against its plain PyTorch
   version on the same inputs on the card: on the Dirichlet hierarchy
   ``ell_spmv`` (f32 and f64) on the fine and coarsest levels, every
   restriction and prolongation of the solve (their u16 tables) and, in
   f64, the fine ones and the f64 outer operator (``sweep=False``), each
   held against its plain version (each row to ``lens``) and the parent
   design (``spmv_rowwarp``) and timed beside both and one
   ``torch.sparse`` CSR call (device times from ``torch.profiler`` in
   turns parent, kernel, library, kernel, parent, twice over for the
   tables whose chain is host-bound, each side's median taken; the column
   format and the share of the bound printed); ``block_oneshot_sweep`` (f32 and f64)
   on the fine level in colored order (``sweep8``: the fused smoother's
   ``colored_smooth``, one sweep; ``sweep8_percolor``: the parent design,
   one launch a color) and on the coarsest level in storage order
   (``sweep7``: ``coarse_smooth``, one sweep); the bf16-K instance of them
   against the bf16 plain version; the storage-order chain on the fine
   level (``sweep6``, ``storage_chain``: the exact path's L3) in f32, bf16
   K and f64 against its plain version and the parent chain
   (``sweep6_chain``), one sweep timed in turns parent, kernel, kernel,
   parent; on the same tables the stale-program sweep (the reference's
   ``sor_sweep_tpu7(stale_program=True)``: ``sweep7_stale``,
   ``storage_chain.cu``'s cluster kernel, and its first design, the walk
   ``sweep7_stale_walk``, mode kStale) in f32, bf16 K and f64, one launch
   of each counted, each against its plain version, one sweep timed in
   turns cluster, walk, walk, cluster, then ``sweep6``;
   the fused smoother (``block_smooth``, ``csrc/block_smooth.cu``) on the
   Dirichlet fine and coarsest levels in f32, f64 and bf16 K: one call of
   the level's 5 sweeps held against its plain version (counted once, a
   rerun bit-identical), then timed against the parent design's loop of
   launches (per-color sweeps or the ``sweep6`` chain, torch relax,
   ``compact_rows``) in turns loop, fused, fused, loop;
   ``stream_ceiling`` at the bench's shape against its plain reduction;
   ``class_sor_sweep`` (f32 and f64, the v2-fallback smoother) on every
   Dirichlet level (L0-L3) and ``ell_spmv`` in its ``spmv2`` role on the
   fine one, the class sweep also against its parent design
   (``sweep2_tilewalk``: frozen rows untouched, one launch each) and one
   sweep timed in turns parent, kernel, kernel, parent; then
   ``probes.vcycle_breakdown`` on the Dirichlet hierarchy (counts set to 0
   before, read after; the Dirichlet roles launched): per level one
   smoother call and one residual, per transfer the restriction and the
   prolongation, the whole V-cycle (host clock, CUDA-event chain, device
   busy time), the f64 outer residual, the modelled cycle and its gap;
   on the Neumann hierarchy ``compact_rows`` (f32 and f64) on the fine
   level's boundary table (re-solve) and condensation table (pushdown),
   ``class_sor_sweep`` (f32, f64) on the fine level (frozen rows,
   Lagrange column, x_lag 0.3; its parent design beside it as on the
   Dirichlet levels), ``ell_spmv`` (f32, f64) on the fine
   level's matvec and the Neumann f64 outer operator (as the Dirichlet
   ones), the chain on the fine level in storage order (rows of mixed
   lengths; f32, bf16 K, f64, as on the Dirichlet level), and the fused
   smoother on the fine and
   coarsest levels (f32, f64, bf16 K; with the Lagrange relax and the
   boundary re-solve, x_lag 0.3, b_lag -0.4) as on the Dirichlet levels,
   then again with the V-cycle's re-solves in the same launch (the
   re-solve and a pin of every 7th row to random values before the first
   sweep, one more re-solve after the last), timed against those as
   launches of their own around the fused call; every Neumann level's
   boundary table's fill (mean ``lens`` over width) printed; the chain's
   and the stale mode's checks on the fine level in storage order as on
   the Dirichlet level.  Both host problems are kept for phase 3's
   Dirichlet and Neumann paths (repacked, not rebuilt);
2b. the smoother-rate probe's stale row (``probes.rho``, counts set to 0
   before its card side, read after): on ``RHO_STALE_CFG`` (square, 2,500
   points, deg 4, Neumann; the smallest configuration of
   ``results/rho_stale_r3.json``), 120 power iterations of the f64 error
   map with the stale sweep and with the exact chain, with the reference's
   K and with the port's, on the host (plain versions) and on the card
   (``sweep7_stale``, ``sweep6`` and ``bound2`` launched): each card rho
   within ``rho.CARD_TOL`` (1e-3) of the host's; the record's values
   printed beside them;
   Prints each comparison's relative error, the kernel's and the plain
   version's time, the kernel's bound (bytes over 3.35 TB/s or operations
   over the arithmetic peak, utils/profiling.py) and, for the SpMV and
   compact-row roles, the time of a ``torch.sparse`` CSR matvec over the
   same rows (a yardstick the port never calls).  Times are chains of
   launches between CUDA events; where the kernel's is below 0.05 ms (the
   host's enqueue rate, not the device's time) the device time per call
   of the kernel and of the library call is read from ``torch.profiler``
   too (``utils.profiling.device_ms``) and printed beside them;
3. run the port's ``solve`` entry point in-process (one untimed outer pass,
   then the timed solve; launch counters set to 0 before each run and read
   after it, printed as "warm-up + timed" beside the timed solve's own,
   the record's ``extra.launches``, from which the V-cycle and re-solve
   checks below are made), print each SolveRecord, and check: Dirichlet
   (on phase 2's host problem, repacked: ``run_solve(argv, problem=)``),
   then on the same host problem ``--sweep-order exact``, ``--fast-k`` and
   the v2-fallback solve (``run_solve(..., use_v6=False)``, the
   reference's ``tpu_hierarchy(use_v6=False)``), then Neumann (on phase
   2's Neumann host problem).  Level kernels ``[v7-exact, v8-colored x3]`` (exact:
   ``[v7-exact, v6-oneshot x3]``; fast-k: every K in bf16; v2:
   ``[v2-fallback x4]``, no K); every kernel role of the path launched
   (exact: ``spmv6``, ``sweep7``, ``sweep6``, with ``spmv8`` and ``sweep8``
   at 0; v2: ``sweep2``, ``spmv2``, ``spmv6``, with ``sweep6/7/8`` and
   ``spmv8`` at 0; Neumann adds both ``compact_rows`` roles;
   ``sweep8_percolor`` at 0 everywhere); one launch a smoother call on a
   ``sweep8``/``sweep7`` level: ``sweep8`` = 3 x ``sweep7`` launches (two
   calls a V-cycle on each colored level and on the coarsest; exact:
   ``sweep6`` = 15 x ``sweep7``, five sweeps a call on three levels), so
   V-cycles = ``sweep7`` / 2; ``bound2`` exactly the standalone re-solves
   at a Krylov solve's end and at the solve's end, passes + 1 (Neumann;
   0 elsewhere): none in a V-cycle, whose fine re-solves ride in the fine
   smoother's launch; relative L1 residual < 1e-8, re-checked
   from the returned (x, x_lag) with the plain f64 SpMV, border row
   included; L1 error < 1e-6.  (The Dirichlet solve's A/B with every
   ``ell_spmv`` on the parent design was dropped for phase 6's time;
   PERF.md keeps its results.)  After the Neumann path's counts are read,
   its timed solve runs twice more, with the V-cycle's re-solves and pin
   as launches of their own (``bound2``, ``torch.where``), then fused,
   each run failing unless
   its ``bound2`` count is its flow's.  After the exact
   path's counts are read, its timed solve runs again with every
   ``sweep6`` sweep on the parent chain (``sweep6_chain``; the run fails
   unless it launched ``sweep6_chain`` and no ``sweep6``), then on
   ``storage_chain`` again, and the three times are printed (each
   residual < 1e-8); the v2 path's timed solve the same way with every
   ``sweep2`` sweep on the parent class sweep (``sweep2_tilewalk``; the
   run fails unless it launched ``sweep2_tilewalk`` and no ``sweep2``).
   After the exact and v2
   paths' counts are read, each runs once more with ``--profile``, its
   per-level table (bounds of the matvec, smoother, transfers and re-solve)
   is printed, each time at or above its bound, and
   ``probes.launchrank``'s excess by role.  Then the 3D path at reduced
   depth: ``solve --geom box3d --sizes 500 2600 19000 140000 --deg 3
   --ordering kdtile --block-rows 512 --tol 1e-8`` (the 3D record's
   settings, ``scripts/build3d_cache.py``, without its 1.06M level: clouds
   of 729 / 3,375 / 21,952 / 148,877 points, stencils of 25 and 50
   entries), its counts set to 0 before and read after: level kinds
   ``[v7-exact x2, v8-colored x2]``, the Dirichlet roles launched, no
   ``bound2``, the residual < 1e-8 re-checked with the plain f64 SpMV, and
   the L1 error within 1% of the reference package's host f64 BiCGStab on
   the same problem (``THREED_REF_L1``); then, on its problem, ``ell_spmv``
   (fine f32 matvec, f64 outer operator, coarsest matvec, the transfers
   between L2 and L3) and the fused smoothers (L3 ``colored_smooth``, L0
   and L1 ``coarse_smooth``) against their plain versions at the 3D
   shapes, as in phase 2;
4. the fractional-step Navier-Stokes path (``cli ns``, Kovasznay, the
   reference program's default run at its default width and depth: sizes
   170/600/2500/10000, deg 6): on its problem, ``ppe_tail`` (role ``ppe2``,
   f32, f64: the compatible matvec's tail in one launch) against its plain
   version and its parent design's launches (the scatter alone, role
   ``ppe2_scatter``, also held against its plain version), device times
   in turns, and ``ell_spmv`` on the
   derivative operators against their plain versions; then ``run_ns``
   in-process for 12 steps from rest (counts set to 0 before,
   read after), checking level kinds ``[v7-exact x3, v8-colored]``, the
   path's roles (SpMV, sweeps, ``bound2``, ``ppe2``) launched, one launch
   a smoother call (``sweep7`` = 3 x ``sweep8``: V-cycles = ``sweep7`` /
   6), ``bound2`` exactly one a PPE pass and one a step, ``ppe2`` exactly
   one a compatible matvec (counted from the passes' inner iterations),
   no ``ppe2_scatter``, no PPE solve stopped above its tolerance
   (``extra.ppe_over_tol`` empty), every
   fs_residual finite, the steps 0, 4, 8, ... matching the reference's TPU
   record ``results/ns_tpu_r5.json`` within 2e-3 relative, and the last
   step's PPE solve (before the p_relax blend) re-checked with a plain f64
   composition of the compatible operator below 1e-9 (the NS fold A/B
   against the separate re-solves and matvec tail was dropped for the
   sharded phase's time; PERF.md keeps PRs 12-15's results); last, the
   checkpoint: the state after 2 steps from rest written
   by ``io.save_state`` and read back by ``load_state``, 2 more steps from
   each, their fs_residuals and ``u``, ``v`` bit-identical;
5. the user surfaces, each through its CLI entry point in-process with
   its counts set to 0 before and read after, every file under a
   temporary directory removed at the end: ``solve --setup-cache
   --write-solution`` (square_with_circle, sizes 2500/10000, deg 6,
   kdtile, 512-row blocks, Neumann) twice, the first run building and
   saving the host problem ("built and cached"), the second loading it
   ("loaded", not built), then the same solve without the cache: the
   three solutions bit-identical, the residual < 1e-8 re-checked with the
   plain f64 SpMV, the five txt files read back (``read_vector_txt``)
   equal in both runs and consistent with the record; a cache stamped
   for other arguments (``--deg 5``) and an unstamped one each refused
   (SystemExit); ``solve --msh tests/fixtures/square_170.msh
   tests/fixtures/square_600.msh --neumann --deg 4 --tol 1e-10``: 610
   fine points, residual < 1e-10 re-checked, L1 within 1% of the
   reference's host f64 BiCGStab (``MSH_REF_L1``, printed beside
   ``results/msh_solve_r2.json``'s); ``probe --geom square --sizes 2500
   --deg 4 --sweeps 1000 --cond`` with every plain version refusing to
   run: the f64 v2 level, exactly 1000 ``sweep2`` and 1000 ``spmv2``
   launches and no other sweep or SpMV, its first 100 residuals within
   1e-10 relative of the host f64 probe on the same level, the time a
   sweep printed; ``sweep --geoms square square_with_circle
   concentric_circles --levels 2 --ks 1 --degs 4``: three rows, none in
   error, each residual < 1e-8 and L1 within 1% of the reference's host
   solve of its configuration (``SWEEP_REF_L1``); the phase's time;
6. the row-sharded solve (``parallel/``), on the host problems of phase
   3's Dirichlet and Neumann paths (full width, not rebuilt): each
   partitioned into 4 shards with ``shard_levels=2`` (host seconds and
   each shard's ns, nf, phases, frontier share and interior kind printed);
   on every shard of both sharded levels, in f32 and f64, the rectangular
   frontier ``class_sor_sweep`` over x_ext (rows past nf untouched), the
   interior pass (``colored_smooth`` or ``storage_chain``, frontier rows
   untouched), the ext ``ell_spmv`` and the ext ``compact_rows`` re-solve
   against their plain versions (``parallel.dryrun.level_plain_errors``);
   shard 1 of the fine level (neighbours on both sides) also
   timed in f32 through the phase-2 checks into the kernels line (labels
   ``shard_frontier_sweep2``, ``shard_interior_sweep8``/``sweep6``,
   ``shard_spmv_ext``, ``shard_bound2_ext``).  Then ``probes.shard_solve``
   (counts set to 0 after each world's repack, read after its solve): the
   Dirichlet slice at P = 1 in process (a world of one, NCCL) and P = 2 on
   the one card (spawned ranks, gloo staged through host), and the
   reference test's Neumann problem (square 600/2500, deg 4) at P = 2,
   each with both levels sharded: in each world every rank first holds its
   kernels on the levels its solve repacked (f64 for the BiCGStab, f32 for
   the V-cycles; every sharded level, the same four checks) against their
   plain versions, then the f64 sharded BiCGStab < 1e-8, re-checked with the plain f64
   SpMV < 1e-8, the solution within 1e-6 of the serial device solve's
   (phase 3's, or the CLI's on that problem), the L1 error at most 1.5x
   the serial one's, the path's kernel roles launched, the collectives a
   V-cycle makes equal to those counted from the partition, every rank
   exiting 0; the iterations, wall seconds, bytes and collectives per
   V-cycle and the f32 25-cycle history printed; after P = 1,
   ``probes.shard_timing`` on the Dirichlet slice (the P = 1 sharded
   V-cycle against the unsharded one, f32); the phase's time;
7. on the bench's 1M-row operator (5 colors of ~1,640 blocks), the fused
   colored smoother in f32, f64 and bf16 K as on the slice's levels (5
   sweeps, no border) and the storage-order chain (f32, 8,192 blocks)
   against the parent chain as on the slice's levels, then the kernel bench
   (``meshlessmultigridpoisson_torch.bench``) in-process on it (counts set
   to 0 before, read after; the bench holds the stream probe at its timed
   depth and one sweep of each timed kind against their plain versions
   before it times them): prints its JSON line; checks the SpMV spot
   check, ``stream14``, ``spmv6``, ``sweep6``, ``sweep8`` and
   ``sweep8_percolor`` launched, and every ``pct_of_bound`` <= 105;
8. on the bench's host operator (built once, before the bench, for the
   bench and both probes): ``probes.kexp`` with 3 iterations (``spmv2``,
   ``spmv3`` and ``spmv1`` at 128- and 256-row blocks, ``sweep1`` at 128),
   then ``probes.ksweepprobe`` with 3 sweeps (the four modes of
   ``sweep_probe``, compile-time modes of ``storage_chain``; ``probe_base``
   also bit for bit against a ``sweep6`` sweep, ``probe_hoist`` against a
   ``sweep7_stale_walk`` one), each in-process with its counts set to 0 before and
   read after; each probe holds every kernel or mode against its plain
   version before timing it; every role launched, each at or above its
   bound; prints the chain's split per block;
9. the kernel-generation probe (``meshlessmultigridpoisson_torch.probes.
   ktime``) in-process on its real 1,048,576-row pattern with 5 iterations
   (counts set to 0 before, read after; the probe holds every kernel
   against its plain version before timing it): ``spmv2`` and ``sweep2``
   at 128- and 256-row blocks (``sweep2`` also against its parent design,
   ``sweep2_tilewalk``, in turns), ``spmv4``, ``sweep4`` and ``sweep5``,
   each launched, each at or above its bound;
10. the stream probes and the SpMV's gather/reduction split, each
   in-process at the reference's sizes with its counts set to 0 before and
   read after: ``probes.kstream`` (the four table mixes over [2^18, 128]
   at 1024-4096 tile rows, 8192 for ``f32``; roles ``kstream_*``),
   ``probes.kprobe`` (the f32 + i32 stream over [2^19, 128] at 64-4096
   tile rows, role ``kprobe_stream``; then the four SpMV modes on
   ``synthetic_banded_csr(262144, 70, 512)``, roles ``spmvp_*``) and
   ``probes.chaintime`` (the stream at 256-4096 tile rows as the delta of
   9 and 1 passes, role ``chain_stream``, and its matmul and elementwise
   calibrations); each probe holds every kernel against its plain version
   before timing it (streams exactly, SpMV modes within 1e-5 of max
   |plain|), and the phase checks every role launched, each row's error
   within that tolerance and each row at or above its bound; prints the
   SpMV's split into gather and reduction.  After ``probes.kprobe``, on
   its 262,144-row operator (built once, before ``kprobe``, for the four
   probes), the kiso probes, each the same way: ``probes.kiso6`` (roles
   ``kiso6_{i16,i32}_{guarded,unguarded}``: u16 or int32 columns, an id
   table padded to a multiple of 8 blocks), ``probes.kiso7``
   (``kiso7_affine``, ``kiso7_ids`` and the stock ``spmv4``) and
   ``probes.kiso8`` (``kiso8_mxu``, ``kiso8_mxudef``: the tensor-core row
   sums in two and one TF32 passes; ``kiso8_vpu``: the warp shuffle;
   ``kiso8_mxu_v1``, ``kiso8_mxudef_v1``: the parent design of the two,
   then each production mma role against its parent in turns parent,
   change, change, parent, printed); every role within 1e-5 of max |plain|
   (the one-pass roles of their TF32 plain version);
11. print a JSON line of per-kernel results, the total time, then, as the
   last line, ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package next to it, it exits with a
non-zero code and prints no result.  ``--sizes`` shrinks the ladder for a
quick rehearsal of the two solve paths; their level-kernel check then only
applies to the default.  The NS path always runs at its default width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import contextlib
import io
import itertools
import math
import os
import statistics
import subprocess
import sys
import time

SLICE_SIZES = [2500, 10000, 35000, 150000]
# the 3D path: the record's settings (scripts/build3d_cache.py) without its
# 1,060,000 level
THREED_SIZES = [500, 2600, 19000, 140000]
THREED_KERNELS = ["v7-exact", "v7-exact", "v8-colored", "v8-colored"]
# L1 error of the reference package's host f64 BiCGStab (tol 1e-8) on the
# same problem, on the CPU (8 BiCGStab iterations to 1.82e-9)
THREED_REF_L1 = 3.0875831977551283e-04
THREED_L1_RTOL = 0.01
EXPECT_KERNELS = ["v7-exact", "v8-colored", "v8-colored", "v8-colored"]
EXACT_KERNELS = ["v7-exact", "v6-oneshot", "v6-oneshot", "v6-oneshot"]
ROLES = {
    # role: (kernel, route source, TPU kernel replaced)
    "spmv6": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels6.py:407"),
    "spmv8": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels8.py:376"),
    "spmv_rowwarp": ("ell_spmv (parent design)",
                     "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
                     "meshlessmultigridpoisson_tpu/ops/kernels8.py:376"),
    "sweep6": ("storage_chain", "meshlessmultigridpoisson_torch/csrc/storage_chain.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels6.py:515"),
    "sweep7_stale": ("stale_cluster (storage_chain.cu, a cluster of 8 CTAs)",
                     "meshlessmultigridpoisson_torch/csrc/storage_chain.cu",
                     "meshlessmultigridpoisson_tpu/ops/kernels6.py:812"),
    "sweep7_stale_walk": ("storage_chain (stale-program mode, parent design)",
                          "meshlessmultigridpoisson_torch/csrc/storage_chain.cu",
                          "meshlessmultigridpoisson_tpu/ops/kernels6.py:812"),
    "sweep6_chain": ("block_oneshot_sweep",
                     "meshlessmultigridpoisson_torch/csrc/block_oneshot_sweep.cu",
                     "meshlessmultigridpoisson_tpu/ops/kernels6.py:515"),
    "sweep7": ("coarse_smooth", "meshlessmultigridpoisson_torch/csrc/block_smooth.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels6.py:812"),
    "sweep8": ("colored_smooth", "meshlessmultigridpoisson_torch/csrc/block_smooth.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels8.py:428"),
    "sweep8_percolor": ("block_oneshot_sweep",
                        "meshlessmultigridpoisson_torch/csrc/block_oneshot_sweep.cu",
                        "meshlessmultigridpoisson_tpu/ops/kernels8.py:428"),
    "bound2": ("compact_rows", "meshlessmultigridpoisson_torch/csrc/compact_rows.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels.py:510"),
    "push2": ("compact_rows", "meshlessmultigridpoisson_torch/csrc/compact_rows.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels.py:510"),
    "ppe2": ("ppe_tail", "meshlessmultigridpoisson_torch/csrc/compact_rows.cu",
             "meshlessmultigridpoisson_tpu/ops/kernels.py:510"),
    "ppe2_scatter": ("compact_rows (parent design of ppe_tail)",
                     "meshlessmultigridpoisson_torch/csrc/compact_rows.cu",
                     "meshlessmultigridpoisson_tpu/ops/kernels.py:510"),
    "stream14": ("stream_ceiling", "meshlessmultigridpoisson_torch/csrc/stream_ceiling.cu",
                 "bench.py:118"),
    "sweep2": ("class_sor_sweep", "meshlessmultigridpoisson_torch/csrc/class_sor_sweep.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels.py:586"),
    "sweep2_tilewalk": ("class_sor_sweep (parent design)",
                        "meshlessmultigridpoisson_torch/csrc/class_sor_sweep.cu",
                        "meshlessmultigridpoisson_tpu/ops/kernels.py:586"),
    "sweep4": ("class_sor_sweep", "meshlessmultigridpoisson_torch/csrc/class_sor_sweep.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels4.py:464"),
    "spmv2": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels.py:510"),
    "spmv4": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels4.py:383"),
    "sweep5": ("storage_chain", "meshlessmultigridpoisson_torch/csrc/storage_chain.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels4.py:620"),
    "spmv1": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels.py:222"),
    "spmv3": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels.py:669"),
    "sweep1": ("class_sor_sweep", "meshlessmultigridpoisson_torch/csrc/class_sor_sweep.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels.py:303"),
    **{m: ("storage_chain", "meshlessmultigridpoisson_torch/csrc/storage_chain.cu",
           "scripts/ksweepprobe.py:110")
       for m in ("probe_base", "probe_hoist", "probe_nodot", "probe_nogather")},
    **{f"kstream_{m}": ("stream_ceiling",
                        "meshlessmultigridpoisson_torch/csrc/stream_ceiling.cu",
                        "scripts/kstream.py:61")
       for m in ("f32i32", "f32f32", "f32", "f32i16")},
    "kprobe_stream": ("stream_ceiling",
                      "meshlessmultigridpoisson_torch/csrc/stream_ceiling.cu",
                      "scripts/kprobe.py:54"),
    **{m: ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
           "scripts/kprobe.py:138")
       for m in ("spmvp_base", "spmvp_nogather", "spmvp_noreduce", "spmvp_neither")},
    "chain_stream": ("stream_ceiling",
                     "meshlessmultigridpoisson_torch/csrc/stream_ceiling.cu",
                     "scripts/chaintime.py:104"),
    **{f"kiso6_{c}_{g}": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
                          "scripts/kiso6.py:98")
       for c in ("i16", "i32") for g in ("guarded", "unguarded")},
    **{m: ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
           "scripts/kiso7.py:86") for m in ("kiso7_affine", "kiso7_ids")},
    **{m: ("ell_rowsum_mma", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
           "scripts/kiso8.py:136") for m in ("kiso8_mxu", "kiso8_mxudef")},
    **{m: ("ell_rowsum_mma (parent design)",
           "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
           "scripts/kiso8.py:136") for m in ("kiso8_mxu_v1", "kiso8_mxudef_v1")},
    "kiso8_vpu": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
                  "scripts/kiso8.py:136"),
}
DIRICHLET_ROLES = ("spmv6", "spmv8", "sweep7", "sweep8")
# the smoother-rate probe's stale row: the smallest configuration of
# results/rho_stale_r3.json (square, 2,500 points, deg 4, Neumann)
RHO_STALE_CFG = ("square", 2500, 4, True)
RHO_STALE_ROLES = ("sweep7_stale", "sweep6", "bound2")
EXACT_ROLES = ("spmv6", "sweep6", "sweep7")
V2_KERNELS = ["v2-fallback"] * 4
V2_ROLES = ("spmv2", "spmv6", "sweep2")
KTIME_N, KTIME_ITERS = 1_048_576, 5
KTIME_ROLES = ("spmv2", "sweep2", "spmv4", "sweep4", "sweep5")
BENCH_ROLES = ("spmv6", "sweep6", "sweep8", "sweep8_percolor", "stream14")
# the parent design of each fused role: the sweep the loop of launches runs
# in the A/B timing (one launch a color; the parent single-CTA chain)
PARENT_ROLE = {"sweep8": "sweep8_percolor", "sweep7": "sweep6_chain"}
SMOOTH_ITERS = 5  # sweeps a smoother call (every level's default)
# the probes on the bench's 1M-row operator (built once for all three)
KEXP_ITERS = 3
KEXP_ROLES = ("spmv1", "spmv2", "spmv3", "sweep1")
SWEEPPROBE_ITERS = 3
SWEEPPROBE_ROLES = ("probe_base", "probe_hoist", "probe_nodot", "probe_nogather")
NEUMANN_ROLES = DIRICHLET_ROLES + ("bound2", "push2")
# the stream probes and the SpMV split (reference sizes, each probe's own)
KSTREAM_ROLES = ("kstream_f32i32", "kstream_f32f32", "kstream_f32", "kstream_f32i16")
KPROBE_ITERS = 20
KPROBE_ROLES = ("kprobe_stream", "spmvp_base", "spmvp_nogather", "spmvp_noreduce",
                "spmvp_neither")
CHAIN_ROLES = ("chain_stream",)
# the kiso probes, on kprobe's operator (each role held within 1e-5)
KISO_ITERS = 20
KISO6_ROLES = ("kiso6_i16_guarded", "kiso6_i16_unguarded", "kiso6_i32_guarded",
               "kiso6_i32_unguarded")
KISO7_ROLES = ("kiso7_affine", "kiso7_ids", "spmv4")
KISO8_ROLES = ("kiso8_mxu", "kiso8_mxudef", "kiso8_vpu", "kiso8_mxu_v1", "kiso8_mxudef_v1")
# the NS main path: the reference program's default run at its own width
# and depth (cli ns defaults), S steps from rest
# the sharded phase: per-shard kernel checks on a 4-way partition (shard 1,
# with neighbours on both sides, timed into the kernels line), the solves
# at P = 1 and 2, and P = 2 on the reference test's Neumann problem
SHARD_CHECK_P = 4
SHARD_TIMED = 1
SHARD_NEUMANN_ARGV = ["solve", "--device", "cuda", "--geom", "square", "--sizes", "600",
                      "2500", "--deg", "4", "--neumann", "--tol", "1e-8"]
NS_SIZES = [170, 600, 2500, 10000]
NS_STEPS = 12
NS_CKPT_STEPS = 2  # steps before the checkpoint, and after it from each state
NS_ROLES = DIRICHLET_ROLES + ("bound2", "ppe2")
NS_EXPECT_KERNELS = ["v7-exact", "v7-exact", "v7-exact", "v8-colored"]
# the reference's TPU record of that run (2000 steps; history every 4th step)
NS_RECORD = "results/ns_tpu_r5.json"
NS_HIST_RTOL = 2e-3
# tolerances, relative to max |plain output|.  f32: the kernel sums a row in
# another order than the plain gather-sum (warp-shuffle tree vs sequential),
# ~70 products of ~1e5-scale weights with cancellation; a sweep adds the
# 128-term K product on top.  f64: the same reorderings at 1e-16 per op.
# compact_rows is a gather-sum like the SpMV (its re-solve epilogue adds
# two operations per row): the SpMV's tolerances.
# The bf16-K sweep against its bf16 plain version: 1e-2 of max |dx| (both
# round t to bf16; a t element on the other side of a rounding boundary
# moves its column's contribution by one bf16 ulp, 2^-8).  The stream
# probe sums small integers: exact.
TOL = {("spmv", "f32"): 1e-5, ("spmv", "f64"): 1e-12,
       ("sweep", "f32"): 1e-4, ("sweep", "f64"): 1e-11,
       ("compact", "f32"): 1e-5, ("compact", "f64"): 1e-12,
       ("sweep", "bf16k"): 1e-2, ("stream", "f32"): 0.0}
PCT_OF_BOUND_MAX = 105.0
# the user surfaces (phase 5).  Reference values: the reference package's
# CLI with its host f64 BiCGStab on the same configurations, on the CPU
# (``--msh``: tol 1e-10, 12 iterations; ``sweep``: tol 1e-8, its rows).
CACHE_ARGV = ["solve", "--device", "cuda", "--geom", "square_with_circle", "--sizes",
              "2500", "10000", "--deg", "6", "--ordering", "kdtile", "--block-rows",
              "512", "--neumann"]
MSH_FILES = ["tests/fixtures/square_170.msh", "tests/fixtures/square_600.msh"]
MSH_POINTS = 610
MSH_REF_L1 = 2.13404311772937e-04
MSH_RECORD = "results/msh_solve_r2.json"
SWEEP_GEOMS = ["square", "square_with_circle", "concentric_circles"]
SWEEP_REF_L1 = {"square": 3.936968915214965e-04,
                "square_with_circle": 6.946786260074965e-05,
                "concentric_circles": 1.5070782728599167e-02}
SURFACE_L1_RTOL = 0.01
PROBE_SWEEPS = 1000
PROBE_CHECKED = 100  # history entries held against the plain f64 probe
PROBE_RTOL = 1e-10
SOLUTION_FILES = ("x", "y", "solution", "exact", "error")


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def compatible_residual(prob, b, x, x_lag) -> float:
    """Relative L1 residual of the bordered compatible pressure system
    (b_lag = 0), recomputed from (x, x_lag) on ``x``'s device by a plain f64
    composition of the host-built operators: Dx.(Dx x) + Dy.(Dy x) with the
    gather-sum SpMV, the fine boundary rows' products scattered over it,
    identity rows at padding, the Lagrange border.  ``prob`` is the host
    FracStepProblem."""
    import torch

    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops.ell import global_cols

    dev = x.device

    def f(v):
        return torch.as_tensor(v).to(device=dev, dtype=torch.float64)

    def spmv(m, v):
        return gk.ell_spmv_plain(f(m.vals), global_cols(m).to(dev), v)

    op = prob.hierarchy.finest
    x, x_lag = f(x), f(x_lag)
    y = spmv(prob.dx, spmv(prob.dx, x)) + spmv(prob.dy, spmv(prob.dy, x))
    rows = op.bound.rows.long().to(dev)
    keep = rows < op.n_pad
    y[rows[keep]] = spmv(op.bound.ell, x)[keep]
    y = torch.where(f(op.smooth_mask + op.neumann_mask) > 0, y, x)
    y = y + f(op.lag_col) * x_lag
    r_lag = (f(op.lag_row) * x).sum() + x_lag
    b = f(b)
    return float(((b - y).abs().sum() + r_lag.abs()) / b.abs().sum())


# the sweep role of each level kind (a v7-exact level whose vectors fit
# coarse_smooth's shared memory: every level of the slice and NS ladders)
KIND_ROLE = {"v8-colored": "sweep8", "v7-exact": "sweep7", "v6-oneshot": "sweep6"}


def vcycles(kinds, counts) -> int:
    """V-cycles of a run from its ``sweep7`` launches, after checking that
    every smoother call on a ``sweep8``/``sweep7`` level was one launch: a
    V-cycle makes two calls on each level (pre and post smoothing; the
    coarsest is smoothed twice), one launch each there, 5 (one a sweep) on
    a ``sweep6`` level, and no ``sweep8_percolor`` launch."""
    n = {r: sum(KIND_ROLE.get(k) == r for k in kinds) for r in ("sweep8", "sweep7", "sweep6")}
    v, rem = divmod(counts["sweep7"], 2 * n["sweep7"])
    want = {"sweep8": 2 * n["sweep8"] * v, "sweep7": 2 * n["sweep7"] * v,
            "sweep6": 2 * SMOOTH_ITERS * n["sweep6"] * v, "sweep8_percolor": 0}
    got = {r: counts[r] for r in want}
    if rem or got != want:
        raise AssertionError(f"smoother launches {got} are not those of {v} V-cycles "
                             f"with one launch a fused smoother call: {want}")
    return v


def ns_matvecs(inner) -> int:
    """Compatible matvecs of NS steps from each step's PPE passes' inner
    iterations (``ppe_inner_iters``): a step's f64 residual before its
    passes, and per pass its BiCGStab's 1 + 2 an iteration and the f64
    residual after it."""
    return sum(1 + sum(2 + 2 * its for its in step) for step in inner)


def ns_bound2(inner) -> int:
    """Standalone re-solves of NS steps: one a Krylov solve (mg/krylov.py's
    last) and one a PPE solve (mg/mixed.py's, f64)."""
    return sum(len(step) + 1 for step in inner)


@contextlib.contextmanager
def no_plain_versions(gk):
    """Every ``*_plain`` function of the kernel module raises while inside:
    a path run there launched kernels only."""
    saved = {k: v for k, v in vars(gk).items() if k.endswith("_plain") and callable(v)}

    def refuse(name):
        def f(*a, **kw):
            raise AssertionError(f"the plain version {name} ran")
        return f

    try:
        for k in saved:
            setattr(gk, k, refuse(k))
        yield
    finally:
        for k, v in saved.items():
            setattr(gk, k, v)


def user_surfaces(cli, gk, launches: dict, card: str, root: str) -> None:
    """Phase 5: ``solve --setup-cache/--write-solution``, ``solve --msh``,
    ``probe`` and ``sweep`` through the CLI's entry points on the card, each
    with its counts set to 0 before it and read after (``launches[path]``);
    every file under a temporary directory, removed at the end.  Raises
    AssertionError on the first failed check."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from meshlessmultigridpoisson_torch.io import bundle, read_vector_txt
    from meshlessmultigridpoisson_torch.ops.smoothers import apply_dirichlet, single_grid_probe
    from meshlessmultigridpoisson_torch.utils.metrics import bordered_residual

    def check(ok, msg):
        if not ok:
            raise AssertionError(msg)

    def run(path, fn, argv):
        print(f"main path ({path}): python -m meshlessmultigridpoisson_torch.apps.cli "
              + " ".join(argv), flush=True)
        gk.reset_counts()
        out = fn(argv)
        torch.cuda.synchronize()
        launches[path] = dict(gk.COUNTS)
        return out

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_surfaces_")
    try:
        # the setup cache: built and saved, then loaded; and the solve without it
        cache = os.path.join(tmp, "c.npz")
        runs = []
        for i in (1, 2):
            argv = CACHE_ARGV + ["--setup-cache", cache, "--write-solution",
                                 os.path.join(tmp, f"sol{i}")]
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rec, prob, x, xl = run(f"setup-cache {i}", cli.run_solve, argv)
            said = [m for m in err.getvalue().splitlines() if m.startswith("setup ")]
            print(f"setup-cache run {i}: " + "; ".join(said), flush=True)
            print(rec.to_json(), flush=True)
            built = any("built and cached" in m for m in said)
            loaded = any("loaded from" in m for m in said)
            check(loaded and built == (i == 1),
                  f"setup-cache run {i}: built {built}, loaded {loaded}: {said}")
            runs.append((rec, prob, x, xl))
        rec3, _, x3, xl3 = run("no cache", cli.run_solve, CACHE_ARGV)
        same = [bool(torch.equal(r[2], x3) and torch.equal(r[3], xl3)) for r in runs]
        c = runs[1][0].extra["setup_cache"]
        print(f"setup cache: {c['bytes'] / 1e6:.3f} MB, saved in "
              f"{runs[0][0].extra['setup_cache']['save_s']:.3f} s, loaded in "
              f"{c['load_s']:.3f} s; host problem built {runs[0][0].extra['setup_stages_s']['host_problem']:.2f} s "
              f"(with the save and load), loaded {runs[1][0].extra['setup_stages_s']['host_problem']:.2f} s, "
              f"without the cache {rec3.extra['setup_stages_s']['host_problem']:.2f} s; "
              f"x (cached, loaded) bit-identical to the solve without the cache: {same} "
              f"({card})", flush=True)
        check(all(same), f"setup cache: solutions not bit-identical to the uncached solve: {same}")
        rec, prob, x, xl = runs[1]
        recheck = bordered_residual(prob.hierarchy.levels[-1], prob.state0.b[-1],
                                    prob.state0.b_lag[-1], x, xl)
        print(f"setup cache: residual {rec.final_residual:.3e}, re-checked (plain f64 "
              f"SpMV) {recheck:.3e}, L1 {rec.l1_error:.6e}", flush=True)
        check(rec.final_residual < 1e-8 and recheck < 1e-8,
              f"setup cache: residual {rec.final_residual:.3e}, re-checked {recheck:.3e}")
        n = prob.clouds[-1].n
        for name in SOLUTION_FILES:
            a, b = (read_vector_txt(os.path.join(tmp, f"sol{i}", f"{name}.txt"))
                    for i in (1, 2))
            check(a.shape == (n,) and np.isfinite(a).all() and np.array_equal(a, b),
                  f"--write-solution {name}.txt: shape {a.shape}, not {n} finite values "
                  "equal in both runs")
        sol, exact, error = (read_vector_txt(os.path.join(tmp, "sol2", f"{k}.txt"))
                             for k in ("solution", "exact", "error"))
        print(f"--write-solution: {len(SOLUTION_FILES)} files of {n} values read back; "
              f"mean error {error.mean():.6e} (record L1 {rec.l1_error:.6e})", flush=True)
        check(np.allclose(exact, prob.exact, rtol=0, atol=1e-15)
              and abs(error.mean() - rec.l1_error) <= 1e-12
              and np.abs(np.abs(sol - exact) - error).max() <= 1e-15,
              "--write-solution: the files disagree with the record")
        # a stamp for other arguments, and no stamp, are refused
        unstamped = os.path.join(tmp, "unstamped.npz")
        bundle.save_tree(unstamped, "poisson_problem",
                         bundle.load_tree(cache, "poisson_problem"))
        for label, argv in (
                ("--deg 5", [a if a != "6" else "5" for a in CACHE_ARGV]
                 + ["--setup-cache", cache]),
                ("no stamp", CACHE_ARGV + ["--setup-cache", unstamped])):
            try:
                cli.run_solve(argv)
            except SystemExit as e:
                print(f"setup cache, {label}: refused ({str(e).splitlines()[0]})", flush=True)
            else:
                raise AssertionError(f"setup cache, {label}: not refused")
        del runs, rec, prob, x, xl, rec3, x3, xl3

        # --msh: the reference's fixtures
        argv = ["solve", "--device", "cuda", "--msh",
                *(os.path.join(root, f) for f in MSH_FILES),
                "--neumann", "--deg", "4", "--tol", "1e-10"]
        rec, prob, x, xl = run("msh", cli.run_solve, argv)
        print(rec.to_json(), flush=True)
        recheck = bordered_residual(prob.hierarchy.levels[-1], prob.state0.b[-1],
                                    prob.state0.b_lag[-1], x, xl)
        with open(os.path.join(root, MSH_RECORD)) as fh:
            record_l1 = json.load(fh)["l1_error"]
        print(f"msh: points {rec.config['sizes']}, kinds {rec.extra['level_kernels']}, "
              f"{rec.cycles} passes, residual {rec.final_residual:.3e} (re-checked "
              f"{recheck:.3e}), L1 {rec.l1_error:.6e} against the reference's "
              f"{MSH_REF_L1:.6e} and {MSH_RECORD}'s {record_l1:.6e}", flush=True)
        check(rec.config["sizes"][-1] == MSH_POINTS,
              f"msh: fine level {rec.config['sizes'][-1]} points, not {MSH_POINTS}")
        check(rec.final_residual < 1e-10 and recheck < 1e-10,
              f"msh: residual {rec.final_residual:.3e}, re-checked {recheck:.3e}")
        check(abs(rec.l1_error - MSH_REF_L1) <= SURFACE_L1_RTOL * MSH_REF_L1,
              f"msh: L1 {rec.l1_error:.6e} not within 1% of {MSH_REF_L1:.6e}")
        del rec, prob, x, xl

        # probe: the f64 class sweep (sweep2) and its matvec (spmv2), no plain version
        argv = ["probe", "--device", "cuda", "--geom", "square", "--sizes", "2500",
                "--deg", "4", "--sweeps", str(PROBE_SWEEPS), "--cond"]
        with no_plain_versions(gk):
            rec, prob, x, hist = run("probe", cli.run_probe, argv)
        n_probe = launches["probe"]
        got = {r: n_probe[r] for r in ("sweep2", "spmv2")}
        others = {r: v for r, v in n_probe.items() if v and r not in ("sweep2", "spmv2",
                                                                    "bound2")}
        op = prob.hierarchy.finest
        x0 = apply_dirichlet(op, prob.state0.x[-1], coarse=False)
        _, href = single_grid_probe(op, x0, prob.state0.b[-1], sweeps=PROBE_CHECKED)
        href = href.numpy()
        dev_max = float(np.max(np.abs(hist[:PROBE_CHECKED] - href) / np.abs(href)))
        print(f"probe: {rec.config['sizes']} points, kinds {rec.extra['level_kernels']}, "
              f"x {x.dtype} on {x.device}; launches {got} (others {others}); "
              f"{rec.extra['ms_a_sweep']:.4f} ms a sweep with its residual "
              f"({PROBE_SWEEPS} sweeps in {rec.wall_time_s:.3f} s); history "
              f"{hist[0]:.6e} .. {hist[-1]:.6e}, L1 {rec.l1_error:.6e}, cond "
              f"{rec.extra['cond_L']:.6e}; first {PROBE_CHECKED} entries against the "
              f"host f64 probe: largest relative deviation {dev_max:.3e} ({card})",
              flush=True)
        check(rec.extra["level_kernels"] == ["v2-fallback"] and x.dtype == torch.float64
              and x.is_cuda, "probe: not the f64 v2 level on the card")
        check(got == {"sweep2": PROBE_SWEEPS, "spmv2": PROBE_SWEEPS} and not others,
              f"probe: launches {got}, others {others}")
        check(dev_max <= PROBE_RTOL, f"probe: history deviates {dev_max:.3e}")
        check(np.isfinite(hist).all() and math.isfinite(rec.extra["cond_L"]),
              "probe: history or cond not finite")
        del rec, prob, x, hist

        # sweep: one row a geometry
        out = os.path.join(tmp, "sweep.json")
        argv = ["sweep", "--device", "cuda", "--geoms", *SWEEP_GEOMS, "--levels", "2",
                "--ks", "1", "--degs", "4", "--out", out]
        try:
            rows = run("sweep", cli.run_sweep, argv)
        except SystemExit as e:
            raise AssertionError(f"sweep: {e}") from None
        with open(out) as fh:
            check(json.load(fh) == rows, "sweep: the rows written differ")
        check(len(rows) == len(SWEEP_GEOMS) and not any("error" in r for r in rows),
              f"sweep: {len(rows)} rows, errors {[r.get('error') for r in rows]}")
        for r in rows:
            geom, ref = r["config"]["geom"], SWEEP_REF_L1[r["config"]["geom"]]
            n_row = r["extra"].get("launches", {})
            print(f"sweep {geom}: points {r['config'].get('sizes', r['config'])}, kinds "
                  f"{r['extra'].get('level_kernels')}, "
                  f"{r['cycles']} passes, residual {r['final_residual']:.3e}, L1 "
                  f"{r['l1_error']:.6e} against the reference's {ref:.6e} "
                  f"({r['l1_error'] / ref:.6f}x), {r['elapsed']:.2f} s", flush=True)
            check(r["final_residual"] < 1e-8, f"sweep {geom}: residual {r['final_residual']}")
            check(abs(r["l1_error"] - ref) <= SURFACE_L1_RTOL * ref,
                  f"sweep {geom}: L1 {r['l1_error']:.6e} not within 1% of {ref:.6e}")
            check(any(n_row[k] for k in n_row if k.startswith("sweep"))
                  and any(n_row[k] for k in n_row if k.startswith("spmv")),
                  f"sweep {geom}: no sweep or SpMV launched: {n_row}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase-5 user surfaces: {time.perf_counter() - t0:.1f} s ({card})", flush=True)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=SLICE_SIZES)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from meshlessmultigridpoisson_torch import bench
        from meshlessmultigridpoisson_torch.apps import cli
        from meshlessmultigridpoisson_torch.mg import gpu_backend
        from meshlessmultigridpoisson_torch.mg.gpu_backend import (
            gpu_hierarchy,
            gpu_level_from_operator,
        )
        from meshlessmultigridpoisson_torch.models import fracstep_gpu
        from meshlessmultigridpoisson_torch.models.poisson import fine_rhs, make_poisson_problem
        from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
        from meshlessmultigridpoisson_torch.probes import (
            chaintime,
            kexp,
            kiso6,
            kiso7,
            kiso8,
            kprobe,
            ksweepprobe,
            kstream,
            ktime,
            launchrank,
            rho,
            sassloads,
            vcycle_breakdown,
        )
        from meshlessmultigridpoisson_torch.utils import profiling as pf
        from meshlessmultigridpoisson_torch.utils.metrics import bordered_residual
    except ImportError as e:
        return fail(f"the port package is not next to this script ({e})")
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    card_name = torch.cuda.get_device_name(0)
    pf.peaks(card_name)  # the bounds need the card's published peaks
    t0 = time.perf_counter()
    gk.build(verbose=True)
    gk._load()
    print(f"kernel library built in {time.perf_counter() - t0:.2f} s", flush=True)
    loads = sassloads.library_loads()
    i16 = {k: v for k, v in loads.items() if sassloads.I16_INSTANCE in k}
    print(f"global loads of the f32i16 stream instance: {i16}", flush=True)
    if not sassloads.i16_loads_live(loads):
        return fail("the f32i16 stream instance does not load its whole i16 table")

    # ---- 2. kernels vs plain on the slice's shapes --------------------------
    geom = dict(geomtype="square_with_circle", sizes=args.sizes, poly_deg=6,
                ordering="kdtile", block_rows=512)
    t0 = time.perf_counter()
    prob = make_poisson_problem(**geom, device=dev)
    hier = prob.hierarchy
    g32 = gpu_hierarchy(hier, dev, torch.float32)
    coarse64 = gpu_level_from_operator(hier.levels[0], dev, torch.float64)
    fine64 = gpu_level_from_operator(hier.levels[-1], dev, torch.float64)
    torch.cuda.synchronize()
    print(f"phase-2 setup {time.perf_counter() - t0:.1f} s, sizes "
          f"{[c.n for c in prob.clouds]}, level kinds "
          f"{[lv.kernel_kind for lv in g32.levels]}", flush=True)

    gen = torch.Generator(device="cpu").manual_seed(0)
    results = {r: [] for r in ROLES}
    launches = {}  # path -> the launches of its run, counts set to 0 just before it

    def record(role, label, tol_key, err, scale, ms, plain_ms, nbytes, flops,
               dtype, library_ms=None, device=None, extra=None):
        """``device``: (kernel, library or None) device ms per call, for a
        kernel whose chain time is the host's enqueue rate; ``extra``: more
        keys for the kernels line."""
        rel = err / max(scale, 1e-300)
        tol = TOL[tol_key]
        b_ms, by = pf.bound_ms(nbytes, flops, dtype, card_name)
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        dev_t = "" if device is None else (
            f"  device time: kernel {device[0]:.4f} ms"
            + ("" if device[1] is None else f", library {device[1]:.4f} ms"))
        print(f"  {label:<52s} rel err {rel:.3e} (tol {tol:.0e})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms "
              f"({by}){lib}{dev_t}", flush=True)
        results[role].append(dict(label=label, max_abs_err=err, rel_err=rel,
                                  ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=by, library_ms=library_ms,
                                  device_ms=None if device is None else device[0],
                                  library_device_ms=None if device is None else device[1],
                                  **(extra or {})))
        if not rel <= tol:
            raise AssertionError(f"{label}: relative error {rel:.3e} > {tol:.0e}")

    def ms_of(op, x, k):
        """ms per application of ``op(x)``: k back-to-back calls after a
        warm-up, between CUDA events."""
        return pf.chain_time(op, x, k=k, reps=1) * 1e3

    def device_times(ms, kernel, library, x, k):
        """(kernel, library) device ms per call from ``torch.profiler``
        where the chain time ``ms`` is the host's enqueue rate, else None."""
        if ms >= pf.ENQUEUE_MS:
            return None
        return pf.device_ms(kernel, x, k), pf.device_ms(library, x, k)

    def dname(dtype):
        return "f32" if dtype == torch.float32 else "f64"

    def check_spmv(role, label, A):
        """The redesigned ``ell_spmv`` (each row to ``lens``, a CTA a
        128-row block, the table's column format) against its plain
        version, the parent design (``spmv_rowwarp``: a warp a row over the
        full width, int32 columns) and one ``torch.sparse`` CSR call; device
        times from ``torch.profiler`` in turns parent, kernel, library,
        kernel, parent (these calls run 0.002-0.3 ms), twice over where the
        host's enqueue rate bounds the chain (the NS tables and the coarse
        transfers: their 2-5 us readings spread most), each side's median
        taken; both rows recorded, the parent's under its own role."""
        x = torch.randn(A.ncols, generator=gen, dtype=torch.float64).to(
            device=dev, dtype=A.vals.dtype)
        P = gk.rowwarp_ell(A)
        y = gk.ell_spmv(A, x)
        yr = gk.ell_spmv(P, x)
        torch.cuda.synchronize()
        yp = gk.ell_spmv_lens_plain(A, x)
        ypr = gk.ell_spmv_plain(P.vals, P.cols, x)
        err, err_r = float((y - yp).abs().max()), float((yr - ypr).abs().max())
        scale = float(yp.abs().max())
        if not float((y - yr).abs().max()) <= TOL[("spmv", dname(A.vals.dtype))] * scale:
            raise AssertionError(f"ell_spmv {label}: kernel and parent design disagree")
        ms = ms_of(lambda v: gk.ell_spmv(A, v), x, 50)
        pr_ms = ms_of(lambda v: gk.ell_spmv(P, v), x, 50)
        pms = ms_of(lambda v: gk.ell_spmv_lens_plain(A, v), x, 10)
        csr = pf.library_csr(A.vals, A.global_cols().to(torch.int32), A.ncols)
        lms = ms_of(lambda v: csr @ v, x, 50)
        ops = {"parent": lambda v: gk.ell_spmv(P, v), "kernel": lambda v: gk.ell_spmv(A, v),
               "library": lambda v: csr @ v}
        turns = ("parent", "kernel", "library", "kernel", "parent")
        if ms < pf.ENQUEUE_MS:
            turns *= 2
        d = [pf.device_ms(ops[k], x, 50) for k in turns]
        dk, dp, dl = (statistics.median(v for k, v in zip(turns, d) if k == side)
                      for side in ("kernel", "parent", "library"))
        dt = dname(A.vals.dtype)
        nbytes, flops = pf.spmv_bytes(A), pf.spmv_flops(A)
        b_ms = pf.bound_ms(nbytes, flops, A.vals.dtype, card_name)[0]
        span = gk.u16_span(A.global_cols())
        shape = (f"{A.nrows_pad} x {A.ncols}, width {A.width}, mean lens "
                 f"{float(A.lens.float().mean()):.1f}, largest block span {span}")
        print(f"  A/B ell_spmv {dt} {label} ({A.col_format}; {shape}): device ms "
              + " / ".join(f"{k} {v:.4f}" for k, v in zip(turns, d))
              + f"; medians kernel {dk:.4f} / parent {dp:.4f} / library {dl:.4f}; bound "
              f"{b_ms:.4f} ms, kernel at {100 * b_ms / dk:.1f}% of bound, "
              f"{'no slower' if dk <= dl else 'SLOWER'} than the library ({card})",
              flush=True)
        record(role, f"ell_spmv {dt} {label} ({A.col_format})", ("spmv", dt), err, scale,
               ms, pms, nbytes, flops, A.vals.dtype, lms, (dk, dl),
               extra=dict(col_format=A.col_format, parent_device_ms=dp,
                          pct_of_bound=100 * b_ms / dk, device_ab_ms=d))
        # the parent design on the same inputs: every stored entry, int32
        p_nbytes, p_flops = pf.spmv_bytes(P), pf.spmv_flops(P)
        record("spmv_rowwarp", f"ell_spmv parent design {dt} {label} (i32)", ("spmv", dt),
               err_r, float(ypr.abs().max()), pr_ms, pms, p_nbytes, p_flops, A.vals.dtype,
               lms, (dp, dl), extra=dict(
                   pct_of_bound=100 * pf.bound_ms(p_nbytes, p_flops, A.vals.dtype,
                                                  card_name)[0] / dp))

    def check_chain(label, sw):
        """The redesigned storage-order chain (``sweep6``, one
        ``storage_chain`` launch a sweep) against its plain version and the
        parent chain (``sweep6_chain``) on the same inputs, then one sweep
        timed in turns parent, kernel, kernel, parent (each a single launch
        of 0.5-110 ms: the chain time is the device time); both rows
        recorded, the parent's under its own role."""
        dtype = sw.A.vals.dtype
        n = sw.A.nrows_pad
        nb = n // gk.LANES
        x0 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        xl = torch.tensor(0.3, dtype=dtype, device=dev)
        par = dataclasses.replace(sw, role="sweep6_chain")
        xk = gk.block_oneshot_sweep(sw, x0.clone(), xl, b)
        xpar = gk.block_oneshot_sweep(par, x0.clone(), xl, b)
        torch.cuda.synchronize()
        staging = gk.CHAIN_INFO[sw.role]
        t0 = time.perf_counter()
        xp = gk.block_oneshot_sweep_plain(sw, x0.clone(), xl, b)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        if sw.kT.dtype == torch.bfloat16:
            dt, scale = "bf16k", float((xp - x0).abs().max())
        else:
            dt, scale = dname(dtype), float(xp.abs().max())
        k = 2 if nb > 2000 else 5
        t = [ms_of(lambda v, s=s: gk.block_oneshot_sweep(s, v, xl, b), x0.clone(), k)
             for s in (par, sw, sw, par)]
        tk, tp = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        print(f"  A/B storage-order chain {dt} {label} ({nb} blocks, width {sw.A.width}; "
              f"ELL tile staged, shared bytes {staging}): ms parent {t[0]:.4f} / "
              f"kernel {t[1]:.4f} / kernel {t[2]:.4f} / parent {t[3]:.4f}; a link "
              f"{1e3 * tk / nb:.2f} us (parent {1e3 * tp / nb:.2f}) ({card})", flush=True)
        nbytes, flops = pf.sweep_bytes(sw), pf.sweep_flops(sw)
        record(sw.role, f"storage_chain {dt} {label}, one sweep", ("sweep", dt),
               float((xk - xp).abs().max()), scale, tk, pms, nbytes, flops, dtype,
               extra=dict(parent_ms=tp, chain_ab_ms=t, staging=staging,
                          link_us=1e3 * tk / nb))
        record("sweep6_chain", f"block_oneshot_sweep parent chain {dt} {label}, one sweep",
               ("sweep", dt), float((xpar - xp).abs().max()), scale, tp, pms, nbytes, flops,
               dtype, extra=dict(link_us=1e3 * tp / nb))

    def check_stale(label, sw):
        """The stale-program sweep (the reference's ``sor_sweep_tpu7(
        stale_program=True)``) on storage-order sweep ``sw``'s tables: its
        cluster kernel (``sweep7_stale``) and the walk (``sweep7_stale_walk``,
        the first design), one launch each counted, each against its plain
        version; then one sweep timed in turns cluster, walk, walk, cluster,
        then the exact chain (``sweep6``) once (single launches of 0.5-10
        ms: the chain time is the device time).  Their bound is the exact
        sweep's (the same bytes, row 6')."""
        dtype = sw.A.vals.dtype
        n = sw.A.nrows_pad
        nb = n // gk.LANES
        sides = {r: gk.stale_sweep_of(sw, r) for r in gk.STALE_ROLES}
        x0 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        xl = torch.tensor(0.3, dtype=dtype, device=dev)
        out, staging = {}, {}
        for role, st in sides.items():
            before = dict(gk.COUNTS)
            out[role] = gk.stale_sweep(st, x0.clone(), xl, b)
            torch.cuda.synchronize()
            made = {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]}
            if made != {role: 1}:
                raise AssertionError(f"stale_sweep {label}: launches {made}, not one {role}")
            staging[role] = gk.CHAIN_INFO[role]
        t0 = time.perf_counter()
        xp = gk.stale_sweep_plain(sides[gk.STALE_ROLE], x0.clone(), xl, b)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        if sw.kT.dtype == torch.bfloat16:
            dt, scale = "bf16k", float((xp - x0).abs().max())
        else:
            dt, scale = dname(dtype), float(xp.abs().max())
        k = 2 if nb > 2000 else 5
        ops = {"cluster": lambda v: gk.stale_sweep(sides[gk.STALE_ROLE], v, xl, b),
               "walk": lambda v: gk.stale_sweep(sides[gk.STALE_WALK], v, xl, b),
               "sweep6": lambda v: gk.storage_chain(sw, v, xl, b)}
        turns = ("cluster", "walk", "walk", "cluster", "sweep6")
        t = [ms_of(ops[side], x0.clone(), k) for side in turns]
        tk, tw, te = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t[4]
        groups = -(-nb // gk.STALE_GROUP)
        print(f"  A/B stale-program sweep {dt} {label} ({nb} blocks, {groups} groups of "
              f"8, width {sw.A.width}; cluster (K tiles, shared bytes) "
              f"{staging[gk.STALE_ROLE]}, walk (ELL tile, shared bytes) "
              f"{staging[gk.STALE_WALK]}): ms cluster "
              f"{t[0]:.4f} / walk {t[1]:.4f} / walk {t[2]:.4f} / cluster {t[3]:.4f} / "
              f"sweep6 {t[4]:.4f}; a group {1e3 * tk / groups:.2f} us (walk "
              f"{1e3 * tw / groups:.2f}) ({card})", flush=True)
        for role, ms, other in ((gk.STALE_ROLE, tk, tw), (gk.STALE_WALK, tw, tk)):
            record(role, f"{ROLES[role][0].split(' ')[0]} stale-program {dt} {label}, "
                   f"one sweep", ("sweep", dt), float((out[role] - xp).abs().max()), scale,
                   ms, pms, pf.sweep_bytes(sw), pf.sweep_flops(sw), dtype,
                   extra=dict(sweep6_ms=te, stale_ab_ms=dict(zip(
                       [f"{i}_{s}" for i, s in enumerate(turns)], t)),
                       staging=staging[role], group_us=1e3 * ms / groups,
                       other_design_ms=other))

    def check_sweep(label, sw):
        dtype = sw.A.vals.dtype
        n = sw.A.nrows_pad
        x0 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        xl = torch.zeros((), dtype=dtype, device=dev)
        xk = gk.block_oneshot_sweep(sw, x0.clone(), xl, b)
        torch.cuda.synchronize()
        xp = gk.block_oneshot_sweep_plain(sw, x0.clone(), xl, b)
        err = float((xk - xp).abs().max())
        xs = x0.clone()
        ms = ms_of(lambda v: gk.block_oneshot_sweep(sw, v, xl, b), xs, 20)
        pms = ms_of(lambda v: gk.block_oneshot_sweep_plain(sw, v, xl, b), xs, 3)
        if sw.kT.dtype == torch.bfloat16:
            dt, scale = "bf16k", float((xp - x0).abs().max())
        else:
            dt, scale = dname(dtype), float(xp.abs().max())
        launches = 1 if sw.role in gk.FUSED_SWEEP_ROLES else sw.nphases
        record(sw.role, f"{ROLES[sw.role][0]} {dt} {label}, one sweep "
               f"({launches} launches)", ("sweep", dt), err, scale, ms, pms,
               pf.sweep_bytes(sw), pf.sweep_flops(sw), dtype)

    def check_class_sweep(label, sw, x_lag):
        """The window class sweep and its parent design (``sweep2_tilewalk``)
        against the plain version on the same inputs, each one launch
        counted, frozen rows untouched; then one sweep timed in turns
        parent, kernel, kernel, parent (single launches of 0.2-35 ms: the
        chain time is the device time); both rows recorded, the parent's
        under its own role."""
        dtype = sw.A.vals.dtype
        n = sw.A.nrows_pad
        tiles = n // sw.class_size
        # x of the table's columns: a rectangular sweep (a shard's frontier
        # rows) reads rows past n and must leave them as they are
        x0 = torch.randn(sw.A.ncols, generator=gen, dtype=torch.float64).to(dev, dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        xl = torch.tensor(x_lag, dtype=dtype, device=dev)
        par = dataclasses.replace(sw, role=gk.CLASS_PARENT)
        frozen = torch.nonzero(sw.mask == 0).flatten()
        out = {}
        for s_ in (sw, par):
            before = gk.COUNTS[s_.role]
            out[s_.role] = gk.class_sor_sweep(s_, x0.clone(), xl, b)
            torch.cuda.synchronize()
            if gk.COUNTS[s_.role] != before + 1:
                raise AssertionError(f"class_sor_sweep {label} ({s_.role}): not one launch")
            if not torch.equal(out[s_.role][frozen], x0[frozen]):
                raise AssertionError(f"class_sor_sweep {label} ({s_.role}): a frozen row moved")
            if not torch.equal(out[s_.role][n:], x0[n:]):
                raise AssertionError(f"class_sor_sweep {label} ({s_.role}): wrote past its rows")
        plan = gk.CLASS_INFO[sw.role]
        t0 = time.perf_counter()
        xp = gk.class_sor_sweep_plain(sw, x0.clone(), xl, b)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        k = 3 if tiles > 10_000 else 10
        t = [ms_of(lambda v, s_=s_: gk.class_sor_sweep(s_, v, xl, b), x0.clone(), k)
             for s_ in (par, sw, sw, par)]
        tk, tp = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        dt = dname(dtype)
        print(f"  A/B class sweep {dt} {label} ({tiles} tiles of {sw.class_size}, width "
              f"{sw.A.width}, window {sw.window}, mean seg {float(sw.seg.float().mean()):.1f} "
              f"of mean lens {float(sw.A.lens.float().mean()):.1f}; ring slots, shared bytes, "
              f"tiles a slot {plan}): ms parent {t[0]:.4f} / kernel {t[1]:.4f} / kernel "
              f"{t[2]:.4f} / parent {t[3]:.4f}; a link {1e3 * tk / tiles:.3f} us (parent "
              f"{1e3 * tp / tiles:.3f}) ({card})", flush=True)
        nbytes, flops = pf.sweep_bytes(sw), pf.sweep_flops(sw)
        scale = float(xp.abs().max())
        common = f"{dt} {label} ({tiles} tiles, x_lag {x_lag}), one sweep"
        record(sw.role, f"class_sor_sweep {common}", ("sweep", dt),
               float((out[sw.role] - xp).abs().max()), scale, tk, pms, nbytes, flops, dtype,
               extra=dict(parent_ms=tp, chain_ab_ms=t, staging=plan,
                          link_us=1e3 * tk / tiles))
        record(par.role, f"class_sor_sweep parent design {common}", ("sweep", dt),
               float((out[par.role] - xp).abs().max()), scale, tp, pms, nbytes, flops, dtype,
               extra=dict(link_us=1e3 * tp / tiles))

    def check_smooth(label, sw, lag_row=None, bound=None, omega=1.4,
                     iters=SMOOTH_ITERS, start=None):
        """One fused smoother call (``iters`` sweeps, with the relax given
        ``lag_row`` and the re-solve given ``bound``; x_lag 0.3, b_lag -0.4)
        against its plain version: counted once, a rerun bit-identical, x
        and x_lag within the sweep's tolerance.  Then one call timed both
        ways in turns, the parent design's loop of launches and the fused
        launch: loop, fused, fused, loop.  Given ``start`` (mask, values), the
        call holds the V-cycle's re-solves too (the first from the input x,
        then the pin; one more after the last sweep), against their plain
        version, and is timed against them as launches of their own
        (``bound2``, ``torch.where``) around the fused call without them."""
        dtype = sw.A.vals.dtype
        n = sw.A.nrows_pad
        x0 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        xl0 = 0.3 if lag_row is not None else 0.0
        xl = torch.tensor(xl0, dtype=dtype, device=dev)
        bl = torch.tensor(-0.4, dtype=dtype, device=dev)
        args = (b, bl, iters, omega, lag_row, bound)
        ends = {} if start is None else dict(start=start, resolve_last=True)
        before = dict(gk.COUNTS)
        out, out_l = gk.block_smooth(sw, x0, xl, *args, **ends)
        torch.cuda.synchronize()
        made = {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]}
        if made != {sw.role: 1}:
            raise AssertionError(f"block_smooth {label}: launches {made}, not one {sw.role}")
        staging = gk.SMOOTH_INFO[sw.role]
        again, again_l = gk.block_smooth(sw, x0, xl, *args, **ends)
        torch.cuda.synchronize()
        if not (torch.equal(again, out) and torch.equal(again_l, out_l)):
            raise AssertionError(f"block_smooth {label}: a rerun gave other bits")
        ref, ref_l = gk.block_smooth_plain(sw, x0, xl, *args, **ends)
        bf = sw.kT.dtype == torch.bfloat16
        dt = "bf16k" if bf else dname(dtype)
        scale = float((ref - x0).abs().max() if bf else ref.abs().max())
        scale_l = abs(float(ref_l - xl0) if bf else float(ref_l))
        err_l = abs(float(out_l - ref_l))
        if lag_row is not None and not err_l <= TOL[("sweep", dt)] * scale_l:
            raise AssertionError(f"block_smooth {label}: x_lag {float(out_l)} against "
                                 f"{float(ref_l)}")
        psw = dataclasses.replace(sw, role=PARENT_ROLE[sw.role])

        def fused(v):
            return gk.block_smooth(sw, v, xl, *args, **ends)[0]

        def loop(v):
            if start is None:
                return gk.smooth_loop(psw, v, xl, b, bl, iters, omega, lag_row, bound)[0]
            v = torch.where(start[0] > 0, start[1], gk.compact_rows(bound, v.clone(), b))
            return gk.compact_rows(bound, gk.block_smooth(sw, v, xl, *args)[0], b)

        k = 20 if n < 500_000 else 4
        t = [ms_of(f, x0, k) for f in (loop, fused, fused, loop)]
        pms = ms_of(lambda v: gk.block_smooth_plain(sw, v, xl, *args, **ends)[0], x0, 1)
        kernel = ROLES[sw.role][0]
        what = (f"{iters} sweeps" + (", relax" if lag_row is not None else "")
                + (f", {bound.nrows} boundary rows" if bound is not None else "")
                + (", the V-cycle's re-solves and pin" if start is not None else ""))
        names = ("loop", "fused") if start is None else ("separate re-solves", "fused")
        print(f"  A/B one smoother call, {kernel} {dt} {label} ({what}; grid, K and ELL "
              f"buffers, shared bytes {staging}): {names[0]} {t[0]:.4f} / {names[1]} "
              f"{t[1]:.4f} / {names[1]} {t[2]:.4f} / {names[0]} {t[3]:.4f} ms ({card})",
              flush=True)
        record(sw.role, f"{kernel} {dt} {label}, one smoother call ({what})",
               ("sweep", dt), float((out - ref).abs().max()), scale, (t[1] + t[2]) / 2,
               pms, pf.smooth_bytes(sw, lag_row, bound, start),
               pf.smooth_flops(sw, iters, lag_row, bound, 0 if start is None else 2), dtype,
               extra=dict(loop_ms=(t[0] + t[3]) / 2, ab_ms=t, staging=staging,
                          x_lag_err=err_l))

    def check_level_smooth(label, lv, start=None):
        check_smooth(label, lv.sweep, *pf.level_smooth_args(lv), omega=lv.omega,
                     iters=lv.iters, start=start)

    def random_pin(lv):
        """A pin on level ``lv`` for the fused re-solves' check: every 7th
        row that no boundary row targets, to random values (the Neumann
        levels pin no row of their own)."""
        mask = lv.dirichlet_mask.clone()
        mask[::7] = 1.0
        rows = lv.bound.rows[: lv.bound.nrows].long()
        mask[rows[rows < lv.n_pad]] = 0.0
        vals = torch.randn(lv.n_pad, generator=gen, dtype=torch.float64).to(dev, mask.dtype)
        return mask, vals

    def storage_order(sw, role):
        nb = sw.A.nrows_pad // gk.LANES
        return dataclasses.replace(
            sw, order=torch.arange(nb, dtype=torch.int32, device=dev),
            phase_ptr=(0, nb), serial=True, role=role)

    def bf16k(sw):
        return dataclasses.replace(sw, kT=sw.kT.to(torch.bfloat16))

    print("kernel vs plain (same inputs, on the card):", flush=True)
    fine32, coarse32 = g32.levels[-1], g32.levels[0]
    check_spmv(fine32.A.role, "fine matvec", fine32.A)
    check_spmv(fine64.A.role, "fine matvec", fine64.A)
    check_spmv(coarse32.A.role, "coarsest matvec", coarse32.A)
    check_spmv(coarse64.A.role, "coarsest matvec", coarse64.A)
    nl = len(g32.levels)
    for i, R in enumerate(g32.restrict):  # the solve's transfer tables
        check_spmv(R.role, f"restriction L{i + 1}->L{i}", R)
    for i, P in enumerate(g32.prolong):
        check_spmv(P.role, f"prolongation L{i}->L{i + 1}", P)
    for name, ell in ((f"restriction L{nl - 1}->L{nl - 2}", hier.restrict[-1]),
                      (f"prolongation L{nl - 2}->L{nl - 1}", hier.prolong[-1])):
        check_spmv("spmv6", name, gk.device_ell(ell, torch.float64, dev, "spmv6", u16=True))
    outer64 = gpu_level_from_operator(hier.levels[-1], dev, torch.float64, sweep=False)
    check_spmv(outer64.A.role, "Dirichlet outer f64 operator", outer64.A)
    check_sweep("fine, colored order", fine32.sweep)
    check_sweep("fine, colored order", fine64.sweep)
    check_sweep("fine, colored order", dataclasses.replace(fine32.sweep,
                                                           role="sweep8_percolor"))
    check_sweep("fine, colored order", dataclasses.replace(fine64.sweep,
                                                           role="sweep8_percolor"))
    for sw in (fine32.sweep, bf16k(fine32.sweep), fine64.sweep):  # the exact path's L3
        check_chain("Dirichlet fine (the exact path's L3)", storage_order(sw, "sweep6"))
        check_stale("Dirichlet fine (the exact path's L3)", storage_order(sw, "sweep6"))
    check_sweep("coarsest, storage order", coarse32.sweep)
    check_sweep("coarsest, storage order", coarse64.sweep)
    check_sweep("fine, colored order", bf16k(fine32.sweep))
    check_sweep("coarsest, storage order", bf16k(coarse32.sweep))
    for name, lv in (("Dirichlet fine", fine32), ("Dirichlet fine", fine64),
                     ("Dirichlet coarsest", coarse32), ("Dirichlet coarsest", coarse64)):
        check_level_smooth(name, lv)
        if lv.sweep.A.vals.dtype == torch.float32:
            check_level_smooth(name, dataclasses.replace(lv, sweep=bf16k(lv.sweep)))
    for dt in (torch.float32, torch.float64):  # the v2-fallback levels
        for i, op in enumerate(hier.levels):
            v2 = gpu_level_from_operator(op, dev, dt, use_v6=False)
            if dt == torch.float32 and i == nl - 1:
                check_spmv(v2.A.role, "fine matvec (v2 level)", v2.A)
            check_class_sweep(f"Dirichlet L{i}", v2.sweep, 0.0)

    # the V-cycle breakdown on the slice's own hierarchy (probes.vcycle_breakdown)
    print("main path (vcycle_breakdown): python -m meshlessmultigridpoisson_torch.probes."
          "vcycle_breakdown " + " ".join(map(str, ["--geom", geom["geomtype"], "--sizes",
                                                   *args.sizes, "--deg", 6, "--ordering",
                                                   "kdtile", "--block-rows", 512])),
          flush=True)
    t0 = time.perf_counter()
    b_fine = fine_rhs(outer64, prob.source, prob.neumann)
    gk.reset_counts()
    vb = vcycle_breakdown.breakdown(g32, outer64, b_fine, prob.state0.b_lag[-1].to(dev))
    torch.cuda.synchronize()
    launches["vcycle_breakdown"] = dict(gk.COUNTS)
    vb.update(pf.card(), sizes=[c.n for c in prob.clouds])
    print(vcycle_breakdown.report(vb), flush=True)
    print(f"vcycle_breakdown: {json.dumps(vb)}", flush=True)
    print(f"launches during the vcycle_breakdown probe: {launches['vcycle_breakdown']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    idle = [r for r in DIRICHLET_ROLES if launches["vcycle_breakdown"][r] == 0]
    if idle or not vb["vcycle_chain_ms"] > 0:
        return fail(f"vcycle_breakdown: kernel roles never launched: {idle}")
    del g32, coarse64, fine64, hier, v2, outer64, b_fine
    host_probs = {"dirichlet": prob}  # phase 3's paths repack these, not rebuild them
    torch.cuda.empty_cache()

    # the bench's stream probe at its own shape: sums of small integers
    sv = torch.randint(0, 4, (bench.STREAM_ROWS, gk.STREAM_COLS), generator=gen).to(
        dev, torch.float32)
    sc = torch.randint(0, 4, (bench.STREAM_ROWS, gk.STREAM_COLS), generator=gen,
                       dtype=torch.int32).to(dev)
    out = gk.stream_ceiling(sv, sc, bench.STREAM_TILE)
    torch.cuda.synchronize()
    ref = gk.stream_ceiling_plain(sv, sc, bench.STREAM_TILE)
    ms = ms_of(lambda v: gk.stream_ceiling(v, sc, bench.STREAM_TILE), sv, 20)
    pms = ms_of(lambda v: gk.stream_ceiling_plain(v, sc, bench.STREAM_TILE), sv, 20)
    record("stream14", "stream_ceiling f32+i32 2 x [262144, 128] (1 pass)",
           ("stream", "f32"), float((out - ref).abs().max()), float(ref.abs().max()),
           ms, pms, sv.nbytes + sc.nbytes + out.nbytes, 2 * sv.numel(), torch.float32)
    del sv, sc, out, ref

    @contextlib.contextmanager
    def unfused():
        """The parent flow of the ``compact_rows`` fold inside: the V-cycle's
        fine re-solves and Dirichlet pin as launches of their own around the
        smoother call (``bound2``, ``torch.where``), and the compatible
        matvec's tail as the parent's launches (``ppe_tail_loop``: the
        ``ppe2_scatter`` scatter, then elementwise ops)."""
        smooth, tail = gpu_backend.smooth, fracstep_gpu.ppe_tail

        def parent_smooth(op, x_, x_lag, b_, b_lag, iters=None, resolve_first=False,
                          resolve_last=False):
            if resolve_first:
                x_ = gpu_backend.bound_eval_neumann(op, x_, b_)
                x_ = torch.where(op.dirichlet_mask > 0, op.dirichlet_values, x_)
            x_, x_lag = smooth(op, x_, x_lag, b_, b_lag, iters)
            if resolve_last:
                x_ = gpu_backend.bound_eval_neumann(op, x_, b_)
            return x_, x_lag

        gpu_backend.smooth, fracstep_gpu.ppe_tail = parent_smooth, gk.ppe_tail_loop
        try:
            yield
        finally:
            gpu_backend.smooth, fracstep_gpu.ppe_tail = smooth, tail

    def check_compact(label, C):
        """Kernel vs plain on one table: "bound2" re-solves x in place,
        "push2" gathers b, "ppe2_scatter" scatters into a copy of b (never
        x); each row read to its lens (the table's fill printed)."""
        n = C.n_pad
        x0 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, C.vals.dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, C.vals.dtype)
        xin = b if C.role == "push2" else x0
        base = x0 if C.role == "bound2" else b  # what the output starts from
        before = gk.COUNTS[C.role]
        out = gk.compact_rows(C, xin.clone(), b.clone())
        torch.cuda.synchronize()
        if gk.COUNTS[C.role] != before + 1:
            raise AssertionError(f"compact_rows {label}: no launch counted")
        ref = gk.compact_rows_plain(C, xin.clone(), b.clone())
        err = float((out - ref).abs().max())
        untouched = torch.ones(n, dtype=torch.bool, device=dev)
        untouched[C.rows[: C.nrows].long()] = False
        if not torch.equal(out[untouched], base[untouched]):
            raise AssertionError(f"compact_rows {label}: wrote outside its rows")
        xs, bs = xin.clone(), b.clone()
        ms = ms_of(lambda v: gk.compact_rows(C, v, bs), xs, 200)
        pms = ms_of(lambda v: gk.compact_rows_plain(C, v, bs), xs, 50)
        csr = pf.library_csr(C.vals, C.cols, C.n_pad)
        lms = ms_of(lambda v: csr @ v, xs, 200)
        dev_ms = device_times(ms, lambda v: gk.compact_rows(C, v, bs), lambda v: csr @ v,
                              xs, 200)
        dt = dname(C.vals.dtype)
        fill = pf.compact_fill(C)
        print(f"  compact_rows {C.role} {dt} {label}: fill (mean lens / width) "
              f"{fill:.4f} of width {C.width}", flush=True)
        record(C.role, f"compact_rows {dt} {label} ({C.nrows} of {C.m_pad} rows, "
               f"width {C.width}, fill {fill:.3f})", ("compact", dt), err,
               float(ref.abs().max()), ms, pms, pf.compact_bytes(C), pf.compact_flops(C),
               C.vals.dtype, lms, dev_ms, extra=dict(fill=fill))

    def check_tail(label, T):
        """``ppe_tail`` (role ppe2, one launch) against its plain version and
        the parent design's launches (``ppe_tail_loop``: the ``ppe2_scatter``
        scatter and the elementwise ops) on the same inputs; then device
        times in turns parent, kernel, kernel, parent, twice over (each
        call runs a few us: the chain time is the host's)."""
        C = T.C
        dt_, n = C.vals.dtype, C.n_pad
        p, q, x = (torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dt_)
                   for _ in range(3))
        xl = torch.tensor(0.3, dtype=dt_, device=dev)
        before = dict(gk.COUNTS)
        y = gk.ppe_tail(T, p, q, x, xl)
        torch.cuda.synchronize()
        made = {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]}
        if made != {"ppe2": 1}:
            raise AssertionError(f"ppe_tail {label}: launches {made}, not one ppe2")
        ref = gk.ppe_tail_loop(T, p, q, x, xl, plain=True)
        par = gk.ppe_tail_loop(T, p, q, x, xl)
        scale = float(ref.abs().max())
        dt = dname(dt_)
        if not float((par - ref).abs().max()) <= TOL[("compact", dt)] * scale:
            raise AssertionError(f"ppe_tail {label}: the parent design disagrees")

        def kernel(v):
            return gk.ppe_tail(T, p, q, v, xl)

        def parent(v):
            return gk.ppe_tail_loop(T, p, q, v, xl)

        ms, par_ms = ms_of(kernel, x, 200), ms_of(parent, x, 200)
        pms = ms_of(lambda v: gk.ppe_tail_loop(T, p, q, v, xl, plain=True), x, 50)
        turns = ("parent", "kernel", "kernel", "parent") * 2
        d = [pf.device_ms(kernel if side == "kernel" else parent, x, 50) for side in turns]
        dk, dp = (statistics.median(v for k, v in zip(turns, d) if k == side)
                  for side in ("kernel", "parent"))
        nbytes, flops = pf.ppe_tail_bytes(T), pf.ppe_tail_flops(T)
        b_ms = pf.bound_ms(nbytes, flops, dt_, card_name)[0]
        print(f"  A/B ppe_tail {dt} {label} ({n} rows, {C.nrows} boundary rows of width "
              f"{C.width}, fill {pf.compact_fill(C):.3f}): device ms "
              + " / ".join(f"{k} {v:.4f}" for k, v in zip(turns, d))
              + f"; medians kernel {dk:.4f} (one launch) / parent {dp:.4f} (five); host "
              f"chain ms kernel {ms:.4f} / parent {par_ms:.4f}; bound {b_ms:.4f} ms "
              f"({card})", flush=True)
        record("ppe2", f"ppe_tail {dt} {label} ({n} rows, {C.nrows} boundary rows)",
               ("compact", dt), float((y - ref).abs().max()), scale, ms, pms, nbytes,
               flops, dt_, None, (dk, None),
               extra=dict(parent_ms=par_ms, parent_device_ms=dp, device_ab_ms=d,
                          pct_of_bound=100 * b_ms / dk))

    t0 = time.perf_counter()
    prob = make_poisson_problem(**geom, neumann=True, device=dev)
    host_probs["neumann"] = prob
    fine = prob.hierarchy.levels[-1]
    torch.cuda.synchronize()
    print(f"phase-2 Neumann setup {time.perf_counter() - t0:.1f} s, sizes "
          f"{[c.n for c in prob.clouds]}", flush=True)
    for i, op in enumerate(prob.hierarchy.levels):  # what each re-solve reads
        C = gk.device_compact(op.bound, torch.float32, dev, "bound2")
        print(f"  Neumann L{i} boundary table: {C.nrows} rows of width {C.width}, fill "
              f"(mean lens / width) {pf.compact_fill(C):.4f}", flush=True)
    for dt in (torch.float32, torch.float64):
        check_compact("fine boundary re-solve",
                      gk.device_compact(fine.bound, dt, dev, "bound2"))
        check_compact("fine condensation pushdown",
                      gk.device_compact(fine.cond, dt, dev, "push2"))
        check_class_sweep("Neumann fine", gpu_level_from_operator(
            fine, dev, dt, use_v6=False).sweep, 0.3)
        for name, op in (("Neumann fine", fine), ("Neumann coarsest", prob.hierarchy.levels[0])):
            lv = gpu_level_from_operator(op, dev, dt)
            if name == "Neumann fine":  # the matvec of the f32 inner and f64 outer solves
                check_spmv(lv.A.role, "Neumann fine matvec", lv.A)
                if dt == torch.float64:
                    outer = gpu_level_from_operator(op, dev, dt, sweep=False)
                    check_spmv(outer.A.role, "Neumann outer f64 operator", outer.A)
                    del outer
                # rows of mixed lengths in storage order
                for sw in ((lv.sweep, bf16k(lv.sweep)) if dt == torch.float32
                           else (lv.sweep,)):
                    check_chain("Neumann fine, storage order", storage_order(sw, "sweep6"))
                    check_stale("Neumann fine, storage order", storage_order(sw, "sweep6"))
            pin = random_pin(lv)
            for sw in (lv.sweep, bf16k(lv.sweep)) if dt == torch.float32 else (lv.sweep,):
                check_level_smooth(name, dataclasses.replace(lv, sweep=sw))
                check_level_smooth(name, dataclasses.replace(lv, sweep=sw), start=pin)
            del lv
    del prob, fine
    torch.cuda.empty_cache()

    # ---- 2b. the smoother-rate probe's stale row (probes.rho) ------------------
    print(f"phase-2b starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("main path (rho): python -m meshlessmultigridpoisson_torch.probes.rho --kinds "
          f"stale, its configuration {RHO_STALE_CFG} (geom, n, deg, neumann)", flush=True)
    row = rho.measure("stale", RHO_STALE_CFG, "cuda")
    launches["rho_stale"] = {r: row["launches"].get(r, 0) for r in gk.COUNTS}
    print(f"{rho.summary(row)} ({card})", flush=True)
    print(f"rho: {json.dumps(row)}", flush=True)
    idle = [r for r in RHO_STALE_ROLES if launches["rho_stale"][r] == 0]
    off = {k: v for k, v in row["card_minus_host"].items()
           if not (math.isfinite(v) and abs(v) <= rho.CARD_TOL)}
    if idle or off:
        return fail(f"rho stale row: roles never launched {idle}; card minus host over "
                    f"{rho.CARD_TOL}: {off}")
    del row

    # ---- 3. the main paths through the CLI entry point -----------------------
    print(f"phase-3 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    argv_solve = ["solve", "--device", "cuda", "--geom", "square_with_circle",
                  "--sizes", *map(str, args.sizes), "--deg", "6",
                  "--ordering", "kdtile", "--block-rows", "512", "--tol", "1e-8"]
    full = args.sizes == SLICE_SIZES
    # (path, extra flags, roles that must launch, roles that must not,
    #  expected level kinds, reuse the previous path's host problem, use_v6)
    paths = (("dirichlet", [], DIRICHLET_ROLES, (), EXPECT_KERNELS, False, None),
             ("exact", ["--sweep-order", "exact"], EXACT_ROLES,
              ("spmv8", "sweep8"), EXACT_KERNELS, True, None),
             ("fast-k", ["--fast-k"], DIRICHLET_ROLES, (), EXPECT_KERNELS, True, None),
             ("v2", [], V2_ROLES, ("sweep6", "sweep7", "sweep8", "spmv8"), V2_KERNELS,
              True, False),
             ("neumann", ["--neumann"], NEUMANN_ROLES, (), EXPECT_KERNELS, False, None))
    prob = None
    kept = {}  # the sharded phase's host problems and serial device solves
    for path, extra, roles, idle_roles, expect, reuse, use_v6 in paths:
        argv = argv_solve + extra
        print(f"main path ({path}): python -m meshlessmultigridpoisson_torch.apps.cli "
              + " ".join(argv) + (" (host problem reused)" if reuse else "")
              + ("" if use_v6 is None else f", run_solve(use_v6={use_v6})"), flush=True)
        if not reuse:  # phase 2's host problem of the path
            prob = host_probs.pop(path)
            torch.cuda.empty_cache()
        gk.reset_counts()
        rec, prob, x, xl = cli.run_solve(argv, problem=prob, use_v6=use_v6)
        torch.cuda.synchronize()
        launches[path] = dict(gk.COUNTS)
        # the timed solve's own counts (the run above also holds the
        # untimed warm-up pass): the V-cycle and re-solve checks read these
        timed = rec.extra["launches"]
        print(rec.to_json(), flush=True)
        print(f"launches during the {path} main path (warm-up + timed): {launches[path]}",
              flush=True)
        print(f"launches of the {path} timed solve: {timed}", flush=True)

        kinds = rec.extra["level_kernels"]
        if full and kinds != expect:
            return fail(f"{path}: level kernels {kinds} != {expect}")
        # a cut ladder may have no level past the union bound (no sweep6)
        idle = [r for r in roles if launches[path][r] == 0 and (full or r != "sweep6")]
        if idle:
            return fail(f"{path}: kernel roles never launched on the main path: {idle}")
        busy = [r for r in idle_roles + ("sweep8_percolor",) if launches[path][r] != 0]
        if busy:
            return fail(f"{path}: roles off this path launched: {busy}")
        if path != "v2":
            v = vcycles(kinds, timed)
            print(f"{path}: {v} V-cycles in the timed solve; launches a V-cycle: "
                  + ", ".join(f"{r} {timed[r] / v:g}" for r in
                              ("sweep8", "sweep7", "sweep6", "bound2", "spmv8", "spmv6")),
                  flush=True)
        # standalone re-solves: one a Krylov solve and one at the end (none
        # in a V-cycle: the fine level's ride in its fused smoother launch)
        want_b2 = rec.cycles + 1 if path == "neumann" else 0
        print(f"{path}: bound2 launches in the timed solve {timed['bound2']} (want "
              f"{want_b2}: {rec.cycles} passes + 1)", flush=True)
        if timed["bound2"] != want_b2:
            return fail(f"{path}: {timed['bound2']} bound2 launches, not {want_b2}: a "
                        "V-cycle's re-solve ran outside the fine smoother's launch")
        want_k = {"fast-k": "torch.bfloat16", "v2": None}.get(path, "torch.float32")
        if any(d != want_k for d in rec.extra["level_k_dtypes"]):
            return fail(f"{path}: K dtypes {rec.extra['level_k_dtypes']}, want {want_k}")
        if not rec.final_residual < 1e-8:
            return fail(f"{path}: final residual {rec.final_residual:.3e} >= 1e-8")
        # independent re-check: plain f64 gather-sum SpMV on the returned
        # (x, x_lag), against the host-built right-hand side
        recheck = bordered_residual(prob.hierarchy.levels[-1], prob.state0.b[-1],
                                    prob.state0.b_lag[-1], x, xl)
        print(f"{path}: re-checked relative L1 residual (plain f64 SpMV, border "
              f"row included): {recheck:.3e}", flush=True)
        if not recheck < 1e-8:
            return fail(f"{path}: re-checked residual {recheck:.3e} >= 1e-8")
        if not rec.l1_error < 1e-6:
            return fail(f"{path}: l1_error {rec.l1_error:.3e} >= 1e-6")
        if path in ("dirichlet", "neumann"):
            kept[path] = dict(prob=prob, x=x.double().cpu(), l1=rec.l1_error, argv=argv)
        if path == "neumann":
            # the compact_rows fold: the timed solve with the V-cycle's
            # re-solves as launches of their own, then fused (one run each,
            # cut for time); each run's counts show which flow ran
            walls, cycles, b2 = [], [], []
            for side in ("parent", "change"):
                with unfused() if side == "parent" else contextlib.nullcontext():
                    r_ab, *_ = cli.run_solve(argv, problem=prob)
                    torch.cuda.synchronize()
                n_ab = r_ab.extra["launches"]
                want = r_ab.cycles + 1 + (2 * vcycles(kinds, n_ab) if side == "parent" else 0)
                if n_ab["bound2"] != want:
                    return fail(f"{path} fold A/B ({side}): {n_ab['bound2']} bound2 "
                                f"launches, not {want}: not the {side}'s flow")
                if not r_ab.final_residual < 1e-8:
                    return fail(f"{path} fold A/B ({side}): residual "
                                f"{r_ab.final_residual:.3e} >= 1e-8")
                walls.append(r_ab.wall_time_s)
                cycles.append(r_ab.cycles)
                b2.append(n_ab["bound2"])
            print(f"{path}: timed solve, V-cycle re-solves separate / fused "
                  + " / ".join(f"{w:.4f}" for w in walls) + f" s (passes "
                  f"{cycles}, bound2 launches {b2}) ({card})", flush=True)
            del r_ab
        if path == "exact":  # the timed solve on the parent chain, in turns
            walls = [rec.wall_time_s]
            orig = gk.storage_chain

            def parent_chain(sw, x_, x_lag, b_):
                return gk.block_oneshot_sweep(
                    dataclasses.replace(sw, role="sweep6_chain"), x_, x_lag, b_)

            before = dict(gk.COUNTS)
            try:
                gk.storage_chain = parent_chain
                rp, *_ = cli.run_solve(argv, problem=prob)
                torch.cuda.synchronize()
            finally:
                gk.storage_chain = orig
            n_parent = gk.COUNTS["sweep6_chain"] - before["sweep6_chain"]
            n_new = gk.COUNTS["sweep6"] - before["sweep6"]
            if n_parent == 0 or n_new != 0:
                return fail(f"exact A/B: the parent run launched {n_parent} sweep6_chain "
                            f"and {n_new} sweep6: it did not run on the parent chain")
            rn, *_ = cli.run_solve(argv, problem=prob)
            torch.cuda.synchronize()
            walls += [rp.wall_time_s, rn.wall_time_s]
            print(f"exact: timed solve, storage_chain {walls[0]:.4f} s / sweep6_chain "
                  f"{walls[1]:.4f} s / storage_chain {walls[2]:.4f} s (passes {rec.cycles} / "
                  f"{rp.cycles} / {rn.cycles}; {n_parent} sweep6_chain launches and no "
                  f"sweep6 one in the parent's run) ({card})", flush=True)
            if not (rp.final_residual < 1e-8 and rn.final_residual < 1e-8):
                return fail(f"exact A/B: residuals {rp.final_residual:.3e}, "
                            f"{rn.final_residual:.3e} >= 1e-8")
            del rp, rn
        if path == "v2":  # the timed solve with every sweep2 on the parent design
            orig = gk.class_sor_sweep

            def parent_class(sw, x_, x_lag, b_):
                return orig(dataclasses.replace(sw, role=gk.CLASS_PARENT), x_, x_lag, b_)

            before = dict(gk.COUNTS)
            try:
                gk.class_sor_sweep = parent_class
                rp, *_ = cli.run_solve(argv, problem=prob, use_v6=False)
                torch.cuda.synchronize()
            finally:
                gk.class_sor_sweep = orig
            made = {k: gk.COUNTS[k] - before[k] for k in before}
            if made[gk.CLASS_PARENT] == 0 or made["sweep2"] != 0:
                return fail(f"v2 A/B: the parent run launched {made[gk.CLASS_PARENT]} "
                            f"{gk.CLASS_PARENT} and {made['sweep2']} sweep2: it did not run "
                            "on the parent design")
            rn, *_ = cli.run_solve(argv, problem=prob, use_v6=False)
            torch.cuda.synchronize()
            walls = [rec.wall_time_s, rp.wall_time_s, rn.wall_time_s]
            print(f"v2: timed solve, class_sor_sweep {walls[0]:.4f} s / {gk.CLASS_PARENT} "
                  f"{walls[1]:.4f} s / class_sor_sweep {walls[2]:.4f} s (passes {rec.cycles} / "
                  f"{rp.cycles} / {rn.cycles}; the parent run: {made[gk.CLASS_PARENT]} "
                  f"{gk.CLASS_PARENT} launches and no sweep2 one) ({card})", flush=True)
            if not (rp.final_residual < 1e-8 and rn.final_residual < 1e-8):
                return fail(f"v2 A/B: residuals {rp.final_residual:.3e}, "
                            f"{rn.final_residual:.3e} >= 1e-8")
            del rp, rn
        if path in ("exact", "v2"):  # the per-level profile, after the counts are read
            rec, *_ = cli.run_solve(argv + ["--profile"], problem=prob, use_v6=use_v6)
            print(f"{path}: per-level profile, cli solve {' '.join(extra)} "
                  f"--profile ({card}):", flush=True)
            for row in rec.extra["per_level"]:
                print("  " + json.dumps(row), flush=True)
            print(f"{path}: launches and device ms per launch by shape (--profile run):",
                  flush=True)
            for row in rec.extra["profile"]["launch_shapes"]:
                print("  " + json.dumps(row), flush=True)
            _, ranked = launchrank.rank(json.loads(rec.to_json()))
            print(f"{path}: excess by role, launchrank: "
                  + ", ".join(f"{role} {ms:.2f} ms" for role, ms in ranked), flush=True)
            slow = [r["level"] for r in rec.extra["per_level"]
                    if not 0 < r["sweep_bound_ms"] <= r["sweep_ms"]
                    or not 0 < r["matvec_bound_ms"] <= r["matvec_ms"]]
            if slow:
                return fail(f"{path}: per-level time below its bound at levels {slow}")
        del rec, x, xl
    del prob
    torch.cuda.empty_cache()

    # the 3D path (box3d, deg 3) at reduced depth
    argv3 = ["solve", "--device", "cuda", "--geom", "box3d",
             "--sizes", *map(str, THREED_SIZES), "--deg", "3", "--ordering", "kdtile",
             "--block-rows", "512", "--tol", "1e-8"]
    print("main path (3d): python -m meshlessmultigridpoisson_torch.apps.cli "
          + " ".join(argv3), flush=True)
    gk.reset_counts()
    rec, prob, x, xl = cli.run_solve(argv3)
    torch.cuda.synchronize()
    launches["3d"] = dict(gk.COUNTS)
    timed = rec.extra["launches"]
    print(rec.to_json(), flush=True)
    print(f"launches during the 3d main path (warm-up + timed): {launches['3d']}",
          flush=True)
    kinds = rec.extra["level_kernels"]
    if kinds != THREED_KERNELS:
        return fail(f"3d: level kernels {kinds} != {THREED_KERNELS}")
    idle = [r for r in DIRICHLET_ROLES if launches["3d"][r] == 0]
    busy = [r for r in ("bound2", "sweep6", "sweep8_percolor") if launches["3d"][r] != 0]
    if idle or busy:
        return fail(f"3d: roles never launched {idle}, roles off this path launched {busy}")
    v = vcycles(kinds, timed)
    print(f"3d: {rec.cycles} passes, {v} V-cycles in the timed solve "
          f"{rec.wall_time_s:.4f} s, setup {rec.extra['setup_time_s']:.1f} s "
          f"({rec.extra['setup_stages_s']}), device memory "
          f"{rec.extra['max_memory_allocated_gb']:.3f} GB ({card})", flush=True)
    recheck = bordered_residual(prob.hierarchy.levels[-1], prob.state0.b[-1],
                                prob.state0.b_lag[-1], x, xl)
    print(f"3d: residual {rec.final_residual:.3e}, re-checked (plain f64 SpMV) "
          f"{recheck:.3e}; L1 error {rec.l1_error:.6e} against the reference's "
          f"{THREED_REF_L1:.6e}", flush=True)
    if not (rec.final_residual < 1e-8 and recheck < 1e-8):
        return fail(f"3d: residual {rec.final_residual:.3e}, re-checked {recheck:.3e}")
    if not abs(rec.l1_error - THREED_REF_L1) <= THREED_L1_RTOL * THREED_REF_L1:
        return fail(f"3d: l1_error {rec.l1_error:.6e} not within {THREED_L1_RTOL:.0%} "
                    f"of the reference's {THREED_REF_L1:.6e}")
    # the kernels at the 3D shapes: stencils of 25 and 50, the x values the
    # colored level's blocks stage
    g3 = gpu_hierarchy(prob.hierarchy, dev, torch.float32)
    outer3 = gpu_level_from_operator(prob.hierarchy.levels[-1], dev, torch.float64,
                                     sweep=False)
    fine3, nl3 = g3.levels[-1], len(g3.levels)
    print(f"3d kernel vs plain: x values staged a block on L3 {fine3.sweep.reads.counts}",
          flush=True)
    check_spmv(fine3.A.role, "3D fine matvec", fine3.A)
    check_spmv(outer3.A.role, "3D outer f64 operator", outer3.A)
    check_spmv(g3.levels[0].A.role, "3D coarsest matvec", g3.levels[0].A)
    check_spmv(g3.restrict[-1].role, f"3D restriction L{nl3 - 1}->L{nl3 - 2}",
               g3.restrict[-1])
    check_spmv(g3.prolong[-1].role, f"3D prolongation L{nl3 - 2}->L{nl3 - 1}",
               g3.prolong[-1])
    for i in (nl3 - 1, 1, 0):
        check_level_smooth(f"3D L{i}", g3.levels[i])
    del rec, prob, x, xl, g3, outer3, fine3
    torch.cuda.empty_cache()

    # ---- 4. the fractional-step Navier-Stokes path ---------------------------
    print(f"phase-4 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    from meshlessmultigridpoisson_torch.models.fracstep import build_fracstep_problem
    from meshlessmultigridpoisson_torch.models.fracstep_gpu import build_gpu_fracstep, run_gpu

    t0 = time.perf_counter()
    nsp = build_fracstep_problem(sizes=NS_SIZES, poly_deg=6, device=dev)
    gfs = build_gpu_fracstep(nsp, dev)
    torch.cuda.synchronize()
    print(f"phase-4 NS setup {time.perf_counter() - t0:.1f} s, sizes "
          f"{[c.n for c in nsp.clouds]}, level kinds "
          f"{[lv.kernel_kind for lv in gfs.hd.levels]}", flush=True)
    for T in (gfs.ppe32, gfs.ppe64):
        check_tail("NS compatible-PPE matvec tail", T)
        check_compact("NS compatible-PPE scatter", T.scatter)
    check_spmv("spmv6", "NS d/dx", gfs.dx32)
    check_spmv("spmv6", "NS velocity Laplacian", gfs.lap32)
    check_spmv("spmv6", "NS d/dx", gfs.dx64)
    del nsp, gfs
    torch.cuda.empty_cache()

    argv = ["ns", "--device", "cuda", "--sizes", *map(str, NS_SIZES), "--deg", "6",
            "--steps", str(NS_STEPS)]
    print("main path (ns): python -m meshlessmultigridpoisson_torch.apps.cli "
          + " ".join(argv), flush=True)
    gk.reset_counts()
    rec, prob, last = cli.run_ns(argv)
    torch.cuda.synchronize()
    launches["ns"] = dict(gk.COUNTS)
    print(rec.to_json(), flush=True)
    print(f"launches during the ns main path: {launches['ns']}", flush=True)
    ex = rec.extra
    print(f"ns: setup {ex['setup_time_s']:.2f} s, {NS_STEPS} steps in "
          f"{rec.wall_time_s:.2f} s (first {ex['step_time_s'][0]:.2f} s, then "
          f"{sum(ex['step_time_s'][1:]) / max(len(ex['step_time_s']) - 1, 1):.3f} "
          f"s/step); PPE outer passes {ex['ppe_outer']}, inner iterations "
          f"{ex['ppe_inner_iters']}, final PPE residuals {ex['ppe_residual']}",
          flush=True)
    if rec.extra["level_kernels"] != NS_EXPECT_KERNELS:
        return fail(f"ns: level kernels {rec.extra['level_kernels']} != "
                    f"{NS_EXPECT_KERNELS}")
    idle = [r for r in NS_ROLES if launches["ns"][r] == 0]
    if idle:
        return fail(f"ns: kernel roles never launched on the main path: {idle}")
    v = vcycles(rec.extra["level_kernels"], launches["ns"])
    print(f"ns: {v} V-cycles; launches a V-cycle: "
          + ", ".join(f"{r} {launches['ns'][r] / v:g}" for r in
                      ("sweep8", "sweep7", "bound2", "ppe2", "spmv8", "spmv6")), flush=True)
    # no re-solve in a V-cycle (the fine level's ride in its fused smoother
    # launch), and one ppe2 launch a compatible matvec
    inner = rec.extra["ppe_inner_iters"]
    want = {"bound2": ns_bound2(inner), "ppe2": ns_matvecs(inner), "ppe2_scatter": 0}
    got = {k: rec.extra["launches"][k] for k in want}
    print(f"ns: launches {got}, want {want} (from the passes' inner iterations)",
          flush=True)
    if got != want:
        return fail(f"ns: launches {got}, not {want}")
    over = ex["ppe_over_tol"]
    print(f"ns: PPE solves that stopped above the tolerance: {len(over)} of "
          f"{NS_STEPS} (steps {over})", flush=True)
    if over:
        return fail(f"ns: the PPE solves of steps {over} stopped above the tolerance")
    hist = rec.residual_history  # every step while steps < 1000
    if len(hist) != NS_STEPS or not all(math.isfinite(h) for h in hist):
        return fail(f"ns: fs_residual history not finite or short: {hist}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           NS_RECORD)) as fh:
        ref = json.load(fh)
    if rec.config["sizes"] != ref["config"]["sizes"]:
        return fail(f"ns: cloud sizes {rec.config['sizes']} != the record's "
                    f"{ref['config']['sizes']}")
    dev_max = 0.0
    for step in range(0, NS_STEPS, 4):
        r = ref["residual_history"][step // 4]
        d = abs(hist[step] - r) / r
        dev_max = max(dev_max, d)
        print(f"  ns step {step}: fs_residual {hist[step]:.10e} record "
              f"{r:.10e} rel dev {d:.3e} (tol {NS_HIST_RTOL:.0e})", flush=True)
    print(f"ns: largest deviation from {NS_RECORD}: {dev_max:.3e}", flush=True)
    if not dev_max <= NS_HIST_RTOL:
        return fail(f"ns: fs_residual deviates {dev_max:.3e} from the record")
    recheck = compatible_residual(prob, last["b"].to(dev), last["x"].to(dev),
                                  last["x_lag"].to(dev))
    print(f"ns: last PPE solve re-checked with the plain f64 compatible "
          f"operator: relative L1 residual {recheck:.3e} (solver reported "
          f"{ex['ppe_residual'][-1]:.3e})", flush=True)
    if not recheck < 1e-9:
        return fail(f"ns: re-checked PPE residual {recheck:.3e} >= 1e-9")
    gfs = build_gpu_fracstep(prob, dev)

    # the checkpoint: a state saved and loaded back steps as the state itself
    import shutil
    import tempfile

    from meshlessmultigridpoisson_torch.io import load_state, save_state

    state, _, _ = run_gpu(prob, dev, steps=NS_CKPT_STEPS, t=gfs)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ns_")
    try:
        ckpt = save_state(os.path.join(tmp, "state"), state)
        ckpt_mb = os.path.getsize(ckpt) / 1e6
        loaded = load_state(ckpt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    after = []
    for s in (state, loaded):
        s, res = fracstep_gpu.state_to(s, dev), []
        for _ in range(NS_CKPT_STEPS):
            s, r = fracstep_gpu.timestep_gpu(gfs, s)
            res.append(float(r))
        after.append((res, s.u.cpu(), s.v.cpu()))
    (ra, ua, va), (rb, ub, vb) = after
    same = ra == rb and torch.equal(ua, ub) and torch.equal(va, vb)
    print(f"ns: checkpoint after {NS_CKPT_STEPS} steps ({ckpt_mb:.3f} MB), "
          f"{NS_CKPT_STEPS} more steps from the state and from the loaded one: "
          f"fs_residual {ra} / {rb}, u and v bit-identical: {same}", flush=True)
    if not same:
        return fail("ns: the steps from the loaded checkpoint differ")
    del rec, prob, last, gfs, state, loaded, after
    torch.cuda.empty_cache()

    # ---- 5. the user surfaces --------------------------------------------------
    print(f"phase-5 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    user_surfaces(cli, gk, launches, card, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.empty_cache()

    # ---- 6. the row-sharded solve (parallel/) ----------------------------------
    t_phase = time.perf_counter()
    print(f"phase-6 starts at {t_phase - t_start:.1f} s", flush=True)
    from meshlessmultigridpoisson_torch.parallel import dryrun as shard_dryrun
    from meshlessmultigridpoisson_torch.parallel import sharded as psh
    from meshlessmultigridpoisson_torch.parallel.partition import partition_hierarchy
    from meshlessmultigridpoisson_torch.probes import shard_solve, shard_timing

    for name in ("dirichlet", "neumann"):
        hp = kept[name]["prob"]
        t0 = time.perf_counter()
        shier = partition_hierarchy(hp.hierarchy, SHARD_CHECK_P, shard_levels=2)
        part_s = time.perf_counter() - t0
        fine_sh = shier.fine
        layout = [(f.shard_rows, f.frontier_rows, f.phases) for f in shier.sharded]
        print(f"sharded {name}: partition into {SHARD_CHECK_P} shards, shard_levels 2, "
              f"{part_s:.2f} s host; fine level {fine_sh.n_pad2} rows, (ns, nf, phases) "
              f"per sharded level {layout}", flush=True)
        for (j, level), s_ in itertools.product(enumerate(shier.sharded),
                                                range(SHARD_CHECK_P)):
            f = level.shard(s_)
            colored = psh.interior_colored(f)
            for dt in (torch.float32, torch.float64):
                lv = psh.shard_level(f, dev, dt, colored)
                tag = f"{name} P={SHARD_CHECK_P} level {j} shard {s_}"
                errs = shard_dryrun.level_plain_errors(lv, seed=100 * j + s_)
                bad = {k: v for k, v in errs.items()
                       if not v <= shard_dryrun.plain_tol(dt, k)}
                print(f"  {tag} {dname(dt)}: ns {f.shard_rows}, nf {f.frontier_rows}, "
                      f"C {f.phases}, frontier share {f.frontier_rows / f.shard_rows:.4f}, "
                      f"interior {lv.kind} ({lv.sweep.role}), partition {part_s:.2f} s; "
                      "kernel vs plain " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()),
                      flush=True)
                if bad:
                    return fail(f"{tag} {dname(dt)}: kernel vs plain over its tolerance: "
                                f"{bad}")
                # one interior shard timed into the kernels line (f32)
                if j == 0 and s_ == SHARD_TIMED and dt == torch.float32:
                    shape = f"{tag} ({f.frontier_rows} x {f.ext_rows} frontier)"
                    check_class_sweep(f"shard_frontier_sweep2 {shape}", lv.front, 0.3)
                    if isinstance(lv.sweep, gk.ClassSweep):
                        check_class_sweep(f"shard_interior_sweep2 {tag}", lv.sweep, 0.3)
                    else:
                        check_sweep(f"shard_interior_{lv.sweep.role} {tag} ({f.shard_rows} "
                                    f"rows, {lv.sweep.phase_ptr[-1]} blocks swept)", lv.sweep)
                    check_spmv("spmv6", f"shard_spmv_ext {tag} ({f.shard_rows} x "
                               f"{f.ext_rows})", lv.A)
                    if lv.bound.nrows:
                        check_compact(f"shard_bound2_ext {tag} (over {f.ext_rows})", lv.bound)
                del lv
        del shier, fine_sh
        torch.cuda.empty_cache()

    # P = 1 in process (a world of one, NCCL) and P = 2 on the one card
    # (spawned ranks, gloo staged through host) on the Dirichlet slice; P = 2
    # on the reference test's Neumann problem
    dk = kept["dirichlet"]
    for path, shards, argv, prob_, serial in (
            ("sharded_p1", 1, dk["argv"], dk["prob"], (dk["x"], dk["l1"])),
            ("sharded_p2", 2, dk["argv"], dk["prob"], (dk["x"], dk["l1"])),
            ("sharded_p2_neumann", 2, SHARD_NEUMANN_ARGV, None, None)):
        print(f"main path ({path}): python -m meshlessmultigridpoisson_torch.probes."
              f"shard_solve --shards {shards} (" + " ".join(argv) + ")", flush=True)
        t0 = time.perf_counter()
        row = shard_solve.run(shards, argv, problem=prob_, serial=serial)
        launches[path] = {r: row["launches"].get(r, 0) for r in gk.COUNTS}
        print(f"{path}: {json.dumps(row)}", flush=True)
        print(f"{path}: {shards} rank(s), backend {row['backend']}"
              f"{' staged through host' if row['staged'] else ''}, f64 BiCGStab "
              f"{row['iters']} iterations to {row['resid']:.3e} (re-checked "
              f"{row['recheck']:.3e}), {row['solve_seconds']:.3f} s; solution "
              f"{row['parity']:.2e} from the serial device solve's, L1 {row['l1_error']:.4e} "
              f"(serial {row['l1_serial']:.4e}); per V-cycle on rank 0: "
              f"{row['comm_per_vcycle']} (counted from the partition: "
              f"{row['comm_model_per_vcycle']}); f32 V-cycle history {row['f32_history']}; "
              f"{time.perf_counter() - t0:.1f} s in all ({card})", flush=True)
        for dt_, checks in row["plain_checks"].items():  # every rank, every sharded level
            print(f"{path}: kernel vs plain on the solve's own shard levels ({dt_}; largest "
                  f"over ranks and levels): " + ", ".join(
                      f"{k} {c['max_rel_err']:.2e} (tol {c['tol']:.0e}, {c['shards']} shards)"
                      for k, c in checks.items()), flush=True)
        if path == "sharded_p1":  # one V-cycle against the serial one, f32
            trow = shard_timing.run(problem=dk["prob"], deg=6, cycles=20)
            print(f"shard_timing (P = 1 sharded vs unsharded V-cycle, f32): "
                  f"{json.dumps(trow)}", flush=True)
        torch.cuda.empty_cache()
    del kept, dk
    print(f"phase-6 the row-sharded solve: {time.perf_counter() - t_phase:.1f} s ({card})",
          flush=True)

    # ---- 7. the kernel bench -------------------------------------------------
    print(f"phase-7 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t0 = time.perf_counter()
    bench_op = bench.build_operator()
    print(f"bench operator (host, shared by the bench, kexp and ksweepprobe): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n1m = bench_op["ell"].nrows_pad
    reads = gk.block_read_tables(gk.global_cols(bench_op["ell"]).numpy(),
                                 n1m // gk.LANES, dev)
    for dt, kdt in ((torch.float32, torch.float32), (torch.float64, torch.float64),
                    (torch.float32, torch.bfloat16)):
        sw = gk.BlockSweep(
            A=gk.device_ell(bench_op["ell"], dt, dev, "spmv6"),
            kT=torch.from_numpy(bench_op["kT"]).to(dev, kdt),
            lagc=torch.zeros(n1m, dtype=dt, device=dev),
            order=torch.as_tensor(bench_op["order"], dtype=torch.int32).to(dev),
            phase_ptr=bench_op["phase_ptr"], serial=False, role="sweep8", reads=reads)
        check_smooth(f"bench {n1m} rows, {sw.nphases} colors", sw)
        del sw
        torch.cuda.empty_cache()
    nb1m = n1m // gk.LANES
    check_chain(f"bench {n1m} rows, storage order", gk.BlockSweep(
        A=gk.device_ell(bench_op["ell"], torch.float32, dev, "spmv6"),
        kT=torch.from_numpy(bench_op["kT"]).to(dev, torch.float32),
        lagc=torch.zeros(n1m, dtype=torch.float32, device=dev),
        order=torch.arange(nb1m, dtype=torch.int32, device=dev), phase_ptr=(0, nb1m),
        serial=True, role="sweep6"))
    torch.cuda.empty_cache()
    print("main path (bench): python -m meshlessmultigridpoisson_torch.bench", flush=True)
    gk.reset_counts()
    res = bench.run(op=bench_op)
    torch.cuda.synchronize()
    launches["bench"] = dict(gk.COUNTS)
    print(json.dumps(res), flush=True)
    print(f"launches during the bench: {launches['bench']}", flush=True)
    idle = [r for r in BENCH_ROLES if launches["bench"][r] == 0]
    if idle:
        return fail(f"bench: kernel roles never launched: {idle}")
    over = {k: r["pct_of_bound"] for k, r in res["extra"]["kernels_ms"].items()
            if not r["pct_of_bound"] <= PCT_OF_BOUND_MAX}
    if over:
        return fail(f"bench: time below the bound (pct_of_bound > {PCT_OF_BOUND_MAX}): "
                    f"{over}")
    del res
    torch.cuda.empty_cache()

    def probe_results(name, res, roles, shape, tol=None):
        """Counts read, every role launched, each time at or above its
        bound, each error within ``tol`` (role -> relative tolerance) where
        given; the probe's rows joined to the kernels line, labelled with
        ``shape``."""
        print(json.dumps(res), flush=True)
        print(f"launches during the {name} probe: {launches[name]}", flush=True)
        idle = [r for r in roles if launches[name][r] == 0]
        if idle:
            raise AssertionError(f"{name}: kernel roles never launched: {idle}")
        for label, r in res["kernels"].items():
            if not r["pct_of_bound"] <= PCT_OF_BOUND_MAX:
                raise AssertionError(f"{name} {label}: time below the bound "
                                     f"({r['pct_of_bound']:.1f}%)")
            if tol is not None and not r["rel_err"] <= tol[r["role"]]:
                raise AssertionError(f"{name} {label}: kernel vs plain {r['rel_err']:.3e}"
                                     f" > {tol[r['role']]:.0e}")
            results[r["role"]].append(dict(
                label=f"{name} {label}, {shape}",
                **{k: r[k] for k in ("max_abs_err", "rel_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}))

    # ---- 8. kexp and the sweep probe on the bench's operator ------------------
    print(f"phase-8 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("main path (kexp): python -m meshlessmultigridpoisson_torch.probes.kexp "
          f"{bench.N} {KEXP_ITERS}", flush=True)
    gk.reset_counts()
    res = kexp.run(bench.N, KEXP_ITERS, a=bench_op["a"])
    torch.cuda.synchronize()
    launches["kexp"] = dict(gk.COUNTS)
    probe_results("kexp", res, KEXP_ROLES, f"bench operator {res['n']} rows")
    del res
    torch.cuda.empty_cache()
    print("main path (ksweepprobe): python -m meshlessmultigridpoisson_torch.probes."
          f"ksweepprobe {SWEEPPROBE_ITERS}", flush=True)
    gk.reset_counts()
    res = ksweepprobe.run(SWEEPPROBE_ITERS, op=bench_op)
    torch.cuda.synchronize()
    launches["ksweepprobe"] = dict(gk.COUNTS)
    probe_results("ksweepprobe", res, SWEEPPROBE_ROLES, f"bench operator {res['n']} rows")
    print(f"ksweepprobe: storage-order chain per 128-row block ({card}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res["split_per_block"].items())
          + "; " + ", ".join(f"{k} is {v}" for k, v in res["instances"].items()),
          flush=True)
    del res, bench_op
    torch.cuda.empty_cache()

    # ---- 9. the kernel-generation probe --------------------------------------
    print(f"phase-9 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("main path (ktime): python -m meshlessmultigridpoisson_torch.probes.ktime "
          f"{KTIME_N} {KTIME_ITERS}", flush=True)
    gk.reset_counts()
    res = ktime.run(KTIME_N, KTIME_ITERS)
    torch.cuda.synchronize()
    launches["ktime"] = dict(gk.COUNTS)
    print(json.dumps(res), flush=True)
    print(f"launches during the ktime probe: {launches['ktime']}", flush=True)
    idle = [r for r in KTIME_ROLES if launches["ktime"][r] == 0]
    if idle:
        return fail(f"ktime: kernel roles never launched: {idle}")
    for label, r in res["kernels"].items():
        if not r["pct_of_bound"] <= PCT_OF_BOUND_MAX:
            return fail(f"ktime {label}: time below the bound ({r['pct_of_bound']:.1f}%)")
        results[r["role"]].append(dict(
            label=f"ktime {label}, real pattern {res['n']} rows x {res['k']}",
            **{k: r[k] for k in ("max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}))
    del res
    torch.cuda.empty_cache()

    # ---- 10. the stream probes and the SpMV's gather/reduction split ------------
    print(f"phase-10 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    stream_tol = dict.fromkeys(KSTREAM_ROLES + CHAIN_ROLES + ("kprobe_stream",),
                               TOL[("stream", "f32")])
    spmv_tol = dict.fromkeys(KPROBE_ROLES[1:] + KISO6_ROLES + KISO7_ROLES + KISO8_ROLES,
                             TOL[("spmv", "f32")])
    t0 = time.perf_counter()
    kiso_ell = kprobe.build_operator(kprobe.N)
    print(f"kprobe operator (host, shared by kprobe and the kiso probes): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    banded = f"banded {kprobe.N} x {kprobe.K}"
    for name, run_probe, roles, shape in (
            ("kstream", kstream.run, KSTREAM_ROLES,
             f"[{kstream.ROWS}, 128] tables"),
            ("kprobe", lambda: kprobe.run(kprobe.N, KPROBE_ITERS, ell=kiso_ell),
             KPROBE_ROLES, f"stream [{kprobe.STREAM_ROWS}, 128] f32 + i32, SpMV {banded}"),
            ("kiso6", lambda: kiso6.run(kiso6.N, KISO_ITERS, ell=kiso_ell), KISO6_ROLES,
             banded),
            ("kiso7", lambda: kiso7.run(kiso7.N, KISO_ITERS, ell=kiso_ell), KISO7_ROLES,
             banded),
            ("kiso8", lambda: kiso8.run(kiso8.N, KISO_ITERS, ell=kiso_ell), KISO8_ROLES,
             banded),
            ("chaintime", chaintime.run, CHAIN_ROLES,
             f"[{chaintime.ROWS}, 128] f32 + i32, delta of 9 and 1 passes")):
        print(f"main path ({name}): python -m meshlessmultigridpoisson_torch.probes."
              f"{name}", flush=True)
        gk.reset_counts()
        res = run_probe()
        torch.cuda.synchronize()
        launches[name] = dict(gk.COUNTS)
        probe_results(name, res, roles, shape, {**stream_tol, **spmv_tol})
        if name == "kprobe":
            print(f"kprobe: ell_spmv split at {res['n']} x {res['k']} ({card}): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in res["spmv_split"].items()),
                  flush=True)
        if name == "kiso6":
            print(f"kiso6 ({card}): {res['padding']}; largest block column span "
                  f"{res['max_block_span']}", flush=True)
        if name == "kiso8":  # each mma role against its parent design, in turns
            for role, t in res["ab"].items():
                turns = [t["parent"][0], t["change"][0], t["change"][1], t["parent"][1]]
                print(f"kiso8 A/B {role}: {kiso8.PARENT[role]} {turns[0]:.4f} / {role} "
                      f"{turns[1]:.4f} / {role} {turns[2]:.4f} / {kiso8.PARENT[role]} "
                      f"{turns[3]:.4f} ms ({card})", flush=True)
                for r in (role, kiso8.PARENT[role]):
                    results[r][-1]["ab_ms"] = turns
        if name == "chaintime":
            for label, r in res["calibrations"].items():
                print(f"chaintime calibration {label} ({card}): {json.dumps(r)}",
                      flush=True)
        del res
        torch.cuda.empty_cache()

    # ---- 11. results ----------------------------------------------------------
    print(f"phase-11 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = []
    for role, (name, source, replaces) in ROLES.items():
        by_path = {p: n[role] for p, n in launches.items()}
        for c in results[role]:
            kernels.append(dict(name=f"{name} [{role}] {c['label']}", route="cuda",
                                source=source, replaces=replaces,
                                launches=sum(by_path.values()),
                                launches_by_path=by_path,
                                max_abs_err=c["max_abs_err"],
                                ms=c["ms"], plain_ms=c["plain_ms"],
                                bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                                library_ms=c["library_ms"],
                                **{k: c[k] for k in ("device_ms", "library_device_ms",
                                                     "loop_ms", "ab_ms", "staging",
                                                     "x_lag_err", "col_format",
                                                     "parent_device_ms", "pct_of_bound",
                                                     "device_ab_ms", "parent_ms",
                                                     "chain_ab_ms", "link_us", "fill",
                                                     "sweep6_ms", "stale_ab_ms",
                                                     "group_us", "other_design_ms")
                                   if c.get(k) is not None}))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s "
          f"({card})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
