"""Row sums by the tensor cores against the warp shuffle (card only).

    python -m meshlessmultigridpoisson_torch.probes.kiso8 [n] [iters]

Port of the reference package's ``scripts/kiso8.py`` (default n 262,144):
the v4 SpMV with its row sums taken by two selector matmuls on the MXU at
``Precision.HIGHEST`` ("mxu"), the same at ``DEFAULT`` ("mxu-def", one bf16
pass on the TPU: numerics off, a bound), or by a reshape-sum and three
cyclic rolls on the VPU ("vpu").  Here the card's counterparts:

* ``kiso8_mxu``: ``ell_rowsum_mma<2>``, the products as TF32 hi and lo
  parts through ``mma.sync`` m16n8k8 against an all-ones B (products kept
  to ~2^-22 relative);
* ``kiso8_mxudef``: ``ell_rowsum_mma<1>``, one TF32 pass (~3 decimal
  digits; held against its TF32 plain version, timing only);
* ``kiso8_vpu``: ``ell_spmv``'s warp-shuffle reduction (the production
  instance under its own role);
* ``kiso8_mxu_v1``, ``kiso8_mxudef_v1``: the same two and one passes on the
  parent design of ``ell_rowsum_mma`` (timing only), run in turns with the
  production roles.

The mma roles pad the ELL's width to a multiple of 8 (70 -> 72 at the
reference's width) with zero values.  Each row's ``f64_rel_err`` is the
reference's ``err``: the distance from an f64 SpMV over max |y|.  Check,
timing and row fields: ``probes.kiso``; ``ab`` times each mma role against
its parent design in turns.  Without a card it exits non-zero.
"""

from __future__ import annotations

import numpy as np
import torch

from meshlessmultigridpoisson_torch.probes import kiso

N, ITERS = kiso.N, kiso.ITERS
ROLES = ("kiso8_mxu", "kiso8_vpu", "kiso8_mxudef", "kiso8_mxu_v1", "kiso8_mxudef_v1")
build_operator = kiso.build_operator


# each production mma role and its parent design
PARENT = {"kiso8_mxu": "kiso8_mxu_v1", "kiso8_mxudef": "kiso8_mxudef_v1"}
AB_TURNS = ("parent", "change", "change", "parent")


def ab(ell, iters: int = ITERS) -> dict:
    """Each production mma role against its parent design on the same
    tables and x (seed 1), timed in turns parent, change, change, parent
    (``profiling.chain_time``: ``iters`` launches, median of 3):
    {role: {"parent": [ms, ms], "change": [ms, ms]}}."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    dev = torch.device("cuda", 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(ell.ncols)).to(
        dev, torch.float32)
    out = {}
    for role, parent in PARENT.items():
        A = {"change": gk.device_kiso(ell, dev, role),
             "parent": gk.device_kiso(ell, dev, parent)}
        times = {"parent": [], "change": []}
        for side in AB_TURNS:
            times[side].append(pf.chain_time(lambda v, a=A[side]: gk.kiso_spmv(a, v), x,
                                             k=iters, reps=3) * 1e3)
        out[role] = times
        del A
    return out


def run(n: int = N, iters: int = ITERS, seed: int = 0, ell=None) -> dict:
    """Build (unless ``ell`` is given), check and time; the result line,
    with the in-turns A/B of each mma role against its parent (``ab``)."""
    kiso.refuse_cpu("kiso8")
    ell = kiso.build_operator(n, seed) if ell is None else ell
    res = kiso.run_roles("kiso8", ROLES, n, iters, seed, ell)
    res["ab"] = ab(ell, iters)
    return res


def main(argv=None) -> None:
    kiso.main(run, argv)


if __name__ == "__main__":
    main()
