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
  instance under its own role).

The mma roles pad the ELL's width to a multiple of 8 (70 -> 72 at the
reference's width) with zero values.  Each row's ``f64_rel_err`` is the
reference's ``err``: the distance from an f64 SpMV over max |y|.  Check,
timing and row fields: ``probes.kiso``.  Without a card it exits non-zero.
"""

from __future__ import annotations

from meshlessmultigridpoisson_torch.probes import kiso

N, ITERS = kiso.N, kiso.ITERS
ROLES = ("kiso8_mxu", "kiso8_vpu", "kiso8_mxudef")
build_operator = kiso.build_operator


def run(n: int = N, iters: int = ITERS, seed: int = 0, ell=None) -> dict:
    """Build (unless ``ell`` is given), check and time; the result line."""
    return kiso.run_roles("kiso8", ROLES, n, iters, seed, ell)


def main(argv=None) -> None:
    kiso.main(run, argv)


if __name__ == "__main__":
    main()
