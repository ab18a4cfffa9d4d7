"""Block ids from a table against affine block ids (card only).

    python -m meshlessmultigridpoisson_torch.probes.kiso7 [n] [iters]

Port of the reference package's ``scripts/kiso7.py`` (default n 262,144):
y = A x on the v4 layout with each program's block id computed (``bi = i *
mb + j``, "affine") or read from a prefetched table (``arange(nb)``, so
both compute y = A x), beside the stock ``spmv_tpu4`` ("v4 stock").  Here:
``ell_spmv``'s production instance (role ``kiso7_affine``: one warp a row,
8 rows a CTA, the row from the thread's index) and its ``kIds`` row source
(role ``kiso7_ids``: one CTA a 128-row block, whose id one thread reads
once and shares; the colored sweep ``sweep8`` pays the same dependent load
on every launch), and the stock row: ``ell_spmv`` in its role ``spmv4``
(the same code as ``kiso7_affine``, under the port's v4 role).  The
difference ids - affine is the id load and the CTA-per-block mapping
together.  Check, timing and row fields: ``probes.kiso``.  Without a card
it exits non-zero.
"""

from __future__ import annotations

from meshlessmultigridpoisson_torch.probes import kiso

N, ITERS = kiso.N, kiso.ITERS
ROLES = ("kiso7_affine", "kiso7_ids")
STOCK = "spmv4"
build_operator = kiso.build_operator


def run(n: int = N, iters: int = ITERS, seed: int = 0, ell=None) -> dict:
    """Build (unless ``ell`` is given), check and time; the result line."""
    return kiso.run_roles("kiso7", ROLES, n, iters, seed, ell, stock=STOCK)


def main(argv=None) -> None:
    kiso.main(run, argv)


if __name__ == "__main__":
    main()
