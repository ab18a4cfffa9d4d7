"""16-bit column offsets and guarded / unguarded padded blocks (card only).

    python -m meshlessmultigridpoisson_torch.probes.kiso6 [n] [iters]

Port of the reference package's ``scripts/kiso6.py`` (default n 262,144):
y = A x with i16 or i32 column tables (6 or 8 bytes per f32 nonzero), on an
id table padded with -1 to a multiple of 8 blocks, whose padded blocks are
skipped (``pl.when(bi >= 0)``, "guarded") or computed as block
``max(bi, 0)`` ("unguarded").  Here ``ell_spmv``'s ``kColU16`` format (an
unsigned 16-bit offset from an int32 base column a 128-row block) or its
int32 columns, with the ``kIdsGuarded`` / ``kIdsUnguarded`` row sources:
roles ``kiso6_{i16,i32}_{guarded,unguarded}`` of ``gpu_kernels.kiso_spmv``.
The reference's per-segment widths are its Mosaic staging: the port's ELL
has one width.  At 262,144 rows there are 2,048 blocks, a multiple of 8,
so no block is padded and the guarded and unguarded instances differ only
by their test of the id; the output says so.  The line also gives the
operator's largest block column span (the u16 format's limit: 65,535).
Check, timing and row fields: ``probes.kiso``.  Without a card it exits
non-zero.
"""

from __future__ import annotations

from meshlessmultigridpoisson_torch.probes import kiso

N, ITERS = kiso.N, kiso.ITERS
ROLES = ("kiso6_i16_guarded", "kiso6_i16_unguarded", "kiso6_i32_guarded",
         "kiso6_i32_unguarded")
build_operator = kiso.build_operator


def max_block_span(ell) -> int:
    """The largest column span of a 128-row block (global columns)."""
    from meshlessmultigridpoisson_torch.ops.ell import global_cols

    c = global_cols(ell).view(ell.nrows_pad // 128, -1)
    return int((c.max(dim=1).values - c.min(dim=1).values).max())


def run(n: int = N, iters: int = ITERS, seed: int = 0, ell=None) -> dict:
    """Build (unless ``ell`` is given), check and time; the result line."""
    kiso.refuse_cpu("kiso6")
    if ell is None:
        ell = build_operator(n, seed)
    res = kiso.run_roles("kiso6", ROLES, n, iters, seed, ell)
    nb = ell.nrows_pad // 128
    pad = -nb % 8
    res.update(blocks=nb, padded_blocks=pad, max_block_span=max_block_span(ell),
               padding=(f"{nb} blocks, {pad} padded to a multiple of 8"
                        + (": guarded and unguarded differ only by the test of the id"
                           if pad == 0 else "")))
    kiso.log(f"kiso6: {res['padding']}; largest block column span "
             f"{res['max_block_span']} (u16 limit 65535)")
    return res


def main(argv=None) -> None:
    kiso.main(run, argv)


if __name__ == "__main__":
    main()
