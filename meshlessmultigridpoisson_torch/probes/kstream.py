"""Stream-ceiling calibration over table mixes and tile sizes (card only).

    python -m meshlessmultigridpoisson_torch.probes.kstream

Port of the reference package's ``scripts/kstream.py``.  The stream
kernel (``gpu_kernels.stream_probe``, ``csrc/stream_ceiling.cu``) sums the
columns of 2^18-row, 128-wide tables per tile, over four table mixes:

* ``f32i32``: f32 and int32 tables, both summed (the bench's probe);
* ``f32f32``: two f32 tables, both summed;
* ``f32``: one f32 table, summed;
* ``f32i16``: f32 and int16 tables; the i16 table is read whole, but only
  its first row of a tile enters the value (``where(c[0] > 0, v[0], 0)``),
  so that value serves timing only;

at 1024, 2048 and 4096 tile rows, and 8192 for ``f32`` (the reference's
grid; the tiles are walked by at most the CTAs resident at once, and each
row gives its CTA count).  The tables hold small integers drawn from ``seed`` on
the card (the i16 table negative and positive, so the select matters): the
sums are exact.  Each (mix, tile rows) is held against its plain version
(``stream_probe_plain``) at 1 and at 9 passes, tolerance 0, then timed: a
pass is (T(9 passes) - T(1 pass)) / 8, each T 10 launches between CUDA
events, the median of 7 such deltas (``pass_ms``).  Each row
gives ms a pass, GB/s over the bytes the mix needs (``profiling.
stream_bytes``: 8 / 8 / 4 / 6 B an element), the bound at the card's
memory rate and its share, the plain version's ms and, for ``f32``, the
ms of one ``torch.sum`` over the tiles (the same tile sums without the
8-row output, a call the port never makes).  The JSON line names the best
mix.  Without a card it exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

ROWS = 1 << 18
PASSES = 9
MIXES = ("f32i32", "f32f32", "f32", "f32i16")
TILES = (1024, 2048, 4096)
F32_TILES = TILES + (8192,)  # the reference runs its one-table kind at 8192 too


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def tables(mix: str, rows: int, device, seed: int = 0):
    """``v`` (f32) and ``c`` of the mix's dtype (None for "f32"): small
    integers from ``seed``, made on ``device``."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (rows, gk.STREAM_COLS)
    v = torch.randint(0, 4, shape, generator=g, device=device).to(torch.float32)
    cdt = gk.STREAM_MIXES[mix][1]
    c = None if cdt is None else torch.randint(-3, 4, shape, generator=g,
                                               device=device).to(cdt)
    return v, c


def held(role: str, v, c, tile_rows: int, reps=(1, PASSES)) -> float:
    """The kernel against its plain version at each pass count in ``reps``;
    returns the largest absolute difference (0, or it raises)."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    ref = gk.stream_probe_plain(v, c, gk.STREAM_ROLES[role], tile_rows)
    err = max(float((gk.stream_probe(v, c, role, tile_rows, r) - ref).abs().max())
              for r in reps)
    if err != 0.0:
        raise AssertionError(f"{role} tpp={tile_rows}: kernel differs from its plain "
                             f"version by {err}")
    return err


def pass_ms(role: str, v, c, tile_rows: int, k: int = 10, reps: int = 7) -> float:
    """ms a pass: per repetition, T(9) and T(1), each ``k`` launches of 9 or
    1 passes between CUDA events over ``k``; the median over ``reps`` of
    (T(9) - T(1)) / 8.  Each chain is enqueued behind one more 9-pass
    launch, so the card is busy while the host enqueues it: a stall of the
    host (the card's host shares its cores) does not leave the card idle
    inside a chain, which would lengthen T(1) and shorten the delta."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

    def chain(passes):
        gk.stream_probe(v, c, role, tile_rows, PASSES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(k):
            gk.stream_probe(v, c, role, tile_rows, passes)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / k

    return statistics.median((chain(PASSES) - chain(1)) / (PASSES - 1)
                             for _ in range(reps))


def run(rows: int = ROWS, seed: int = 0) -> dict:
    """Check and time every (mix, tile rows); returns the result line."""
    if not torch.cuda.is_available():
        raise SystemExit("the kstream probe times on the card: "
                         "torch.cuda.is_available() is False")
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    dev = torch.device("cuda", 0)
    info = pf.card()
    log(f"card {info['name']}, power limit {info['power_limit']}")
    rows_out = {}
    for mix in MIXES:
        role = f"kstream_{mix}"
        v, c = tables(mix, rows, dev, seed)
        for tpp in F32_TILES if mix == "f32" else TILES:
            err = held(role, v, c, tpp)
            ms = pass_ms(role, v, c, tpp)
            plain_ms = pf.chain_time(
                lambda _: gk.stream_probe_plain(v, c, mix, tpp), v, k=3, reps=3) * 1e3
            lib = None
            if mix == "f32":
                lib = pf.chain_time(lambda t: t.view(-1, tpp, gk.STREAM_COLS).sum(dim=1),
                                    v, k=3, reps=3) * 1e3
            nbytes = pf.stream_bytes(v, c, tpp)
            b_ms, by = pf.bound_ms(nbytes, pf.stream_flops(v, c, tpp), torch.float32,
                                   info["name"])
            label = f"{mix} tpp={tpp}"
            rows_out[label] = dict(
                role=role, mix=mix, tile_rows=tpp, ctas=gk.STREAM_CTAS[role],
                ms=ms, gb_s=nbytes / ms / 1e6, plain_ms=plain_ms, max_abs_err=err,
                rel_err=0.0, bound_ms=b_ms, bound_by=by, pct_of_bound=100.0 * b_ms / ms,
                library_ms=lib)
            log(f"  {label:<16s} {ms:.4f} ms/pass  {nbytes / ms / 1e6:7.1f} GB/s  bound "
                f"{b_ms:.4f} ms ({100.0 * b_ms / ms:.1f}%)  plain {plain_ms:.4f} ms"
                + ("" if lib is None else f"  torch.sum {lib:.4f} ms"))
        del v, c
    best = max(rows_out, key=lambda k: rows_out[k]["gb_s"])
    log(f"best: {best}, {rows_out[best]['gb_s']:.1f} GB/s "
        f"({rows_out[best]['pct_of_bound']:.1f}% of its bound)")
    return {"probe": "kstream", "n": rows, "passes": PASSES, "seed": seed,
            "card": info["name"], "power_limit": info["power_limit"],
            "best": best, "kernels": rows_out}


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
