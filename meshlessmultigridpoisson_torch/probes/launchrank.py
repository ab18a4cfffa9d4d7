"""Launches and device time per launch by kernel role and level, ranked.

    python -m meshlessmultigridpoisson_torch.probes.launchrank RECORD.json ...

Reads SolveRecords written by ``cli solve --device cuda --profile --out``
(``extra.profile.launch_shapes``: launches and device ms per launch of
each "role rows x cols", or "role rows x cols x sweeps" for a fused
smoother launch, from torch.profiler; ``extra.per_level``: each level's
one-sweep smoother, matvec, transfer and re-solve bounds) and prints, per record, one JSON line per
(role, level, part): the launches of the timed solve, the device ms per
launch, the bound per launch where the record holds it, and the excess
``launches x (device ms per launch - bound per launch)``; then the roles
ranked by their summed excess.  Levels are numbered coarse (0) to fine
by the vectors' lengths of the sweep launches.  A part is "matvec" (a
square SpMV), "restrict" / "prolong" (an SpMV onto a coarser / finer
level: output rows), "smooth" (a fused smoother call: ``iters`` sweeps with
their relax and re-solve in one launch), "sweep" (a sweep launched on its
own: a colored sweep's launches, one per color, summed) or "rows"
(``compact_rows``).  Bounds: a fused launch of ``iters`` sweeps takes
``iters`` times the level's one-sweep smoother bound (what ``iters``
separate sweeps must move), a sweep launch its rows' share of it, a matvec
the level's matvec bound, a transfer the bound of the restriction or
prolongation into its level (``restrict_bound_ms`` / ``prolong_bound_ms``)
and a ``compact_rows`` re-solve its level's ``resolve_bound_ms``.  A record
written before those keys existed charges transfers and ``compact_rows``
0 (the excess is then their device time).  Reads no card.
"""

from __future__ import annotations

import json
import sys


def rank(rec: dict) -> tuple[list[dict], list[tuple[str, float]]]:
    """(rows by role, level and part; [(role, summed excess ms)] ranked)."""
    shapes = rec["extra"]["profile"]["launch_shapes"]
    per_level = rec["extra"]["per_level"]
    parsed = []
    for s in shapes:
        role, dims = s["shape"].split()
        r, c, *sweeps = (int(v) for v in dims.split("x"))
        parsed.append((role, r, c, sweeps[0] if sweeps else None, s))
    n_pads = sorted({c for role, _, c, _, _ in parsed if role.startswith("sweep")})
    level = {n: i for i, n in enumerate(n_pads)}
    groups: dict[tuple, list] = {}
    for role, r, c, sweeps, s in parsed:
        if role.startswith("sweep"):
            lv, part = level[c], ("sweep" if sweeps is None else "smooth")
            bound = per_level[lv]["sweep_bound_ms"] * r / c * (sweeps or 1)
        elif role in ("bound2", "push2", "ppe2", "ppe2_scatter"):
            lv, part = level.get(c), "rows"
            bound = (per_level[lv].get("resolve_bound_ms", 0.0)
                     if role == "bound2" and lv is not None else 0.0)
        else:  # an SpMV: its output rows name the level
            lv = level.get(r)
            part = "matvec" if r == c else ("restrict" if r < c else "prolong")
            key = "matvec_bound_ms" if part == "matvec" else f"{part}_bound_ms"
            bound = per_level[lv].get(key, 0.0) if lv is not None else 0.0
        g = groups.setdefault((role, lv, part), [0, 0.0, 0.0])
        g[0] += s["launches"]
        g[1] += s["device_ms"]
        g[2] += s["launches"] * bound
    rows = [dict(role=role, level=lv, part=part, launches=n,
                 device_ms_per_launch=dev / n, bound_ms_per_launch=b / n,
                 excess_ms=dev - b)
            for (role, lv, part), (n, dev, b) in sorted(groups.items(),
                                                         key=lambda kv: str(kv[0]))]
    total: dict[str, float] = {}
    for row in rows:
        total[row["role"]] = total.get(row["role"], 0.0) + row["excess_ms"]
    return rows, sorted(total.items(), key=lambda kv: -kv[1])


def main(argv=None) -> None:
    for path in (sys.argv[1:] if argv is None else argv):
        with open(path) as fh:
            rec = json.load(fh)
        rows, ranked = rank(rec)
        print(f"# {path}: {rec['extra']['device']}, timed solve "
              f"{rec['wall_time_s']:.3f} s", flush=True)
        for row in rows:
            print(json.dumps(row), flush=True)
        print("rank: " + ", ".join(f"{role} {ms:.2f} ms" for role, ms in ranked), flush=True)


if __name__ == "__main__":
    main()
