"""The 2000-step Kovasznay run, in parts that continue from a checkpoint.

    python -m meshlessmultigridpoisson_torch.probes.ns_long --steps 1000 \
        --save state_1000 --out part1.json
    python -m meshlessmultigridpoisson_torch.probes.ns_long --steps 1000 \
        --resume state_1000.npz --out part2.json
    python -m meshlessmultigridpoisson_torch.probes.ns_long \
        --merge part1.json part2.json --out results/ns_torch_h100_2000.json

The problem is ``cli ns``'s at its defaults (``--sizes 170 600 2500 10000
--deg 6``: 9,055 fine points, dt 2e-4, Re 40, PPE tolerance 1e-10,
p_relax 0.7).  A part builds it, takes its start state from ``--resume``
(an ``io.save_state`` checkpoint; the step it was taken after is stored
beside it) or the problem's own, and steps it ``--steps`` times through
``models.fracstep_gpu.run_gpu`` from ``dataclasses.replace(prob,
state0=state)``; ``--save`` checkpoints the state it ends on.  Its record
holds the fs_residual of every step, the u L1 error against Kovasznay
after every 50th step (counted from the run's start), the host time of
every step and the card's name and power limit.  ``--merge`` joins the
parts' records in order, checks that each starts where the last ended,
and holds the whole against the targets: u L1 within 2% of 0.112 after
step 1000 and of 0.04525 after step 2000 (``results/ns_tpu_r5.json``),
the fs_residual of steps 1, 5, 9, ... within 2e-3 (relative) of that
record's ``residual_history`` (the steps off listed); it reports the
median and p90 step time over the steps with their count, and the steps
whose PPE solve ended above its tolerance.  A part runs on the card unless it is
given ``--device cpu`` (the plain versions: a rehearsal).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

SIZES, DEG = [170, 600, 2500, 10000], 6
L1_EVERY = 50
# u L1 after step 1000 (the port's first 1000-step run, PERF.md) and after
# step 2000 (results/ns_tpu_r5.json's l1_error)
TARGETS = {1000: 0.112, 2000: 0.045245944937653194}
L1_RTOL = 0.02
RECORD = "results/ns_tpu_r5.json"
HIST_RTOL, HIST_EVERY = 2e-3, 4
PPE_TOL = 1e-10  # cli ns's PPE tolerance: steps whose solve ended above it are listed


def build(sizes=SIZES, deg=DEG, device="cuda"):
    """(host problem, device time-stepper) as ``cli ns`` builds them."""
    import torch

    from meshlessmultigridpoisson_torch.config import FracStepConfig
    from meshlessmultigridpoisson_torch.models import fracstep as fs
    from meshlessmultigridpoisson_torch.models.fracstep_gpu import build_gpu_fracstep
    from meshlessmultigridpoisson_torch.ops import gpu_kernels

    dev = torch.device(device)
    prob = fs.build_fracstep_problem(sizes=list(sizes), poly_deg=deg,
                                     config=FracStepConfig(), device=dev)
    gfs = build_gpu_fracstep(prob, dev)
    if dev.type == "cuda":
        gpu_kernels.build()
    return prob, gfs


def _start_path(state_path: str) -> str:
    from meshlessmultigridpoisson_torch.io.bundle import npz_path

    return npz_path(state_path)[:-len(".npz")] + ".start.json"


def save(path: str, state, step: int) -> str:
    """Checkpoint ``state``, taken after ``step`` steps; returns the file."""
    from meshlessmultigridpoisson_torch.io import save_state

    out = save_state(path, state)
    with open(_start_path(path), "w") as f:
        json.dump({"step": step}, f)
    return out


def load(path: str):
    """(state, the step it was taken after) of a ``save`` checkpoint."""
    from meshlessmultigridpoisson_torch.io import load_state

    with open(_start_path(path)) as f:
        return load_state(path), int(json.load(f)["step"])


def run_part(prob, gfs, steps: int, state=None, start: int = 0, log=None):
    """``steps`` steps from ``state`` (taken after ``start`` steps; None:
    the problem's own start).  Returns (final host state, part record)."""
    import torch

    from meshlessmultigridpoisson_torch.models import fracstep as fs
    from meshlessmultigridpoisson_torch.models.fracstep_gpu import run_gpu

    dev = gfs.bmask.device
    if state is not None:
        prob = dataclasses.replace(prob, state0=state)
    l1, step_s, ppe_res = [], [], []
    t_prev = [time.perf_counter()]

    def on_step(i, st, stats):
        now = time.perf_counter()
        step_s.append(now - t_prev[0])
        ppe_res.append(float(stats["ppe_residual"]))
        n = start + i + 1
        if n % L1_EVERY == 0:
            l1.append([n, fs.u_error_vs_kovasznay(prob, st)])
            if log is not None:
                log(f"step {n}: u L1 {l1[-1][1]:.6e} ({step_s[-1]:.3f} s a step)")
        t_prev[0] = time.perf_counter()

    t0 = time.perf_counter()
    final, hist, _ = run_gpu(prob, dev, steps=steps, t=gfs, on_step=on_step)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec = dict(start=start, steps=steps, sizes=[c.n for c in prob.clouds],
               fs_residual=[float(h) for h in hist], u_l1=l1, step_time_s=step_s,
               ppe_residual=ppe_res, wall_s=time.perf_counter() - t0,
               platform=dev.type)
    return final, rec


def merge(parts: list[dict], record: dict | None = None) -> dict:
    """The parts joined in order, held against the targets (``ok``)."""
    for a, b in zip(parts, parts[1:]):
        if b["start"] != a["start"] + a["steps"] or b["sizes"] != a["sizes"]:
            raise ValueError(f"part starting at {b['start']} does not continue the "
                             f"one of {a['steps']} steps from {a['start']}")
    if parts[0]["start"] != 0:
        raise ValueError("the first part does not start at step 0")
    hist = [h for p in parts for h in p["fs_residual"]]
    ppe = [r for p in parts for r in p.get("ppe_residual", [])]
    l1 = dict((int(n), e) for p in parts for n, e in p["u_l1"])
    st = np.asarray([s for p in parts for s in p["step_time_s"]])
    out = dict(steps=len(hist), sizes=parts[0]["sizes"], fs_residual=hist,
               u_l1=[[n, e] for n, e in sorted(l1.items())],
               step_time_s=dict(median=float(np.median(st)),
                                p90=float(np.percentile(st, 90)), count=int(st.size)),
               parts=[{k: p[k] for k in ("start", "steps", "wall_s", "platform")}
                      for p in parts],
               card=parts[0].get("card"), power_limit=parts[0].get("power_limit"),
               ppe_residual_over_tol=[[i + 1, r] for i, r in enumerate(ppe) if r > PPE_TOL])
    checks = {}
    for n, want in TARGETS.items():
        if n <= len(hist):
            got = l1.get(n)
            checks[f"u_l1_at_{n}"] = dict(got=got, want=want, rtol=L1_RTOL,
                                          ok=got is not None and abs(got - want) <= L1_RTOL * want)
    if record is not None:
        ref = record["residual_history"]
        devs = {s + 1: abs(hist[s] - ref[s // HIST_EVERY]) / ref[s // HIST_EVERY]
                for s in range(0, min(len(hist), HIST_EVERY * len(ref)), HIST_EVERY)}
        off = sorted(n for n, d in devs.items() if d > HIST_RTOL)
        checks["fs_residual_vs_record"] = dict(
            max_rel_dev=max(devs.values()), n=len(devs), tol=HIST_RTOL, steps_off=off,
            max_rel_dev_elsewhere=max((d for n, d in devs.items() if n not in off),
                                      default=None), ok=not off)
    out["checks"] = checks
    out["ok"] = all(c["ok"] for c in checks.values()) and all(map(np.isfinite, hist))
    return out


def _log(m) -> None:
    print(m, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    ap.add_argument("--deg", type=int, default=DEG)
    ap.add_argument("--resume", default=None, help="checkpoint to start from")
    ap.add_argument("--save", default=None, help="checkpoint the final state here")
    ap.add_argument("--merge", nargs="+", default=None, metavar="PART",
                    help="join these part records (no run)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.merge:
        parts = []
        for p in args.merge:
            with open(p) as f:
                parts.append(json.load(f))
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        with open(os.path.join(root, RECORD)) as f:
            res = merge(parts, json.load(f))
    else:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            _log("probes.ns_long: --device cuda needs a card (torch.cuda.is_available() "
                 "is False); --device cpu rehearses on the plain versions")
            return 1
        t0 = time.perf_counter()
        prob, gfs = build(args.sizes, args.deg, args.device)
        setup_s = time.perf_counter() - t0
        state, start = load(args.resume) if args.resume else (None, 0)
        _log(f"setup {setup_s:.1f} s; {args.steps} steps from step {start}")
        final, res = run_part(prob, gfs, args.steps, state, start, log=_log)
        res["setup_s"] = setup_s
        if args.device == "cuda":
            from meshlessmultigridpoisson_torch.utils.profiling import card

            info = card()
            res.update(card=info["name"], power_limit=info["power_limit"])
        if args.save:
            save(args.save, final, start + args.steps)
        res["ok"] = all(map(np.isfinite, res["fs_residual"]))
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    summary = {k: v for k, v in res.items() if k not in ("fs_residual", "step_time_s",
                                                          "ppe_residual", "u_l1")}
    print(json.dumps(summary), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
