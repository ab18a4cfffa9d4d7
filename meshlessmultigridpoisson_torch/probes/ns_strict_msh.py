"""The strict reference-PPE fractional step on Gmsh meshes, beside the
compatible PPE on the same meshes.

    python -m meshlessmultigridpoisson_torch.probes.ns_strict_msh [--steps 200] \
        [--device cuda|cpu] [--out PATH]

Counterpart of the reference's ``scripts/ns_strict_msh.py``.  The mesh
ladder: ``tests/fixtures/square_170.msh`` and ``square_600.msh`` and a
generated ``square_2500.msh`` (``ensure_msh``: the port's own copies of the
reference's ``scripts/make_msh_fixtures.py`` ``boundary_loops`` and
``domain_triangles`` on a seeded ``square`` cloud, written by
``geometry/msh.write_msh`` under ``MSH_DIR``, which git ignores), 188 /
610 / 2,355 points, deg 6, dt 2e-4, Re 40, PPE tolerance 1e-10,
explicit diffusion.  Two runs, each stopped where the fs_residual or the
u L1 error (read every 10 steps and after the last) passes ``BLOWUP``:

* strict: the assembled-Laplacian PPE with the source's pushdown,
  p_relax 1.0, the host f64 model (``models/fracstep.timestep`` with its
  BiCGStab: the only path either package has for it);
* compatible: the production div∘grad PPE, p_relax 0.7, on ``--device``
  (the card by default: ``models/fracstep_gpu.timestep_gpu``).

Held against ``results/ns_strict_msh_r3.json``: the cloud sizes, the
strict run's divergence step, and the compatible run's final u L1 error
within ``L1_RTOL`` (checked when ``--steps`` is the record's 200).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
MSH_DIR = os.path.join(ROOT, "build", "mshcache")
RECORD = os.path.join(ROOT, "results", "ns_strict_msh_r3.json")
BLOWUP = 1e3
L1_RTOL = 0.01


def domain_triangles(pts: np.ndarray, geomtype: str) -> np.ndarray:
    """Delaunay triangles with centroids inside the domain."""
    from scipy.spatial import Delaunay

    tri = Delaunay(pts).simplices
    c = pts[tri].mean(axis=1)
    r2 = (c[:, 0] - 0.5) ** 2 + (c[:, 1] - 0.5) ** 2
    if geomtype == "square_with_circle":
        keep = r2 > 0.25**2
    elif geomtype == "concentric_circles":
        keep = (r2 > 0.25**2) & (r2 < 0.5**2)
    else:
        keep = np.ones(len(tri), dtype=bool)
    return tri[keep]


def boundary_loops(cloud) -> list[np.ndarray]:
    """Each boundary component as a closed loop: generated clouds emit
    their boundary points in loop order, so the component's index array is
    the loop."""
    return [np.asarray(b) for b in cloud.boundaries]


def ensure_msh(paths) -> None:
    """Write any missing (path, n) of ``paths``: a ``square`` cloud of n
    points from seed 0, its boundary loops and domain triangles."""
    from meshlessmultigridpoisson_torch.geometry.msh import write_msh
    from meshlessmultigridpoisson_torch.geometry.pointclouds import make_cloud

    for path, n in paths:
        if os.path.exists(path):
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cloud = make_cloud("square", n, seed=0)
        write_msh(path, cloud.points, boundary_loops(cloud),
                  domain_triangles(cloud.points, "square"))
        print(f"generated {path}: {cloud.n} nodes", file=sys.stderr)


def ladder() -> list[str]:
    paths = [(os.path.join(FIXTURES, "square_170.msh"), 170),
             (os.path.join(FIXTURES, "square_600.msh"), 600),
             (os.path.join(MSH_DIR, "square_2500.msh"), 2500)]
    ensure_msh(paths)
    return [p for p, _ in paths]


def run_mode(msh_files, strict: bool, steps: int, device: str = "cuda", log=None) -> dict:
    """One run (module docstring); returns its row."""
    import torch

    from meshlessmultigridpoisson_torch.config import FracStepConfig
    from meshlessmultigridpoisson_torch.models import fracstep as fs

    cfg = FracStepConfig(dt=2e-4, mu=0.025, rho=1.0, ppe_tol=1e-10,
                         p_relax=1.0 if strict else 0.7, diffusion="explicit",
                         max_steps=steps)
    dev = torch.device("cpu" if strict else device)
    prob = fs.build_fracstep_problem(poly_deg=6, config=cfg, compatible_ppe=not strict,
                                     msh_files=msh_files, device=dev)
    if strict:
        state = prob.state0

        def step(s):
            return fs.timestep(prob, s, ppe_solver="bicgstab")
    else:
        from meshlessmultigridpoisson_torch.models.fracstep_gpu import (
            build_gpu_fracstep,
            state_to,
            timestep_gpu,
        )

        t = build_gpu_fracstep(prob, dev)
        state = state_to(prob.state0, dev)

        def step(s):
            return timestep_gpu(t, s)
    hist, err_hist, step_s = [], [], []
    diverged_at = None
    for i in range(steps):
        t0 = time.perf_counter()
        state, res = step(state)
        r = float(res)
        step_s.append(time.perf_counter() - t0)
        hist.append(r)
        if i % 10 == 0 or i == steps - 1:
            err = fs.u_error_vs_kovasznay(prob, state)
            err_hist.append([i, err])
            if log is not None:
                log(f"  [{'strict' if strict else 'compat'}] step {i}: fs_res={r:.3e} "
                    f"u_err={err:.3e}")
            if not np.isfinite(err) or err > BLOWUP:
                diverged_at = i
                break
        if not np.isfinite(r) or r > BLOWUP:
            diverged_at = i
            break
    return dict(mode="strict-reference" if strict else "compatible",
                p_relax=cfg.p_relax, diffusion=cfg.diffusion, platform=dev.type,
                sizes=[c.n for c in prob.clouds], steps_run=len(hist),
                diverged_at_step=diverged_at, fs_residual_history=hist,
                u_err_history=err_hist, final_u_err=err_hist[-1][1] if err_hist else None,
                step_time_s=step_s if dev.type == "cuda" else None)


def check(runs: list, record: dict, steps: int) -> list:
    """The misses against the record (empty: it is reproduced)."""
    bad = []
    for mine, ref in zip(runs, record["runs"]):
        if mine["sizes"] != ref["sizes"]:
            bad.append(f"{mine['mode']}: sizes {mine['sizes']} != {ref['sizes']}")
    strict, compat = runs
    if strict["diverged_at_step"] != record["runs"][0]["diverged_at_step"]:
        bad.append(f"strict diverged at {strict['diverged_at_step']}, the record at "
                   f"{record['runs'][0]['diverged_at_step']}")
    want = record["runs"][1]
    if compat["diverged_at_step"] is not None:
        bad.append(f"compatible diverged at {compat['diverged_at_step']}")
    elif steps == want["steps_run"]:
        got, ref = compat["final_u_err"], want["final_u_err"]
        if not abs(got - ref) <= L1_RTOL * ref:
            bad.append(f"compatible final u L1 {got:.6e}, the record's {ref:.6e} "
                       f"(within {L1_RTOL:.0%})")
    return bad


def _log(m) -> None:
    print(m, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the compatible run's device (the strict run is host f64)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        _log("probes.ns_strict_msh: --device cuda needs a card (torch.cuda.is_available() "
             "is False); --device cpu runs the compatible run on the plain versions")
        return 1
    paths = ladder()
    runs = [run_mode(paths, True, args.steps, args.device, _log),
            run_mode(paths, False, args.steps, args.device, _log)]
    with open(RECORD) as f:
        record = json.load(f)
    bad = check(runs, record, args.steps)
    res = dict(msh_files=[os.path.relpath(p, ROOT) for p in paths], steps=args.steps,
               runs=runs, record=os.path.relpath(RECORD, ROOT), misses=bad, ok=not bad)
    if args.device == "cuda":
        from meshlessmultigridpoisson_torch.utils.profiling import card

        res.update(card())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "runs"}), flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
