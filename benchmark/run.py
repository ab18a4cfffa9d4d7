"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Reads ``BENCHMARK.json``, finds the cell's
configuration, traffic mix, driver module and metric readers by name
(``benchmark/spec.py``), runs the mix's driver module on the first card
and prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared for ``correct`` beside its limit,
which also end standard error.  Without a card (or with fewer cards than
the cell asks for), or where the process has loaded JAX or the JAX
package, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "meshlessmultigridpoisson_tpu")


def execute(spec, workload: str, seed: int, seconds: float, trace: bool, dev) -> dict:
    """One run of ``workload`` on ``dev``; returns the result line's object."""
    import torch

    cell = spec.cell(workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    readers = [(m, spec.reader(m["name"])) for m in spec.metrics(workload, trace)]

    def read_metrics(ctx) -> dict:
        out = {}
        for m, reader in readers:
            v = reader.read(ctx)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out

    rec = spec.driver(mix["driver"]).run(config, mix, seed, seconds, trace, dev, read_metrics)
    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = {"correct": rec["correct"], "attempted": rec["attempted"], "failed": rec["failed"],
            "metrics": rec["metrics"], "device": device}
    if trace and rec["trace"] is not None:
        t = rec["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = rec["checks"]
    return line


def loaded_forbidden() -> list[str]:
    """The top-level names of FORBIDDEN that ``sys.modules`` holds, each
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.spec import ROOT, Spec

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "benchmark", "build", sub)
    import torch

    spec = Spec()
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    line = execute(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = loaded_forbidden()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
