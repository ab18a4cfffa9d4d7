"""Import rules of the port, checked in a fresh interpreter.

With JAX and Triton made unimportable, every module of
``meshlessmultigridpoisson_torch`` imports, the reference package is never
pulled in, and CUDA stays uninitialised (kernels build and the device is
touched only at the first launch); the CLI's ``preprocess``, ``solve
--setup-cache --write-solution``, ``solve --solver``, ``probe`` and
``sweep`` run on the CPU the same way.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any `import jax` now raises ImportError
sys.modules["triton"] = None
import torch
import meshlessmultigridpoisson_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not torch.cuda.is_initialized(), "CUDA initialised at import"
leaked = sorted(m for m in sys.modules if m.startswith("meshlessmultigridpoisson_tpu"))
assert not leaked, leaked
print(" ".join(names))
"""

# the modules each slice of the port added; every one must be visited
SLICE_MODULES = (
    "ops.gpu_kernels", "mg.gpu_backend", "mg.mixed", "mg.krylov", "apps.cli",
    "interop", "models.fracstep", "models.fracstep_gpu", "geometry.msh",
    "bench", "utils.profiling", "probes.realsparsity", "probes.ktime",
    "probes.kexp", "probes.ksweepprobe", "probes.kstream", "probes.kprobe",
    "probes.chaintime", "probes.kiso6", "probes.kiso7", "probes.kiso8",
    "probes.launchrank", "probes.blockgraph", "probes.solve3d", "io", "io.bundle",
    "parallel", "parallel.partition", "parallel.runtime", "parallel.sharded",
    "parallel.dryrun", "probes.shard_timing", "probes.shard_solve", "probes.rho",
    "probes.vcycle_breakdown",
)

# the CLI's sub-commands beside solve and ns, and solve's setup cache and
# txt files, run on the CPU with JAX and Triton unimportable
SURFACES = """
import os, sys, tempfile
sys.modules["jax"] = None
sys.modules["triton"] = None
from meshlessmultigridpoisson_torch.apps import cli
d = tempfile.mkdtemp()
grid = ["--device", "cpu", "--geom", "square", "--sizes", "170", "600", "--deg", "4"]
cli.main(["preprocess", *grid, "--out", os.path.join(d, "b")])
for _ in range(2):
    cli.main(["solve", *grid, "--setup-cache", os.path.join(d, "c"),
              "--write-solution", os.path.join(d, "sol")])
cli.main(["solve", *grid, "--solver", "bicgstab"])
cli.main(["probe", *grid, "--sweeps", "3", "--cond"])
cli.main(["sweep", "--device", "cpu", "--geoms", "square", "--levels", "2", "--ks", "1",
          "--degs", "4", "--out", os.path.join(d, "rows.json")])
leaked = sorted(m for m in sys.modules if m.startswith("meshlessmultigridpoisson_tpu"))
assert not leaked, leaked
print(sorted(os.listdir(d)), sorted(os.listdir(os.path.join(d, "sol"))))
"""


def test_port_imports_without_jax_or_triton_and_leaves_cuda_alone():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20  # every sub-module was visited
    missing = [m for m in SLICE_MODULES
               if f"meshlessmultigridpoisson_torch.{m}" not in names]
    assert not missing, missing


def test_cli_surfaces_run_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", SURFACES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-2] == (
        "['b.npz', 'c.npz', 'rows.json', 'sol'] "
        "['error.txt', 'exact.txt', 'solution.txt', 'x.txt', 'y.txt']")
