"""Import rules of the port, checked in a fresh interpreter.

With JAX and Triton made unimportable, every module of
``meshlessmultigridpoisson_torch`` imports, the reference package is never
pulled in, and CUDA stays uninitialised (kernels build and the device is
touched only at the first launch).
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
    "bench", "utils.profiling",
)


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
