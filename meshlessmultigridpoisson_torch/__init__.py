"""PyTorch + CUDA port of the meshless multigrid Poisson framework.

A second package beside ``meshlessmultigridpoisson_tpu`` (the JAX/Pallas
reference, which this package never imports).  The layout mirrors the
reference package module for module:

* ``geometry/`` — clouds, kNN, orderings, in-block coloring (numpy/scipy/C++);
* ``stencil/``  — RBF-FD weights (batched f64 ``torch.linalg.solve``) and
  operator assembly into windowed ELL;
* ``ops/``      — ELL container, the plain f64 smoother path, and
  ``gpu_kernels`` (hand-written CUDA kernels for Hopper, bound with ctypes);
* ``mg/``       — V-cycle, setup, stabilization, BiCGStab, mixed-precision
  defect correction, and ``gpu_backend`` (level repack for the kernels);
* ``models/``, ``apps/``, ``utils/`` — Poisson problems, the CLI, records.

Importing this package touches neither CUDA nor Triton; kernels are built at
their first launch.
"""

from meshlessmultigridpoisson_torch.config import (
    GridConfig,
    MultigridConfig,
    poly_terms,
    stencil_size,
)

__all__ = ["GridConfig", "MultigridConfig", "stencil_size", "poly_terms"]

__version__ = "0.1.0"
