"""Frozen configuration dataclasses (the reference package's ``config.py``).

The reference C++ code populates ``GridProperties`` (gridclasses.hpp:6-14)
from hardcoded generators (testing_functions.cpp:351-395); here every
preset is an immutable dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


def poly_terms(poly_deg: int, dim: int = 2) -> int:
    """Number of monomials up to total degree ``poly_deg`` in ``dim`` D.

    2D reference rule: ``(polyDeg + 1) * (polyDeg + 2) / 2`` (grid.cpp:266);
    3D is the designed extension (C(deg+3, 3) terms).
    """
    if dim == 2:
        return (poly_deg + 1) * (poly_deg + 2) // 2
    if dim == 3:
        return (poly_deg + 1) * (poly_deg + 2) * (poly_deg + 3) // 6
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def stencil_size(poly_deg: int, dim: int = 2) -> int:
    """Stencil size rule k = floor(2.5 * polyTerms) (grid.cpp:267)."""
    return int(2.5 * poly_terms(poly_deg, dim))


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Per-level grid/operator configuration (reference defaults: PHS r^3,
    omega=1.4, 5 sweeps per smoother call, testing_functions.cpp:372-380)."""

    poly_deg: int = 3
    rbf_exp: int = 3
    omega: float = 1.4
    iters: int = 5
    dim: int = 2

    @property
    def stencil_size(self) -> int:
        return stencil_size(self.poly_deg, self.dim)

    @property
    def poly_terms(self) -> int:
        return poly_terms(self.poly_deg, self.dim)


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    """Multigrid hierarchy configuration.

    Levels are sorted by size ascending (multigrid.cpp:116-122); the fine
    level uses ``fine_poly_deg``, coarse levels ``coarse_poly_deg``
    (testing_functions.cpp:375).  Every interpolation matrix uses the
    finest grid's degree, as the Poisson engine does (multigrid.cpp:22),
    unless ``transfer_poly="base"``: each transfer then uses its base grid's
    degree, as the fractional-step engine does (FracStepMultigrid.cpp:23).
    """

    num_levels: int = 3
    fine_poly_deg: int = 6
    coarse_poly_deg: int = 3
    dim: int = 2
    omega: float = 1.4
    iters: int = 5
    rbf_exp: int = 3
    transfer_poly: str = "finest"  # "finest" | "base"

    def level_config(self, level: int) -> GridConfig:
        """Level 0 = coarsest; num_levels-1 = finest (reference ordering)."""
        deg = self.fine_poly_deg if level == self.num_levels - 1 else self.coarse_poly_deg
        return GridConfig(
            poly_deg=deg, rbf_exp=self.rbf_exp, omega=self.omega,
            iters=self.iters, dim=self.dim,
        )


@dataclasses.dataclass(frozen=True)
class FracStepConfig:
    """Fractional-step Navier-Stokes configuration.

    Reference defaults from gen_fracstep_param / run_frac_step_test
    (FractionalStepSim.cpp:50-79, 201-204): dt=2e-4, mu=0.025, rho=1
    (Re=40), PPE tolerance 1e-10, <=2000 timesteps, Kovasznay flow.
    ``p_relax``: pressure under-relaxation p = p_relax*p_new +
    (1-p_relax)*p_old (1.0: the reference's own update).  ``diffusion``:
    "explicit" (forward Euler, fractionalStepGrid.cpp:101-124) or
    "implicit" (backward-Euler Helmholtz solve).  ``hyperviscosity``: the
    strength of -hv*nu*Lap(Lap u)/|lam_max(Lap)| in the explicit predictor
    (0: off, the reference's behaviour).
    """

    dt: float = 2e-4
    mu: float = 0.025
    rho: float = 1.0
    ppe_tol: float = 1e-10
    max_steps: int = 2000
    flow_type: str = "kovasznay"
    p_relax: float = 0.7
    diffusion: str = "explicit"
    hyperviscosity: float = 0.0

    @property
    def reynolds(self) -> float:
        return self.rho / self.mu


# point counts of the reference's named .msh fixtures
# (testing_functions.cpp:355-364); the generators build clouds of these sizes
REFERENCE_MG_SIZES: dict[str, Sequence[int]] = {
    "square": (170, 600, 2500, 10000),
    "square_with_circle": (176, 640, 2532, 10197, 37943, 150214),
    "concentric_circles": (188, 650, 2581, 10207),
    "box3d": (4000, 16000, 64000, 250000, 1000000),
}
