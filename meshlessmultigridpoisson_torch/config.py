"""Frozen configuration dataclasses (the reference package's ``config.py``).

The reference C++ code populates ``GridProperties`` (gridclasses.hpp:6-14)
from hardcoded generators (testing_functions.cpp:351-395); here every
preset is an immutable dataclass.
"""

from __future__ import annotations

import dataclasses


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
    finest grid's degree, as the Poisson engine does (multigrid.cpp:22).
    """

    num_levels: int = 3
    fine_poly_deg: int = 6
    coarse_poly_deg: int = 3
    dim: int = 2
    omega: float = 1.4
    iters: int = 5
    rbf_exp: int = 3

    def level_config(self, level: int) -> GridConfig:
        """Level 0 = coarsest; num_levels-1 = finest (reference ordering)."""
        deg = self.fine_poly_deg if level == self.num_levels - 1 else self.coarse_poly_deg
        return GridConfig(
            poly_deg=deg, rbf_exp=self.rbf_exp, omega=self.omega,
            iters=self.iters, dim=self.dim,
        )
