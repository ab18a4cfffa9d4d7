"""Boundary data and the seeded stream of sources.

Boundary data are those of the configuration's manufactured solution,
frozen from ``meshlessmultigridpoisson_torch/models/poisson.py``'s
``_bc_value_fn`` at commit 57ee902 (``square_with_circle`` and ``box3d``).

Sources: the reference's manufactured ones for the wavenumbers its
``run_tests`` sweeps, frozen from the same file's ``source_square`` /
``source_box3d`` (k1 = k2 = k); the seed draws their order
(``SourceStream``).  The boundary data stay those of the configuration's
``manufactured_k`` for every source: the port's set-up fixes them in the
hierarchy, as a simulation's boundary stays while its source changes.
"""

from __future__ import annotations

import numpy as np

PI = np.pi


def boundary_values(geometry: str, neumann: bool, k: int, points: np.ndarray,
                    normals: np.ndarray, component: int) -> np.ndarray:
    """g at one boundary component's points: the value (Dirichlet) or the
    stored-normal derivative (Neumann) of the manufactured solution."""
    n = points.shape[0]
    if geometry == "box3d" or component == 0:
        # box3d: the sin products vanish on every face, the cos products'
        # normal derivatives too; the square's edges likewise
        return np.zeros(n)
    if geometry != "square_with_circle":
        raise ValueError(geometry)
    x, y = points[:, 0], points[:, 1]
    if not neumann:
        return np.sin(k * PI * x) * np.sin(k * PI * y)
    nx, ny = normals[:, 0], normals[:, 1]
    return (-nx * PI * k * np.sin(k * PI * x) * np.cos(k * PI * y)
            - ny * PI * k * np.cos(k * PI * x) * np.sin(k * PI * y))


def dense_boundary_values(geometry: str, neumann: bool, k: int, cloud) -> np.ndarray:
    """g at every point of ``cloud`` (zero inside)."""
    out = np.zeros(cloud.n)
    for comp, idx in enumerate(cloud.boundaries):
        out[idx] = boundary_values(geometry, neumann, k, cloud.points[idx],
                                   cloud.normals[idx], comp)
    return out


class SourceStream:
    """The stream of one seed at fixed ``points`` [n, dim].

    The sources are the reference's manufactured ones
    (``genGmshGridDirichlet`` / ``genGmshGridNeumann``,
    testing_functions.cpp:68-284, with k1 = k2 = k as ``gen_mg_param``
    sets them), for each wavenumber k of ``mix["wavenumbers"]``, the values
    ``run_tests`` sweeps (testing_functions.cpp:396-412):
    ``f_k = -dim k^2 pi^2 prod_d s(k pi x_d)``, ``s`` the sine (Dirichlet)
    or the cosine (Neumann); in 3D the product over all three coordinates,
    as the port's ``source_box3d`` extends the family.  The seed sets the
    order alone: solves ``m j .. m j + m - 1`` (m wavenumbers) take each
    wavenumber once, in a permutation drawn from ``(seed, j)``.  So every
    seed's window holds the same mix of sources.
    """

    def __init__(self, points: np.ndarray, seed: int, mix: dict):
        self.seed = seed % 2**64
        self.neumann = mix["boundary"] == "neumann"
        self.wavenumbers = [int(k) for k in mix["wavenumbers"]]
        self.points = points

    def wavenumber(self, index: int) -> int:
        """The wavenumber of the seed's solve ``index``."""
        m = len(self.wavenumbers)
        order = np.random.default_rng([self.seed, index // m]).permutation(m)
        return self.wavenumbers[int(order[index % m])]

    def source(self, k: int) -> np.ndarray:
        """The manufactured source of wavenumber ``k`` at the points."""
        dim = self.points.shape[1]
        ang = k * PI * self.points
        prod = np.prod(np.cos(ang) if self.neumann else np.sin(ang), axis=1)
        return -dim * k * k * PI * PI * prod
