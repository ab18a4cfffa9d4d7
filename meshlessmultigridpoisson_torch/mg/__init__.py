"""Multigrid: hierarchy setup, V-cycle, Krylov and mixed-precision solves."""
