"""Manufactured-solution Poisson problems."""
