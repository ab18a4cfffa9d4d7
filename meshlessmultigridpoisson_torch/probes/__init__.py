"""Measurement probes: kernel timings on real operator patterns (card only)."""
