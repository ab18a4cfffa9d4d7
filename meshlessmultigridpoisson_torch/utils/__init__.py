"""Solve records and timers."""
