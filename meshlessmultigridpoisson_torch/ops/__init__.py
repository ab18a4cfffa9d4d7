"""Operator containers, smoother protocol and the CUDA kernels."""
