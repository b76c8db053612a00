"""Kernels and tensor ops of the port (CUDA kernels under ../csrc)."""
