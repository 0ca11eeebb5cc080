"""Kernels of the port (CUDA sources in ../csrc) and host-side signal ops."""
