"""Diffusion samplers of the port."""
