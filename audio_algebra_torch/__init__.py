"""PyTorch / CUDA port of audio_algebra_tpu.

The JAX package stays the reference; this package follows its numerics
and module names, keeps activations in (B, C, T), and runs its kernels
(hand-written CUDA for Hopper, under `csrc/`) on the card. It imports
nothing of JAX or of audio_algebra_tpu.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
