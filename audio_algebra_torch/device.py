"""Device resolution for the port's entry points.

Every entry point takes an explicit `device`. The default is the card
("cuda"); without one it raises rather than quietly running on the CPU.
The CPU is used only when the caller asks for it, as the tests do.
`full_f32` keeps the float32 products of a block out of TF32.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return the torch.device to run on; raise if CUDA is asked for and
    there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "audio_algebra_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def full_f32():
    """Run float32 matrix products and cuDNN convolutions in full float32
    (no TF32) inside the block, whatever the process-wide flags say, and
    restore the flags after. The DSP front end and CLAP need it: the JAX
    package computes them at Precision.HIGHEST, and a TF32 product breaks
    the STFT round trip's 1e-9."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
