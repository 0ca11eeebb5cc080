"""Device resolution for the port's entry points.

Every entry point takes an explicit `device`. The default is the card
("cuda"); without one it raises rather than quietly running on the CPU.
The CPU is used only when the caller asks for it, as the tests do.
"""
from __future__ import annotations

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
