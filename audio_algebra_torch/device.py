"""Device resolution for the port's entry points.

Every entry point takes an explicit `device`. The default is the card
("cuda"); without one it raises rather than quietly running on the CPU.
The CPU is used only when the caller asks for it, as the tests do.
`full_f32` keeps the float32 products of a block out of TF32;
`cast_params` and `call_with` run a module on copies of its parameters in a
lower precision.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn


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


class _Method(nn.Module):
    """`module.<method>` as a module's forward, for functional_call."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.module, self.method = module, method

    def forward(self, *args, **kwargs):
        return getattr(self.module, self.method)(*args, **kwargs)


def cast_params(module: nn.Module, dtype: torch.dtype, parts: tuple[str, ...] = ()) -> dict:
    """Copies of the module's floating parameters cast to `dtype`, by name:
    all of them, or those of the submodules named in `parts`. Made under a
    graph, the casts are in it, so gradients reach the parameters in their
    own dtype."""
    prefixes = tuple(f"{part}." for part in parts)
    return {name: p.to(dtype) for name, p in module.named_parameters()
            if p.is_floating_point() and name.startswith(prefixes or ("",))}


def call_with(module: nn.Module, params: dict, *args, method: str = "forward", **kwargs):
    """`module.<method>(*args, **kwargs)` computed with `params` (by name, as
    cast_params gives them) in place of those parameters
    (torch.func.functional_call), as JAX's bf16 steps apply a cast params
    tree. The other parameters, the buffers and the arguments are left as
    they are."""
    params = {f"module.{name}": p for name, p in params.items()}
    return torch.func.functional_call(_Method(module, method), params, args, kwargs,
                                      strict=False)
