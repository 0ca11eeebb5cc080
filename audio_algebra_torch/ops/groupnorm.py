"""Fused GroupNorm(1) [+ tanh-GELU] [+ residual] — kernel K1.

`groupnorm1_gelu` is the port of audio_algebra_tpu's Pallas
`ops/pallas/groupnorm.py:groupnorm1_gelu_btc` (without its turbo int8
extras), on the port's (B, C, T) layout. On a CUDA tensor it launches the
hand-written CUDA kernel of `csrc/groupnorm.cu` (built for sm_90a at first
use) or raises; on a CPU tensor it takes the plain PyTorch twin
`groupnorm1_gelu_ref`, which computes the same function. There is no
fallback from the card to the twin.

`launches` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "groupnorm.cu"
GELU_C = 0.7978845608028654
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW = 1 << 30              # the kernel indexes a row with 32-bit ints
_THREADS = 256

launches = 0


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, written out as the JAX kernels do."""
    return 0.5 * y * (1.0 + torch.tanh(GELU_C * (y + 0.044715 * y * y * y)))


def groupnorm1_gelu_ref(x, scale, bias, gelu: bool, residual=None,
                        eps: float = 1e-6):
    """Plain PyTorch GN(1)[+GELU][+residual] on (B, C, T): f32 statistics
    over (C, T) per batch row, variance clamped at 0, output in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(x32.square().mean(dim=(1, 2), keepdim=True)
                      - mu.square(), min=0.0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()[None, :, None] + bias.float()[None, :, None]
    if gelu:
        y = gelu_tanh(y)
    if residual is not None:
        y = residual.float() + y
    return y.to(x.dtype)


def _check(x, scale, bias, residual):
    if x.dim() != 3:
        raise ValueError(f"groupnorm1_gelu wants (B, C, T), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"groupnorm1_gelu supports float32/bfloat16, got {x.dtype}")
    c = x.shape[1]
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.dtype != x.dtype or p.device != x.device:
            raise ValueError(f"{name} must be ({c},) {x.dtype} on {x.device}, "
                             f"got {tuple(p.shape)} {p.dtype} on {p.device}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError("residual must match x in shape, dtype and device")
    tensors = [x, scale, bias] + ([residual] if residual is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("groupnorm1_gelu wants contiguous tensors")


def _lib():
    from ._build import load
    lib = load(SOURCE)
    fn = lib.aa_groupnorm1_gelu
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


def _launch_shape(b: int, n: int, vec: int) -> tuple[int, int]:
    """(n_split, apply_blocks): statistics blocks per row and apply blocks
    per row, so that each pass puts a few waves of blocks on the card."""
    n_split = max(1, min(-(-n // (_THREADS * vec * 4)), 1024 // b))
    apply_blocks = max(1, min(-(-n // (_THREADS * vec)), 2048 // b))
    return n_split, apply_blocks


def groupnorm1_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    gelu: bool, residual: torch.Tensor | None = None,
                    eps: float = 1e-6) -> torch.Tensor:
    """y = [residual +] [gelu](GroupNorm1(x) * scale + bias) on (B, C, T).

    scale and bias are (C,) in x's dtype. CPU tensors take the plain twin;
    CUDA tensors launch the CUDA kernel."""
    global launches
    _check(x, scale, bias, residual)
    if x.device.type == "cpu":
        return groupnorm1_gelu_ref(x, scale, bias, gelu, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm1_gelu: unsupported device {x.device}")
    b, c, t_len = x.shape
    n = c * t_len
    if n > _MAX_ROW:
        raise ValueError(f"groupnorm1_gelu: row of {n} elements exceeds {_MAX_ROW}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    vec = 16 // x.element_size()
    ptrs = [x.data_ptr(), y.data_ptr()] + \
        ([residual.data_ptr()] if residual is not None else [])
    vec_ok = int(n % vec == 0 and all(p % 16 == 0 for p in ptrs))
    n_split, apply_blocks = _launch_shape(b, n, vec)
    partials = torch.empty((b, n_split, 2), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(_DTYPES[x.dtype], x.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 partials.data_ptr(), b, c, t_len, n_split, apply_blocks,
                 int(gelu), int(residual is not None), float(eps), vec_ok,
                 stream)
    if err != 0:
        raise RuntimeError(f"groupnorm1_gelu kernel launch failed: CUDA error {err}")
    launches += 1
    return y
