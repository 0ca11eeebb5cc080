"""Blocked (flash) self-attention with an additive rel-pos bias — kernel K3.

`flash_attention_relpos(q, k, v, biasT, sm_scale)` is the port of
audio_algebra_tpu's `ops/pallas/flash_attention.py:flash_attention_relpos`
(forward only): q, k, v are (B, H, T, D), biasT the TRANSPOSED bias
(H, S, T) (`models.unet_cfg1d.toeplitz_rel_pos_bias(..., transposed=True)`),
and it returns softmax(q·kᵀ·sm_scale + bias)·v in q's dtype, with f32
scores and softmax statistics and P cast to v's dtype before P·V. On a
CUDA tensor it launches the hand-written CUDA kernel of
`csrc/flash_attention.cu` (built for sm_90a at first use) or raises; on a
CPU tensor it takes the plain twin `flash_attention_relpos_ref`, which
takes the same biasT. `launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from .groupnorm import _DTYPES

SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
TILE = 64                     # the kernel's query and key tile

launches = 0


def flash_ok(t: int, block: int = 512, min_t: int = 1024) -> bool:
    """True when the blocked path applies (the JAX gate): a long enough
    sequence that divides into blocks."""
    return t >= min_t and t % block == 0


def flash_attention_relpos_ref(q, k, v, biasT, sm_scale: float = 1.0):
    """Plain twin with the kernel's arithmetic: f32 scores plus the bias,
    P = exp(s - rowmax) and its f32 row sum l, P cast to v's dtype, P·V
    accumulated in f32, divided by l, output in q's dtype. biasT is
    (H, S, T)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s + biasT.float().transpose(-1, -2)[None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _check(q, k, v, biasT):
    if q.dim() != 4:
        raise ValueError(f"flash_attention_relpos wants (B, H, T, D), got {tuple(q.shape)}")
    if q.dtype not in _DTYPES or biasT.dtype not in _DTYPES:
        raise TypeError("flash_attention_relpos supports float32/bfloat16, got "
                        f"{q.dtype} and a {biasT.dtype} bias")
    b, h, t, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    if biasT.shape != (h, t, t) or biasT.device != q.device:
        raise ValueError(f"biasT must be ({h}, {t}, {t}) on {q.device}, "
                         f"got {tuple(biasT.shape)} on {biasT.device}")
    if not all(x.is_contiguous() for x in (q, k, v, biasT)):
        raise ValueError("flash_attention_relpos wants contiguous tensors")


def _lib():
    from ._build import load
    fn = load(SOURCE).aa_flash_attention_relpos
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
    return fn


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           biasT: torch.Tensor, sm_scale: float = 1.0) -> torch.Tensor:
    """softmax(q·kᵀ·sm_scale + bias)·v for (B, H, T, D) q, k, v and the
    transposed (H, S, T) bias, in q's dtype. CPU tensors take the plain
    twin; CUDA tensors launch the CUDA kernel (T a multiple of 64, D one
    of 16, 32, 64, 128)."""
    global launches
    _check(q, k, v, biasT)
    if q.device.type == "cpu":
        return flash_attention_relpos_ref(q, k, v, biasT, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_relpos: unsupported device {q.device}")
    b, h, t, d = q.shape
    if t % TILE or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_relpos: T={t} must be a multiple of {TILE} "
                         f"and D={d} one of {HEAD_DIMS}")
    if q.numel() >= 1 << 31 or biasT.numel() >= 1 << 40:
        raise ValueError(f"flash_attention_relpos: {tuple(q.shape)} is too large")
    o = torch.empty_like(q)
    if any(x.data_ptr() % 16 for x in (q, k, v, biasT, o)):
        raise ValueError("flash_attention_relpos wants 16-byte aligned tensors")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(_DTYPES[q.dtype], _DTYPES[biasT.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), biasT.data_ptr(), o.data_ptr(), b, h, t, d,
                 float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_relpos kernel launch failed: CUDA error {err}")
    launches += 1
    return o
