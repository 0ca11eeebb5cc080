"""Plain PyTorch layers of the benchmark's reference, on (B, C, T) in f32.

Frozen, independent copies of the arithmetic of the measured models: XLA
SAME padding, GroupNorm eps 1e-6 (torch's own group_norm), tanh-GELU,
SiLU, dance-diffusion self-attention and the rel-pos / cross attention of
the MIRAGE UNet. Every function takes its weights from a dict `P` of
tensors keyed by the measured module's parameter names, with a prefix.
Nothing here imports the measured program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GELU_C = 0.7978845608028654
EPS = 1e-6


def same_padding(t_len: int, kernel: int, stride: int = 1, dilation: int = 1):
    """XLA SAME: total = max((ceil(T/s) - 1) s + (k - 1) d + 1 - T, 0),
    the lower half on the left."""
    out_len = -(-t_len // stride)
    total = max((out_len - 1) * stride + (kernel - 1) * dilation + 1 - t_len, 0)
    return total // 2, total - total // 2


def conv1d(P, name, x, stride=1, dilation=1, bias=True):
    """SAME conv by its definition: one matrix product of the weight
    (Cout, Cin K) with the input's K taps unfolded (B, Cin K, Tout)."""
    w = P[f"{name}.weight"]
    c_out, c_in, k = w.shape
    left, right = same_padding(x.shape[-1], k, stride, dilation)
    x = F.pad(x, (left, right))
    t_out = (x.shape[-1] - (k - 1) * dilation - 1) // stride + 1
    span = (t_out - 1) * stride + 1
    cols = torch.stack([x[..., j * dilation:j * dilation + span:stride] for j in range(k)],
                       dim=2)                                   # (B, Cin, K, Tout)
    y = torch.matmul(w.reshape(c_out, c_in * k), cols.reshape(x.shape[0], c_in * k, t_out))
    return y + P[f"{name}.bias"][:, None] if bias else y


def conv_transpose1d(P, name, x, stride):
    """flax ConvTranspose(padding='SAME'): T * stride outputs; weight
    (Cin, Cout, K)."""
    w = P[f"{name}.weight"]
    k = w.shape[-1]
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    left = k - 1 - pad_a
    right = (k - 1) - (pad_len - pad_a)
    y = F.conv_transpose1d(x, w, P[f"{name}.bias"], stride=stride)
    return y[..., left:y.shape[-1] - right]


def dense(P, name, x, bias=True):
    """Dense over the channel axis of (B, C, T)."""
    y = torch.matmul(P[f"{name}.weight"], x)
    return y + P[f"{name}.bias"][:, None] if bias else y


def linear(P, name, x, bias=True):
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"] if bias else None)


def layer_norm(P, name, x):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], EPS)


def gelu_tanh(y):
    return 0.5 * y * (1.0 + torch.tanh(GELU_C * (y + 0.044715 * y * y * y)))


def group_norm(P, name, x, groups):
    return F.group_norm(x, groups, P[f"{name}.weight"], P[f"{name}.bias"], EPS)


def gn1_gelu(P, name, x, gelu: bool, residual=None):
    """GroupNorm(1) [+ tanh-GELU] [+ residual]."""
    y = group_norm(P, name, x, 1)
    if gelu:
        y = gelu_tanh(y)
    return y if residual is None else residual + y


def gn_film_silu(P, name, x, groups, film_scale=None, film_shift=None, silu=True):
    """GroupNorm(groups) * (1 + scale) + shift, then SiLU."""
    y = group_norm(P, name, x, groups)
    if film_scale is not None:
        y = y * (1.0 + film_scale[:, :, None])
    if film_shift is not None:
        y = y + film_shift[:, :, None]
    return F.silu(y) if silu else y


def fourier_features(P, name, t):
    f = 2.0 * math.pi * t[:, None] * P[f"{name}.weight"][None, :, 0]
    return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


def _taps(x, norm):
    """[1, 3, 3, 1] / norm, made where x lives (no copy from the host)."""
    i = torch.arange(4, device=x.device)
    taps = (1.0 + 2.0 * ((i == 1) | (i == 2)).to(x.dtype)) / norm
    return taps[None, None, :].expand(x.shape[1], 1, 4)


def downsample(x):
    """x2 down: depthwise [1,3,3,1]/8, stride 2, padding 1."""
    return F.conv1d(x, _taps(x, 8.0), stride=2, padding=1, groups=x.shape[1])


def upsample(x):
    """x2 up: depthwise [1,3,3,1]/4 transposed, stride 2, padding 1."""
    return F.conv_transpose1d(x, _taps(x, 4.0), stride=2, padding=1, groups=x.shape[1])


def upsample_nearest(cond, t_len):
    n = cond.shape[-1]
    if n == t_len:
        return cond
    idx = torch.div(torch.arange(t_len, device=cond.device) * n, t_len, rounding_mode="floor")
    return cond[:, :, idx]


def attention(q, k, v, bias=None):
    """softmax(q kᵀ [+ bias]) v over (B, H, T, D); q already scaled."""
    att = torch.matmul(q, k.transpose(-1, -2))
    if bias is not None:
        att = att + bias[None]
    return torch.matmul(torch.softmax(att, dim=-1), v)
