"""Shared neural blocks, channels-first (B, C, T).

Port of audio_algebra_tpu/models/blocks.py (the dance-diffusion style
blocks of DiffusionAttnUnet1D and the SoundStream encoder), plus the flax
layers the MIRAGE models use: Dense on the last axis (`Linear`),
`LayerNorm`, grouped `GroupNorm` [+ FiLM] [+ SiLU] through kernel K5, and
`ConvTranspose1d` with flax's SAME padding. Modules and
parameters keep the flax names (`Conv1d_0`, `GroupNorm_1`, `skip_proj`,
`qkv_proj`, ...) so that utils/params.load_flax_params maps a flax param
tree onto them mechanically. The numerics follow the JAX code: XLA SAME
padding, eps 1e-6, tanh-GELU, q and k each scaled by (C/n_head)^(-1/4)
with f32 attention scores.

Parameters start at zero (norm scales at one); fill them with
utils/params.random_init_ or load_flax_params.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import groupnorm1_gelu
from ..ops.groupnorm_grouped import grouped_gn_film_silu


def same_padding(t_len: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1) -> tuple[int, int]:
    """XLA SAME padding: total = max((out-1)*s + (k-1)*d + 1 - T, 0) with
    out = ceil(T/s), the lower half first."""
    out_len = -(-t_len // stride)
    total = max((out_len - 1) * stride + (kernel_size - 1) * dilation + 1 - t_len, 0)
    return total // 2, total - total // 2


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           stride: int = 1, dilation: int = 1):
    """(B, Cin, T) * (Cout, Cin, K) -> (B, Cout, ceil(T / stride)) with XLA
    SAME padding."""
    pad_l, pad_r = same_padding(x.shape[-1], weight.shape[-1], stride, dilation)
    if pad_l != pad_r:
        x = F.pad(x, (pad_l, pad_r))
        pad_l = 0
    return F.conv1d(x, weight, bias, stride=stride, padding=pad_l,
                    dilation=dilation)


class Conv1d(nn.Module):
    """1D conv with XLA SAME padding; flax kernel (K, Cin, Cout) maps to
    `weight` (Cout, Cin, K)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 5,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return conv1d(x, self.weight, self.bias, self.stride, self.dilation)


class Dense(nn.Module):
    """flax nn.Dense over the channel axis of (B, C, T); flax kernel
    (in, out) maps to `weight` (out, in)."""

    def __init__(self, c_in: int, c_out: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None

    def forward(self, x):
        y = torch.matmul(self.weight, x)
        return y if self.bias is None else y + self.bias[:, None]


class Linear(nn.Module):
    """flax nn.Dense over the last axis; flax kernel (in, out) maps to
    `weight` (out, in)."""

    def __init__(self, c_in: int, c_out: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis (eps 1e-6); flax scale/bias
    map to weight/bias."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups) on (B, C, T), with the FiLM
    modulation and SiLU of the MIRAGE UNet fused in, through kernel K5
    (ops/groupnorm_grouped.py). flax scale/bias map to weight/bias.
    film_scale / film_shift are (B, C) or None."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, film_scale=None, film_shift=None, silu: bool = True):
        return grouped_gn_film_silu(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                    self.groups, film_scale, film_shift, silu)


class ConvTranspose1d(nn.Module):
    """flax nn.ConvTranspose(padding="SAME", transpose_kernel=True) on
    (B, C, T): torch conv_transpose1d, cropped to lax.conv_transpose's SAME
    output of T * stride samples. The flax kernel (K, Cout, Cin) maps to
    `weight` (Cin, Cout, K)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(c_in, c_out, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        k, s = self.weight.shape[-1], self.stride
        pad_len = k + s - 2                       # lax.conv_transpose, SAME
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        left = k - 1 - pad_a                      # crop of the full output
        right = (k - 1) - (pad_len - pad_a)
        if left == right:
            return F.conv_transpose1d(x, self.weight, self.bias, stride=s, padding=left)
        y = F.conv_transpose1d(x, self.weight, self.bias, stride=s)
        return y[..., left:y.shape[-1] - right]


class FourierFeatures(nn.Module):
    """Random Fourier timestep embedding: t (B,) -> (B, out_features).
    `weight` is (out/2, 1), as in flax."""

    def __init__(self, out_features: int = 16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features // 2, 1))

    def forward(self, t):
        f = 2.0 * math.pi * t[:, None] * self.weight[None, :, 0]
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


class GroupNorm1(nn.Module):
    """GroupNorm(num_groups=1) [+ GELU] [+ residual], through kernel K1
    (ops/groupnorm.py). flax scale/bias map to weight/bias."""

    def __init__(self, channels: int, fuse_gelu: bool = False):
        super().__init__()
        self.fuse_gelu = fuse_gelu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, residual=None):
        return groupnorm1_gelu(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                               gelu=self.fuse_gelu, residual=residual)


class ResConvBlock(nn.Module):
    """conv5-GN-GELU-conv5-GN-GELU with a 1x1-projected residual (bias-free
    `skip_proj`, identity when c_in == c_out); is_last drops the final
    norm and activation."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, is_last: bool = False):
        super().__init__()
        self.is_last = is_last
        self.Conv1d_0 = Conv1d(c_in, c_mid, 5)
        self.GroupNorm_0 = GroupNorm1(c_mid, fuse_gelu=True)
        self.Conv1d_1 = Conv1d(c_mid, c_out, 5)
        if not is_last:
            self.GroupNorm_1 = GroupNorm1(c_out, fuse_gelu=True)
        self.skip_proj = Dense(c_in, c_out, use_bias=False) if c_in != c_out else None

    def forward(self, x):
        skip = x if self.skip_proj is None else self.skip_proj(x)
        h = self.GroupNorm_0(self.Conv1d_0(x))
        h = self.Conv1d_1(h)
        if self.is_last:
            return skip + h
        return self.GroupNorm_1(h, residual=skip)


class SelfAttention1d(nn.Module):
    """Pre-norm multi-head self-attention over time, with residual. qkv
    channels are laid out [q (all heads), k, v]; scores and softmax in f32,
    the softmax cast to v's dtype."""

    def __init__(self, channels: int, n_head: int = 1):
        super().__init__()
        self.n_head = n_head
        self.GroupNorm_0 = GroupNorm1(channels, fuse_gelu=False)
        self.qkv_proj = Dense(channels, 3 * channels)
        self.out_proj = Dense(channels, channels)

    def forward(self, x):
        b, c, t = x.shape
        hd = c // self.n_head
        qkv = self.qkv_proj(self.GroupNorm_0(x))
        q, k, v = (p.reshape(b, self.n_head, hd, t) for p in qkv.chunk(3, dim=1))
        scale = 1.0 / math.sqrt(math.sqrt(hd))
        att = torch.matmul((q * scale).float().transpose(-1, -2),
                           (k * scale).float())            # (b, h, t, s)
        att = torch.softmax(att, dim=-1).to(v.dtype)
        y = torch.matmul(v, att.transpose(-1, -2))         # (b, h, hd, t)
        return x + self.out_proj(y.reshape(b, c, t))


class _FixedTaps(nn.Module):
    """Depthwise [1,3,3,1]/norm taps, kept as a buffer so that they move
    with the module (a tensor built from a list per call would be a
    host-to-device copy that waits for the card at every resample)."""

    def __init__(self, norm: float):
        super().__init__()
        self.register_buffer("taps", torch.tensor([1.0, 3.0, 3.0, 1.0]) / norm,
                             persistent=False)

    def weight(self, x):
        return self.taps.to(x.dtype)[None, None, :].expand(x.shape[1], 1, 4).contiguous()


class Downsample1d(_FixedTaps):
    """x2 downsample: depthwise [1,3,3,1]/8, stride 2, padding (1, 1)."""

    def __init__(self):
        super().__init__(8.0)

    def forward(self, x):
        return F.conv1d(x, self.weight(x), stride=2, padding=1, groups=x.shape[1])


class Upsample1d(_FixedTaps):
    """x2 upsample: depthwise [1,3,3,1]/4 with lhs-dilation 2 and padding
    (2, 2), which is conv_transpose1d(stride=2, padding=1)."""

    def __init__(self):
        super().__init__(4.0)

    def forward(self, x):
        return F.conv_transpose1d(x, self.weight(x), stride=2, padding=1,
                                  groups=x.shape[1])


def timestep_broadcast(emb: torch.Tensor, t_len: int) -> torch.Tensor:
    """(B, C) embedding -> (B, C, T) broadcast along time."""
    return emb[:, :, None].expand(emb.shape[0], emb.shape[1], t_len)


def upsample_to(cond: torch.Tensor, t_len: int) -> torch.Tensor:
    """Nearest-upsample (B, C, n) along time to (B, C, t_len)."""
    b, c, n = cond.shape
    if n == t_len:
        return cond
    if t_len % n == 0:
        r = t_len // n
        return cond[:, :, :, None].expand(b, c, n, r).reshape(b, c, t_len)
    idx = torch.div(torch.arange(t_len, device=cond.device) * n, t_len,
                    rounding_mode="floor")
    return cond[:, :, idx]
