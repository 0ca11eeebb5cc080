"""Plain reference of the v-diffusion UNet DiffusionAttnUnet1D (the
Destructo decoder and MIRAGE's outer stage), float route only.

Every level j has a down stack and an up stack of three ResConvBlocks
(conv5 - GN(1) - GELU - conv5 - GN(1) - GELU, a 1x1 bias-free skip
projection where the width changes; the io head drops the last norm),
with self-attention after each block in the deepest `n_attn_layers`
levels. Stacks are `stack_000`... in forward order, their blocks m0..m5.
The input is [x, Fourier(t) broadcast, nearest-upsampled cond].
"""
from __future__ import annotations

import math

import torch

from .nn import (conv1d, dense, downsample, fourier_features, gn1_gelu, upsample,
                 upsample_nearest)


def res_conv_block(P, name, x, is_last: bool):
    skip = dense(P, f"{name}.skip_proj", x, bias=False) \
        if f"{name}.skip_proj.weight" in P else x
    h = conv1d(P, f"{name}.Conv1d_0", x)
    h = conv1d(P, f"{name}.Conv1d_1", gn1_gelu(P, f"{name}.GroupNorm_0", h, gelu=True))
    if is_last:
        return skip + h
    return gn1_gelu(P, f"{name}.GroupNorm_1", h, gelu=True, residual=skip)


def self_attention(P, name, x):
    b, c, t = x.shape
    n_head = max(1, c // 32)
    hd = c // n_head
    qkv = dense(P, f"{name}.qkv_proj", gn1_gelu(P, f"{name}.GroupNorm_0", x, gelu=False))
    q, k, v = (p.reshape(b, n_head, hd, t) for p in qkv.chunk(3, dim=1))
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    att = torch.softmax(torch.matmul((q * scale).transpose(-1, -2), k * scale), dim=-1)
    y = torch.matmul(v, att.transpose(-1, -2))
    return x + dense(P, f"{name}.out_proj", y.reshape(b, c, t))


def stack3(P, name, x, attn: bool, is_last: bool):
    x = res_conv_block(P, f"{name}.m0", x, False)
    if attn:
        x = self_attention(P, f"{name}.m1", x)
    x = res_conv_block(P, f"{name}.m2", x, False)
    if attn:
        x = self_attention(P, f"{name}.m3", x)
    x = res_conv_block(P, f"{name}.m4", x, is_last)
    if attn and not is_last:
        x = self_attention(P, f"{name}.m5", x)
    return x


def unet_forward(P, prefix, x, t, cond, depth: int, n_attn_layers: int):
    """x (B, io, T), t (B,), cond (B, cond_dim, n) or None -> v (B, io, T)."""
    attn_start = max(0, depth - n_attn_layers)
    t_len = x.shape[-1]
    emb = fourier_features(P, f"{prefix}.timestep_embed", t)
    parts = [x, emb[:, :, None].expand(*emb.shape, t_len)]
    if cond is not None:
        parts.append(upsample_nearest(cond, t_len))
    h = torch.cat(parts, dim=1)
    skips = []
    idx = 0
    for j in range(depth):
        h = stack3(P, f"{prefix}.stack_{idx:03d}", h, j >= attn_start, False)
        idx += 1
        if j < depth - 1:
            skips.append(h)
            h = downsample(h)
    for j in reversed(range(depth)):
        if j < depth - 1:
            h = torch.cat([upsample(h), skips.pop()], dim=1)
        h = stack3(P, f"{prefix}.stack_{idx:03d}", h, j >= attn_start, j == 0)
        idx += 1
    return h
