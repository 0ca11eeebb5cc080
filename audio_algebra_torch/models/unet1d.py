"""DiffusionAttnUnet1D — the v-diffusion decoder UNet, (B, C, T).

Port of audio_algebra_tpu/models/unet1d.py (bf16/f32 path; the turbo
int8 arguments are not ported). Every level carries a down-stack and an
up-stack of three ResConvBlocks (`_Stack3`), with self-attention after
each block in the deepest n_attn_layers levels. Stacks are named
stack_000... in forward order, their blocks m0..m5, as in flax.

The input is cat[x, Fourier features of t broadcast, nearest-upsampled
cond]; up-stacks consume cat[deep, skip].
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import (Downsample1d, FourierFeatures, ResConvBlock, SelfAttention1d,
                     Upsample1d, timestep_broadcast, upsample_to)


class _Stack3(nn.Module):
    """Three ResConvBlocks with optional self-attention after each; the
    third block maps to c_out (and is the io head when is_last)."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, attn: bool,
                 is_last: bool = False):
        super().__init__()
        self.attn, self.is_last = attn, is_last
        self.m0 = ResConvBlock(c_in, c_mid, c_mid)
        self.m2 = ResConvBlock(c_mid, c_mid, c_mid)
        self.m4 = ResConvBlock(c_mid, c_mid, c_out, is_last=is_last)
        if attn:
            self.m1 = SelfAttention1d(c_mid, max(1, c_mid // 32))
            self.m3 = SelfAttention1d(c_mid, max(1, c_mid // 32))
            if not is_last:
                self.m5 = SelfAttention1d(c_out, max(1, c_out // 32))

    def forward(self, x):
        x = self.m0(x)
        if self.attn:
            x = self.m1(x)
        x = self.m2(x)
        if self.attn:
            x = self.m3(x)
        x = self.m4(x)
        if self.attn and not self.is_last:
            x = self.m5(x)
        return x


class DiffusionAttnUnet1D(nn.Module):
    def __init__(self, io_channels: int = 2, cond_dim: int = 0,
                 n_attn_layers: int = 4,
                 c_mults: Sequence[int] = tuple([256, 256] + [512] * 12),
                 depth: int | None = None, pqmf_bands: int = 1,
                 timestep_features: int = 16):
        super().__init__()
        self.depth = depth or len(c_mults)
        c_mults = list(c_mults)[:self.depth]
        self.cond_dim = cond_dim
        n_io = io_channels * pqmf_bands
        attn_start = self.depth - n_attn_layers
        self.timestep_embed = FourierFeatures(timestep_features)
        self.down = Downsample1d()
        self.up = Upsample1d()
        c_in = n_io + timestep_features + cond_dim
        idx = 0
        for j in range(self.depth):
            setattr(self, f"stack_{idx:03d}",
                    _Stack3(c_in, c_mults[j], c_mults[j], attn=j >= attn_start))
            c_in = c_mults[j]
            idx += 1
        for j in reversed(range(self.depth)):
            c_out = c_mults[j - 1] if j > 0 else n_io
            c_in = c_mults[j] if j == self.depth - 1 else 2 * c_mults[j]
            setattr(self, f"stack_{idx:03d}",
                    _Stack3(c_in, c_mults[j], c_out, attn=j >= attn_start,
                            is_last=j == 0))
            idx += 1

    def forward(self, x, t, cond=None):
        """x (B, io, T), t (B,), cond (B, cond_dim, n) -> v (B, io, T)."""
        t_len = x.shape[-1]
        parts = [x, timestep_broadcast(self.timestep_embed(t), t_len)]
        if self.cond_dim > 0:
            if cond is None:
                raise ValueError("cond_dim > 0 requires a conditioning signal")
            parts.append(upsample_to(cond, t_len))
        h = torch.cat(parts, dim=1)
        idx = 0
        skips = []
        for j in range(self.depth):
            h = getattr(self, f"stack_{idx:03d}")(h)
            idx += 1
            if j < self.depth - 1:
                skips.append(h)
                h = self.down(h)
        for j in reversed(range(self.depth)):
            if j < self.depth - 1:
                h = torch.cat([self.up(h), skips.pop()], dim=1)
            h = getattr(self, f"stack_{idx:03d}")(h)
            idx += 1
        return h
