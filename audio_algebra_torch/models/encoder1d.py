"""Encoder1d — the stage-2 latent encoder of the stacked diffusion AE.

Port of audio_algebra_tpu/models/encoder1d.py: in 32 -> out 32, channels
128, multipliers [1, 2, 4, 8, 8], factors [2] * 4, num_blocks [8] * 4
(downsampling ratio 16); conv-GroupNorm(8)-SiLU ResNet stages with
strided downsampling. Every GroupNorm + SiLU goes through kernel K5.
Modules are named l000, l001, ... in forward order, as in flax.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from .blocks import Conv1d, Dense, GroupNorm

GROUPS = 8


class _ResnetBlock1d(nn.Module):
    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(c_in, GROUPS)
        self.Conv1d_0 = Conv1d(c_in, features, 3)
        self.GroupNorm_1 = GroupNorm(features, GROUPS)
        self.Conv1d_1 = Conv1d(features, features, 3)
        self.Dense_0 = Dense(c_in, features, use_bias=False) if c_in != features else None

    def forward(self, x):
        h = self.Conv1d_0(self.GroupNorm_0(x))
        h = self.Conv1d_1(self.GroupNorm_1(h))
        return (x if self.Dense_0 is None else self.Dense_0(x)) + h


class Encoder1d(nn.Module):
    """(B, in_channels, T) -> (B, out_channels, T / prod(factors))."""

    def __init__(self, in_channels: int = 32, out_channels: int = 32,
                 channels: int = 128, multipliers: Sequence[int] = (1, 2, 4, 8, 8),
                 factors: Sequence[int] = (2, 2, 2, 2),
                 num_blocks: Sequence[int] = (8, 8, 8, 8)):
        super().__init__()
        layers = [Conv1d(in_channels, channels * multipliers[0], 7)]
        for i, (factor, blocks) in enumerate(zip(factors, num_blocks)):
            feats = channels * multipliers[i]
            layers += [_ResnetBlock1d(feats, feats) for _ in range(blocks)]
            layers.append(Conv1d(feats, channels * multipliers[i + 1], 2 * factor,
                                 stride=factor))
        c = channels * multipliers[len(factors)]
        layers += [GroupNorm(c, GROUPS), Conv1d(c, out_channels, 3)]
        for idx, layer in enumerate(layers):
            setattr(self, f"l{idx:03d}", layer)
        self.n_layers = len(layers)

    def forward(self, x):
        for idx in range(self.n_layers):
            x = getattr(self, f"l{idx:03d}")(x)
        return x
