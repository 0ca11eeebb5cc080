"""SoundStream-XL encoder (the DVAE's convolutional front-end), (B, C, T).

Port of audio_algebra_tpu/models/soundstream.py: conv7 -> per stage
[3 dilated residual units (1, 3, 9) + ELU + strided conv of kernel
2*stride] -> ELU -> conv3 to latent_dim. Module names follow flax
(`l000`, `l001/u0/Conv1d_0`, ...). The decoder comes with a later slice.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .blocks import Conv1d


class ResidualUnit(nn.Module):
    def __init__(self, features: int, dilation: int):
        super().__init__()
        self.Conv1d_0 = Conv1d(features, features, 7, dilation=dilation)
        self.Conv1d_1 = Conv1d(features, features, 1)

    def forward(self, x):
        h = self.Conv1d_0(F.elu(x))
        h = self.Conv1d_1(F.elu(h))
        return x + h


class EncoderBlock(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int):
        super().__init__()
        for j, d in enumerate((1, 3, 9)):
            setattr(self, f"u{j}", ResidualUnit(c_in, d))
        self.u3 = Conv1d(c_in, features, 2 * stride, stride=stride)

    def forward(self, x):
        x = self.u2(self.u1(self.u0(x)))
        return self.u3(F.elu(x))


class SoundStreamXLEncoder(nn.Module):
    """(B, C_in, T) -> (B, latent_dim, T / prod(strides))."""

    def __init__(self, in_channels: int = 2, capacity: int = 32,
                 latent_dim: int = 64, c_mults: Sequence[int] = (2, 4, 8, 16, 32),
                 strides: Sequence[int] = (4, 4, 2, 2, 2)):
        super().__init__()
        self.l000 = Conv1d(in_channels, capacity, 7)
        c = capacity
        self.n_blocks = len(c_mults)
        for i, (mult, stride) in enumerate(zip(c_mults, strides)):
            setattr(self, f"l{i + 1:03d}", EncoderBlock(c, capacity * mult, stride))
            c = capacity * mult
        setattr(self, f"l{self.n_blocks + 1:03d}", Conv1d(c, latent_dim, 3))

    def forward(self, audio):
        x = self.l000(audio)
        for i in range(self.n_blocks):
            x = getattr(self, f"l{i + 1:03d}")(x)
        return getattr(self, f"l{self.n_blocks + 1:03d}")(F.elu(x))
