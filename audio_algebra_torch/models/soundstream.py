"""SoundStream-XL encoder and decoder (the DVAE's convolutional front-end
and the first-stage AudioAutoencoder), (B, C, T).

Port of audio_algebra_tpu/models/soundstream.py. Encoder: conv7 -> per
stage [3 dilated residual units (1, 3, 9) + ELU + strided conv of kernel
2*stride] -> ELU -> conv3 to latent_dim. Decoder: conv7 -> per stage
[ELU + transposed conv of kernel 2*stride (flax SAME, torch kernel
orientation) + 3 residual units] -> ELU -> conv7. Module names follow
flax (`l000`, `l001/u0/Conv1d_0`, ...).
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .blocks import Conv1d, ConvTranspose1d


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


class DecoderBlock(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int):
        super().__init__()
        self.u0 = ConvTranspose1d(c_in, features, 2 * stride, stride)
        for j, d in enumerate((1, 3, 9)):
            setattr(self, f"u{j + 1}", ResidualUnit(features, d))

    def forward(self, x):
        x = self.u0(F.elu(x))
        return self.u3(self.u2(self.u1(x)))


class SoundStreamXLDecoder(nn.Module):
    """(B, latent_dim, T') -> (B, out_channels, T' * prod(strides))."""

    def __init__(self, out_channels: int = 2, capacity: int = 32,
                 latent_dim: int = 64, c_mults: Sequence[int] = (2, 4, 8, 16, 32),
                 strides: Sequence[int] = (4, 4, 2, 2, 2)):
        super().__init__()
        c = capacity * c_mults[-1]
        self.l000 = Conv1d(latent_dim, c, 7)
        mults_next = list(c_mults[-2::-1]) + [1]
        self.n_blocks = len(mults_next)
        for i, (mult, stride) in enumerate(zip(mults_next, list(strides)[::-1])):
            setattr(self, f"l{i + 1:03d}", DecoderBlock(c, capacity * mult, stride))
            c = capacity * mult
        setattr(self, f"l{self.n_blocks + 1:03d}", Conv1d(c, out_channels, 7))

    def forward(self, latents):
        x = self.l000(latents)
        for i in range(self.n_blocks):
            x = getattr(self, f"l{i + 1:03d}")(x)
        return getattr(self, f"l{self.n_blocks + 1:03d}")(F.elu(x))
