"""DMAE — archinet's DiffusionAE: MelE1d latents injected into an
LTPlugin-wrapped UNetV0 v-diffusion decoder.

Port of audio_algebra_tpu/models/dmae.py, channels-first (B, C, T). The
reference's DMAE1d (the defaults here):

    UNet = LTPlugin(UNetV0, num_filters=128, window_length=128, stride=64)
    DiffusionAE(channels=[256, 512, 512, 512, 1024, 1024, 1024],
                factors=[1, 2, 2, 2, 2, 2, 2], items=[1, 2, 2, 2, 2, 2, 2],
                linear_attentions=[0, 1, 1, 1, 1, 1, 1],
                attention_features=64, attention_heads=8, inject_depth=4,
                encoder=MelE1d(channels=512, multipliers=[1, 1, 1],
                               factors=[2, 2], num_blocks=[4, 8],
                               mel_channels=80, out_channels=32, ...))

UNetV0 runs, per level, `items` repetitions of [Resnet, time modulation
(AdaGN), latent injection (at inject_depth), linear attention] on the way
down and up, around strided-conv downsampling, concatenated skips and
transposed-conv upsampling. Modules are named n000, n001, ... in forward
order and the items' parts keep flax's auto-names, so the flax bridge and
the checkpoint pour see JAX's paths.

The mel front end is the port's `ops/mel.melspectrogram(center=False)`
after a reflect pre-pad of (n_fft - hop) / 2, so exactly T / hop frames:
on a CUDA tensor its STFT is kernel K6. The UNet's GroupNorms are flax
nn.GroupNorm in JAX (no Pallas kernel), so here plain torch group_norm
(blocks.PlainGroupNorm, eps 1e-6); the MelE1d tower is the port's
Encoder1d.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mel import melspectrogram
from ..ops.stft import reflect_pad
from .blocks import Conv1d, ConvTranspose1d, FourierFeatures, Linear, PlainGroupNorm
from .encoder1d import Encoder1d


class _ResnetItem(nn.Module):
    """GN-SiLU-conv3 twice, plus the input (1x1-projected, bias-free, where
    the channels change: the up path's 2c -> c after the skip concat)."""

    def __init__(self, c_in: int, features: int, groups: int = 8):
        super().__init__()
        self.GroupNorm_0 = PlainGroupNorm(c_in, groups)
        self.Conv1d_0 = Conv1d(c_in, features, 3)
        self.GroupNorm_1 = PlainGroupNorm(features, groups)
        self.Conv1d_1 = Conv1d(features, features, 3)
        self.Conv1d_2 = Conv1d(c_in, features, 1, use_bias=False) if c_in != features else None

    def forward(self, x):
        h = self.Conv1d_0(F.silu(self.GroupNorm_0(x)))
        h = self.Conv1d_1(F.silu(self.GroupNorm_1(h)))
        return (x if self.Conv1d_2 is None else self.Conv1d_2(x)) + h


class _ModulationItem(nn.Module):
    """AdaGN time modulation: GroupNorm without affine, then
    (1 + scale) h + shift from the shared modulation embedding."""

    def __init__(self, c: int, modulation_features: int, groups: int = 8):
        super().__init__()
        self.Dense_0 = Linear(modulation_features, 2 * c)
        self.GroupNorm_0 = PlainGroupNorm(c, groups, affine=False)

    def forward(self, x, emb):
        s, b = self.Dense_0(F.silu(emb))[:, :, None].chunk(2, dim=1)   # (B, c, 1) each
        return self.GroupNorm_0(x) * (1 + s) + b


class _InjectItem(nn.Module):
    """Concatenate the encoder latent along channels and 1x1-conv back to c
    (DiffusionAE's context at inject_depth)."""

    def __init__(self, c: int, ctx_channels: int):
        super().__init__()
        self.Conv1d_0 = Conv1d(c + ctx_channels, c, 1)

    def forward(self, x, ctx):
        if ctx.shape[-1] != x.shape[-1]:
            raise ValueError(f"inject length {ctx.shape[-1]} != level length {x.shape[-1]}")
        return self.Conv1d_0(torch.cat([x, ctx.to(x.dtype)], dim=1))


class _LinearAttentionItem(nn.Module):
    """Pre-norm linear attention with residual: q softmaxed over features,
    k over time, in f32; O(T) memory."""

    def __init__(self, c: int, heads: int = 8, head_features: int = 64):
        super().__init__()
        self.heads, self.head_features = heads, head_features
        inner = heads * head_features
        self.GroupNorm_0 = PlainGroupNorm(c, 1)
        self.to_q = Linear(c, inner, use_bias=False)
        self.to_k = Linear(c, inner, use_bias=False)
        self.to_v = Linear(c, inner, use_bias=False)
        self.to_out = Linear(inner, c)

    def forward(self, x):
        b, c, t = x.shape
        hd, nh = self.head_features, self.heads
        h = self.GroupNorm_0(x).transpose(1, 2)                    # (B, T, C)
        q, k, v = (p(h).reshape(b, t, nh, hd) for p in (self.to_q, self.to_k, self.to_v))
        q = torch.softmax(q.float(), dim=-1) * (hd ** -0.5)
        k = torch.softmax(k.float(), dim=1)
        ctx = torch.einsum("bshd,bshe->bhde", k, v.float())
        y = torch.einsum("bthd,bhde->bthe", q, ctx).to(x.dtype)
        return x + self.to_out(y.reshape(b, t, nh * hd)).transpose(1, 2)


class UNetV0(nn.Module):
    """a-unet's UNetV0: (B, in_channels, T) x t (B,) [x context (B, Cc, Tc)]
    -> (B, out_channels, T)."""

    def __init__(self, in_channels: int = 128, out_channels: Optional[int] = None,
                 channels: Sequence[int] = (256, 512, 512, 512, 1024, 1024, 1024),
                 factors: Sequence[int] = (1, 2, 2, 2, 2, 2, 2),
                 items: Sequence[int] = (1, 2, 2, 2, 2, 2, 2),
                 linear_attentions: Sequence[int] = (0, 1, 1, 1, 1, 1, 1),
                 context_channels: Sequence[int] = (0, 0, 0, 0, 32, 0, 0),
                 attention_features: int = 64, attention_heads: int = 8,
                 resnet_groups: int = 8, modulation_features: int = 1024):
        super().__init__()
        n = len(channels)
        if not (len(factors) == len(items) == len(linear_attentions)
                == len(context_channels) == n):
            raise ValueError("channels, factors, items, linear_attentions and "
                             "context_channels must have one entry a level")
        self.needs_context = any(context_channels)
        self.time_ff = FourierFeatures(256)
        self.time_mlp_0 = Linear(256, modulation_features)
        self.time_mlp_1 = Linear(modulation_features, modulation_features)
        # (kind, module name) in forward order; "push" / "cat" move a skip
        self.plan: list[tuple[str, Optional[str]]] = []
        n_modules = 0

        def add(kind: str, module: nn.Module):
            nonlocal n_modules
            name = f"n{n_modules:03d}"
            n_modules += 1
            self.add_module(name, module)
            self.plan.append((kind, name))

        def level_items(i: int, c_in: int):
            c = channels[i]
            for _ in range(items[i]):
                add("res", _ResnetItem(c_in, c, resnet_groups))
                c_in = c
                add("mod", _ModulationItem(c, modulation_features, resnet_groups))
                if context_channels[i]:
                    add("inj", _InjectItem(c, context_channels[i]))
                for _ in range(linear_attentions[i]):
                    add("att", _LinearAttentionItem(c, attention_heads, attention_features))

        prev = in_channels
        for i in range(n):                          # down: strided conv + items
            f = factors[i]
            add("op", Conv1d(prev, channels[i], 2 * f if f > 1 else 1, stride=f))
            prev = channels[i]
            level_items(i, prev)
            if i < n - 1:
                self.plan.append(("push", None))
        for i in reversed(range(n)):                # up: (cat skip) + items + up conv
            if i < n - 1:
                self.plan.append(("cat", None))
            level_items(i, 2 * channels[i] if i < n - 1 else channels[i])
            c_out = (out_channels or in_channels) if i == 0 else channels[i - 1]
            f = factors[i]
            add("op", ConvTranspose1d(channels[i], c_out, 2 * f, f) if f > 1
                else Conv1d(channels[i], c_out, 1))

    def forward(self, x, t, context=None):
        if self.needs_context and context is None:
            raise ValueError("this UNetV0 expects a context latent")
        emb = self.time_mlp_1(F.silu(self.time_mlp_0(self.time_ff(t)))).to(x.dtype)
        h, skips = x, []
        for kind, name in self.plan:
            if kind == "push":
                skips.append(h)
            elif kind == "cat":
                h = torch.cat([h, skips.pop()], dim=1)
            elif kind == "mod":
                h = getattr(self, name)(h, emb)
            elif kind == "inj":
                h = getattr(self, name)(h, context)
            else:
                h = getattr(self, name)(h)
        return h


class LearnedTransform(nn.Module):
    """LTPlugin's learned frame transform: analysis = strided conv audio ->
    (B, num_filters, T / stride); synthesis = transposed conv back."""

    def __init__(self, num_filters: int = 128, window_length: int = 128, stride: int = 64,
                 audio_channels: int = 2):
        super().__init__()
        self.lt_in = Conv1d(audio_channels, num_filters, window_length, stride=stride)
        self.lt_out = ConvTranspose1d(num_filters, audio_channels, window_length, stride)

    def analysis(self, audio):
        return self.lt_in(audio)

    def synthesis(self, h):
        return self.lt_out(h)

    def forward(self, audio):
        return self.synthesis(self.analysis(audio))


class MelE1d(nn.Module):
    """audio_encoders_pytorch's MelE1d: log-mel front end -> Encoder1d tower
    -> tanh bottleneck. Latents at hop * prod(factors) of the audio rate."""

    def __init__(self, in_channels: int = 2, channels: int = 512,
                 multipliers: Sequence[int] = (1, 1, 1), factors: Sequence[int] = (2, 2),
                 num_blocks: Sequence[int] = (4, 8), out_channels: int = 32,
                 mel_channels: int = 80, sample_rate: int = 44100, n_fft: int = 1024,
                 hop: int = 256):
        super().__init__()
        self.mel_channels, self.sample_rate, self.n_fft, self.hop = \
            mel_channels, sample_rate, n_fft, hop
        self.tower = Encoder1d(in_channels=in_channels * mel_channels,
                               out_channels=out_channels, channels=channels,
                               multipliers=tuple(multipliers), factors=tuple(factors),
                               num_blocks=tuple(num_blocks))

    def mel(self, audio):
        """(B, C, T) -> (B, C * mel, T / hop) log-mels: center=False after a
        reflect pre-pad of (n_fft - hop) / 2, exactly T / hop frames. The
        pre-pad is numpy's reflect (ops/stft.reflect_pad), so a clip no
        longer than the pad is padded as JAX's jnp.pad pads it."""
        p = (self.n_fft - self.hop) // 2
        x = reflect_pad(audio, p)
        m = melspectrogram(x, self.sample_rate, self.n_fft, self.hop,
                           n_mels=self.mel_channels, center=False)
        m = torch.log(torch.clamp(m, min=1e-5))              # mel_normalize_log
        return m.reshape(m.shape[0], -1, m.shape[-1])

    def encode_mel(self, logmel):
        return torch.tanh(self.tower(logmel))                # TanhBottleneck

    def forward(self, audio):
        return self.encode_mel(self.mel(audio))


class DiffusionAE1d(nn.Module):
    """DiffusionAE: MelE1d latents injected into an LT-wrapped UNetV0."""

    def __init__(self, in_channels: int = 2,
                 channels: Sequence[int] = (256, 512, 512, 512, 1024, 1024, 1024),
                 factors: Sequence[int] = (1, 2, 2, 2, 2, 2, 2),
                 items: Sequence[int] = (1, 2, 2, 2, 2, 2, 2),
                 linear_attentions: Sequence[int] = (0, 1, 1, 1, 1, 1, 1),
                 attention_features: int = 64, attention_heads: int = 8,
                 inject_depth: int = 4, latent_dim: int = 32, resnet_groups: int = 8,
                 num_filters: int = 128, window_length: int = 128, lt_stride: int = 64,
                 enc_channels: int = 512, enc_multipliers: Sequence[int] = (1, 1, 1),
                 enc_factors: Sequence[int] = (2, 2), enc_num_blocks: Sequence[int] = (4, 8),
                 n_mels: int = 80, sample_rate: int = 44100, mel_n_fft: int = 1024,
                 mel_hop: int = 256):
        super().__init__()
        self.downsampling_ratio = mel_hop
        for f in enc_factors:
            self.downsampling_ratio *= f
        unet_rate = lt_stride
        for f in factors[:inject_depth + 1]:
            unet_rate *= f
        if unet_rate != self.downsampling_ratio:   # the latent must meet its level's rate
            raise ValueError(f"UNet rate {unet_rate} at inject_depth != mel-encoder rate "
                             f"{self.downsampling_ratio}")
        self.encoder = MelE1d(in_channels=in_channels, channels=enc_channels,
                              multipliers=enc_multipliers, factors=enc_factors,
                              num_blocks=enc_num_blocks, out_channels=latent_dim,
                              mel_channels=n_mels, sample_rate=sample_rate, n_fft=mel_n_fft,
                              hop=mel_hop)
        self.lt = LearnedTransform(num_filters, window_length, lt_stride, in_channels)
        ctx = [0] * len(channels)
        ctx[inject_depth] = latent_dim
        self.unet = UNetV0(in_channels=num_filters, channels=channels, factors=factors,
                           items=items, linear_attentions=linear_attentions,
                           context_channels=ctx, attention_features=attention_features,
                           attention_heads=attention_heads, resnet_groups=resnet_groups)

    def encode(self, audio):
        """(B, C, T) -> (B, latent_dim, T / downsampling_ratio) in [-1, 1]."""
        return self.encoder(audio)

    def decode_v(self, x, t, latent):
        """One v-diffusion step on audio x: LT analysis -> UNetV0 (latent
        injected at inject_depth) -> LT synthesis."""
        return self.lt.synthesis(self.unet(self.lt.analysis(x), t, context=latent))

    def forward(self, audio, t):
        return self.decode_v(audio, t, self.encode(audio))
