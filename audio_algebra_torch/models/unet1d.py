"""DiffusionAttnUnet1D — the v-diffusion decoder UNet, (B, C, T).

Port of audio_algebra_tpu/models/unet1d.py, with its turbo int8 route.
Every level carries a down-stack and an up-stack of three ResConvBlocks
(`_Stack3`), with self-attention after each block in the deepest
n_attn_layers levels. Stacks are named stack_000... in forward order, their
blocks m0..m5, as in flax.

The input is cat[x, Fourier features of t broadcast, nearest-upsampled
cond]; up-stacks consume cat[deep, skip] (in turbo, the pair of parts).

Turbo (`forward(..., turbo=True)`, batch >= turbo_min_b): the blocks run
their int8 route (blocks.ResConvBlock), and each stack without attention
threads the per-channel |h| bound of its blocks' outputs (K2b) so that the
next conv1 quantises on it. The amax carry: with `q_aux`, the previous
sampler step's bounds of each stack's first two blocks, those blocks' GN_1
also emit the int8 twin of their output on that grid (K2c), and the next
conv1 reads it directly. `collect_q_aux=True` returns this step's bounds.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import (TURBO_MIN_B, Downsample1d, FourierFeatures, ResConvBlock,
                     SelfAttention1d, Upsample1d, timestep_broadcast, turbo_batch_ok,
                     upsample_to)

QUANT_CARRY_MARGIN = 1.25   # headroom over the previous step's amax; the
                            # int8 clip absorbs a rarer larger drift


def _q_scale(bound: torch.Tensor) -> torch.Tensor:
    """The carried int8 grid: max(bound, 1e-6) * margin / 127, in f32."""
    return torch.clamp(bound.float(), min=1e-6) * QUANT_CARRY_MARGIN / 127.0


class _Stack3(nn.Module):
    """Three ResConvBlocks with optional self-attention after each; the
    third block maps to c_out (and is the io head when is_last).

    Returns (x, amax, q_amaxes) as JAX `_Stack3`: with `turbo` and no
    attention, amax bounds the output per channel and q_amaxes is this
    step's (amax of m0, amax of m2) for the next step's grids; otherwise
    both are None. `q_in` is the previous step's q_amaxes (the carry)."""

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

    def forward(self, x, x_amax=None, q_in=None, turbo: bool = False):
        emit = turbo and not self.attn
        carry = emit and q_in is not None
        a1 = a2 = xq = None
        if carry:
            x, a1, xq = self.m0(x, x_amax=x_amax, q_emit_scale=_q_scale(q_in[0]), turbo=turbo)
        elif emit:
            x, a1 = self.m0(x, x_amax=x_amax, emit_amax=True, turbo=turbo)
        else:
            x = self.m0(x, x_amax=x_amax, turbo=turbo)
        if self.attn:
            x = self.m1(x)
        if carry:
            x, a2, xq = self.m2(x, x_amax=a1, x_q=xq, q_emit_scale=_q_scale(q_in[1]),
                                turbo=turbo)
        elif emit:
            x, a2 = self.m2(x, x_amax=a1, emit_amax=True, turbo=turbo)
        else:
            x = self.m2(x, turbo=turbo)
        if self.attn:
            x = self.m3(x)
        a = None
        if emit:
            x, a = self.m4(x, x_amax=a2, x_q=xq, emit_amax=True, turbo=turbo)
        else:
            x = self.m4(x, turbo=turbo)
        if self.attn and not self.is_last:
            x = self.m5(x)
        return x, a, ((a1, a2) if emit else None)


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

    def forward(self, x, t, cond=None, q_aux=None, collect_q_aux: bool = False,
                turbo: bool = False, turbo_min_b: int = TURBO_MIN_B):
        """x (B, io, T), t (B,), cond (B, cond_dim, n) -> v (B, io, T).

        `turbo` runs the int8 route when B >= turbo_min_b (JAX: the env
        vars AA_TURBO_INT8 and AA_TURBO_MIN_B). `q_aux` is the tuple this
        UNet returned on the previous sampler step with `collect_q_aux`,
        which makes the return (v, q_aux_out)."""
        t_len = x.shape[-1]
        turbo = turbo and turbo_batch_ok(x.shape[0], turbo_min_b)
        parts = [x, timestep_broadcast(self.timestep_embed(t), t_len)]
        if self.cond_dim > 0:
            if cond is None:
                raise ValueError("cond_dim > 0 requires a conditioning signal")
            parts.append(upsample_to(cond, t_len))
        h = torch.cat(parts, dim=1)
        idx = 0
        skips, q_out = [], []
        a = None

        def stack(h, a):
            out = getattr(self, f"stack_{idx:03d}")(
                h, x_amax=a, q_in=None if q_aux is None else q_aux[idx], turbo=turbo)
            q_out.append(out[2])
            return out[0], out[1]

        # the amax survives Downsample1d / Upsample1d: their [1,3,3,1] taps are
        # non-negative and sum to 1, so each output is a convex combination
        for j in range(self.depth):
            h, a = stack(h, a)
            idx += 1
            if j < self.depth - 1:
                skips.append((h, a))
                h = self.down(h)
        for j in reversed(range(self.depth)):
            if j < self.depth - 1:
                h_skip, a_skip = skips.pop()
                if turbo:               # the split skip join, as JAX
                    a = (a, a_skip) if a is not None and a_skip is not None else None
                    h = (self.up(h), h_skip)
                else:
                    h = torch.cat([self.up(h), h_skip], dim=1)
            h, a = stack(h, a)
            idx += 1
        return (h, tuple(q_out)) if collect_q_aux else h
