"""UNetCFG1d — the CLAP-conditioned latent-diffusion UNet with CFG, (B, C, T).

Port of audio_algebra_tpu/models/unet_cfg1d.py (the MIRAGE inner UNet, the
reference's "songs" configuration by default: in_channels 32, context
512 x 1, channels 256, multipliers [2,3,4,4,4,4], factors [1,2,2,4,4],
num_blocks [3]*5, attentions [0,0,2,2,2,2], 16 heads x 64 features,
rel-pos buckets 256 / max distance 2048, skip scaling, context time).
Module and parameter names follow flax (`core/down_res0_0/GroupNorm_0`,
`core/mid_attn5_0/RelPosSelfAttention_0/rel_pos_bias`, `time_mlp1`,
`down_conv{i}`, `up_conv{i}`, `fixed_embedding`, ...) so that
utils/params.load_flax_params maps a flax tree onto the module. The TPU
sequence folds (pick_cfg_fold, _fold_halo, _fold_conv) are not ported.

Activations are (B, C, T) between convolutions; the transformer blocks
work in (B, T, C) inside. Every GroupNorm (+ FiLM + SiLU) goes through
kernel K5; every rel-pos self-attention site with flash_ok(T) through
kernel K3, with the transposed bias; the other sites, the cross-attention,
the feed-forward and the convolutions stay plain PyTorch, as they were
XLA in JAX. Sampling with CFG runs cond and null in one doubled batch and
returns null + s * (cond - null).

Training. With grad enabled and no hoisted bias, a self-attention site
with flash_train_ok(T) builds its transposed bias inside the graph and
goes through the differentiable kernels K4 (`train_flash`, default on:
JAX's AA_TRAIN_FLASH=1). `embedding_mask_proba` / `keep` is the CFG
dropout of the conditioning, drawn from an explicit generator or given.
`remat` recomputes each ResnetBlock and TransformerBlock in the backward
(JAX's AA_LDM_REMAT=1), off by default.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import (flash_attention_relpos, flash_attention_relpos_train,
                                   flash_ok, flash_train_ok)
from ..ops.groupnorm import gelu_tanh
from .blocks import Conv1d, ConvTranspose1d, Dense, GroupNorm, LayerNorm, Linear


class TransposedBias(NamedTuple):
    """A hoisted rel-pos bias stored TRANSPOSED, (H, S, T), for kernel K3.
    RelPosSelfAttention dispatches on the type, so a plain (H, T, S) bias
    is never read in the wrong orientation."""
    arr: torch.Tensor


def sinusoidal_embedding(t: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """[cos, sin] of t * freqs * 1000, in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5 bidirectional relative-position bucketing, with the bucket of a
    large distance from an f32 log truncated to an integer, as in JAX."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.clamp(min=1).float() / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def toeplitz_rel_pos_bias(bias_table: torch.Tensor, t: int, num_buckets: int,
                          max_distance: int, transposed: bool = False) -> torch.Tensor:
    """(num_buckets, H) bucket table -> (H, T, S) rel-pos bias,
    bias[h, t, s] = table[bucket(s - t), h]; with `transposed` the
    (H, S, T) transpose, M[h, r, c] = table[bucket(r - c), h]. The buckets
    are computed on the CPU (bit-equal to JAX's), then one gather of the
    (2T - 1)-long diagonal profile builds the table on its own device."""
    delta = torch.arange(-(t - 1), t)                      # rel = s - t
    if transposed:
        delta = -delta
    buckets = _relative_position_bucket(delta, num_buckets, max_distance)
    diag = bias_table[buckets.to(bias_table.device)].t()  # (H, 2T-1)
    ar = torch.arange(t, device=bias_table.device)
    return diag[:, ar[None, :] - ar[:, None] + (t - 1)]    # (H, T, S)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, H*D) -> contiguous (B, H, T, D)."""
    b, t, _ = x.shape
    return x.view(b, t, heads, -1).transpose(1, 2).contiguous()


def _plain_attention(q, k, v, bias=None):
    """softmax(q kᵀ [+ bias]) v on (B, H, T, D), q already scaled: f32
    scores, the softmax cast to v's dtype (the JAX XLA route)."""
    att = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        att = att + bias.float()[None]
    return torch.matmul(torch.softmax(att, dim=-1).to(v.dtype), v)


class RelPosSelfAttention(nn.Module):
    """Pre-LayerNorm self-attention with a T5 rel-pos bias, on (B, T, C).
    With grad enabled, no hoisted bias and flash_train_ok(T): the
    differentiable kernels K4, the transposed bias built in the graph so
    that its gradient reaches the bucket table (`train_flash`, JAX's
    AA_TRAIN_FLASH). Else kernel K3 when flash_ok(T) and nothing needs a
    gradient: grad off, or a hoisted TransposedBias and no input that
    requires grad (JAX's "auto" gate). Else the plain route of
    unet_cfg1d.py:240-256 (q scaled in x's dtype, f32 scores), which is
    also JAX's training route under AA_TRAIN_FLASH=0."""

    def __init__(self, channels: int, heads: int, head_features: int,
                 num_buckets: int = 256, max_distance: int = 2048,
                 train_flash: bool = True):
        super().__init__()
        inner = heads * head_features
        self.heads, self.head_features = heads, head_features
        self.train_flash = train_flash
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.LayerNorm_0 = LayerNorm(channels)
        self.Dense_0 = Linear(channels, inner, use_bias=False)
        self.Dense_1 = Linear(channels, inner, use_bias=False)
        self.Dense_2 = Linear(channels, inner, use_bias=False)
        self.Dense_3 = Linear(inner, channels)
        self.rel_pos_bias = nn.Parameter(torch.zeros(num_buckets, heads))

    def _bias(self, t: int, transposed: bool) -> torch.Tensor:
        return toeplitz_rel_pos_bias(self.rel_pos_bias, t, self.num_buckets,
                                     self.max_distance, transposed)

    def forward(self, x, bias=None):
        b, t, _ = x.shape
        h = self.LayerNorm_0(x)
        q, k, v = (_heads(d(h), self.heads) for d in (self.Dense_0, self.Dense_1,
                                                      self.Dense_2))
        scale = self.head_features ** -0.5
        grad = torch.is_grad_enabled()
        if self.train_flash and bias is None and grad and flash_train_ok(t):
            bias_t = self._bias(t, transposed=True).to(x.dtype).contiguous()
            y = flash_attention_relpos_train(q, k, v, bias_t, scale)
        elif flash_ok(t) and (not grad or (isinstance(bias, TransposedBias) and not any(
                a.requires_grad for a in (q, k, v, bias.arr)))):
            if isinstance(bias, TransposedBias):
                bias_t = bias.arr
            elif bias is None:
                bias_t = self._bias(t, transposed=True)
            else:
                bias_t = bias.transpose(1, 2)
            y = flash_attention_relpos(q, k, v, bias_t.to(x.dtype).contiguous(), scale)
        else:
            if isinstance(bias, TransposedBias):
                bias = bias.arr.transpose(1, 2)
            elif bias is None:
                bias = self._bias(t, transposed=False)
            y = _plain_attention(q * scale, k, v, bias)
        return x + self.Dense_3(y.transpose(1, 2).reshape(b, t, -1))


class CrossAttention(nn.Module):
    """Pre-LayerNorm attention from (B, T, C) to the (B, L, E) context."""

    def __init__(self, channels: int, context_features: int, heads: int,
                 head_features: int):
        super().__init__()
        inner = heads * head_features
        self.heads, self.head_features = heads, head_features
        self.LayerNorm_0 = LayerNorm(channels)
        self.LayerNorm_1 = LayerNorm(context_features)
        self.Dense_0 = Linear(channels, inner, use_bias=False)
        self.Dense_1 = Linear(context_features, inner, use_bias=False)
        self.Dense_2 = Linear(context_features, inner, use_bias=False)
        self.Dense_3 = Linear(inner, channels)

    def forward(self, x, context):
        b, t, _ = x.shape
        h = self.LayerNorm_0(x)
        ctx = self.LayerNorm_1(context)
        q = _heads(self.Dense_0(h), self.heads)
        k = _heads(self.Dense_1(ctx), self.heads)
        v = _heads(self.Dense_2(ctx), self.heads)
        y = _plain_attention(q * self.head_features ** -0.5, k, v)
        return x + self.Dense_3(y.transpose(1, 2).reshape(b, t, -1))


class FeedForward(nn.Module):
    def __init__(self, channels: int, multiplier: int = 4):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(channels)
        self.Dense_0 = Linear(channels, channels * multiplier)
        self.Dense_1 = Linear(channels * multiplier, channels)

    def forward(self, x):
        return x + self.Dense_1(gelu_tanh(self.Dense_0(self.LayerNorm_0(x))))


class TransformerBlock(nn.Module):
    """Rel-pos self-attention, cross-attention, feed-forward; takes and
    returns (B, C, T), works in (B, T, C)."""

    def __init__(self, channels: int, context_features: int, heads: int,
                 head_features: int, multiplier: int, num_buckets: int,
                 max_distance: int, train_flash: bool = True):
        super().__init__()
        self.RelPosSelfAttention_0 = RelPosSelfAttention(
            channels, heads, head_features, num_buckets, max_distance, train_flash)
        self.CrossAttention_0 = CrossAttention(channels, context_features, heads,
                                               head_features)
        self.FeedForward_0 = FeedForward(channels, multiplier)

    def forward(self, x, context, rel_bias=None):
        h = x.transpose(1, 2)
        h = self.RelPosSelfAttention_0(h, bias=rel_bias)
        h = self.CrossAttention_0(h, context)
        return self.FeedForward_0(h).transpose(1, 2).contiguous()


class ResnetBlock(nn.Module):
    """GN-SiLU-conv3, time FiLM (scale, shift) into GN-SiLU, conv3, plus
    the (projected) skip. The norms are blocks.GroupNorm, the port of
    GroupNormFoldable, always fused through kernel K5 (the JAX module's
    AA_LDM_GN=1 route)."""

    def __init__(self, c_in: int, features: int, groups: int, time_features: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(c_in, groups)
        self.Conv1d_0 = Conv1d(c_in, features, 3)
        self.Dense_0 = Linear(time_features, 2 * features)
        self.GroupNorm_1 = GroupNorm(features, groups)
        self.Conv1d_1 = Conv1d(features, features, 3)
        self.Dense_1 = Dense(c_in, features, use_bias=False) if c_in != features else None

    def forward(self, x, time_emb):
        h = self.Conv1d_0(self.GroupNorm_0(x))
        scale, shift = self.Dense_0(F.silu(time_emb)).chunk(2, dim=1)
        h = self.Conv1d_1(self.GroupNorm_1(h, scale, shift))
        skip = x if self.Dense_1 is None else self.Dense_1(x)
        return skip + h


class _UNetCore(nn.Module):
    """The UNet body, called once per forward (with a doubled batch under
    CFG). With `remat`, and grad enabled, each ResnetBlock and
    TransformerBlock keeps only its inputs and is recomputed in the
    backward (torch.utils.checkpoint)."""

    def __init__(self, cfg: "UNetCFG1dConfig", train_flash: bool = True,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        ch, mults = cfg.channels, cfg.multipliers
        n_levels = len(mults)
        tf = 4 * ch
        if cfg.use_context_time:
            self.time_mlp1 = Linear(ch, tf)
            self.time_mlp2 = Linear(tf, tf)
        self.init_conv = Conv1d(cfg.in_channels, ch * mults[0], 7)

        def add_level(c_in: int, i: int, stage: str) -> int:
            feats = ch * mults[i]
            for j in range(self._n_blocks(i)):
                setattr(self, f"{stage}_res{i}_{j}",
                        ResnetBlock(c_in, feats, cfg.resnet_groups, tf))
                c_in = feats
            for j in range(cfg.attentions[i]):
                setattr(self, f"{stage}_attn{i}_{j}", TransformerBlock(
                    feats, cfg.context_embedding_features, cfg.attention_heads,
                    cfg.attention_features, cfg.attention_multiplier,
                    cfg.attention_rel_pos_num_buckets,
                    cfg.attention_rel_pos_max_distance, train_flash))
            return feats

        c = ch * mults[0]
        for i in range(n_levels - 1):
            c = add_level(c, i, "down")
            f = cfg.factors[i]
            kernel = f * cfg.kernel_multiplier_downsample if f > 1 else 3
            setattr(self, f"down_conv{i}", Conv1d(c, ch * mults[i + 1], kernel, stride=f))
            c = ch * mults[i + 1]
        c = add_level(c, n_levels - 1, "mid")
        for i in reversed(range(n_levels - 1)):
            f = cfg.factors[i]
            if f > 1:
                up = ConvTranspose1d(c, ch * mults[i], f * cfg.kernel_multiplier_downsample, f)
            else:
                up = Conv1d(c, ch * mults[i], 3)
            setattr(self, f"up_conv{i}", up)
            c = add_level(2 * ch * mults[i], i, "up")
        self.out_norm = GroupNorm(c, cfg.resnet_groups)
        self.out_conv = Conv1d(c, cfg.in_channels, 7)

    def _n_blocks(self, i: int) -> int:
        nb = self.cfg.num_blocks
        return nb[i] if i < len(nb) else 1

    def _run(self, block, *args, **kwargs):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, **kwargs)
        return block(*args, **kwargs)

    def _level(self, h, i, stage, time_emb, context, rel_biases):
        for j in range(self._n_blocks(i)):
            h = self._run(getattr(self, f"{stage}_res{i}_{j}"), h, time_emb)
        for j in range(self.cfg.attentions[i]):
            name = f"{stage}_attn{i}_{j}"
            h = self._run(getattr(self, name), h, context, rel_bias=rel_biases.get(name))
        return h

    def forward(self, x, t, context, rel_biases=None):
        cfg = self.cfg
        rel_biases = rel_biases or {}
        if cfg.use_context_time:
            emb = sinusoidal_embedding(t, cfg.channels).to(x.dtype)
            time_emb = self.time_mlp2(F.silu(self.time_mlp1(emb)))
        else:
            time_emb = torch.zeros((x.shape[0], 4 * cfg.channels), dtype=x.dtype,
                                   device=x.device)
        n_levels = len(cfg.multipliers)
        h = self.init_conv(x)
        skips = []
        for i in range(n_levels - 1):
            h = self._level(h, i, "down", time_emb, context, rel_biases)
            skips.append(h)
            h = getattr(self, f"down_conv{i}")(h)
        h = self._level(h, n_levels - 1, "mid", time_emb, context, rel_biases)
        for i in reversed(range(n_levels - 1)):
            h = getattr(self, f"up_conv{i}")(h)
            skip = skips.pop()
            if cfg.use_skip_scale:
                skip = skip * (2.0 ** -0.5)
            h = self._level(torch.cat([h, skip], dim=1), i, "up", time_emb, context,
                            rel_biases)
        return self.out_conv(self.out_norm(h))


@dataclass(frozen=True)
class UNetCFG1dConfig:
    """The UNetCFG1d hyper-parameters (the flax module's fields)."""
    in_channels: int = 32
    context_embedding_features: int = 512
    context_embedding_max_length: int = 1
    channels: int = 256
    resnet_groups: int = 8
    kernel_multiplier_downsample: int = 2
    multipliers: Sequence[int] = (2, 3, 4, 4, 4, 4)
    factors: Sequence[int] = (1, 2, 2, 4, 4)
    num_blocks: Sequence[int] = (3, 3, 3, 3, 3)
    attentions: Sequence[int] = (0, 0, 2, 2, 2, 2)
    attention_heads: int = 16
    attention_features: int = 64
    attention_multiplier: int = 4
    attention_rel_pos_max_distance: int = 2048
    attention_rel_pos_num_buckets: int = 256
    use_skip_scale: bool = True
    use_context_time: bool = True


class UNetCFG1d(nn.Module):
    """Keyword arguments: the fields of UNetCFG1dConfig, and the training
    options `train_flash` (kernels K4 under grad, default on) and `remat`
    (per-block recomputation, default off)."""

    def __init__(self, train_flash: bool = True, remat: bool = False, **kwargs):
        super().__init__()
        self.cfg = cfg = UNetCFG1dConfig(**kwargs)
        self.fixed_embedding = nn.Parameter(
            torch.zeros(cfg.context_embedding_max_length, cfg.context_embedding_features))
        self.core = _UNetCore(cfg, train_flash, remat)

    def forward(self, x, t, embedding=None, embedding_scale: float = 1.0,
                rel_biases=None, embedding_mask_proba: float = 0.0, keep=None,
                generator: torch.Generator | None = None):
        """x (B, in_channels, T), t (B,), embedding (B or 1, L, E) -> v
        (B, in_channels, T). With an embedding and embedding_scale != 1,
        classifier-free guidance over one doubled batch. CFG dropout
        (training): rows of the embedding where `keep` (B, 1, 1) bool is
        False are replaced by the learned null embedding; without `keep`
        and with embedding_mask_proba > 0 it is drawn Bernoulli(1 - p)
        from `generator`."""
        b = x.shape[0]
        null_ctx = self.fixed_embedding[None].expand(b, *self.fixed_embedding.shape).to(x.dtype)
        if embedding is None:
            return self.core(x, t, null_ctx, rel_biases)
        context = embedding.to(x.dtype)
        if context.shape[0] == 1 and b != 1:
            context = context.expand(b, *context.shape[1:])
        elif context.shape[0] != b:
            raise ValueError(f"embedding batch {context.shape[0]} must be 1 or match "
                             f"x batch {b}")
        if keep is None and embedding_mask_proba > 0.0:
            if generator is None:
                raise ValueError("CFG dropout draws from an explicit torch.Generator: "
                                 "pass `generator` or a `keep` mask")
            keep = torch.rand((b, 1, 1), generator=generator, device=generator.device) \
                < 1.0 - embedding_mask_proba
        if keep is not None:
            keep = torch.as_tensor(keep, dtype=torch.bool).to(x.device).reshape(b, 1, 1)
            context = torch.where(keep, context, null_ctx)
        if embedding_scale == 1.0:
            return self.core(x, t, context, rel_biases)
        v2 = self.core(torch.cat([x, x]), torch.cat([t, t]),
                       torch.cat([context, null_ctx]), rel_biases)
        v_cond, v_null = v2.chunk(2)
        return v_null + embedding_scale * (v_cond - v_null)


def precompute_rel_biases(model: UNetCFG1d, t_len: int) -> dict:
    """Every rel-pos self-attention site's bias, built once (it depends on
    the weights and T only), keyed by the site's module name. Sites where
    flash_ok(T) hold a TransposedBias (H, S, T) for kernel K3; the others a
    plain (H, T, S) bias. The biases have the bucket table's dtype."""
    core, cfg = model.core, model.cfg
    out = {}

    def site(stage: str, i: int, t_i: int):
        for j in range(cfg.attentions[i]):
            name = f"{stage}_attn{i}_{j}"
            attn = getattr(core, name).RelPosSelfAttention_0
            flashy = flash_ok(t_i)
            bias = attn._bias(t_i, transposed=flashy)
            out[name] = TransposedBias(bias.contiguous()) if flashy else bias

    n_levels = len(cfg.multipliers)
    t_i = t_len
    for i in range(n_levels - 1):
        site("down", i, t_i)
        t_i //= cfg.factors[i]
    site("mid", n_levels - 1, t_i)
    for i in reversed(range(n_levels - 1)):
        t_i *= cfg.factors[i]
        site("up", i, t_i)
    return out
