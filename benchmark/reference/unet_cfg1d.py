"""Plain reference of the MIRAGE inner UNet (UNetCFG1d, the "songs"
configuration) with classifier-free guidance.

ResnetBlock: GN-SiLU-conv3, a time FiLM (scale, shift) into GN-SiLU,
conv3, plus the (projected) skip. TransformerBlock, in (B, T, C): pre-LN
self-attention with a T5 bidirectional rel-pos bias, pre-LN
cross-attention to the (B, 1, 512) context, pre-LN feed-forward with
tanh-GELU. Levels go down by strided convs and up by SAME transposed
convs, skips scaled by 2^-1/2; sinusoidal time features through a
two-layer MLP. CFG runs cond and the learned null embedding in one
doubled batch: null + s (cond - null). Weights are keyed by the measured
module's names under `prefix` (e.g. `core.down_res0_0.GroupNorm_0`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .nn import (attention, conv1d, conv_transpose1d, dense, gelu_tanh, gn_film_silu,
                 layer_norm, linear)


def relative_position_bucket(rel_pos, num_buckets: int, max_distance: int):
    """T5 bidirectional bucketing; a large distance's bucket from an f32
    log truncated to an integer."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (torch.log(n.clamp(min=1).float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.int32)
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, large)


def rel_pos_bias(table, t_len: int, num_buckets: int, max_distance: int, cache=None):
    """(num_buckets, H) table -> (H, T, S) bias, bias[h, t, s] =
    table[bucket(s - t), h]. `cache` (a dict) keeps each length's bucket
    indices on the table's device between calls."""
    key = (t_len, num_buckets, max_distance)
    buckets = None if cache is None else cache.get(key)
    if buckets is None:
        pos = torch.arange(t_len)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], num_buckets,
                                           max_distance).to(table.device)
        if cache is not None:
            cache[key] = buckets
    return table[buckets].permute(2, 0, 1)


def _heads(x, heads):
    b, t, _ = x.shape
    return x.reshape(b, t, heads, -1).transpose(1, 2)


def _merge(y):
    b, h, t, d = y.shape
    return y.transpose(1, 2).reshape(b, t, h * d)


def transformer_block(P, name, x, context, cfg, cache=None):
    heads, feats = cfg["attention_heads"], cfg["attention_features"]
    h = x.transpose(1, 2)
    a = f"{name}.RelPosSelfAttention_0"
    n = layer_norm(P, f"{a}.LayerNorm_0", h)
    q, k, v = (_heads(linear(P, f"{a}.Dense_{i}", n, bias=False), heads) for i in range(3))
    bias = rel_pos_bias(P[f"{a}.rel_pos_bias"], h.shape[1],
                        cfg["attention_rel_pos_num_buckets"],
                        cfg["attention_rel_pos_max_distance"], cache)
    h = h + linear(P, f"{a}.Dense_3", _merge(attention(q * feats ** -0.5, k, v, bias)))
    c = f"{name}.CrossAttention_0"
    n = layer_norm(P, f"{c}.LayerNorm_0", h)
    ctx = layer_norm(P, f"{c}.LayerNorm_1", context)
    q = _heads(linear(P, f"{c}.Dense_0", n, bias=False), heads)
    k = _heads(linear(P, f"{c}.Dense_1", ctx, bias=False), heads)
    v = _heads(linear(P, f"{c}.Dense_2", ctx, bias=False), heads)
    h = h + linear(P, f"{c}.Dense_3", _merge(attention(q * feats ** -0.5, k, v)))
    f = f"{name}.FeedForward_0"
    h = h + linear(P, f"{f}.Dense_1",
                   gelu_tanh(linear(P, f"{f}.Dense_0", layer_norm(P, f"{f}.LayerNorm_0", h))))
    return h.transpose(1, 2)


def resnet_block(P, name, x, time_emb, groups):
    h = conv1d(P, f"{name}.Conv1d_0", gn_film_silu(P, f"{name}.GroupNorm_0", x, groups))
    scale, shift = linear(P, f"{name}.Dense_0", F.silu(time_emb)).chunk(2, dim=1)
    h = conv1d(P, f"{name}.Conv1d_1",
               gn_film_silu(P, f"{name}.GroupNorm_1", h, groups, scale, shift))
    skip = dense(P, f"{name}.Dense_1", x, bias=False) if f"{name}.Dense_1.weight" in P else x
    return skip + h


def sinusoidal_embedding(t, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def core_forward(P, prefix, x, t, context, cfg, cache=None):
    n_levels = len(cfg["multipliers"])
    groups = cfg["resnet_groups"]
    emb = sinusoidal_embedding(t, cfg["channels"])
    time_emb = linear(P, f"{prefix}.time_mlp2", F.silu(linear(P, f"{prefix}.time_mlp1", emb)))

    def level(h, i, stage):
        for j in range(cfg["num_blocks"][i] if i < len(cfg["num_blocks"]) else 1):
            h = resnet_block(P, f"{prefix}.{stage}_res{i}_{j}", h, time_emb, groups)
        for j in range(cfg["attentions"][i]):
            h = transformer_block(P, f"{prefix}.{stage}_attn{i}_{j}", h, context, cfg, cache)
        return h

    h = conv1d(P, f"{prefix}.init_conv", x)
    skips = []
    for i in range(n_levels - 1):
        h = level(h, i, "down")
        skips.append(h)
        h = conv1d(P, f"{prefix}.down_conv{i}", h, stride=cfg["factors"][i])
    h = level(h, n_levels - 1, "mid")
    for i in reversed(range(n_levels - 1)):
        f = cfg["factors"][i]
        h = conv_transpose1d(P, f"{prefix}.up_conv{i}", h, f) if f > 1 \
            else conv1d(P, f"{prefix}.up_conv{i}", h)
        h = level(torch.cat([h, skips.pop() * 2.0 ** -0.5], dim=1), i, "up")
    return conv1d(P, f"{prefix}.out_conv", gn_film_silu(P, f"{prefix}.out_norm", h, groups))


def cfg_forward(P, prefix, x, t, embedding, scale: float, cfg, cache=None):
    """v = null + scale (cond - null) over one doubled batch; `cache` as
    rel_pos_bias's."""
    b = x.shape[0]
    null = P[f"{prefix}.fixed_embedding"][None].expand(b, -1, -1)
    context = embedding.expand(b, -1, -1) if embedding.shape[0] == 1 else embedding
    v2 = core_forward(P, f"{prefix}.core", torch.cat([x, x]), torch.cat([t, t]),
                      torch.cat([context, null]), cfg, cache)
    v_cond, v_null = v2.chunk(2)
    return v_null + scale * (v_cond - v_null)
