"""DiffusionAttnUnet1D (the Destructo decoder, MIRAGE's outer stage): the
operations of one forward, and its K1 launches with their shapes.

Level j runs at T / 2^j with c_mults[j] channels: a down stack and an up
stack of three ResConvBlocks (conv5, conv5, and a bias-free 1x1 skip
projection where the width changes), self-attention after each block in
the deepest `n_attn` levels (qkv and out projections, scores and the
weighted sum over T x T), and depthwise 4-tap resampling between levels.
"""
from __future__ import annotations


def _stacks(io: int, cond_dim: int, c_mults, n_attn: int, timestep_features: int = 16):
    """(level, c_in, c_mid, c_out, attn, is_last) of every stack, in order."""
    depth = len(c_mults)
    attn_start = max(0, depth - n_attn)
    out, c_in = [], io + timestep_features + cond_dim
    for j in range(depth):
        out.append((j, c_in, c_mults[j], c_mults[j], j >= attn_start, False))
        c_in = c_mults[j]
    for j in reversed(range(depth)):
        c_out = c_mults[j - 1] if j > 0 else io
        c_in = c_mults[j] if j == depth - 1 else 2 * c_mults[j]
        out.append((j, c_in, c_mults[j], c_out, j >= attn_start, j == 0))
    return out


def _blocks(c_in, c_mid, c_out, attn, is_last):
    """(kind, c_in, c_out) of a stack's blocks: 'res' or 'attn'."""
    seq = [("res", c_in, c_mid)]
    if attn:
        seq.append(("attn", c_mid, c_mid))
    seq.append(("res", c_mid, c_mid))
    if attn:
        seq.append(("attn", c_mid, c_mid))
    seq.append(("res", c_mid, c_out))
    if attn and not is_last:
        seq.append(("attn", c_out, c_out))
    return seq


def flops(batch: int, t_len: int, io: int, cond_dim: int, c_mults, n_attn: int) -> float:
    """Operations of one forward at (batch, io, t_len)."""
    total = 0.0
    for j, c_in, c_mid, c_out, attn, is_last in _stacks(io, cond_dim, c_mults, n_attn):
        t = t_len >> j
        for kind, a, b in _blocks(c_in, c_mid, c_out, attn, is_last):
            if kind == "res":
                mid = c_mid
                total += 2 * batch * t * (a * mid * 5 + mid * b * 5)
                if a != b:
                    total += 2 * batch * t * a * b
            else:
                total += 2 * batch * t * (a * 3 * a + a * a) + 4 * batch * t * t * a
    depth = len(c_mults)
    for j in range(depth - 1):       # Downsample1d and Upsample1d at c_mults[j]: 4 taps
        total += 2 * 2 * batch * c_mults[j] * (t_len >> (j + 1)) * 4
    return total


def k1_launches(batch: int, t_len: int, io: int, cond_dim: int, c_mults, n_attn: int):
    """[(shape, gelu, residual)] of every K1 launch of one forward."""
    out = []
    for j, c_in, c_mid, c_out, attn, is_last in _stacks(io, cond_dim, c_mults, n_attn):
        t = t_len >> j
        blocks = _blocks(c_in, c_mid, c_out, attn, is_last)
        for i, (kind, a, b) in enumerate(blocks):
            if kind == "res":
                out.append(((batch, c_mid, t), True, False))
                if not (is_last and i == len(blocks) - 1):
                    out.append(((batch, b, t), True, True))
            else:
                out.append(((batch, a, t), False, False))
    return out
