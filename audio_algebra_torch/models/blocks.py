"""Shared neural blocks, channels-first (B, C, T).

Port of audio_algebra_tpu/models/blocks.py (the dance-diffusion style
blocks of DiffusionAttnUnet1D and the SoundStream encoder), plus the flax
layers the MIRAGE models use: Dense on the last axis (`Linear`),
`LayerNorm`, grouped `GroupNorm` [+ FiLM] [+ SiLU] through kernel K5, and
`ConvTranspose1d` with flax's SAME padding. Modules and
parameters keep the flax names (`Conv1d_0`, `GroupNorm_1`, `skip_proj`,
`qkv_proj`, ...) so that utils/params.load_flax_params maps a flax param
tree onto them mechanically. The numerics follow the JAX code: XLA SAME
padding, eps 1e-6, tanh-GELU, q and k each scaled by (C/n_head)^(-1/4)
with f32 attention scores.

The turbo int8 route of the Destructo UNet (JAX `blocks.py:101-169`,
`:237-429`) is here too: `Int8Act`, `quantize_act`, `conv1d_int8`,
`Conv1d.forward_int8`, GroupNorm1's int8 emit (kernel K2a) and amax /
int8-twin emit (K2b, K2c), and ResConvBlock's `turbo` route. It adds no
parameter. The JAX package turns it on with the env var AA_TURBO_INT8 and
gates it on batch with AA_TURBO_MIN_B; the port takes both as arguments
(`turbo`, `turbo_min_b`) and reads no env var. ResConvBlock's
`dynamic_int8` mode is the int8-in-fold route of MIRAGE's outer stage
below the batch gate (JAX `parallel/fold.py` `_resconv(q=True)`): both
conv5s on an exact per-channel amax of their input, with no shape gate.

Parameters start at zero (norm scales at one); fill them with
utils/params.random_init_ or load_flax_params.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import (groupnorm1_gelu, groupnorm1_gelu_quant,
                             groupnorm1_gelu_res_amax)
from ..ops.groupnorm_grouped import grouped_gn_film_silu

TURBO_MIN_B = 16            # JAX turbo_batch_ok's default threshold
QUANT_BOUND_SIGMAS = 6.0    # GN_0's analytic int8 grid: +-6 standardised sigmas


def same_padding(t_len: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1) -> tuple[int, int]:
    """XLA SAME padding: total = max((out-1)*s + (k-1)*d + 1 - T, 0) with
    out = ceil(T/s), the lower half first."""
    out_len = -(-t_len // stride)
    total = max((out_len - 1) * stride + (kernel_size - 1) * dilation + 1 - t_len, 0)
    return total // 2, total - total // 2


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           stride: int = 1, dilation: int = 1):
    """(B, Cin, T) * (Cout, Cin, K) -> (B, Cout, ceil(T / stride)) with XLA
    SAME padding."""
    pad_l, pad_r = same_padding(x.shape[-1], weight.shape[-1], stride, dilation)
    if pad_l != pad_r:
        x = F.pad(x, (pad_l, pad_r))
        pad_l = 0
    return F.conv1d(x, weight, bias, stride=stride, padding=pad_l,
                    dilation=dilation)


class Int8Act(NamedTuple):
    """An int8 activation (B, C, T) with its per-channel (C,) f32 grid:
    the value is x8 * scale. Emitted by GN_1's K2c (the amax carry) and
    read directly by the next conv1's int8 route."""
    x8: torch.Tensor
    scale: torch.Tensor


def turbo_batch_ok(b: int, turbo_min_b: int = TURBO_MIN_B) -> bool:
    """JAX `turbo_batch_ok`: the turbo route runs at batch >= turbo_min_b.
    The default of 16 is the JAX package's, chosen there for the TPU's
    sublane tiles; the port keeps it so that it computes what JAX does."""
    return b >= turbo_min_b


def gn_supported(c: int, t_len: int) -> bool:
    """JAX `ops/pallas/groupnorm.supported`: the shapes at which the JAX
    package takes its Pallas GroupNorm kernels, and with them the turbo
    route: C % 128 == 0 and T >= 8 a power of two."""
    return c % 128 == 0 and t_len >= 8 and (t_len & (t_len - 1)) == 0


def quantize_act(x: torch.Tensor, amax: torch.Tensor):
    """Per-channel symmetric int8 of x (B, C, T) under a per-channel |x|
    bound amax (C,): s = max(amax, 1e-6) / 127, x8 = clip(round(x / s)).
    Returns (x8, s); s is f32. It divides, as JAX does."""
    s = torch.clamp(amax.float(), min=1e-6) / 127.0
    x8 = torch.clamp(torch.round(x.float() / s[None, :, None]), -127, 127).to(torch.int8)
    return x8, s


def _int8_conv_acc(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """int32 SAME, stride-1 conv of x8 (B, Cin, T) by w8 (Cout, Cin, K),
    returned as (Cout, B, T). One int8 matrix product (torch._int_mm:
    int8 tensor cores on the card) over an im2col of x8: both operands
    K-contiguous, the layout cuBLASLt's int8 product takes. The int32 sums
    are exact (|sum| <= K * Cin * 127^2 < 2^31 for Cin * K < 133,000)."""
    b, c_in, t_len = x8.shape
    c_out, _, k = w8.shape
    pad_l, pad_r = same_padding(t_len, k)
    xp = torch.empty((b, t_len + pad_l + pad_r, c_in), dtype=torch.int8, device=x8.device)
    xp[:, :pad_l].zero_()
    xp[:, pad_l + t_len:].zero_()
    xp[:, pad_l:pad_l + t_len].copy_(x8.transpose(1, 2))
    # row (b, t) of the im2col is xp[b, t:t + k, :], contiguous in xp
    cols = xp.as_strided((b, t_len, k * c_in), (xp.stride(0), c_in, 1)).contiguous()
    wmat = w8.permute(0, 2, 1).reshape(c_out, k * c_in)
    m = c_out if c_out > 16 and c_out % 8 == 0 else max(32, -(-c_out // 8) * 8)
    if m != c_out:             # the int8 product wants m > 16: zero rows
        wmat = torch.cat([wmat, wmat.new_zeros((m - c_out, k * c_in))])
    acc = torch._int_mm(wmat, cols.view(b * t_len, k * c_in).t())
    return acc[:c_out].view(c_out, b, t_len)


def conv1d_int8(x8: torch.Tensor, x_scale: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """SAME stride-1 conv of an int8 activation x8 (B, Cin, T) with grid
    x_scale (Cin,) against a float weight (Cout, Cin, K), as JAX
    `conv1d_int8`: the activation grid folds into the weights first,
    w = weight * x_scale[cin]; then per output channel s_w = max(max |w|
    over (Cin, K), 1e-12) / 127 and w8 = clip(round(w / s_w)). The int32
    sums come out as y = acc * s_w + bias in f32, cast to out_dtype."""
    w = weight.float() * x_scale.float()[None, :, None]
    s_w = torch.clamp(w.abs().amax(dim=(1, 2)), min=1e-12) / 127.0
    w8 = torch.clamp(torch.round(w / s_w[:, None, None]), -127, 127).to(torch.int8)
    acc = _int8_conv_acc(x8, w8).permute(1, 0, 2)            # (B, Cout, T) view
    out = torch.empty(acc.shape, dtype=out_dtype, device=x8.device)
    if bias is None:
        return torch.mul(acc, s_w[:, None], out=out)
    return torch.addcmul(bias.float()[:, None], acc, s_w[:, None], out=out)


def quantize_dynamic(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX fold `_conv5(q=True)`'s activation side: x (B, C, T) quantised on
    its exact per-channel amax of |x| over (B, T)."""
    return quantize_act(x, x.abs().amax(dim=(0, 2)))


class Conv1d(nn.Module):
    """1D conv with XLA SAME padding; flax kernel (K, Cin, Cout) maps to
    `weight` (Cout, Cin, K).

    `x` may be a tuple of channel parts (the up-stacks' split skip join,
    JAX `Conv1d`): conv(cat(a, b), W) = conv(a, W_a) + conv(b, W_b), the
    bias added to the first part's output, the part outputs summed in the
    activations' dtype."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 5,
                 stride: int = 1, dilation: int = 1, use_bias: bool = True):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None

    def _parts(self, parts):
        ofs = 0
        for i, p in enumerate(parts):
            yield p, self.weight[:, ofs:ofs + p.shape[1]], self.bias if i == 0 else None
            ofs += p.shape[1]

    def forward(self, x):
        if not isinstance(x, tuple):
            return conv1d(x, self.weight, self.bias, self.stride, self.dilation)
        ys = [conv1d(p, w.to(p.dtype), b, self.stride, self.dilation)
              for p, w, b in self._parts(x)]
        return sum(ys[1:], ys[0])

    def forward_int8(self, x8, x_scale, out_dtype: torch.dtype) -> torch.Tensor:
        """The turbo int8 route (JAX `Conv1d` on an int8 input): x8 and
        x_scale are a tensor and its grid, or tuples of parts and grids,
        each part with its own slice of the weight and its own s_w."""
        if self.stride != 1 or self.dilation != 1:
            raise ValueError("the int8 route takes SAME stride-1 convs only")
        parts = x8 if isinstance(x8, tuple) else (x8,)
        scales = x_scale if isinstance(x_scale, tuple) else (x_scale,)
        ys = [conv1d_int8(p, s, w, b, out_dtype)
              for (p, w, b), s in zip(self._parts(parts), scales)]
        return sum(ys[1:], ys[0])


class Dense(nn.Module):
    """flax nn.Dense over the channel axis of (B, C, T); flax kernel
    (in, out) maps to `weight` (out, in)."""

    def __init__(self, c_in: int, c_out: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None

    def forward(self, x):
        y = torch.matmul(self.weight, x)
        return y if self.bias is None else y + self.bias[:, None]


class Linear(nn.Module):
    """flax nn.Dense over the last axis; flax kernel (in, out) maps to
    `weight` (out, in)."""

    def __init__(self, c_in: int, c_out: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis (eps 1e-6); flax scale/bias
    map to weight/bias."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups) on (B, C, T), with the FiLM
    modulation and SiLU of the MIRAGE UNet fused in, through kernel K5
    (ops/groupnorm_grouped.py). flax scale/bias map to weight/bias.
    film_scale / film_shift are (B, C) or None."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, film_scale=None, film_shift=None, silu: bool = True):
        return grouped_gn_film_silu(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                    self.groups, film_scale, film_shift, silu)


class PlainGroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups) on (B, C, T) as plain torch group_norm
    (eps 1e-6), for the models whose JAX code calls flax's GroupNorm and
    no Pallas kernel (DMAE's UNetV0). `affine=False` is flax's
    use_scale=use_bias=False: no parameters."""

    def __init__(self, channels: int, groups: int, affine: bool = True):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None

    def forward(self, x):
        w = None if self.weight is None else self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.group_norm(x, self.groups, w, b, eps=1e-6)


class ConvTranspose1d(nn.Module):
    """flax nn.ConvTranspose(padding="SAME", transpose_kernel=True) on
    (B, C, T): torch conv_transpose1d, cropped to lax.conv_transpose's SAME
    output of T * stride samples. The flax kernel (K, Cout, Cin) maps to
    `weight` (Cin, Cout, K)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(c_in, c_out, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        k, s = self.weight.shape[-1], self.stride
        pad_len = k + s - 2                       # lax.conv_transpose, SAME
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        left = k - 1 - pad_a                      # crop of the full output
        right = (k - 1) - (pad_len - pad_a)
        if left == right:
            return F.conv_transpose1d(x, self.weight, self.bias, stride=s, padding=left)
        y = F.conv_transpose1d(x, self.weight, self.bias, stride=s)
        return y[..., left:y.shape[-1] - right]


class FourierFeatures(nn.Module):
    """Random Fourier timestep embedding: t (B,) -> (B, out_features).
    `weight` is (out/2, 1), as in flax."""

    def __init__(self, out_features: int = 16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features // 2, 1))

    def forward(self, t):
        f = 2.0 * math.pi * t[:, None] * self.weight[None, :, 0]
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


class GroupNorm1(nn.Module):
    """GroupNorm(num_groups=1) [+ GELU] [+ residual], through kernel K1
    (ops/groupnorm.py). flax scale/bias map to weight/bias."""

    def __init__(self, channels: int, fuse_gelu: bool = False):
        super().__init__()
        self.fuse_gelu = fuse_gelu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, residual=None, quantize: bool = False,
                emit_amax: bool = False, q_emit_scale=None):
        """[residual +] [gelu](gn(x)). Turbo extras, as JAX `GroupNorm1`:
        `quantize` returns (int8 tensor, grid (C,) f32) on the analytic
        grid (6 |scale| + |bias| + 1e-6) / 127, computed in x's dtype and
        cast to f32 (K2a); `emit_amax` (with a residual) returns (out,
        amax (C,) f32) (K2b); `q_emit_scale` (C,) returns (out, amax,
        Int8Act(out8, q_emit_scale)) (K2c). Both need the residual."""
        if quantize and residual is not None:
            raise ValueError("turbo quantise is exclusive with residual")
        scale, bias = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if quantize:
            q = (QUANT_BOUND_SIGMAS * scale.abs() + bias.abs() + 1e-6).float() / 127.0
            return groupnorm1_gelu_quant(x, scale, bias, q, gelu=self.fuse_gelu), q
        if emit_amax or q_emit_scale is not None:
            out = groupnorm1_gelu_res_amax(x, scale, bias, residual, gelu=self.fuse_gelu,
                                           q_emit_scale=q_emit_scale)
            if q_emit_scale is None:
                return out
            return out[0], out[1], Int8Act(out[2], q_emit_scale)
        return groupnorm1_gelu(x, scale, bias, gelu=self.fuse_gelu, residual=residual)


class ResConvBlock(nn.Module):
    """conv5-GN-GELU-conv5-GN-GELU with a 1x1-projected residual (bias-free
    `skip_proj`, identity when c_in == c_out); is_last drops the final
    norm and activation."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, is_last: bool = False):
        super().__init__()
        self.is_last = is_last
        self.Conv1d_0 = Conv1d(c_in, c_mid, 5)
        self.GroupNorm_0 = GroupNorm1(c_mid, fuse_gelu=True)
        self.Conv1d_1 = Conv1d(c_mid, c_out, 5)
        if not is_last:
            self.GroupNorm_1 = GroupNorm1(c_out, fuse_gelu=True)
        self.skip_proj = Dense(c_in, c_out, use_bias=False) if c_in != c_out else None

    def _skip(self, parts):
        if self.skip_proj is None:
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if len(parts) == 1:
            return self.skip_proj(parts[0])
        ys, ofs = [], 0                        # JAX SplitLinear
        for p in parts:
            ys.append(torch.matmul(self.skip_proj.weight[:, ofs:ofs + p.shape[1]], p))
            ofs += p.shape[1]
        return sum(ys[1:], ys[0])

    def forward(self, x, x_amax=None, emit_amax: bool = False, x_q: Int8Act | None = None,
                q_emit_scale=None, turbo: bool = False, dynamic_int8: bool = False):
        """The block; with none of the extras, exactly the bf16/f32 route.

        `dynamic_int8` (JAX fold `_resconv(q=True)`): conv1 and conv2 each
        run int8 on their input quantised with its exact per-channel amax
        (`quantize_dynamic`), whatever the channel count or length; the
        GroupNorms stay on K1. x is one tensor (that route joins the skip
        by concatenation), and the mode takes none of the turbo extras.

        Turbo (JAX `ResConvBlock`; `turbo` says the batch passed the
        gate): where x's dtype and shape allow it (`gn_supported`), GN_0
        emits int8 (K2a) and conv2 runs int8. conv1 takes, in order: the
        int8 twin `x_q` of a previous GN_1; else, given per-channel bounds
        `x_amax`, `quantize_act` of x; else the float conv. `x` may be a
        tuple of channel parts (the up-stacks' split skip join), with
        `x_amax` a matching tuple. `emit_amax` returns (out, amax) (amax
        None for the is_last head); with `q_emit_scale`, (out, amax,
        Int8Act) (K2b, K2c)."""
        if dynamic_int8:
            return self._forward_dynamic_int8(x)
        pair = isinstance(x, tuple)
        parts = x if pair else (x,)
        p0 = parts[0]
        turbo = turbo and p0.dtype in (torch.bfloat16, torch.float32) \
            and gn_supported(sum(p.shape[1] for p in parts), p0.shape[-1])
        skip = self._skip(parts)
        amaxes = x_amax if isinstance(x_amax, tuple) else (x_amax,)
        if turbo and x_q is not None and not pair:
            h = self.Conv1d_0.forward_int8(x_q.x8, x_q.scale, p0.dtype)
        elif turbo and all(a is not None for a in amaxes) \
                and all(p.shape[1] % 128 == 0 for p in parts):
            q = [quantize_act(p, a) for p, a in zip(parts, amaxes)]
            h = self.Conv1d_0.forward_int8(tuple(v[0] for v in q), tuple(v[1] for v in q),
                                           p0.dtype)
        else:
            h = self.Conv1d_0(x)
        if turbo and gn_supported(h.shape[1], h.shape[-1]):
            h8, s_h = self.GroupNorm_0(h, quantize=True)
            h = self.Conv1d_1.forward_int8(h8, s_h, p0.dtype)
        else:
            h = self.Conv1d_1(self.GroupNorm_0(h))
        if self.is_last:
            return (skip + h, None) if emit_amax else skip + h
        if q_emit_scale is not None:
            return self.GroupNorm_1(h, residual=skip, emit_amax=True,
                                    q_emit_scale=q_emit_scale)
        return self.GroupNorm_1(h, residual=skip, emit_amax=emit_amax)

    def _forward_dynamic_int8(self, x: torch.Tensor) -> torch.Tensor:
        skip = self._skip((x,))
        h = self.Conv1d_0.forward_int8(*quantize_dynamic(x), x.dtype)
        h = self.Conv1d_1.forward_int8(*quantize_dynamic(self.GroupNorm_0(h)), x.dtype)
        return skip + h if self.is_last else self.GroupNorm_1(h, residual=skip)


class SelfAttention1d(nn.Module):
    """Pre-norm multi-head self-attention over time, with residual. qkv
    channels are laid out [q (all heads), k, v]; scores and softmax in f32,
    the softmax cast to v's dtype."""

    def __init__(self, channels: int, n_head: int = 1):
        super().__init__()
        self.n_head = n_head
        self.GroupNorm_0 = GroupNorm1(channels, fuse_gelu=False)
        self.qkv_proj = Dense(channels, 3 * channels)
        self.out_proj = Dense(channels, channels)

    def forward(self, x):
        b, c, t = x.shape
        hd = c // self.n_head
        qkv = self.qkv_proj(self.GroupNorm_0(x))
        q, k, v = (p.reshape(b, self.n_head, hd, t) for p in qkv.chunk(3, dim=1))
        scale = 1.0 / math.sqrt(math.sqrt(hd))
        att = torch.matmul((q * scale).float().transpose(-1, -2),
                           (k * scale).float())            # (b, h, t, s)
        att = torch.softmax(att, dim=-1).to(v.dtype)
        y = torch.matmul(v, att.transpose(-1, -2))         # (b, h, hd, t)
        return x + self.out_proj(y.reshape(b, c, t))


class _FixedTaps(nn.Module):
    """Depthwise [1,3,3,1]/norm taps, kept as a buffer so that they move
    with the module (a tensor built from a list per call would be a
    host-to-device copy that waits for the card at every resample)."""

    def __init__(self, norm: float):
        super().__init__()
        self.register_buffer("taps", torch.tensor([1.0, 3.0, 3.0, 1.0]) / norm,
                             persistent=False)

    def weight(self, x):
        return self.taps.to(x.dtype)[None, None, :].expand(x.shape[1], 1, 4).contiguous()


class Downsample1d(_FixedTaps):
    """x2 downsample: depthwise [1,3,3,1]/8, stride 2, padding (1, 1)."""

    def __init__(self):
        super().__init__(8.0)

    def forward(self, x):
        return F.conv1d(x, self.weight(x), stride=2, padding=1, groups=x.shape[1])


class Upsample1d(_FixedTaps):
    """x2 upsample: depthwise [1,3,3,1]/4 with lhs-dilation 2 and padding
    (2, 2), which is conv_transpose1d(stride=2, padding=1)."""

    def __init__(self):
        super().__init__(4.0)

    def forward(self, x):
        return F.conv_transpose1d(x, self.weight(x), stride=2, padding=1,
                                  groups=x.shape[1])


def timestep_broadcast(emb: torch.Tensor, t_len: int) -> torch.Tensor:
    """(B, C) embedding -> (B, C, T) broadcast along time."""
    return emb[:, :, None].expand(emb.shape[0], emb.shape[1], t_len)


def upsample_to(cond: torch.Tensor, t_len: int) -> torch.Tensor:
    """Nearest-upsample (B, C, n) along time to (B, C, t_len)."""
    b, c, n = cond.shape
    if n == t_len:
        return cond
    if t_len % n == 0:
        r = t_len // n
        return cond[:, :, :, None].expand(b, c, n, r).reshape(b, c, t_len)
    idx = torch.div(torch.arange(t_len, device=cond.device) * n, t_len,
                    rounding_mode="floor")
    return cond[:, :, idx]
