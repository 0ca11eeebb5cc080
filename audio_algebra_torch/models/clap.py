"""CLAP — the contrastive language-audio embedder of MIRAGE: the HTSAT
Swin audio tower and the RoBERTa text tower, inference only.

Port of audio_algebra_tpu/models/clap.py. `CLAPModule` keeps the
laion_clap call surface: `get_text_embedding([texts]) -> (N, 512)` and
`get_audio_embedding_from_data((B, T) mono at 48 kHz) -> (B, 512)`, both
L2-normalised.

  * audio: 64-bin log-mel (the STFT front end, kernel K6 on the card, at
    n_fft 1024 / hop 480), BatchNorm over mel bins, bicubic resize and
    fold to a 256 x 256 "image", 4 x 4 patch conv, Swin stages with
    shifted-window attention, relative position bias and patch merging,
    LayerNorm and a mean pool. Clips longer than 10 s take the fusion
    branch: a bilinear-shrunk global mel and three local crops, the crops
    through `mel_conv2d`, merged by the AFF block.
  * text: RoBERTa with padding-offset position ids, post-LN layers, a
    tanh pooler on token 0.
  * projections: Linear-ReLU-Linear to 512, then L2 normalisation.

The numerics are the JAX package's: exact-erf GELU, LayerNorm eps 1e-5 in
the audio tower and 1e-12 in the text tower, -100 across the shifted
windows' seam, -1e9 on padded tokens, the interpolation matrices of JAX
(copied, not F.interpolate). Everything runs in full f32 (no TF32), as
the JAX package keeps CLAP in f32. Module and parameter names are the
flax ones, so utils/params.load_flax_params pours a flax tree onto them.
Without weights the towers take seeded random ones (utils/params.
random_init_ with `seed` and `seed + 1`); `CLAPModule.load_ckpt` pours a
laion_clap or HF ClapModel checkpoint (convert.convert_clap_state_dict),
the tower sizes read from its shapes.

Tokenizer: the exact byte-level BPE of utils/bpe.py over vocab.json +
merges.txt in the asset directory; without them, byte-level ids in the
vocab's reserved low range (the JAX package's fallback, id for id).
`tokenizer_backend` and `tokenize` share one validation of the engine, so
the backend the service reports is the one that tokenizes.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import full_f32, resolve_device
from ..ops.mel import melspectrogram
from ..ops.stft import device_table
from .blocks import LayerNorm, Linear

# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClapAudioCfg:
    """HTSAT audio-tower hyperparameters (laion_clap audio_cfg)."""
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    patch_embed_hidden: int = 128          # HTSAT-base
    depths: tuple = (2, 2, 6, 2)
    heads: tuple = (4, 8, 16, 32)
    window: int = 8
    mlp_ratio: int = 4
    num_mel_bins: int = 64
    projection_dim: int = 512
    ln_eps: float = 1e-5
    sample_rate: int = 48000
    n_fft: int = 1024
    hop: int = 480
    f_min: float = 50.0
    f_max: float = 14000.0
    clip_samples: int = 480000
    enable_fusion: bool = False
    aff_r: int = 4

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def num_features(self) -> int:
        return self.patch_embed_hidden * 2 ** (len(self.depths) - 1)


@dataclasses.dataclass(frozen=True)
class ClapTextCfg:
    """RoBERTa text-tower hyperparameters (roberta-base)."""
    vocab: int = 50265
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_pos: int = 514
    pad_id: int = 1
    type_vocab: int = 1
    ln_eps: float = 1e-12
    projection_dim: int = 512
    max_len: int = 77


_AMODEL_EMBED = {"HTSAT-tiny": 96, "HTSAT-base": 128, "HTSAT-large": 256}

# the same architecture at a few thousand parameters, for tests
TINY_AUDIO_CFG = dict(spec_size=32, num_mel_bins=8, patch_embed_hidden=16,
                      depths=(1, 1), heads=(2, 2), window=4,
                      n_fft=256, hop=64, clip_samples=4096)
TINY_TEXT_CFG = dict(vocab=300, hidden=32, layers=1, heads=2,
                     intermediate=64, max_pos=80, max_len=16)


# --------------------------------------------------------------------------
# Swin window machinery (index math in numpy, as in JAX)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _relative_position_index(window: int) -> np.ndarray:
    """(w*w, w*w) index into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def _shift_attn_mask(height: int, width: int, window: int, shift: int) -> Optional[np.ndarray]:
    """Additive (nW, L, L) mask for shifted-window attention: -100 between
    tokens the cyclic shift brought together across the seam."""
    if shift == 0:
        return None
    img = np.zeros((height, width))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = count
            count += 1
    img = img.reshape(height // window, window, width // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = img[:, None, :] - img[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window * window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """(B * nW, window * window, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _attend(q, k, v, heads: int, bias=None):
    """Softmax attention of (B, L, C) q, k, v over `heads` heads with an
    additive f32 bias broadcast onto (B, heads, L, L) scores."""
    b, L, c = q.shape
    hd = c // heads
    q, k, v = (t.reshape(b, L, heads, hd).transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v).transpose(1, 2).reshape(b, L, c)


class _WindowAttention(nn.Module):
    """Window MSA with a relative position bias (flax `attn`)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.query, self.key, self.value, self.out = (Linear(dim, dim) for _ in range(4))
        self.register_buffer("rel_index", torch.from_numpy(
            _relative_position_index(window).reshape(-1)), persistent=False)

    def forward(self, x, attn_mask=None):
        """x (B_, L, C); attn_mask (nW, L, L) additive or None."""
        b_, L, _ = x.shape
        bias = self.rel_pos_bias[self.rel_index].reshape(L, L, self.heads)
        bias = bias.permute(2, 0, 1)[None]                      # (1, h, L, L)
        if attn_mask is not None:
            n_w = attn_mask.shape[0]
            bias = (bias[None] + attn_mask[None, :, None]).expand(
                b_ // n_w, n_w, self.heads, L, L).reshape(b_, self.heads, L, L)
        return self.out(_attend(self.query(x), self.key(x), self.value(x), self.heads, bias))


class _SwinBlock(nn.Module):
    """Pre-norm Swin block: (shifted-)window attention + MLP, residuals.
    The window clamps to the map (no shift) when min(H, W) <= window."""

    def __init__(self, dim: int, heads: int, resolution: tuple, window: int, shift: int,
                 mlp_ratio: int = 4, ln_eps: float = 1e-5):
        super().__init__()
        self.resolution = resolution
        if min(resolution) <= window:
            window, shift = min(resolution), 0
        self.window, self.shift = window, shift
        self.layernorm_before = LayerNorm(dim, ln_eps)
        self.attn = _WindowAttention(dim, heads, window)
        self.layernorm_after = LayerNorm(dim, ln_eps)
        self.intermediate = Linear(dim, mlp_ratio * dim)
        self.output = Linear(mlp_ratio * dim, dim)

    def forward(self, x):
        h_res, w_res = self.resolution
        window, shift = self.window, self.shift
        b, L, c = x.shape
        h = self.layernorm_before(x).reshape(b, h_res, w_res, c)
        pad_b = (window - h_res % window) % window
        pad_r = (window - w_res % window) % window
        if pad_b or pad_r:
            h = F.pad(h, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h_res + pad_b, w_res + pad_r
        if shift > 0:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        mask = _shift_attn_mask(hp, wp, window, shift)
        if mask is not None:
            mask = device_table(f"swin_mask{(hp, wp, window, shift)}", lambda: mask, x.device)
        h = _window_reverse(self.attn(_window_partition(h, window), mask), window, hp, wp)
        if shift > 0:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            h = h[:, :h_res, :w_res]
        x = x + h.reshape(b, L, c)
        y = self.output(F.gelu(self.intermediate(self.layernorm_after(x))))
        return x + y


class _PatchMerging(nn.Module):
    """2 x 2 patch merge: LayerNorm of the 4 phases, Linear 4C -> 2C."""

    def __init__(self, dim: int, resolution: tuple, ln_eps: float = 1e-5):
        super().__init__()
        self.resolution = resolution
        self.norm = LayerNorm(4 * dim, ln_eps)
        self.reduction = Linear(4 * dim, 2 * dim, use_bias=False)

    def forward(self, x):
        h_res, w_res = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h_res, w_res, c)
        if h_res % 2 or w_res % 2:
            x = F.pad(x, (0, 0, 0, w_res % 2, 0, h_res % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


# --------------------------------------------------------------------------
# mel "image" reshaping (HTSAT reshape_mel2img)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bicubic upsampling matrix, align_corners=True, Keys
    kernel a = -0.75, edge-clamped (torch's bicubic interpolate)."""
    a = -0.75

    def w(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        if x < 2.0:
            return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
        return 0.0

    m = np.zeros((n_out, n_in), dtype=np.float64)
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    for o in range(n_out):
        s = o * scale
        i0 = int(np.floor(s))
        t = s - i0
        for off in (-1, 0, 1, 2):
            m[o, min(max(i0 + off, 0), n_in - 1)] += w(off - t)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear resize matrix, align_corners=False,
    edge-clamped half-pixel centres (the fusion front end's shrink)."""
    m = np.zeros((n_out, n_in), dtype=np.float64)
    scale = n_in / n_out
    for o in range(n_out):
        s = max((o + 0.5) * scale - 0.5, 0.0)
        i0 = min(int(np.floor(s)), n_in - 1)
        i1 = min(i0 + 1, n_in - 1)
        t = s - i0
        m[o, i0] += 1.0 - t
        m[o, i1] += t
    return m.astype(np.float32)


def _reshape_mel2img(x: torch.Tensor, cfg: ClapAudioCfg) -> torch.Tensor:
    """(B, C, T, F) log-mel -> (B, C, spec_size, spec_size): time resized
    (bicubic) up to spec_size * freq_ratio if shorter, then the freq_ratio
    time folds stacked along frequency."""
    b, ch, t, f = x.shape
    r = cfg.freq_ratio
    spec_w, spec_h = cfg.spec_size * r, cfg.spec_size // r
    if t > spec_w or f > spec_h:
        raise ValueError(f"mel input ({t}x{f}) exceeds swin size ({spec_w}x{spec_h})")
    if t < spec_w:
        m = device_table(f"bicubic{(t, spec_w)}", lambda: _bicubic_matrix(t, spec_w), x.device)
        x = torch.matmul(m, x)                                  # "ot,bctf->bcof"
        t = spec_w
    if f < spec_h:
        m = device_table(f"bicubic{(f, spec_h)}", lambda: _bicubic_matrix(f, spec_h), x.device)
        x = torch.matmul(x, m.t())                              # "of,bctf->bcto"
        f = spec_h
    x = x.reshape(b, ch * r, t // r, f).transpose(2, 3)
    return x.reshape(b, ch, f * r, t // r)


# --------------------------------------------------------------------------
# towers
# --------------------------------------------------------------------------

class _BN(nn.Module):
    """Inference BatchNorm over the last (channel) axis, its statistics
    held as parameters (flax names scale, bias, mean, var), eps 1e-5."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        return (x - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias


class _AFFBlock(nn.Module):
    """Attentional feature fusion on NHWC maps: gate = sigmoid(local(g + l)
    + global(g + l)); out = 2 g gate + 2 l (1 - gate). The 1 x 1 convs are
    Linear layers over channels."""

    def __init__(self, channels: int, r: int = 4):
        super().__init__()
        inter = channels // r
        self.local_conv1, self.local_bn1 = Linear(channels, inter), _BN(inter)
        self.local_conv2, self.local_bn2 = Linear(inter, channels), _BN(channels)
        self.global_conv1, self.global_bn1 = Linear(channels, inter), _BN(inter)
        self.global_conv2, self.global_bn2 = Linear(inter, channels), _BN(channels)

    def forward(self, g, local):
        s = g + local
        la = self.local_bn2(self.local_conv2(F.relu(self.local_bn1(self.local_conv1(s)))))
        ga = s.mean(dim=(1, 2), keepdim=True)
        ga = self.global_bn2(self.global_conv2(F.relu(self.global_bn1(self.global_conv1(ga)))))
        gate = torch.sigmoid(la + ga)
        return 2.0 * g * gate + 2.0 * local * (1.0 - gate)


class Conv2d(nn.Module):
    """flax nn.Conv on an image, run in NCHW: the flax kernel
    (kh, kw, in, out) maps to `weight` (out, in, kh, kw)."""

    def __init__(self, c_in: int, c_out: int, kernel: tuple, stride: tuple, pad: int = 0):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, *kernel))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.pad)


class HTSATAudioTower(nn.Module):
    """HTSAT Swin transformer over the mel image -> pooled (B, num_features).
    Parameters carry the flax tower's names: bn_*, patch_proj, mel_conv2d,
    fusion_model, patch_norm, layers_{i}_blocks_{j}, layers_{i}_downsample,
    norm."""

    def __init__(self, cfg: ClapAudioCfg):
        super().__init__()
        self.cfg = cfg
        f_bins, c = cfg.num_mel_bins, cfg.patch_embed_hidden
        self.bn_scale = nn.Parameter(torch.ones(f_bins))
        self.bn_bias = nn.Parameter(torch.zeros(f_bins))
        self.bn_mean = nn.Parameter(torch.zeros(f_bins))
        self.bn_var = nn.Parameter(torch.ones(f_bins))
        p, st = cfg.patch_size, cfg.patch_stride
        pad = (p - st) // 2
        self.patch_proj = Conv2d(1, c, (p, p), (st, st), pad)
        if cfg.enable_fusion:
            self.mel_conv2d = Conv2d(1, c, (p, 3 * p), (st, 3 * st), pad)
            self.fusion_model = _AFFBlock(c, cfg.aff_r)
        self.patch_norm = LayerNorm(c, cfg.ln_eps)
        grid = (cfg.spec_size + 2 * pad - p) // st + 1
        res = (grid, grid)
        for i, depth in enumerate(cfg.depths):
            dim = c * 2 ** i
            for j in range(depth):
                setattr(self, f"layers_{i}_blocks_{j}", _SwinBlock(
                    dim, cfg.heads[i], res, cfg.window,
                    shift=0 if j % 2 == 0 else cfg.window // 2,
                    mlp_ratio=cfg.mlp_ratio, ln_eps=cfg.ln_eps))
            if i < len(cfg.depths) - 1:
                setattr(self, f"layers_{i}_downsample", _PatchMerging(dim, res, cfg.ln_eps))
                res = ((res[0] + 1) // 2, (res[1] + 1) // 2)
        self.norm = LayerNorm(cfg.num_features, cfg.ln_eps)

    def forward(self, input_features: torch.Tensor, is_longer: bool = False) -> torch.Tensor:
        """(B, 1, T, F) log-mel, or (B, 4, T, F) [global, front, middle,
        back] with fusion. `is_longer` (static) runs the local-crop fusion;
        otherwise only channel 0 is read."""
        cfg = self.cfg
        x = (input_features - self.bn_mean) * torch.rsqrt(self.bn_var + 1e-5)
        x = x * self.bn_scale + self.bn_bias
        x = _reshape_mel2img(x, cfg)                           # (B, ch, S, S)
        g = self.patch_proj(x[:, 0:1]).permute(0, 2, 3, 1)     # (B, gh, gw, C)
        if cfg.enable_fusion and is_longer:
            b, _, s_h, s_w = x.shape
            loc = self.mel_conv2d(x[:, 1:4].reshape(b * 3, 1, s_h, s_w))
            loc = loc.permute(0, 2, 3, 1)                       # (B*3, lh, lw, C)
            _, lh, lw, c = loc.shape
            loc = loc.reshape(b, 3, lh, lw, c).transpose(1, 2).reshape(b, lh, 3 * lw, c)
            loc = F.pad(loc, (0, 0, 0, g.shape[2] - 3 * lw))
            g = self.fusion_model(g, loc)
        b, gh, gw, c = g.shape
        x = self.patch_norm(g.reshape(b, gh * gw, c))
        for i, depth in enumerate(cfg.depths):
            for j in range(depth):
                x = getattr(self, f"layers_{i}_blocks_{j}")(x)
            if i < len(cfg.depths) - 1:
                x = getattr(self, f"layers_{i}_downsample")(x)
        return self.norm(x).mean(dim=1)


class Embed(nn.Module):
    """flax nn.Embed: an `embedding` table (num, features)."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features))

    def forward(self, ids):
        return self.embedding[ids]


class RobertaTextTower(nn.Module):
    """RoBERTa encoder + tanh pooler -> (B, hidden); post-LN, position ids
    cumsum(mask) * mask + pad_id, -1e9 on padded keys."""

    def __init__(self, cfg: ClapTextCfg):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden, cfg.ln_eps
        self.word_embeddings = Embed(cfg.vocab, h)
        self.position_embeddings = Embed(cfg.max_pos, h)
        self.token_type_embeddings = nn.Parameter(torch.zeros(cfg.type_vocab, h))
        self.embeddings_norm = LayerNorm(h, eps)
        for i in range(cfg.layers):
            for name in ("query", "key", "value", "attn_out"):
                setattr(self, f"layer_{i}_{name}", Linear(h, h))
            setattr(self, f"layer_{i}_attn_norm", LayerNorm(h, eps))
            setattr(self, f"layer_{i}_intermediate", Linear(h, cfg.intermediate))
            setattr(self, f"layer_{i}_output", Linear(cfg.intermediate, h))
            setattr(self, f"layer_{i}_out_norm", LayerNorm(h, eps))
        self.pooler = Linear(h, h)

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if mask is None:
            mask = (ids != cfg.pad_id).to(torch.int64)
        pos_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_id
        x = self.word_embeddings(ids) + self.position_embeddings(pos_ids)
        x = self.embeddings_norm(x + self.token_type_embeddings[0])
        bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]    # (B, 1, 1, L)
        for i in range(cfg.layers):
            q, k, v, att_out, att_norm, inter, out, out_norm = (
                getattr(self, f"layer_{i}_{n}") for n in (
                    "query", "key", "value", "attn_out", "attn_norm", "intermediate",
                    "output", "out_norm"))
            x = att_norm(x + att_out(_attend(q(x), k(x), v(x), cfg.heads, bias)))
            x = out_norm(x + out(F.gelu(inter(x))))
        return torch.tanh(self.pooler(x[:, 0]))


class ProjectionMLP(nn.Module):
    """Linear-ReLU-Linear to the shared embedding space."""

    def __init__(self, c_in: int, out_dim: int = 512):
        super().__init__()
        self.linear1 = Linear(c_in, out_dim)
        self.linear2 = Linear(out_dim, out_dim)

    def forward(self, x):
        return self.linear2(F.relu(self.linear1(x)))


def _l2_normalise(e: torch.Tensor) -> torch.Tensor:
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-8)


class ClapAudioEmbedder(nn.Module):
    """Audio tower + projection + L2 normalisation -> (B, 512)."""

    def __init__(self, cfg: ClapAudioCfg):
        super().__init__()
        self.audio_branch = HTSATAudioTower(cfg)
        self.audio_projection = ProjectionMLP(cfg.num_features, cfg.projection_dim)

    def forward(self, input_features, is_longer: bool = False):
        return _l2_normalise(self.audio_projection(
            self.audio_branch(input_features, is_longer=is_longer)))


class ClapTextEmbedder(nn.Module):
    """Text tower + projection + L2 normalisation -> (B, 512)."""

    def __init__(self, cfg: ClapTextCfg):
        super().__init__()
        self.text_branch = RobertaTextTower(cfg)
        self.text_projection = ProjectionMLP(cfg.hidden, cfg.projection_dim)

    def forward(self, ids, mask=None):
        return _l2_normalise(self.text_projection(self.text_branch(ids, mask)))


# --------------------------------------------------------------------------
# tokenizer + waveform front end
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _resolve_tokenizer(asset_dir: Optional[str], pad_id: int):
    """(backend, engine or None, reason or None): the one validation that
    both `tokenizer_backend` and `tokenize` read. "bpe" is the exact engine
    over the asset directory's vocab.json + merges.txt, accepted only when
    it is RoBERTa's (<s> = 0, <pad> = the text config's pad id); anything
    else is "byte-fallback" with the reason."""
    from ..utils.bpe import RobertaBPE
    try:
        engine = RobertaBPE.from_assets(asset_dir)
        if engine.bos_id != 0 or engine.pad_id != pad_id:
            raise ValueError(f"tokenizer is not RoBERTa-compatible (<s> = {engine.bos_id}, "
                             f"<pad> = {engine.pad_id}, the text tower pads with {pad_id})")
        return "bpe", engine, None
    except Exception as e:
        return "byte-fallback", None, f"bpe: {type(e).__name__}: {e}"


def tokenizer_backend(cfg: ClapTextCfg = ClapTextCfg(),
                      asset_dir: Optional[os.PathLike] = None) -> tuple:
    """(backend, reason) of `tokenize` with this config and asset
    directory, without tokenizing: "bpe" (exact ids), or "byte-fallback"
    and why (text embeddings are then degraded)."""
    backend, _, reason = _resolve_tokenizer(
        None if asset_dir is None else str(asset_dir), cfg.pad_id)
    return backend, reason


def tokenize(texts: Sequence[str], cfg: ClapTextCfg = ClapTextCfg(),
             asset_dir: Optional[os.PathLike] = None) -> np.ndarray:
    """list[str] -> (N, L) int32 RoBERTa ids: the BPE engine's when
    `tokenizer_backend` says "bpe", else byte-level ids in the vocab's
    reserved low range (<s> = 0, <pad> = pad_id, </s> = 2, byte b at 4 + b),
    rows padded to the longest (at least 2)."""
    backend, engine, reason = _resolve_tokenizer(
        None if asset_dir is None else str(asset_dir), cfg.pad_id)
    if backend == "bpe":
        ids, _ = engine(list(texts), max_len=cfg.max_len)
        return ids
    warnings.warn(f"tokenize: no usable RoBERTa tokenizer ({reason}); byte-level "
                  "ids in use (text embeddings degrade to rare-BPE rows)")
    out = np.full((len(texts), cfg.max_len), cfg.pad_id, dtype=np.int32)
    for i, t in enumerate(texts):
        ids = [0] + [4 + b for b in t.encode("utf-8")[: cfg.max_len - 2]] + [2]
        out[i, : len(ids)] = ids
    longest = max((int((row != cfg.pad_id).sum()) for row in out), default=2)
    return out[:, : max(longest, 2)]


def fusion_crop_starts(total_frames: int, chunk_frames: int):
    """Start frames of the 3 local crops: the centre of each third of the
    range laion_clap samples from (deterministic)."""
    span = total_frames - chunk_frames + 1
    splits = np.array_split(np.arange(max(span, 1)), 3)
    return tuple(int(s[len(s) // 2]) if len(s) else 0 for s in splits)


def _log_mel(x: torch.Tensor, cfg: ClapAudioCfg) -> torch.Tensor:
    """(B, T) -> (B, F, mels): 10 log10(max(mel power, 1e-10))."""
    mel = melspectrogram(x, cfg.sample_rate, cfg.n_fft, cfg.hop, n_mels=cfg.num_mel_bins,
                         power=2.0, f_min=cfg.f_min, f_max=cfg.f_max)
    return (10.0 * torch.log10(torch.clamp(mel, min=1e-10))).transpose(1, 2)


def audio_to_fusion_features(x: torch.Tensor, cfg: ClapAudioCfg,
                             crop_starts=None) -> torch.Tensor:
    """(B, T) mono longer than clip_samples -> (B, 4, chunk, mels)
    [global shrink, front, middle, back]: the whole log-mel shrunk
    (bilinear) to chunk frames, and 3 crops of chunk frames."""
    chunk = cfg.clip_samples // cfg.hop + 1
    logmel = _log_mel(x, cfg)                                  # (B, F, mels)
    total = logmel.shape[1]
    if total <= chunk:
        pad = F.pad(logmel, (0, 0, 0, chunk - total))
        return pad[:, None].repeat(1, 4, 1, 1)
    if crop_starts is None:
        crop_starts = fusion_crop_starts(total, chunk)
    m = device_table(f"bilinear{(total, chunk)}", lambda: _bilinear_matrix(total, chunk),
                     x.device)
    shrink = torch.matmul(m, logmel)                           # "ot,btf->bof"
    crops = [logmel[:, int(s):int(s) + chunk] for s in crop_starts]
    return torch.stack([shrink] + crops, dim=1)


def audio_to_input_features(x: torch.Tensor, cfg: ClapAudioCfg) -> torch.Tensor:
    """(B, T) mono -> (B, 1, frames, mels) log-mel: short clips
    repeat-padded to clip_samples, long ones centre-cropped."""
    t, clip = x.shape[-1], cfg.clip_samples
    if t < clip:
        x = x.repeat(1, -(-clip // t))[:, :clip]
    elif t > clip:
        start = (t - clip) // 2
        x = x[:, start:start + clip]
    return _log_mel(x, cfg)[:, None]


# --------------------------------------------------------------------------
# the laion_clap call surface
# --------------------------------------------------------------------------

class CLAPModule:
    """The audio and text embedders on one device, in f32. The towers are
    built and given seeded random weights at first use (`ensure_params`),
    or take a flax tree from `load_flax_params`."""

    def __init__(self, enable_fusion: bool = True, amodel: str = "HTSAT-base",
                 embed_dim: int = 512, audio_cfg: Optional[dict] = None,
                 text_cfg: Optional[dict] = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 asset_dir: Optional[os.PathLike] = None):
        self.device = resolve_device(device)
        a = dict(audio_cfg or {})
        a.setdefault("patch_embed_hidden", _AMODEL_EMBED.get(amodel, 128))
        a.setdefault("projection_dim", embed_dim)
        a.setdefault("enable_fusion", enable_fusion)
        for k in ("depths", "heads"):
            if k in a:
                a[k] = tuple(a[k])
        t = dict(text_cfg or {})
        t.setdefault("projection_dim", embed_dim)
        self.audio_cfg, self.text_cfg = ClapAudioCfg(**a), ClapTextCfg(**t)
        self.seed, self.asset_dir = seed, asset_dir
        self.audio_model: Optional[ClapAudioEmbedder] = None
        self.text_model: Optional[ClapTextEmbedder] = None

    def _build(self):
        self.audio_model = ClapAudioEmbedder(self.audio_cfg).eval()
        self.text_model = ClapTextEmbedder(self.text_cfg).eval()

    def _place(self):
        for m in (self.audio_model, self.text_model):
            m.to(self.device, torch.float32)

    def ensure_params(self) -> None:
        """Build the towers with seeded random weights unless built."""
        if self.audio_model is None:
            from ..utils.params import random_init_
            self._build()
            random_init_(self.audio_model, self.seed)
            random_init_(self.text_model, self.seed + 1)
            self._place()

    def load_flax_params(self, audio_tree: dict, text_tree: dict) -> None:
        """Pour flax params trees (the JAX module's audio_params and
        text_params)."""
        from ..utils.params import load_flax_params
        self._build()
        load_flax_params(self.audio_model, audio_tree)
        load_flax_params(self.text_model, text_tree)
        self._place()

    def load_ckpt(self, ckpt=None, model_id=None, verbose: bool = False) -> None:
        """laion_clap's signature (JAX models/clap.py:818): pour a torch CLAP
        checkpoint, laion_clap / timm naming with fused qkv or HF
        ClapModel naming, into the towers. The tower configs are inferred
        from the checkpoint's shapes first and the towers rebuilt when they
        differ; the skipped tensors are counted and printed. A file that
        does not load leaves the seeded random weights, with JAX's
        message."""
        if ckpt is None:
            if verbose:
                print("CLAPModule: no checkpoint provided, keeping weights")
            return
        from ..checkpoint import load_torch_checkpoint
        from ..convert import convert_clap_state_dict, infer_clap_cfgs
        from ..utils.params import load_flax_params, to_flax_params

        try:
            sd = load_torch_checkpoint(ckpt)
            if verbose:
                print(f"CLAPModule: loaded {len(sd)} tensors from {ckpt}")
            a_cfg, t_cfg = infer_clap_cfgs(sd, self.audio_cfg, self.text_cfg)
            if a_cfg != self.audio_cfg or t_cfg != self.text_cfg:
                if verbose:
                    print("CLAPModule: re-instantiating towers to checkpoint "
                          f"config (audio {a_cfg.patch_embed_hidden}-wide, "
                          f"text {t_cfg.hidden}-wide)")
                self.audio_cfg, self.text_cfg = a_cfg, t_cfg
                self.audio_model = self.text_model = None
            self.ensure_params()
            audio, text, _, _ = convert_clap_state_dict(
                sd, {"params": to_flax_params(self.audio_model)},
                {"params": to_flax_params(self.text_model)})
            load_flax_params(self.audio_model, audio)
            load_flax_params(self.text_model, text)
        except Exception as e:   # the reference's fallback
            print(f"CLAPModule: {e}. Going with random weights")

    def tokenizer_backend(self) -> tuple:
        return tokenizer_backend(self.text_cfg, self.asset_dir)

    @torch.no_grad()
    def get_audio_embedding_from_data(self, x) -> torch.Tensor:
        """(B, T) or (T,) mono audio at 48 kHz -> (B, 512). With fusion,
        clips longer than clip_samples take the local-crop fusion path.
        Under no_grad (not inference_mode): the trainer feeds the result
        into a graph."""
        self.ensure_params()
        x = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
        x = x.to(self.device, torch.float32)
        if x.dim() == 1:
            x = x[None]
        cfg = self.audio_cfg
        n_frames = x.shape[-1] // cfg.hop + 1
        with full_f32():
            if cfg.enable_fusion and n_frames > cfg.clip_samples // cfg.hop + 1:
                return self.audio_model(audio_to_fusion_features(x, cfg), is_longer=True)
            return self.audio_model(audio_to_input_features(x, cfg))

    @torch.no_grad()
    def get_text_embedding(self, texts: Sequence[str]) -> torch.Tensor:
        """list[str] -> (N, 512)."""
        self.ensure_params()
        ids = torch.from_numpy(tokenize(list(texts), self.text_cfg, self.asset_dir))
        with full_f32():
            return self.text_model(ids.to(self.device, torch.int64))
