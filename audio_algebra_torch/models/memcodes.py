"""Memcodes — the multi-head attention-style vector quantizer of the DVAE.

Port of audio_algebra_tpu/models/memcodes.py (nwt_pytorch's Memcodes /
ResidualMemcodes, the reference DVAE's optional quantizer): each head's
slice of the vector is scored against that head's codebook by a scaled
dot product, and the argmax code is taken, with a straight-through
softmax gradient. `codes` is (heads, num_codes, dim / heads), as in flax.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Memcodes(nn.Module):
    def __init__(self, dim: int = 64, heads: int = 8, num_codes: int = 1024,
                 temperature: float = 1.0):
        super().__init__()
        self.heads, self.num_codes, self.temperature = heads, num_codes, temperature
        self.codes = nn.Parameter(torch.zeros(heads, num_codes, dim // heads))

    def forward(self, x: torch.Tensor):
        """(B, N, dim) -> (quantized (B, N, dim), indices (B, N, heads))."""
        b, n, d = x.shape
        dh = d // self.heads
        codes = self.codes.to(x.dtype)
        xh = x.reshape(b, n, self.heads, dh)
        logits = torch.einsum("bnhd,hcd->bnhc", xh, codes).float()
        logits = logits / (math.sqrt(dh) * self.temperature)
        indices = torch.argmax(logits, dim=-1)
        hard = F.one_hot(indices, self.num_codes).to(logits.dtype)
        soft = torch.softmax(logits, dim=-1)
        onehot = soft + (hard - soft).detach()              # straight-through
        quantized = torch.einsum("bnhc,hcd->bnhd", onehot, self.codes.float())
        return quantized.reshape(b, n, d).to(x.dtype), indices


class ResidualMemcodes(nn.Module):
    """Memcodes stacked over successive residuals (num_quantizers > 1);
    the stages are `quantizer_0`, `quantizer_1`, ..., as in flax."""

    def __init__(self, dim: int = 64, heads: int = 8, num_codes: int = 1024,
                 num_quantizers: int = 2, temperature: float = 1.0):
        super().__init__()
        self.num_quantizers = num_quantizers
        for i in range(num_quantizers):
            setattr(self, f"quantizer_{i}", Memcodes(dim, heads, num_codes, temperature))

    def forward(self, x: torch.Tensor):
        out = torch.zeros_like(x)
        residual = x
        all_indices = []
        for i in range(self.num_quantizers):
            q, idx = getattr(self, f"quantizer_{i}")(residual)
            out = out + q
            residual = residual - q.detach()
            all_indices.append(idx)
        return out, torch.stack(all_indices, dim=-1)
