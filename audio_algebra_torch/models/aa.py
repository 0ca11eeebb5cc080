"""EmbedBlock + AudioAlgebra: the trainable re-embedding map h and its
inverse h^-1.

Port of audio_algebra_tpu/models/aa.py: a 4-block MLP encoder and a
same-shaped decoder applied per time step over (b, d, n) embeddings, with
the features last for the products, optional per-block and global
residuals, tanh GELU (flax `nn.gelu`), optional BatchNorm, and a `trivial`
identity mode.

BatchNorm is flax's: statistics over every axis but the last, eps 1e-5,
momentum 0.99 (torch's 0.01), and the running variance takes the biased
batch variance, computed as E[x^2] - E[x]^2 clipped at 0. Whether it runs
on batch or running statistics is the `train` argument of each call, as
in flax, and never `module.training`: the algebra losses call the model
with `train=False`, so inside them BatchNorm always reads its running
statistics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Linear

BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(axis=-1): parameters `scale`, `bias`; the
    `batch_stats` collection `mean`, `var` as buffers."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            rows = x.reshape(-1, x.shape[-1])
            mean = rows.mean(dim=0)
            var = (rows.square().mean(dim=0) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean.detach())
                self.var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var.detach())
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) + self.bias


class EmbedBlock(nn.Module):
    """Dense -> act -> optional BatchNorm, residual when the dims match."""

    def __init__(self, in_dims: int, out_dims: int, act: bool = True, resid: bool = True,
                 use_bn: bool = False):
        super().__init__()
        self.Dense_0 = Linear(in_dims, out_dims)
        self.BatchNorm_0 = BatchNorm(out_dims) if use_bn else None
        self.act = act
        self.resid = resid and in_dims == out_dims

    def forward(self, xin: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.Dense_0(xin)
        if self.act:
            x = gelu(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, train)
        return xin + x if self.resid else x


class _MLP(nn.Module):
    def __init__(self, dims: int, hidden_dims: int, resid: bool, use_bn: bool):
        super().__init__()
        self.EmbedBlock_0 = EmbedBlock(dims, hidden_dims, resid=resid, use_bn=use_bn)
        self.EmbedBlock_1 = EmbedBlock(hidden_dims, hidden_dims, resid=resid, use_bn=use_bn)
        self.EmbedBlock_2 = EmbedBlock(hidden_dims, hidden_dims, resid=resid, use_bn=use_bn)
        self.EmbedBlock_3 = EmbedBlock(hidden_dims, dims, act=False, resid=resid,
                                       use_bn=use_bn)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for block in (self.EmbedBlock_0, self.EmbedBlock_1, self.EmbedBlock_2,
                      self.EmbedBlock_3):
            x = block(x, train)
        return x


class AudioAlgebra(nn.Module):
    """h: y -> z and h^-1: z -> y over (b, d, n) embeddings."""

    def __init__(self, dims: int = 32, hidden_dims: int = 64, resid: bool = True,
                 use_bn: bool = False, trivial: bool = False):
        super().__init__()
        self.dims, self.hidden_dims = dims, hidden_dims
        self.resid, self.use_bn, self.trivial = resid, use_bn, trivial
        if not trivial:
            self.encoder = _MLP(dims, hidden_dims, resid, use_bn)
            self.decoder = _MLP(dims, hidden_dims, resid, use_bn)

    def _run(self, mlp: _MLP, xin: torch.Tensor, train: bool) -> torch.Tensor:
        x = mlp(xin.transpose(1, 2), train).transpose(1, 2)    # features last
        return x + xin if self.resid else x

    def encode(self, xin: torch.Tensor, train: bool = False) -> torch.Tensor:
        return xin if self.trivial else self._run(self.encoder, xin, train)

    def decode(self, xin: torch.Tensor, train: bool = False) -> torch.Tensor:
        return xin if self.trivial else self._run(self.decoder, xin, train)

    def forward(self, x: torch.Tensor, train: bool = False):
        """(encode(x), decode(encode(x)))."""
        xprime = self.encode(x, train)
        return xprime, self.decode(xprime, train)
