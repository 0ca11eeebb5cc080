"""Sequence parallelism: the time axis of 1-D (B, C, T) tensors split over
the ranks of a `seq` world, each rank holding one equal slab.

Port of audio_algebra_tpu/parallel/seq.py. JAX writes each op as a
`shard_map` over a mesh axis; here each function is the body one rank runs
on its slab, with the collectives of parallel.mesh.World between:

  * conv1d_seq        SAME stride-1 conv: the K-1 boundary samples come
                      from the neighbours (World.exchange_halo), then a
                      VALID conv
  * groupnorm1_seq    GroupNorm(num_groups=1) [+ GELU] whose statistics are
                      the whole row's: K1's statistics pass, the partials
                      summed over the ranks, K1's apply pass
                      (ops/groupnorm.groupnorm1_gelu_sharded)
  * resconv_block_seq a whole ResConvBlock (conv5-GN-GELU-conv5-GN-GELU +
                      residual) on the slab, over the block module's own
                      weights

The halo split of an even kernel follows XLA's SAME: (K-1)//2 samples
from the left neighbour and K//2 from the right, so even kernels land on
the unsharded op's offsets.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.groupnorm import groupnorm1_gelu_sharded


def conv1d_seq(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               world) -> torch.Tensor:
    """SAME stride-1 conv of this rank's slab (B, Cin, T_local) with weight
    (Cout, Cin, K): the neighbours' (K-1)//2 left and K//2 right samples
    (zeros at the row's ends), then VALID -> (B, Cout, T_local)."""
    k = weight.shape[-1]
    xh = world.exchange_halo(x, (k - 1) // 2, k // 2)
    return F.conv1d(xh, weight, bias)


def groupnorm1_seq(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, world,
                   gelu: bool = False, residual: torch.Tensor | None = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """[residual +] [gelu](GroupNorm1(x) * scale + bias) on this rank's slab,
    the statistics over the whole row (every rank's slab): one sum of
    [B, n_split, 2] f32 partials over the ranks between K1's two passes."""
    return groupnorm1_gelu_sharded(x.contiguous(), scale.to(x.dtype), bias.to(x.dtype), gelu,
                                   None if residual is None else residual.contiguous(), eps,
                                   world.all_reduce_sum_, world.size)


def resconv_block_seq(x: torch.Tensor, block, world) -> torch.Tensor:
    """models.blocks.ResConvBlock `block` on this rank's slab: the skip
    (skip_proj, a per-sample product, or x), conv5 with halos, the whole
    row's GN + GELU, conv5, and GN + GELU + skip (skip + h for the io
    head, `is_last`)."""
    skip = block._skip((x,))
    h = conv1d_seq(x, block.Conv1d_0.weight, block.Conv1d_0.bias, world)
    gn0 = block.GroupNorm_0
    h = groupnorm1_seq(h, gn0.weight, gn0.bias, world, gelu=gn0.fuse_gelu)
    h = conv1d_seq(h, block.Conv1d_1.weight, block.Conv1d_1.bias, world)
    if block.is_last:
        return skip + h
    gn1 = block.GroupNorm_1
    return groupnorm1_seq(h, gn1.weight, gn1.bias, world, gelu=gn1.fuse_gelu, residual=skip)
