"""The sequence-folded decode forward and its int8-in-fold turbo route.

Port of audio_algebra_tpu/parallel/fold.py, written over the port's own
models/unet1d.DiffusionAttnUnet1D module, as parallel/infer.py is.

JAX folds time blocks into the batch axis at small batch: its conv layout
puts the batch in the TPU's sublanes, and B = 1 fills one of 16. The fold
is layout only. Its halo zero fill is exactly SAME zero padding, and its
GroupNorm statistics run over the whole (block, T_local, C) extent, so
JAX's own tests hold it equal to the unfolded forward. The port does not
fold. Its rule is "port behaviour, not TPU tricks":

  * its activations are (B, C, T), so a fold would be a permute copy at
    every level;
  * cuDNN's convs have no sublane tile to fill;
  * the outer step at B = 1 is host-bound on the card already (PERF.md §5).

What the fold carries that is not layout is `quantized=True`: the turbo
route of MIRAGE's outer stage below the batch gate. Every conv5 of the
folded levels runs int8 on an exact dynamic per-channel amax (JAX
`_conv5(q=True)`); the halo is zero-filled on the int8 tensor, which is
SAME padding again, since int8's zero point is 0. So `decode_unet_seqfold`
runs the whole sequence at once, with its first `n_folded` down levels and
last `n_folded` up levels in ResConvBlock's `dynamic_int8` mode
(`DiffusionAttnUnet1D.forward(int8_levels=)`) and the deeper levels in
float. The pickers are JAX's, so the same levels run int8.
"""
from __future__ import annotations

from typing import Optional

import torch

from .infer import pick_sharded_levels

__all__ = ["decode_unet_seqfold", "pick_fold_blocks", "pick_folded_levels", "seqfold_ok"]


def seqfold_ok(batch: int, max_b: int = 2) -> bool:
    """JAX's gate of its bf16 layout fold: batch <= max_b (JAX reads
    AA_SEQFOLD and AA_SEQFOLD_MAX_B; the port reads no env var). The port
    takes no layout fold and nothing in it branches on this: it is kept
    beside the other two pickers so the three are held to JAX's together."""
    return batch <= max_b


def pick_fold_blocks(batch: int, target_rows: int = 16) -> int:
    """The fold factor n: the least power of two with batch * n >=
    target_rows (16: JAX's bf16 sublane tile; 32: int8's)."""
    n = 1
    while batch * n < target_rows:
        n *= 2
    return n


def pick_folded_levels(t_len: int, n_blocks: int, depth: int, attn_start: int,
                       min_local: int = 16) -> int:
    """How many outer levels fold: the sequence-parallel picker's rule with
    n_blocks for the shards (even blocks of at least min_local samples
    through every stride-2 resample, attention levels and the bottleneck
    unfolded)."""
    return pick_sharded_levels(t_len, n_blocks, depth, attn_start, min_local)


def decode_unet_seqfold(unet, x: torch.Tensor, t: torch.Tensor,
                        cond: Optional[torch.Tensor] = None, *,
                        folded_levels: Optional[int] = None,
                        quantized: bool = False) -> torch.Tensor:
    """`unet`'s forward as JAX's fold computes it: x (B, io, T), t (B,),
    cond (B, cond_dim, n) -> v (B, io, T). `folded_levels` defaults to
    JAX's choice, `pick_folded_levels` at the fold factor that fills 32
    rows with quantized (int8's tile), 16 without. With `quantized`, those
    levels' conv5s run int8 on a dynamic amax (the UNet checks the count);
    without it the result is the plain forward."""
    if folded_levels is None:
        n_blocks = pick_fold_blocks(x.shape[0], 32 if quantized else 16)
        folded_levels = pick_folded_levels(x.shape[-1], n_blocks, unet.depth, unet.attn_start)
    return unet(x, t, cond, int8_levels=folded_levels if quantized else 0)
