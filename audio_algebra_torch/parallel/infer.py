"""Sequence-parallel inference: one DiffusionAttnUnet1D forward with its
time axis split over the ranks of a `seq` world.

Port of audio_algebra_tpu/parallel/infer.py, written over the port's own
models/unet1d.DiffusionAttnUnet1D module (its `stack_NNN` blocks and
their weights), not over a param tree. Each rank holds one time slab of
the input and returns its slab of the output. Sharded outer, replicated
core:

  * levels 0..J-1 (the long time axis and nearly all the conv work) run on
    the slabs: halo convs (parallel/seq.py), GroupNorms whose statistics
    are summed over the ranks between K1's two passes, and the [1,3,3,1]
    resamplers as VALID convs over one halo sample a side, whose outputs
    land on the unsharded op's offsets;
  * at level J the slabs are gathered along time and the deep levels,
    every self-attention level among them, run whole on every rank
    through the module's own stacks (K1 whole);
  * the up sweep cuts each rank's slab out of the replicated result again
    and consumes the skips that never left the rank.

JAX runs this inside one `shard_map`; here the collectives are calls on
the World (parallel.mesh). The turbo int8 route is not taken: JAX's
sequence-parallel path is bf16 / f32 only.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .seq import resconv_block_seq

__all__ = ["decode_unet_seqpar", "pick_sharded_levels"]


def pick_sharded_levels(t_len: int, n_shards: int, depth: int, attn_start: int,
                        min_local: int = 16) -> int:
    """How many outer UNet levels run on the slabs: each must keep an even
    slab of at least min_local samples (the halo exchange and the stride-2
    resample need that), attention levels stay whole (they mix the whole
    time axis), and so does at least the bottleneck."""
    j = 0
    while (j < attn_start and j < depth - 1
           and (t_len >> j) % (2 * n_shards) == 0
           and (t_len >> j) // n_shards >= min_local):
        j += 1
    return j


def _down2_seq(h: torch.Tensor, taps, world) -> torch.Tensor:
    """Downsample1d on a slab: [1,3,3,1]/8, stride 2. One halo sample a
    side, VALID: local output i reads x[2 g0 + 2i - 1 .. 2 g0 + 2i + 2], as
    the global padding-(1, 1) op does."""
    hh = world.exchange_halo(h, 1, 1)
    return F.conv1d(hh, taps.weight(hh), stride=2, groups=h.shape[1])


def _up2_seq(h: torch.Tensor, taps, world) -> torch.Tensor:
    """Upsample1d on a slab: the transposed [1,3,3,1]/4 with stride 2. One
    halo sample a side; padding 3 of the transposed conv (lhs dilation 2,
    no padding) gives exactly the slab's 2 T_local outputs at the global
    offsets."""
    hh = world.exchange_halo(h, 1, 1)
    return F.conv_transpose1d(hh, taps.weight(hh), stride=2, padding=3, groups=h.shape[1])


def _stack3_seq(stack, h: torch.Tensor, world) -> torch.Tensor:
    if stack.attn:
        raise ValueError("an attention level cannot run on time slabs")
    for block in (stack.m0, stack.m2, stack.m4):
        h = resconv_block_seq(h, block, world)
    return h


def decode_unet_seqpar(unet, x: torch.Tensor, t: torch.Tensor,
                       cond: Optional[torch.Tensor], world,
                       sharded_levels: Optional[int] = None) -> torch.Tensor:
    """`unet` (models/unet1d.DiffusionAttnUnet1D) on this rank's slab.

    x is this rank's time slab (B, io, T / world.size) of the input, t (B,)
    and cond (B, cond_dim, n) the whole ones; returns this rank's slab of
    v. `sharded_levels` (default: pick_sharded_levels) is how many outer
    levels run on slabs. The result is the unsharded forward's up to the
    order of the sums (f32 statistics, the same ops in the same order)."""
    depth = unet.depth
    attn_start = unet.attn_start
    t_local = x.shape[-1]
    t_len = t_local * world.size
    n_sharded = (pick_sharded_levels(t_len, world.size, depth, attn_start)
                 if sharded_levels is None else int(sharded_levels))
    if not 0 <= n_sharded <= min(attn_start, depth - 1):
        raise ValueError(f"sharded_levels={n_sharded} conflicts with attn_start={attn_start} "
                         f"and depth={depth}")
    if (t_len >> n_sharded) % world.size or (n_sharded and (t_len >> (n_sharded - 1)) %
                                              (2 * world.size)):
        raise ValueError(f"{n_sharded} sharded levels do not split T = {t_len} over "
                         f"{world.size} ranks")
    if unet.cond_dim > 0 and cond is None:
        raise ValueError("cond_dim > 0 requires a conditioning signal")

    g0 = world.rank * t_local                     # the slab's global start
    emb = unet.timestep_embed(t)
    parts = [x, emb[:, :, None].expand(emb.shape[0], emb.shape[1], t_local)]
    if unet.cond_dim > 0:
        n = cond.shape[-1]
        gi = torch.div((g0 + torch.arange(t_local, device=cond.device)) * n, t_len,
                       rounding_mode="floor")
        parts.append(cond[:, :, gi])
    h = torch.cat(parts, dim=1)

    def stack(i):
        return getattr(unet, f"stack_{i:03d}")

    skips_local = []
    for j in range(n_sharded):                    # the sharded down sweep
        h = _stack3_seq(stack(j), h, world)
        skips_local.append(h)
        h = _down2_seq(h, unet.down, world)

    h = world.all_gather_time(h)                  # the replicated core
    skips_full = []
    for j in range(n_sharded, depth):
        h = stack(j)(h)[0]
        if j < depth - 1:
            skips_full.append(h)
            h = unet.down(h)
    for j in reversed(range(n_sharded, depth)):
        if j < depth - 1:
            h = torch.cat([unet.up(h), skips_full.pop()], dim=1)
        h = stack(2 * depth - 1 - j)(h)[0]

    loc = h.shape[-1] // world.size               # my slab of the core's result
    h = h[..., world.rank * loc:(world.rank + 1) * loc]
    for j in reversed(range(n_sharded)):          # the sharded up sweep
        h = torch.cat([_up2_seq(h, unet.up, world), skips_local.pop()], dim=1)
        h = _stack3_seq(stack(2 * depth - 1 - j), h, world)
    return h
