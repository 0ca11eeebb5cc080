"""FSDP: the train state (parameters, EMA, Adam m and v) sharded over the
ranks of a `data` world (ZeRO-3).

Port of audio_algebra_tpu/parallel/fsdp.py onto torch's FSDP2
(`torch.distributed.fsdp.fully_shard` on a 1-D DeviceMesh of the group).
MIRAGE's trainer is held back by its replicated f32 state: 499 M
parameters make params + EMA + Adam m and v about 8 GB a card, which caps
the batch. Sharded, each rank keeps 1/N of every leaf; FSDP2 all-gathers
the parameters for the step's forward and backward and reduce-scatters
the gradients, so that each rank's Adam and EMA update only its shards.

Placement. JAX's rule (`leaf_spec`, its `_leaf_spec`): a leaf is sharded
along its largest dimension that the number of ranks divides, and
replicated when it has fewer than `min_size` (2^14) elements or no such
dimension. FSDP2's `shard_placement_fn` takes a `Shard(dim)` and offers no
replication, so the port shards every leaf: along JAX's dimension where
it has one (the small leaves too, by the same rule without the minimum),
else along dim 0, which FSDP2 splits unevenly (torch.chunk's pieces, the
storage padded). `state_bytes_per_device` reports that layout.

Gradient scale. The port's global-batch step (train_clapdae.make_train_step,
parallel.train) sums the ranks' gradients of the global batch's mean loss
(each rank's backward carries its rows' share). FSDP2's reduce-scatter
averages by default; `shard_state` sets its divide factor to 1, so the
reduce-scatter sums, and the update is the replicated step's.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["fsdp_sharding", "leaf_spec", "shard_state", "state_bytes_per_device"]

MIN_SIZE = 2 ** 14


def leaf_spec(shape, n_shards: int, min_size: int = MIN_SIZE) -> Optional[int]:
    """JAX's `_leaf_spec`: the dimension to shard a leaf of `shape` along
    (the largest that n_shards divides), or None (replicated) when the leaf
    has fewer than `min_size` elements or no such dimension."""
    if int(np.prod(shape, dtype=np.int64)) < min_size:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % n_shards == 0 and d >= n_shards and (best is None or d > shape[best]):
            best = i
    return best


def placement_dim(shape, n_shards: int) -> int:
    """The dimension the port shards a leaf along: JAX's rule without the
    size minimum, else dim 0 (split unevenly by FSDP2)."""
    dim = leaf_spec(shape, n_shards, 0)
    return 0 if dim is None else dim


def _leaves(tree) -> dict:
    """name -> tensor of a module's parameters, a dict or a list."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, dict):
        return dict(tree)
    return {str(i): t for i, t in enumerate(tree)}


def fsdp_sharding(tree, world) -> dict:
    """name -> the dimension each leaf of `tree` (a module, or a name ->
    tensor dict) is sharded along over `world`'s ranks (placement_dim)."""
    return {name: placement_dim(tuple(t.shape), world.size)
            for name, t in _leaves(tree).items()}


def state_bytes_per_device(tree, world) -> int:
    """Resident bytes a rank holds of `tree` (a module, a name -> tensor
    dict, or a list of tensors) under the port's placement: each leaf's
    largest piece, ceil(d / n) along its placement dim."""
    total = 0
    for t in _leaves(tree).values():
        shape = list(t.shape)
        if shape:
            dim = placement_dim(tuple(shape), world.size)
            shape[dim] = -(-shape[dim] // world.size)
        total += math.prod(shape) * t.element_size()
    return total


def full_tensor(t):
    """A DTensor's whole value (a collective: every rank calls it); any
    other value as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _set_sum_reduction(module) -> None:
    """FSDP2's reduce-scatter sums the ranks' gradients: divide factor 1,
    and a plain SUM on the wire where the build can ask for it (gloo has no
    PREMUL_SUM, which a custom factor otherwise takes)."""
    if hasattr(module, "set_gradient_divide_factor"):
        module.set_gradient_divide_factor(1.0)
    else:
        module.set_reduce_scatter_divide_factor(1.0)
    if hasattr(module, "set_force_sum_reduction_for_comms"):
        module.set_force_sum_reduction_for_comms(True)


def shard_state(state, world):
    """Shard a train state (train_clapdae.TrainState: `model`, `ema_params`
    name -> tensor, `opt` a torch optimiser) over `world`'s ranks, in place:
    fully_shard the model on a 1-D DeviceMesh of the group with the port's
    placement, the gradient reduce-scatter set to sum; the EMA copies
    distributed with their parameters' placements (the EMA then updates
    the local shards, elementwise, in the replicated order); the optimiser
    rebuilt over the sharded parameters with its state distributed the
    same way. Call it after loading or broadcasting the replicated state.
    Returns (state, fsdp_sharding)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard, distribute_tensor

    model = state.model
    sharding = fsdp_sharding(model, world)
    names = {id(p): name for name, p in model.named_parameters()}
    params_before = [p for g in state.opt.param_groups for p in g["params"]]
    opt_sd = state.opt.state_dict()
    mesh = init_device_mesh(world.device.type, (world.size,))
    fully_shard(model, mesh=mesh,
                shard_placement_fn=lambda p: Shard(sharding[names[id(p)]]))
    _set_sum_reduction(model)
    params = dict(model.named_parameters())
    state.ema_params = {name: distribute_tensor(e.detach().to(world.device), mesh,
                                                params[name].placements)
                        for name, e in state.ema_params.items()}
    new_params = [params[names[id(p)]] for p in params_before]
    opt = type(state.opt)(new_params, **state.opt.defaults)
    for idx, entry in opt_sd["state"].items():
        p = new_params[idx]
        for key, v in entry.items():
            if torch.is_tensor(v) and tuple(v.shape) == tuple(p.shape) and v.dim():
                entry[key] = distribute_tensor(v.to(world.device), mesh, p.placements)
    opt.load_state_dict(opt_sd)
    state.opt = opt
    state.sharded = True
    return state, sharding
