"""The data-parallel training step with the global batch's semantics.

Port of audio_algebra_tpu/parallel/train.py. JAX's step is one jitted
function over sharded arrays: `loss_fn` sees the global batch and XLA
inserts the collectives, so the mixer loss's VICReg variance and
covariance terms read global batch statistics. torch runs one process a
card, each holding its rows of the batch. `make_data_parallel_step` keeps
JAX's semantics by giving `loss_fn` a `gather` (World.gather: an
all_gather with autograd) that it applies to its per-example tensors
before any term that couples the batch; every rank then computes the same
loss of the global batch, and the ranks' parameter gradients sum to its
gradient. That is not plain DDP, which averages losses of local shards:
parallel/manual.py is that variant.

Gradient accumulation is optax.MultiSteps' (`MultiSteps` below), and
`compute_dtype` casts the floating batch arguments while the parameters
stay f32.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .mesh import World
from .multihost import Shard


def optimizer_params(optimizer) -> list:
    """The parameters an optimiser updates: a torch.optim.Optimizer's
    param groups, else its `params` (aa_mixer.OneCycleAdam, MultiSteps)."""
    if isinstance(optimizer, torch.optim.Optimizer):
        return [p for group in optimizer.param_groups for p in group["params"]]
    return list(optimizer.params)


def take_step(optimizer) -> bool:
    """Step on the gradients of the last backward() and clear them; returns
    whether the parameters were updated."""
    if isinstance(optimizer, torch.optim.Optimizer):
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return True
    return optimizer.step()


class MultiSteps:
    """optax.MultiSteps(optimizer, every_k_schedule=k): the gradients of k
    calls are averaged (acc += (g - acc) / (i + 1)) and the inner
    optimiser steps once on the k-th, with the mean."""

    def __init__(self, optimizer, every_k: int):
        self.inner, self.every_k = optimizer, int(every_k)
        self.params = optimizer_params(optimizer)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0

    def step(self) -> bool:
        with torch.no_grad():
            for p, a in zip(self.params, self.acc):
                if p.grad is not None:
                    a.add_((p.grad - a) / (self.mini_step + 1))
                else:
                    a.mul_(self.mini_step / (self.mini_step + 1))
                p.grad = None
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a.clone()
            a.zero_()
        self.mini_step = 0
        return take_step(self.inner)


def _auto_shards(x, world: World) -> bool:
    """parallel/manual.py's rule in JAX: a tensor of rank >= 2 is cut by
    rank when its leading dim splits over the ranks; a rank-1 one (the
    (nstems,) faders) stays whole. JAX's annotated step shards rank-1
    arguments too, but there a sharding is only a layout; here, as under
    shard_map, it decides what the loss sees."""
    return (torch.is_tensor(x) and x.dim() >= 2
            and x.shape[0] >= world.size and x.shape[0] % world.size == 0)


def place_args(batch_args: Sequence, world: World, compute_dtype=None,
               arg_specs=None) -> list:
    """This rank's view of the step's arguments on its device: a Shard as
    it is; a global tensor cut to the rank's rows where `arg_specs[i]` is
    "data" (or None and the auto rule shards it), whole where it is
    "replicated"; anything else (an int, a string) as it is. Floating
    tensors are cast to `compute_dtype`."""
    out = []
    for i, x in enumerate(batch_args):
        spec = arg_specs[i] if arg_specs is not None else None
        if spec not in (None, "data", "replicated"):
            raise ValueError(f"arg_specs[{i}] = {spec!r}: expected None, 'data' or "
                             "'replicated'")
        if isinstance(x, Shard):
            x = x.local
        elif torch.is_tensor(x) or hasattr(x, "__array__"):
            x = torch.as_tensor(x)
            cut = spec == "data" or (spec is None and _auto_shards(x, world))
            x = (x[world.rows(x.shape[0])] if cut else x).to(world.device)
        if torch.is_tensor(x) and compute_dtype is not None and x.is_floating_point():
            x = x.to(compute_dtype)
        out.append(x)
    return out


def shard_batch(batch, world: World):
    """This rank's rows of a global batch (a tensor, an array, or a dict /
    list of them), on its device."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, world) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, world) for v in batch)
    x = torch.as_tensor(batch)
    return x[world.rows(x.shape[0])].to(world.device)


def make_data_parallel_step(loss_fn: Callable, optimizer, world: World,
                            accum_steps: int = 1, compute_dtype=None,
                            arg_specs: Optional[Sequence] = None,
                            reduce_grads: bool = True) -> Callable:
    """Build `step(*batch_args) -> logs`, updating the parameters in place.

    loss_fn(*batch_args, gather=world.gather) -> (loss, logs): it sees this
    rank's rows of the sharded arguments and must reach every batch
    statistic (means included) through `gather`, so that its loss, and its
    logs, are the global batch's on every rank. Arguments are placed by
    `place_args` (`arg_specs` as there; the auto rule shards rank >= 2
    arguments whose leading dim splits over the ranks and keeps rank-1 ones
    whole). `step.optimizer` is the optimiser the step drives, wrapped in
    MultiSteps when accum_steps > 1: checkpoint that one. `reduce_grads`
    False leaves the gradients as backward left them: a model sharded by
    parallel.fsdp reduce-scatters (sums) them itself."""
    if accum_steps > 1:
        optimizer = MultiSteps(optimizer, accum_steps)
    params = optimizer_params(optimizer)

    def step(*batch_args):
        args = place_args(batch_args, world, compute_dtype, arg_specs)
        loss, logs = loss_fn(*args, gather=world.gather)
        loss.backward()
        if world.grouped and reduce_grads:
            world.all_reduce_sum_(grads_of(params))
        step.updated = take_step(optimizer)
        return logs

    step.optimizer = optimizer
    step.updated = False
    return step


def grads_of(params) -> list:
    """Every parameter's gradient (zeros where backward left none), so that
    each rank reduces the same buffers."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def replicate_state(state, world: World):
    """Rank 0's values in every rank: a module's parameters and buffers, or
    a dict / list of tensors on the world's device, broadcast in place.
    Returns `state`."""
    if isinstance(state, torch.nn.Module):
        tensors = [t.data for t in state.parameters()] + list(state.buffers())
    elif isinstance(state, dict):
        tensors = [v for v in state.values() if torch.is_tensor(v)]
    else:
        tensors = [v for v in state if torch.is_tensor(v)]
    world.broadcast_(tensors)
    return state
