"""The data-parallel step with its collective written out: plain DDP.

Port of audio_algebra_tpu/parallel/manual.py (a `jax.shard_map` with an
explicit `jax.lax.pmean` of the gradients). Each rank computes the loss on
its own rows and the gradients are averaged with one `all_reduce`, which
is what DDP's and Accelerate's backward do behind the scenes. So the
batch-coupled terms (the mixer loss's VICReg variance and covariance) see
each rank's local statistics, as under the reference's DDP;
parallel/train.py's step sees the global batch's. For a loss that is a
mean over examples the two updates are the same.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .mesh import World
from .train import MultiSteps, grads_of, optimizer_params, place_args, take_step


def make_manual_ddp_step(loss_fn: Callable, optimizer, world: World,
                         accum_steps: int = 1, compute_dtype=None,
                         arg_specs: Optional[Sequence] = None) -> Callable:
    """Build `step(*batch_args) -> logs` (the logs averaged over the ranks),
    updating the parameters in place.

    loss_fn(*batch_args) -> (loss, logs) on this rank's rows. Arguments are
    placed by parallel.train.place_args: a tensor of rank >= 2 whose
    leading dim splits over the ranks is cut to the rank's rows, and a
    rank-1 tensor stays whole unless its `arg_specs` entry is "data" —
    shape alone cannot tell a per-example (B,) timestep vector from the
    (nstems,) faders, and cutting the faders would mix each stem with the
    wrong fader. `step.optimizer` is as in make_data_parallel_step."""
    if accum_steps > 1:
        optimizer = MultiSteps(optimizer, accum_steps)
    params = optimizer_params(optimizer)

    def step(*batch_args):
        args = place_args(batch_args, world, compute_dtype, arg_specs)
        loss, logs = loss_fn(*args)
        loss.backward()
        if world.grouped:
            world.all_reduce_mean_(grads_of(params))     # the pmean over 'data'
            names = sorted(logs)
            values = torch.stack([torch.as_tensor(logs[k], dtype=torch.float32,
                                                  device=world.device) for k in names])
            world.all_reduce_mean_([values])
            logs = dict(zip(names, values.unbind()))
        step.updated = take_step(optimizer)
        return logs

    step.optimizer = optimizer
    step.updated = False
    return step
