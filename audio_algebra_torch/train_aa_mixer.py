#!/usr/bin/env python
"""Train the AudioAlgebra mixer model (zsum ≈ zmix).

    python -m audio_algebra_torch.train_aa_mixer --training_dir DIR \\
        --batch_size 128 --num_gpus 1 [--ckpt_path RUN/ckpt]
    torchrun --nproc_per_node N -m audio_algebra_torch.train_aa_mixer \\
        --training_dir DIR --batch_size 1024 --num_gpus N

Port of the repository's train_aa_mixer.py (same flags, through
config.get_all_args; `--device cpu` runs it off the card):

  * the frozen DVAEWrapper encodes the stems, their mix and the raw batch
    (`model_config` names a JSON of model kwargs; without a checkpoint, and
    none is read yet, its weights are the seeded random ones)
  * the trainable AudioAlgebra(latent_dim, hidden_dims) and the mixer loss
    (aa_mixer.make_mixer_loss_fn, in two timed stages)
  * Adam on optax's one-cycle schedule over len(loader) * max_epochs //
    accum_batches updates, optax.MultiSteps' averaging for accum_batches >
    1 (aa_mixer.OneCycleAdam)
  * a JSONL log every 25 steps, decoded zsum / zmix audio every
    `demo_every` steps, checkpoints {params, opt_state, step} every
    `checkpoint_every` steps and at the end; `--ckpt_path` resumes params,
    Adam's state and the step from the newest one there (params only from
    a checkpoint without an optimiser state); the loop then takes every
    epoch's batches again, as the reference's does

f32, no autocast. `--num_gpus N` > 1 trains over N processes (torchrun,
parallel.multihost.data_parallel_world), each encoding its rows of every
global batch, through parallel.train's step: the mixer loss's VICReg
terms read the global batch's statistics, as the JAX step's do. Rank 0 logs, runs
the demos and writes the checkpoints. `main` returns the run's record.
"""
from __future__ import annotations

import pickle
import time
import traceback

import numpy as np
import torch

from .aa_mixer import (AABundle, OneCycleAdam, aa_demo, as_tensors, do_mixing,
                       encode_mixer_inputs, get_stems_faders, given_model_encode_fn,
                       mixer_loss)
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .config import get_all_args, load_model_config
from .datasets import AudioDataset, DataLoader
from .device import resolve_device
from .given_models import DVAEWrapper
from .parallel.multihost import Shard, data_parallel_world
from .parallel.train import make_data_parallel_step, replicate_state
from .train_clapdae import onecycle_lr
from .utils.logging import RunLogger

LOG_EVERY = 25
DEMO_STEPS_MAX = 35


class AATrainState:
    """What a step updates: the algebra model (parameters and BatchNorm
    buffers, in place), the optimiser and the step count."""

    def __init__(self, module: torch.nn.Module, opt: OneCycleAdam, step: int = 0):
        self.module, self.opt, self.step = module, opt, step

    def tree(self) -> dict:
        """The checkpoint's state tree."""
        return {"params": self.module.state_dict(), "opt_state": self.opt.state_dict(),
                "step": self.step}

    def restore(self, ck: str) -> None:
        """Load params, the optimiser's state and the step from the
        checkpoint `ck`; params and step alone from one without an
        optimiser state."""
        tree = load_checkpoint(ck)
        self.module.load_state_dict(tree["params"])
        if tree.get("opt_state") is not None:
            self.opt.load_state_dict(tree["opt_state"])
            print(f"Resumed from {ck} at step {int(tree['step'])}")
        else:
            print(f"Resumed (params only, no opt_state) from {ck} at step {int(tree['step'])}")
        self.step = int(tree["step"])

    def digest(self) -> dict:
        """Exact integer checksums of the model's and the optimiser's bits:
        two states with the same digests hold the same numbers."""
        def bits(tensors):
            return int(sum(int(t.detach().contiguous().view(torch.int32).to(torch.int64).sum())
                           for t in tensors if t.dtype == torch.float32))
        adam = [v for s in self.opt.opt.state.values() for v in s.values()
                if isinstance(v, torch.Tensor)]
        return {"params": bits(self.module.state_dict().values()), "opt": bits(adam),
                "updates": self.opt.updates}


def build_given_model(args, device) -> DVAEWrapper:
    """The frozen DVAEWrapper of the flags: `model_config` kwargs, seeded
    weights (no checkpoint is read yet)."""
    model_kwargs, cfg_args = load_model_config(args.model_config)
    args_dict = {'sample_size': args.sample_size, 'latent_dim': args.latent_dim,
                 'num_quantizers': args.num_quantizers, 'pqmf_bands': args.pqmf_bands}
    args_dict.update(cfg_args)
    given_model = DVAEWrapper(args_dict=args_dict, model_kwargs=model_kwargs,
                              seed=args.seed, device=device)
    if args.dvae_ckpt_file:
        print(f"dvae_ckpt_file {args.dvae_ckpt_file} is not read: the port pours no "
              "checkpoint yet")
    given_model.setup(gdrive=False)
    given_model.model.requires_grad_(False)
    return given_model


def build_state(args, device, n_batches: int, schedule_epochs: int):
    """(AABundle, AATrainState, total optimiser updates) for the flags,
    with `n_batches` the loader's batches an epoch and the schedule over
    `schedule_epochs` epochs."""
    accum = max(int(getattr(args, 'accum_batches', 1) or 1), 1)
    total = max(max(n_batches, 1) * schedule_epochs // accum, 1)
    if total < 4:
        print(f"one-cycle schedule over {total} updates: optax's is NaN below 4, and so "
              "is this one's")
    aa = AABundle(dims=args.latent_dim, hidden_dims=getattr(args, 'hidden_dims', args.latent_dim),
                  seed=args.seed, device=device)
    opt = OneCycleAdam(aa.module, total, getattr(args, 'max_lr', 1e-3), accum)
    return aa, AATrainState(aa.module, opt), total


def resume(state: AATrainState, ckpt_path: str) -> None:
    if not ckpt_path:
        return
    ck = latest_checkpoint(ckpt_path) or ckpt_path
    try:
        state.restore(ck)
    except (OSError, KeyError, RuntimeError, pickle.UnpicklingError) as e:
        print(f"Resume failed ({e}); starting fresh")


class StepClock:
    """Host milliseconds between marks, the card synchronised at each."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t = self.now()

    def now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self) -> float:
        t, self.t = self.t, self.now()
        return (self.t - t) * 1e3


def main(argv=None) -> dict:
    """Train as the flags say. Returns the run's record: per-step loss
    terms, the learning rate Adam stepped with and times (host data, frozen
    encode, algebra forward + backward + Adam), each demo's seconds and the
    errors of demos that failed, the checkpoint written at the end, and the
    state's digests at the start and the end."""
    args = get_all_args(argv=argv)
    print(f"args = {args}")
    world = data_parallel_world(args, resolve_device(args.device), "train_aa_mixer")
    device = world.device
    seed = args.seed

    train_set = AudioDataset([args.training_dir], sample_rate=args.sample_rate,
                             sample_size=args.sample_size, random_crop=args.random_crop,
                             load_frac=args.load_frac,
                             cache_training_data=args.cache_training_data)
    train_dl = DataLoader(train_set, batch_size=args.batch_size, shuffle=True,
                          num_workers=min(args.num_workers, 8), seed=seed,
                          shard=(world.rank, world.size))
    given_model = build_given_model(args, device)
    encode_fn = given_model_encode_fn(given_model)
    aa, state, total = build_state(args, device, len(train_dl), args.max_epochs)
    accum = state.opt.accum
    resume(state, args.ckpt_path)
    replicate_state(aa.module, world)
    start_step, start_digest = state.step, state.digest()
    step_fn = make_data_parallel_step(
        lambda y_all, y_batch, nstems, gather: mixer_loss(aa.module, y_all, y_batch, nstems,
                                                          gather), state.opt, world)

    main_rank = world.rank == 0
    logger = RunLogger(project='aa-mixer-vicreg', name=args.name, config=args.to_dict()) \
        if main_rank else None
    rng = np.random.default_rng(seed)
    demo_every = getattr(args, 'demo_every', 0)
    records, demo_s, demo_errors = [], [], []

    def demo(step, stems, faders):
        try:
            zsum, zmix, _ = do_mixing(stems[:, :1], faders, given_model, aa)
            logs = aa_demo(given_model, aa, {}, zsum, zmix, step,
                           demo_steps=min(getattr(args, 'demo_steps', 35), DEMO_STEPS_MAX),
                           sr=args.sample_rate, out_dir=str(logger.dir))
            logger.log({f"demo/{k}": v for k, v in logs.items()}, step=step)
        except Exception as e:       # a demo never stops training
            traceback.print_exc()
            print(f"demo error (non-fatal): {e}")
            demo_errors.append(f"step {step}: {type(e).__name__}: {e}")

    def save():
        """Rank 0 writes the checkpoint; returns its path (None elsewhere)."""
        if main_rank:
            return save_checkpoint(f"{logger.dir}/ckpt", state.tree(), step=state.step)
        return None

    for epoch in range(args.max_epochs):
        train_iter = iter(train_dl)
        clock = StepClock(device)
        for batch in train_dl:
            step = state.step
            batch = np.asarray(batch)
            stems, faders, train_iter = get_stems_faders(batch, train_iter, train_dl, rng=rng)
            data_ms = clock.lap()
            if demo_every and step and step % demo_every == 0 and main_rank:
                demo(step, stems, faders)
                demo_s.append(clock.lap() / 1e3)
            stems_t, faders_t, batch_t = as_tensors(device, stems, faders, batch)
            data_ms += clock.lap()
            y_all, y_batch = encode_mixer_inputs(encode_fn, stems_t, faders_t, batch_t)
            encode_ms = clock.lap()
            lr = state.opt.lr()
            logs = step_fn(Shard(y_all), Shard(y_batch), stems.shape[0])
            updated = step_fn.updated
            state.step += 1
            step_ms = clock.lap()
            rec = {k: float(v) for k, v in logs.items()}
            if updated:                  # the rate Adam stepped with
                lr = state.opt.opt.param_groups[0]["lr"]
            rec.update(step=step, epoch=epoch, lr=lr, updated=updated, data_ms=data_ms,
                       encode_ms=encode_ms, step_ms=step_ms)
            records.append(rec)
            if step % LOG_EVERY == 0 and main_rank:
                out = {k: rec[k] for k in logs}
                out.update(epoch=epoch, learning_rate=onecycle_lr(
                    min(step // accum, total - 1), total, state.opt.max_lr))
                logger.log(out, step=step)
            if args.checkpoint_every and step and step % args.checkpoint_every == 0:
                save()
            clock.lap()
    ckpt = save()
    if main_rank:
        logger.finish()
    print("training done.")
    return {"records": records, "demo_s": demo_s, "demo_errors": demo_errors,
            "start_step": start_step,
            "end_step": state.step, "total_updates": total, "ckpt": ckpt,
            "run_dir": str(logger.dir) if main_rank else None,
            "start_digest": start_digest, "end_digest": state.digest(), "state": state,
            "world": world}


if __name__ == "__main__":
    main()
