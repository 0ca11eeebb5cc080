#!/usr/bin/env python
"""Train the AudioAlgebra mixer model with the written-out DDP step.

    python -m audio_algebra_torch.train_aa_mixer_accel --training_dir DIR \\
        --batch_size 128 --num_gpus 1 [--ckpt_path RUN/ckpt]
    torchrun --nproc_per_node N -m audio_algebra_torch.train_aa_mixer_accel \\
        --training_dir DIR --batch_size 1024 --num_gpus N

Port of the repository's train_aa_mixer_accel.py (the Accelerate variant):
where train_aa_mixer trains through parallel.train's step (the global
batch's VICReg statistics), this one trains through
parallel.manual.make_manual_ddp_step: each rank's loss on its own rows,
the gradients averaged by one all_reduce, so the VICReg terms read each
rank's local statistics, as under the reference's DDP. At one process the
two are the same step.

A flat epoch / step loop, HostPrinter's rank-0 prints, a JSONL log every
25 steps, checkpoints {params, opt_state, step} on rank 0 every
`checkpoint_every` steps and at the end, `--ckpt_path` resuming as
train_aa_mixer does; the frozen encoder, the algebra model and Adam on
the one-cycle schedule (accum_batches through aa_mixer.OneCycleAdam) are
train_aa_mixer's. `main` returns the run's record.
"""
from __future__ import annotations

import numpy as np
import torch

from .aa_mixer import get_stems_faders, given_model_encode_fn, make_mixer_loss_fn
from .checkpoint import save_checkpoint
from .config import get_all_args
from .datasets import AudioDataset, DataLoader
from .device import resolve_device
from .parallel.manual import make_manual_ddp_step
from .parallel.multihost import HostPrinter, data_parallel_world, global_batch_sharding
from .parallel.train import replicate_state
from .train_aa_mixer import LOG_EVERY, build_given_model, build_state, resume
from .train_clapdae import onecycle_lr
from .utils.logging import RunLogger


def main(argv=None) -> dict:
    """Train as the flags say. Returns the run's record: per-step logs
    (averaged over the ranks) and learning rates, the checkpoint written at
    the end (rank 0), and the state's digests at the start and the end."""
    args = get_all_args(argv=argv)
    hprint = HostPrinter(prefix="[accel] ")
    hprint(f"args = {args}")
    world = data_parallel_world(args, resolve_device(args.device), "train_aa_mixer_accel")
    device, seed = world.device, args.seed

    train_set = AudioDataset([args.training_dir], sample_rate=args.sample_rate,
                             sample_size=args.sample_size, random_crop=args.random_crop,
                             load_frac=args.load_frac,
                             cache_training_data=args.cache_training_data)
    train_dl = DataLoader(train_set, batch_size=args.batch_size, shuffle=True,
                          num_workers=min(args.num_workers, 8), seed=seed,
                          shard=(world.rank, world.size))
    given_model = build_given_model(args, device)
    aa, state, total = build_state(args, device, len(train_dl), args.max_epochs)
    resume(state, args.ckpt_path)
    replicate_state(aa.module, world)
    start_step, start_digest = state.step, state.digest()

    loss_fn = make_mixer_loss_fn(aa.module, given_model_encode_fn(given_model))
    step_fn = make_manual_ddp_step(
        lambda stems_b, faders, batch: loss_fn(stems_b.transpose(0, 1), faders, batch),
        state.opt, world)
    place = global_batch_sharding(world, args.batch_size // world.size)

    main_rank = world.rank == 0
    logger = RunLogger(project='aa-mixer-vicreg', name=args.name, config=args.to_dict()) \
        if main_rank else None
    rng = np.random.default_rng(seed)
    records = []

    def save():
        """Rank 0 writes the checkpoint; returns its path (None elsewhere)."""
        if main_rank:
            return save_checkpoint(f"{logger.dir}/ckpt", state.tree(), step=state.step)
        return None

    for epoch in range(args.max_epochs):
        train_iter = iter(train_dl)
        for batch in train_dl:
            step = state.step
            batch = np.asarray(batch, np.float32)
            stems, faders, train_iter = get_stems_faders(batch, train_iter, train_dl, rng=rng)
            lr = state.opt.lr()
            logs = step_fn(place(np.ascontiguousarray(np.swapaxes(stems, 0, 1), np.float32)),
                           torch.from_numpy(faders), place(batch))
            state.step += 1
            rec = {k: float(v) for k, v in logs.items()}
            rec.update(step=step, epoch=epoch, lr=lr, updated=step_fn.updated)
            records.append(rec)
            if step % LOG_EVERY == 0:
                out = {k: rec[k] for k in logs}
                out.update(epoch=epoch, learning_rate=onecycle_lr(
                    min(step // state.opt.accum, total - 1), total, state.opt.max_lr))
                if main_rank:
                    logger.log(out, step=step)
                hprint(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in out.items()))
            if args.checkpoint_every and step and step % args.checkpoint_every == 0:
                save()
    ckpt = save()
    if main_rank:
        logger.finish()
    hprint("training done.")
    return {"records": records, "start_step": start_step, "end_step": state.step,
            "total_updates": total, "ckpt": ckpt,
            "run_dir": str(logger.dir) if main_rank else None,
            "start_digest": start_digest, "end_digest": state.digest(), "state": state,
            "world": world}


if __name__ == "__main__":
    main()
