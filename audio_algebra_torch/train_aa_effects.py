#!/usr/bin/env python
"""Train the AudioAlgebra effects model (za2 ≈ za1 + (zb2 - zb1)).

    python -m audio_algebra_torch.train_aa_effects --training_dir DIR \\
        --batch_size 128 --num_gpus 1 [--ckpt_path RUN/ckpt]
    torchrun --nproc_per_node N -m audio_algebra_torch.train_aa_effects \\
        --training_dir DIR --batch_size 1024 --num_gpus N

Port of the repository's train_aa_effects.py (same flags, through
config.get_all_args; `--device cpu` runs it off the card):
DualEffectsDataset (the host filter bank), the frozen DVAEWrapper, the
trainable AudioAlgebra and aa_effects' loss, Adam on optax's one-cycle
schedule over len(loader) * min(max_epochs, 1000) // accum_batches
updates, a JSONL log
every 25 steps, `demo_log` every `demo_every` steps, and checkpoints
{params, opt_state, step} every `checkpoint_every` steps and, whatever
happens, at the end; `--ckpt_path` resumes as train_aa_mixer does. A step
that raises prints its traceback and ends the run. `--num_gpus N` > 1 runs
over N processes as train_aa_mixer's does (the global batch's VICReg
statistics; rank 0 logs, demos and checkpoints). `main` returns the run's
record.
"""
from __future__ import annotations

import traceback

import torch

from . import aa_effects
from .checkpoint import save_checkpoint
from .config import get_all_args
from .datasets import DataLoader, DualEffectsDataset
from .device import resolve_device
from .train_aa_mixer import (DEMO_STEPS_MAX, LOG_EVERY, StepClock, build_given_model,
                             build_state, resume)
from .parallel.multihost import Shard, data_parallel_world
from .parallel.train import make_data_parallel_step, replicate_state
from .train_clapdae import onecycle_lr
from .utils.logging import RunLogger
from .utils.viz import embeddings_table, pca_point_cloud, save_image, tokens_spectrogram_image

MAX_SCHEDULE_EPOCHS = 1000


def demo_log(logger, aa, given_model, val_batch, step: int, sr: int, demo_steps: int = 35):
    """The demo's media: an embeddings table, a 3-D PCA cloud, the token
    spectrograms of the embeddings, and decoded audio of the algebra's
    guess za2_guess = zb2 - zb1 + za1 beside the true za2. A failure is
    printed and does not stop training; returns its message, or None."""
    try:
        zs = aa_effects.do_mixing(val_batch, given_model, aa)["zs"]
        names = ["za1", "zb1", "za2", "zb2"]
        table = embeddings_table(zs, names=names)
        cols = ["name"] + list(next(iter(table.values())).keys())
        rows = [[n] + [s[c] for c in cols[1:]] for n, s in table.items()]
        logger.log_table("demo/emb_stats", cols, rows, step=step)
        logger.log_point_cloud("demo/pca_cloud", pca_point_cloud(torch.cat(zs, dim=0)),
                               step=step)
        for name, z in zip(names, zs):
            img = tokens_spectrogram_image(z)
            path = save_image(img, str(logger.dir / f"tokens_{name}_{step:08d}.png"))
            if path is None:           # no matplotlib: save_image kept the array
                logger.log({f"demo/tokens_{name}":
                            str(logger.dir / f"tokens_{name}_{step:08d}.png.npy")}, step=step)
            else:
                logger.log_image(f"demo/tokens_{name}", path, step=step)
        za1, zb1, za2, zb2 = zs
        za2_guess = zb2 - zb1 + za1
        for name, z in (("za2_guess", za2_guess), ("za2", za2)):
            y = aa.decode(z[:1])
            fake = given_model.decode(y, demo_steps)
            logger.log_audio(f"demo/{name}", fake.float().cpu().numpy(), sr, step=step)
    except Exception as e:             # a demo never stops training
        traceback.print_exc()
        print(f"demo_log error (non-fatal): {e}")
        return f"step {step}: {type(e).__name__}: {e}"
    return None


def main(argv=None) -> dict:
    """Train as the flags say. Returns the run's record, as
    train_aa_mixer.main's."""
    args = get_all_args(argv=argv)
    print(f"args = {args}")
    world = data_parallel_world(args, resolve_device(args.device), "train_aa_effects")
    device = world.device

    train_set = DualEffectsDataset([args.training_dir], sample_rate=args.sample_rate,
                                   sample_size=args.sample_size,
                                   random_crop=args.random_crop, load_frac=args.load_frac)
    train_dl = DataLoader(train_set, batch_size=args.batch_size, shuffle=True,
                          num_workers=min(args.num_workers, 8), seed=args.seed,
                          shard=(world.rank, world.size))
    given_model = build_given_model(args, device)
    encode_fn = aa_effects.given_model_encode_fn(given_model)
    aa, state, total = build_state(args, device, len(train_dl),
                                   min(args.max_epochs, MAX_SCHEDULE_EPOCHS))
    accum = state.opt.accum
    resume(state, args.ckpt_path)
    replicate_state(aa.module, world)
    start_step, start_digest = state.step, state.digest()
    step_fn = make_data_parallel_step(
        lambda y_all, gather: aa_effects.effects_loss(aa.module, y_all, gather), state.opt, world)

    main_rank = world.rank == 0
    logger = RunLogger(project='aa-effects', name=args.name, config=args.to_dict()) \
        if main_rank else None
    records, demo_s, demo_errors = [], [], []
    val_batch = None
    try:
        for epoch in range(args.max_epochs):
            clock = StepClock(device)
            for batch in train_dl:
                step = state.step
                if val_batch is None:
                    val_batch = batch
                clips = aa_effects.as_tensors(device, *(batch[k] for k in aa_effects.CLIP_KEYS))
                data_ms = clock.lap()
                y_all = encode_fn(torch.cat(clips, dim=0))
                encode_ms = clock.lap()
                lr = state.opt.lr()
                logs = step_fn(Shard(y_all))
                updated = step_fn.updated
                state.step += 1
                step_ms = clock.lap()
                rec = {k: float(v) for k, v in logs.items()}
                if updated:              # the rate Adam stepped with
                    lr = state.opt.opt.param_groups[0]["lr"]
                rec.update(step=step, epoch=epoch, lr=lr, updated=updated, data_ms=data_ms,
                           encode_ms=encode_ms, step_ms=step_ms)
                records.append(rec)
                if step % LOG_EVERY == 0 and main_rank:
                    out = {k: rec[k] for k in logs}
                    out.update(epoch=epoch, learning_rate=onecycle_lr(
                        min(step // accum, total - 1), total, state.opt.max_lr))
                    logger.log(out, step=step)
                if args.demo_every and step and step % args.demo_every == 0 and main_rank:
                    clock.lap()
                    error = demo_log(logger, aa, given_model, val_batch, step,
                                     args.sample_rate, demo_steps=min(
                                         getattr(args, 'demo_steps', 35), DEMO_STEPS_MAX))
                    if error:
                        demo_errors.append(error)
                    demo_s.append(clock.lap() / 1e3)
                if args.checkpoint_every and step and step % args.checkpoint_every == 0 \
                        and main_rank:
                    save_checkpoint(f"{logger.dir}/ckpt", state.tree(), step=state.step)
                clock.lap()
    except Exception:
        print("~~~~ training raised: ~~~~")
        traceback.print_exc()
        raise
    finally:
        ckpt = None
        if main_rank:
            ckpt = save_checkpoint(f"{logger.dir}/ckpt", state.tree(), step=state.step)
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
