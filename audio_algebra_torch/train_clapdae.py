#!/usr/bin/env python
"""Train the MIRAGE generator (StackedAELatentDiffusionCond).

    python -m audio_algebra_torch.train_clapdae --training_dir DIR \\
        --batch_size 8 --sample_size 1048576 --num_gpus 1 [--ckpt_path RUN/ckpt]
    torchrun --nproc_per_node N -m audio_algebra_torch.train_clapdae \\
        --training_dir DIR --batch_size 8N ... --num_gpus N

Port of the repository's train_clapdae.py (same flags, through
config.get_all_args; `--device cpu` runs it off the card):

  * the frozen stage-1 stack encodes reals to 32-d latents
  * the frozen CLAP embeds the mono mix to (B, 1, 512) conditioning
  * scrambled-Sobol timestep draws
  * v-objective MSE with 0.1 CFG dropout through the UNetCFG1d (kernels K5
    and, under grad, the differentiable flash attention K4)
  * Adam (lr 4e-5, betas 0.9 / 0.999, eps 1e-8) with optax's cosine decay to
    1e-6 over 500 steps, flat afterwards
  * EMA of the diffusion parameters, beta 0.9999, power 3/4
  * a JSONL run log and checkpoints {params, ema_params, opt_state, step};
    `--ckpt_path` resumes from the newest one there

f32 parameters and activations, no autocast, as in JAX's trainer;
`make_train_step(..., compute_dtype=torch.bfloat16)` is JAX's bf16 training
step of tools/bench_train.py (bf16 compute on the f32 masters), which the
CLI does not expose, as JAX's trainer does not. The step's noise
and CFG-dropout mask come from a torch.Generator seeded per step from
(seed, step) on the host, for the global batch (`step_draws`); the step
of `make_train_step` takes them as arguments. `--num_gpus N` > 1 runs
parallel.train's data-parallel step over N processes
(parallel.multihost.data_parallel_world): each loads its rows of every
global batch, and the loss is the global batch's mean. `--fsdp 1` with
more than one process shards the parameters, the EMA and Adam's state over
them (parallel/fsdp.py, FSDP2; one process keeps the replicated state, as
JAX shards only when its data axis is larger than 1). Checkpoints hold
whole tensors, written by rank 0, so a run resumes into either layout.
"""
from __future__ import annotations

import json
import math
import pickle
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .config import get_all_args
from .datasets import AudioDataset, DataLoader
from .device import call_with, cast_params, resolve_device
from .given_models import CLAPDAE
from .models.ema import EMASchedule
from .models.stacked import v_objective_loss
from .parallel.fsdp import full_tensor, shard_state, state_bytes_per_device
from .parallel.mesh import World
from .parallel.multihost import Shard, data_parallel_world
from .parallel.train import make_data_parallel_step, replicate_state
from .utils.logging import RunLogger
from .utils.qmc import SobolSampler

LR_MIN = 1e-6
LOG_EVERY = 25


def cosine_lr(step: int, lr: float, t_max: int, lr_min: float = LR_MIN) -> float:
    """optax.cosine_decay_schedule(lr, t_max, alpha=lr_min / lr): a half
    cosine from lr to lr_min over t_max steps, then flat at lr_min (torch's
    CosineAnnealingLR swings back up)."""
    alpha = lr_min / lr
    s = min(step, t_max)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * s / t_max)) + alpha)


def onecycle_lr(step: int, total_steps: int, max_lr: float, pct_start: float = 0.3,
                div_factor: float = 25.0, final_div_factor: float = 1e4) -> float:
    """optax.cosine_onecycle_schedule(total_steps, max_lr): a half cosine
    from max_lr / div_factor up to max_lr over the first
    int(pct_start * total_steps) steps, a half cosine down to
    max_lr / (div_factor * final_div_factor) by int(total_steps), flat
    after. As in optax, a phase of zero steps (total_steps < 4 at the
    default pct_start) makes every value NaN: optax divides by the
    phase's length whether or not the step lies in it."""
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = [max_lr / div_factor, max_lr, max_lr / (div_factor * final_div_factor)]
    if bounds[1] == bounds[0] or bounds[2] == bounds[1]:
        return math.nan
    for i in range(2):
        if bounds[i] <= step < bounds[i + 1]:
            pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * \
                (math.cos(math.pi * pct) + 1.0)
    return values[2]


@dataclass
class TrainState:
    """What a step updates: the model's parameters (in place), their EMA
    copies (name -> tensor), Adam's state and the step count. `sharded`:
    parallel.fsdp.shard_state has sharded them over the ranks."""
    model: torch.nn.Module
    ema_params: dict
    opt: torch.optim.Optimizer
    step: int = 0
    lr: float = 4e-5
    t_max: int = 500
    ema_sched: EMASchedule = field(default_factory=lambda: EMASchedule(0.9999, 0.75))
    sharded: bool = False

    def current_lr(self) -> float:
        return cosine_lr(self.step, self.lr, self.t_max)

    def tree(self) -> dict:
        """The checkpoint's state tree, of whole tensors in either layout
        (sharded, every rank must call it: it gathers)."""
        opt = self.opt.state_dict()
        opt["state"] = {i: {k: full_tensor(v) for k, v in entry.items()}
                        for i, entry in opt["state"].items()}
        return {"params": {k: full_tensor(v.detach())
                           for k, v in self.model.named_parameters()},
                "ema_params": {k: full_tensor(v) for k, v in self.ema_params.items()},
                "opt_state": opt, "step": self.step}

    def load_tree(self, tree: dict) -> None:
        """Load a checkpoint's tree into the replicated state (before
        shard_state)."""
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(tree["params"][name])
            for name, e in self.ema_params.items():
                e.copy_(tree["ema_params"][name])
        self.opt.load_state_dict(tree["opt_state"])
        self.step = int(tree["step"])

    def digest(self) -> dict:
        """Exact integer checksums of the parameters' and the EMA copies'
        bits: two states with the same digests hold the same weights."""
        def bits(tensors):
            return int(sum(int(full_tensor(t.detach()).contiguous().view(torch.int32)
                               .to(torch.int64).sum()) for t in tensors))
        return {"params": bits(self.model.parameters()),
                "ema": bits(self.ema_params.values())}


def make_state(model: torch.nn.Module, lr: float = 4e-5, t_max: int = 500) -> TrainState:
    """A fresh train state around `model` (its parameters f32, requires_grad
    on): EMA copies of the parameters and optax-like Adam."""
    params = dict(model.named_parameters())
    ema = {k: v.detach().clone() for k, v in params.items()}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0, amsgrad=False)
    return TrainState(model=model, ema_params=ema, opt=opt, lr=lr, t_max=t_max)


def build_state(args, device, clap_module=None):
    """(CLAPDAE with its encoders frozen, TrainState) for `args`
    (config.get_all_args) on `device`. `clap_module`: a CLAP module to use
    instead of building one (its weights are frozen either way)."""
    cfg = {}
    if args.model_config:
        with open(args.model_config) as f:
            cfg = json.load(f)
    clapdae = CLAPDAE(sample_size=args.sample_size, seed=args.seed,
                      first_stage_config=cfg.get("first_stage_config"),
                      model_kwargs=cfg.get("model_kwargs"),
                      clap_kwargs=cfg.get("clap_kwargs"), device=device)
    if clap_module is not None:
        clapdae.clap_module = clap_module
    clapdae.freeze_for_training()
    state = make_state(clapdae.latent_diffusion_model, lr=getattr(args, "lr", 4e-5),
                       t_max=getattr(args, "lr_t_max", 500))
    return clapdae, state


def mixed_precision(model: torch.nn.Module, compute_dtype: torch.dtype) -> Callable:
    """The model as the v-objective calls it, computing in `compute_dtype`
    on f32 master parameters, as JAX's bf16 training step does
    (tools/bench_train.py:86-92): every floating parameter and the input x
    cast to `compute_dtype` inside the graph (t and the embedding as given),
    v returned in f32. The model itself in f32."""
    if compute_dtype == torch.float32:
        return model

    def apply(x, t, **kwargs):
        return call_with(model, cast_params(model, compute_dtype), x.to(compute_dtype), t,
                         **kwargs).float()
    return apply


def clapdae_loss_fn(model: torch.nn.Module, compute_dtype: torch.dtype = torch.float32):
    """loss_fn(latents, emb, t, noise, keep, gather=None) -> (loss, logs) for
    parallel.train: the v-objective of this rank's rows, averaged over the
    ranks' equal shards through `gather` (the global batch's mean); the
    model's forward in `compute_dtype` (mixed_precision), the loss in f32."""
    apply = mixed_precision(model, compute_dtype)

    def loss_fn(latents, emb, t, noise, keep, gather=None):
        loss = v_objective_loss(apply, latents, emb, t, noise, embedding_mask_proba=0.0,
                                keep=keep)
        if gather is not None:
            loss = gather(loss[None]).mean()
        return loss, {"train_loss": loss.detach()}
    return loss_fn


def make_train_step(state: TrainState, world: Optional[World] = None,
                    compute_dtype: torch.dtype = torch.float32) -> Callable:
    """`step(latents, emb, t, noise, keep=None) -> loss`: one optimiser step
    on (latents (B, 32, n), emb (B, 1, 512), t (B,), noise like latents,
    keep (B, 1, 1) bool or None: no CFG dropout), this rank's rows of the
    global batch where `world` (parallel.World) has more than one:
    parallel.train's step, built once. Each call updates the parameters,
    the optimiser's state and the EMA in place, advances `state.step`, and
    returns the loss of the global batch (before the update).

    `compute_dtype` torch.bfloat16 runs the UNet's forward and backward in
    bf16 on the f32 parameters (mixed_precision): the gradients, Adam and
    the EMA stay f32. The data-parallel step takes it; a state sharded by
    FSDP2 does not (its parameters are gathered by FSDP's own hooks, which
    the cast copies would bypass) and raises."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"make_train_step: compute_dtype {compute_dtype} is not "
                         "float32 or bfloat16")
    if state.sharded and compute_dtype != torch.float32:
        raise ValueError("make_train_step: a state sharded by FSDP (--fsdp 1) trains in "
                         "float32 only; compute_dtype bfloat16 needs a replicated state")
    device = next(state.model.parameters()).device
    # sharded, FSDP2 reduce-scatters (sums) the gradients in backward
    dp_step = make_data_parallel_step(clapdae_loss_fn(state.model, compute_dtype), state.opt,
                                      world or World(1, 0, device),
                                      reduce_grads=not state.sharded)

    def step(latents, emb, t, noise, keep=None) -> torch.Tensor:
        for group in state.opt.param_groups:
            group["lr"] = state.current_lr()
        state.opt.zero_grad(set_to_none=True)
        # the arguments are this rank's own rows already
        logs = dp_step(*(x if x is None else Shard(x) for x in (latents, emb, t, noise, keep)))
        state.ema_sched.update(dict(state.model.named_parameters()), state.ema_params,
                               state.step)
        state.step += 1
        return logs["train_loss"]

    return step


def train_state_leaves(state: TrainState) -> dict:
    """name -> tensor of the state's resident f32 leaves: parameters, EMA
    copies and Adam's m and v (the tree parallel.fsdp sizes)."""
    leaves = {f"params/{k}": p for k, p in state.model.named_parameters()}
    leaves.update({f"ema/{k}": e for k, e in state.ema_params.items()})
    for i, entry in state.opt.state_dict()["state"].items():
        leaves.update({f"opt/{i}/{k}": v for k, v in entry.items()
                       if torch.is_tensor(v) and v.dim()})
    return leaves


def train_step(state: TrainState, latents, emb, t, noise, keep=None) -> torch.Tensor:
    """One step of make_train_step's in one process."""
    return make_train_step(state)(latents, emb, t, noise, keep)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator: seeded on the host from (seed, step), so that a
    resumed run draws what an uninterrupted one would."""
    s = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s % (1 << 63))


def step_draws(sobol: SobolSampler, seed: int, step: int, latents: torch.Tensor,
               world: World, cfg_dropout: float):
    """(t, noise, keep) of a step for this rank's rows `latents`: drawn for
    the global batch (latents.shape[0] x world.size rows), the same on every
    rank, and cut to the rank's rows, so that any world takes the draws of
    one process. t from the scrambled Sobol sequence, noise and the CFG
    keep mask (kept with probability 1 - cfg_dropout) from
    step_generator(seed, step)."""
    device = latents.device
    n_global = latents.shape[0] * world.size
    rows = world.rows(n_global)
    t = torch.from_numpy(sobol.draw(n_global)).to(device)[rows]
    gen = step_generator(seed, step, device)
    noise = torch.randn((n_global, *latents.shape[1:]), generator=gen, device=device,
                        dtype=latents.dtype)[rows]
    keep = (torch.rand((n_global, 1, 1), generator=gen, device=device)
            < 1.0 - cfg_dropout)[rows]
    return t, noise, keep


def main(argv=None, clap_module=None) -> dict:
    """Train as the flags say. Returns the run's record: its per-step
    losses, learning rates, EMA decays and times, the checkpoint written at
    the end, and the state's digests at the start and the end."""
    args = get_all_args(argv=argv)
    print(f"args = {args}")
    world = data_parallel_world(args, resolve_device(args.device), "train_clapdae",
                                fsdp=True)
    device = world.device
    seed = args.seed

    train_set = AudioDataset([args.training_dir], sample_rate=args.sample_rate,
                             sample_size=args.sample_size, random_crop=args.random_crop,
                             load_frac=args.load_frac,
                             cache_training_data=args.cache_training_data)
    train_dl = DataLoader(train_set, batch_size=args.batch_size, shuffle=True,
                          num_workers=args.num_workers, seed=seed,
                          shard=(world.rank, world.size))
    clapdae, state = build_state(args, device, clap_module)
    cfg_dropout = getattr(args, "cfg_dropout", 0.1)

    if args.ckpt_path:
        ck = latest_checkpoint(args.ckpt_path) or args.ckpt_path
        try:
            state.load_tree(load_checkpoint(ck))
            print(f"Resumed from {ck} at step {state.step}")
        except (OSError, KeyError, RuntimeError, pickle.UnpicklingError) as e:
            print(f"Resume failed ({e}); starting fresh")
    replicate_state(state.model, world)
    if int(getattr(args, "fsdp", 0) or 0):
        if world.size > 1:
            shard_state(state, world)
            print(f"fsdp: train state sharded over data={world.size}: "
                  f"{state_bytes_per_device(train_state_leaves(state), world) / 2**30:.2f} "
                  "GiB a rank")
        else:
            print("fsdp: --fsdp 1 on one process: the train state stays replicated "
                  "(sharding needs --num_gpus N > 1 under torchrun)")
    start_step, start_digest = state.step, state.digest()
    step_fn = make_train_step(state, world)

    main_rank = world.rank == 0
    logger = RunLogger(project="clapdae", name=args.name, config=args.to_dict()) \
        if main_rank else None
    sobol = SobolSampler(dim=1, scramble=True, seed=seed)
    records = []

    def synced() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def save():
        """Rank 0 writes the checkpoint of whole tensors (every rank gathers
        its shards); returns its path (None elsewhere)."""
        tree = state.tree()
        if main_rank:
            return save_checkpoint(f"{logger.dir}/ckpt", tree, step=state.step)
        return None

    for epoch in range(getattr(args, "max_epochs", 40)):
        for batch in train_dl:
            t0 = synced()
            reals = torch.from_numpy(np.asarray(batch, np.float32)).to(device)
            latents = clapdae.encode_audio_latents(reals).float()
            t1 = synced()
            emb = clapdae.clap_module.get_audio_embedding_from_data(reals.mean(dim=1))
            emb = emb[:, None, :]
            t2 = synced()
            t, noise, keep = step_draws(sobol, seed, state.step, latents, world, cfg_dropout)
            step, lr = state.step, state.current_lr()
            loss = float(step_fn(latents, emb, t, noise, keep))
            t3 = synced()
            rec = {"step": step, "epoch": epoch, "train_loss": loss, "train_lr": lr,
                   "train_ema_decay": state.ema_sched.decay(step),
                   "encode_ms": (t1 - t0) * 1e3, "embed_ms": (t2 - t1) * 1e3,
                   "step_ms": (t3 - t2) * 1e3}
            records.append(rec)
            if step % LOG_EVERY == 0 and main_rank:
                logger.log({k: rec[k] for k in ("train_loss", "train_lr", "train_ema_decay",
                                                "epoch")}, step=step)
            if args.checkpoint_every and step and step % args.checkpoint_every == 0:
                save()
    ckpt = save()
    if main_rank:
        logger.finish()
    print("training done.")
    return {"records": records, "start_step": start_step, "end_step": state.step,
            "ckpt": ckpt, "run_dir": str(logger.dir) if main_rank else None,
            "start_digest": start_digest, "end_digest": state.digest(), "state": state,
            "world": world}


if __name__ == "__main__":
    main()
