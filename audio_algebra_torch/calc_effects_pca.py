#!/usr/bin/env python
"""Corpus-scale PCA of DVAE embeddings.

    python -m audio_algebra_torch.calc_effects_pca --training_dir DIR
        [--batch_size 1024] [--model_config cfg.json] [--device cuda]
    torchrun --nproc_per_node N -m audio_algebra_torch.calc_effects_pca
        --training_dir DIR --num_gpus N

Port of the repository's calc_effects_pca.py, on bdct-chunk-pca.ini's
defaults: stream batches, encode them through DVAEWrapper, rearrange
'b d n -> d (b n)', accumulate Σxxᵀ and Σx, and eigendecompose the
covariance (descending) after every batch, logging the eigenvalues.

The accumulators stay on the device in f32, the product in full f32 (no
TF32); only the (d, d) matrix comes back, finalised in float64. With
`--num_gpus N` > 1 each of N processes (torchrun) loads and encodes its
rows of every batch and the partial sums are all-reduced, as the JAX
version's sharded step all-reduces them. Rank 0 logs and saves
`cov.npy`, `eigvals.npy` and `eigvecs.npy` in its run directory.
"""
from __future__ import annotations

import json
from typing import Callable, Optional

import numpy as np
import torch

from .aa_mixer import given_model_encode_fn
from .config import get_all_args, load_model_config
from .device import full_f32, resolve_device
from .parallel.mesh import World
from .parallel.multihost import global_batch_sharding
from .parallel.train import place_args
from .utils.logging import RunLogger


def sorted_eig(cov: np.ndarray):
    """Descending eigendecomposition."""
    vals, vecs = np.linalg.eigh(cov)
    order = np.argsort(vals)[::-1]
    return vals[order], vecs[:, order]


def make_streaming_cov_step(encode_fn: Callable, world: Optional[World] = None):
    """step(cov_num, mean_num, count, batch) -> the accumulators updated by
    one batch: Σxxᵀ (d, d) and Σx (d,) f32 on the device, the count of
    latent vectors an int. `batch` is the global batch (each rank encodes
    its rows) or this rank's parallel.multihost.Shard; with more than one
    rank the batch's sums are all-reduced, so every rank holds the same
    accumulators."""

    def step(cov_num, mean_num, count, batch):
        if world is not None:
            (batch,) = place_args([batch], world, arg_specs=["data"])
        ys = encode_fn(batch)                               # (b, d, n) f32
        b, d, n = ys.shape
        flat = ys.transpose(0, 1).reshape(d, b * n)         # 'b d n -> d (b n)'
        with full_f32():
            part_cov = flat @ flat.T
        part_mean = flat.sum(dim=1)
        size = 1
        if world is not None:
            world.all_reduce_sum_([part_cov, part_mean])
            size = world.size
        return cov_num + part_cov, mean_num + part_mean, count + b * n * size

    return step


def finalize_cov(cov_num, mean_num, count) -> np.ndarray:
    """(Σxxᵀ - N μμᵀ) / (N - 1) in float64."""
    def f64(a):
        return a.double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a, np.float64)
    cov_num, mean_num = f64(cov_num), f64(mean_num)
    n = float(count)
    mu = mean_num / n
    return (cov_num - n * np.outer(mu, mu)) / (n - 1)


def main(argv=None) -> dict:
    """The corpus PCA as the flags say. Returns {cov, eigvals, eigvecs,
    batches, count, run_dir} (run_dir None off rank 0)."""
    args = get_all_args(defaults_file="bdct-chunk-pca.ini", argv=argv)
    from .datasets import AudioDataset, DataLoader
    from .given_models import DVAEWrapper
    from .parallel.multihost import data_parallel_world

    print(f"args = {args}")
    world = data_parallel_world(args, resolve_device(args.device), "calc_effects_pca")
    train_set = AudioDataset([args.training_dir], sample_rate=args.sample_rate,
                             sample_size=args.sample_size, random_crop=args.random_crop,
                             load_frac=args.load_frac)
    train_dl = DataLoader(train_set, batch_size=args.batch_size, shuffle=True,
                          num_workers=min(args.num_workers, 4),
                          shard=(world.rank, world.size))

    model_kwargs, cfg_args = load_model_config(args.model_config)
    args_dict = {'sample_size': args.sample_size, 'latent_dim': args.latent_dim, **cfg_args}
    given_model = DVAEWrapper(args_dict=args_dict, model_kwargs=model_kwargs, seed=args.seed,
                              device=world.device)
    given_model.setup(gdrive=False)

    main_rank = world.rank == 0
    logger = RunLogger(project='aa-dvae-pca', config=args.to_dict()) if main_rank else None
    d = int(args_dict['latent_dim'])
    cov_num = torch.zeros((d, d), device=world.device)
    mean_num = torch.zeros((d,), device=world.device)
    count = 0
    step_fn = make_streaming_cov_step(given_model_encode_fn(given_model), world)
    place = global_batch_sharding(world, args.batch_size // world.size)
    batches = 0
    for i, batch in enumerate(train_dl):
        batch = np.asarray(batch, np.float32)
        cov_num, mean_num, count = step_fn(cov_num, mean_num, count, place(batch))
        vals, _ = sorted_eig(finalize_cov(cov_num, mean_num, count))
        if main_rank:
            logger.log({f"lambda{j:02d}": float(vals[j]) for j in range(d)}, step=i)
        print(f"step {i}: top eigenvalues {vals[:4]}")
        batches += 1

    cov = finalize_cov(cov_num, mean_num, count)
    vals, vecs = sorted_eig(cov)
    if main_rank:
        np.save(logger.dir / "cov.npy", cov)
        np.save(logger.dir / "eigvals.npy", vals)
        np.save(logger.dir / "eigvecs.npy", vecs)
        logger.finish()
    print(json.dumps({"top_eigenvalues": vals[:8].tolist()}))
    return {"cov": cov, "eigvals": vals, "eigvecs": vecs, "batches": batches, "count": count,
            "run_dir": str(logger.dir) if main_rank else None, "world": world}


if __name__ == "__main__":
    main()
