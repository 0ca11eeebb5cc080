"""XAE dataset factory: build the effected-audio corpus.

    python -m audio_algebra_torch.xae_dataset --source-dir DIR [--out-dir xae_out]
        [--sample-rate 48000] [--chunk-size 262144] [--knob-steps 32]
        [--effects Clean,TimeReverse,...] [--normalize loudness|maxabs|none]
        [--target-lufs -23] [--max-clips N] [--encode [--encode-batch 64]
        [--model-config cfg.json] [--num-devices N]] [--device cuda]

Port of the root `xae_dataset.py`: load the source files (WAV, MP3, FLAC,
OGG), normalise each by integrated loudness (ops/loudness, its K-weighting
on kernel R1) or by its peak, cut it into stereo clips of `--chunk-size`
samples, run every effect over its knob sweep, and save `clips.npy`,
`fx_<effect>.npy` (clips, knobs, 2, chunk) and `manifest.json`; with
`--encode`, encode every effected clip through DVAEWrapper in
`--encode-batch` chunks into `emb_<effect>.npy`. The names, keys and
shapes of the files are the JAX version's.

JAX sweeps a knob by `jax.vmap` one clip at a time; here the batch is
written out: each effect takes all K knobs and SWEEP_CLIPS clips in one
call (ops/effects), PitchShift's static knob looping on the host.

The JAX version shards its encode over every local device. Here
`--num-devices N` (0, the default: the process group's size, one process
without one) splits each encode batch over N processes, one a card:

    torchrun --nproc_per_node N -m audio_algebra_torch.xae_dataset \
        --source-dir DIR --encode --num-devices N

Rank 0 builds and writes the clips, effect arrays and manifest; the other
ranks wait at a barrier and read the effect arrays back. Each encode
batch is padded by repeating its rows to a multiple of N (JAX's `place`),
each rank encodes its rows, and rank 0 gathers them, drops the pad and
writes `emb_<effect>.npy`. Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

DEFAULT_EFFECTS = ("Clean,TimeReverse,Gain,Distortion,Reverb,Chorus,Delay,Phaser,"
                   "Compressor,HighpassFilter,LowpassFilter")
SWEEP_CLIPS = 8          # clips an effect sweeps in one call: 32 knobs x 8 clips x 2 x
                         # 262,144 f32 is 537 MB an output


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description="XAE effected-audio corpus (PyTorch port)")
    p.add_argument("--source-dir", required=True, help="input audio tree")
    p.add_argument("--out-dir", default="xae_out")
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--chunk-size", type=int, default=262144, help="samples a clip")
    p.add_argument("--knob-steps", type=int, default=32)
    p.add_argument("--effects", default=DEFAULT_EFFECTS)
    p.add_argument("--normalize", choices=["loudness", "maxabs", "none"], default="loudness")
    p.add_argument("--target-lufs", type=float, default=-23.0)
    p.add_argument("--max-clips", type=int, default=0)
    p.add_argument("--encode", action="store_true",
                   help="also encode every effected clip with the DVAE")
    p.add_argument("--encode-batch", type=int, default=64)
    p.add_argument("--model-config", default=None)
    p.add_argument("--num-devices", type=int, default=0,
                   help="split the encode over this many processes, one a card (0: the "
                        "process group's size); more than one needs torchrun")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from .datasets import get_audio_filenames
    from .device import resolve_device
    from .ops.effects import EFFECTS, STATIC_KNOB, apply_effect, knob_sweep
    from .ops.loudness import loudness_normalize, maxabs_normalize
    from .utils.audio_io import load_audio

    from .parallel.mesh import make_mesh
    from .parallel.multihost import launched_world_size

    device = resolve_device(args.device)
    launched_world_size(args.num_devices, device, "xae_dataset", "--num-devices")
    world = make_mesh(device=device)
    device = world.device
    if world.rank != 0:
        return _follow_encode(args, world)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = get_audio_filenames([args.source_dir])
    if args.max_clips:
        files = files[: args.max_clips]
    print(f"{len(files)} source files")

    # 1. load, normalise, chunk
    clips, sources = [], []
    for f in files:
        try:
            audio = load_audio(f, sr=args.sample_rate)
        except Exception as e:
            print(f"skip {f}: {e}")
            continue
        if args.normalize == "loudness":
            audio, _ = loudness_normalize(audio, args.target_lufs, args.sample_rate,
                                          device=device)
        elif args.normalize == "maxabs":
            audio, _ = maxabs_normalize(audio)
        t = audio.shape[-1]
        for c in range(max(t // args.chunk_size, 1)):
            seg = np.zeros((2, args.chunk_size), np.float32)
            chunk = audio[:2, c * args.chunk_size: (c + 1) * args.chunk_size]
            if chunk.shape[0] == 1:
                chunk = np.repeat(chunk, 2, axis=0)
            seg[:, : chunk.shape[1]] = chunk
            clips.append(np.clip(seg, -1, 1))
            sources.append(f)
    clips = np.stack(clips) if clips else np.zeros((0, 2, args.chunk_size), np.float32)
    print(f"{len(clips)} clips of {args.chunk_size} samples")

    # 2. every effect over its knob sweep, all knobs and SWEEP_CLIPS clips a
    # call
    effect_names = [e.strip() for e in args.effects.split(",") if e.strip()]
    manifest, store = [], {}
    for name in effect_names:
        knobs = knob_sweep(name, args.knob_steps) if EFFECTS[name][1] != "none" \
            else np.asarray([0.0])
        print(f"effect {name}: {len(knobs)} knob values")
        sweep = knobs if name in STATIC_KNOB else torch.tensor(knobs, dtype=torch.float32)
        outs = []
        for i in range(0, len(clips), SWEEP_CLIPS):
            x = torch.from_numpy(clips[i:i + SWEEP_CLIPS]).to(device)
            ys = apply_effect(name, x, sweep, args.sample_rate)        # (K, n, 2, T)
            outs.append(ys.transpose(0, 1).float().cpu().numpy())
        for clip_idx in range(len(clips)):
            for k in knobs:
                manifest.append({"effect": name, "knob_name": EFFECTS[name][1],
                                 "knob": float(k), "clip": clip_idx,
                                 "source": sources[clip_idx], "row": len(manifest)})
        if outs:
            store[name] = np.concatenate(outs)                         # (clips, K, 2, T)

    # 3. the consolidated save
    np.save(out / "clips.npy", clips)
    for name, arr in store.items():
        np.save(out / f"fx_{name}.npy", arr)
    with open(out / "manifest.json", "w") as f:
        json.dump({"sample_rate": args.sample_rate, "chunk_size": args.chunk_size,
                   "effects": effect_names, "rows": manifest}, f)
    print(f"wrote {out}/clips.npy + {len(store)} effect arrays + manifest")
    world.barrier()                        # the other ranks read the arrays now
    world.broadcast_object({"encode": bool(args.encode and len(clips)),
                            "effects": list(store)})

    # 4. optionally, the encode of every effected clip
    embs = {}
    if args.encode and len(clips):
        embs = _encode_banks(args, world, store, out)
        print(f"encoded {len(embs)} effect banks")
    return {"clips": clips.shape, "effects": {k: v.shape for k, v in store.items()},
            "embeddings": {k: v.shape for k, v in embs.items()}, "rows": len(manifest),
            "world": [world.size, world.rank]}


def _encode_banks(args, world, store: dict, out: Path) -> dict:
    """Encode every effect array through DVAEWrapper in --encode-batch
    batches, each padded by repeating its rows to a multiple of the ranks
    and split over them; rank 0 gathers, drops the pad and writes
    emb_<effect>.npy. Returns the embeddings (rank 0; empty elsewhere)."""
    from .config import load_model_config
    from .given_models import DVAEWrapper

    model_kwargs, extra_args = load_model_config(args.model_config)
    w = DVAEWrapper(args_dict={"sample_size": args.chunk_size, **extra_args},
                    model_kwargs=model_kwargs, device=world.device)
    w.setup(gdrive=False)
    if world.size > 1 and world.rank == 0:
        print(f"encode sweep split over {world.size} processes")
    embs = {}
    for name, arr in store.items():
        flat = arr.reshape(-1, 2, args.chunk_size)
        chunks = []
        for i in range(0, len(flat), args.encode_batch):
            batch = flat[i:i + args.encode_batch]
            n0 = len(batch)
            pad = (-n0) % world.size
            if pad:                        # repeat rows up to a multiple of the ranks
                batch = np.concatenate([batch] * -(-(n0 + pad) // n0))[:n0 + pad]
            enc = world.all_gather_rows(w.encode(batch[world.rows(len(batch))]))
            chunks.append(enc[:n0].float().cpu().numpy())
        if world.rank == 0:
            embs[name] = np.concatenate(chunks).reshape(arr.shape[0], arr.shape[1],
                                                        *chunks[0].shape[1:])
            np.save(out / f"emb_{name}.npy", embs[name])
    return embs


def _follow_encode(args, world) -> dict:
    """Ranks above 0: wait for rank 0's effect arrays, read them, and take
    their rows of every encode batch."""
    world.barrier()
    plan = world.broadcast_object(None)
    out = Path(args.out_dir)
    if plan["encode"]:
        store = {name: np.load(out / f"fx_{name}.npy") for name in plan["effects"]}
        _encode_banks(args, world, store, out)
    return {"world": [world.size, world.rank]}


if __name__ == "__main__":
    main()
