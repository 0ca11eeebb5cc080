#!/usr/bin/env python
"""Effects explorer: a corpus study of effect geometry in embedding space.

    python -m audio_algebra_torch.effects_explorer --source-dir DIR
        [--out-dir fx_explorer_out] [--effects Clean,Gain,...] [--knob-steps 8]
        [--chunk-size 65536] [--max-clips 8] [--model-config cfg.json]
        [--umap [--umap-steps 1500]] [--fx2fx EffectA,EffectB [--fx2fx-steps 35]]
        [--device cuda]

Port of the repository's effects_explorer.py: sweep an effect bank's
knobs over a corpus, encode everything through DVAEWrapper, and save the
embeddings, a time-mean PCA cloud, each effect's mean embedding and the
pairwise displacements between them (`embeddings.npz`, `pca_cloud.npy`,
`effect_means.npz`, `effect_dirs.npz`, `labels.json`). `--umap` adds
parametric-UMAP maps aligned across the sweeps (`umap_maps.npz`);
`--fx2fx A,B` moves one clip's embedding along A->B and decodes it
(`fx2fx_A_to_B.wav`). The file names and keys are the JAX version's.

JAX calls `apply_effect` once a knob; here each clip's sweep is one call
of ops/effects over its (K,) knobs (kernel R1 for the filters, R3 for
Reverb, K6 for PitchShift), then one encode of the (K, 2, T) stack. Runs
on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

DEFAULT_EFFECTS = "Clean,Gain,Distortion,Reverb,LowpassFilter,HighpassFilter"


def effect_directions(embs: dict) -> dict:
    """Each effect's mean time-averaged embedding and the pairwise
    displacements between them (the FX2FX core)."""
    # e: (clips, knobs, d, n) -> mean over clips, knobs, time -> (d,)
    means = {name: np.asarray(e).mean(axis=(0, 1, -1)) for name, e in embs.items()}
    return {"means": means,
            "dirs": {f"{a}->{b}": means[b] - means[a] for a in means for b in means if a != b}}


def fx2fx(z, direction: np.ndarray, scale: float = 1.0):
    """Move embeddings (b, d, n) by scale x an effect direction (d,)."""
    if torch.is_tensor(z):
        direction = torch.as_tensor(direction, dtype=z.dtype, device=z.device)
    return z + scale * direction[None, :, None]


def sweep_embeddings(w, clips: np.ndarray, name: str, knob_steps: int,
                     sample_rate: int) -> np.ndarray:
    """(clips, K, d, n) embeddings of every clip under the effect `name`
    at each of its K knob values (one for a knobless effect): a clip's
    sweep is one batched call of the effect and one encode."""
    from .ops.effects import EFFECTS, STATIC_KNOB, apply_effect, knob_sweep

    knobs = knob_sweep(name, knob_steps) if EFFECTS[name][1] != "none" else np.asarray([0.0])
    sweep = knobs if name in STATIC_KNOB else torch.tensor(knobs, dtype=torch.float32)
    rows = []
    for clip in clips:
        ys = apply_effect(name, torch.from_numpy(clip).to(w.device), sweep, sample_rate)
        rows.append(w.encode(ys).float().cpu().numpy())        # (K, d, n)
    return np.stack(rows)


def main(argv: Optional[list] = None) -> dict:
    """The study, as the flags say. Returns the embeddings' shapes, the
    files written and the seconds of each stage (each ends on the host)."""
    p = argparse.ArgumentParser(description="effect geometry in embedding space "
                                            "(PyTorch port)")
    p.add_argument("--source-dir", required=True)
    p.add_argument("--out-dir", default="fx_explorer_out")
    p.add_argument("--effects", default=DEFAULT_EFFECTS)
    p.add_argument("--knob-steps", type=int, default=8)
    p.add_argument("--chunk-size", type=int, default=65536)
    p.add_argument("--max-clips", type=int, default=8)
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--model-config", default=None)
    p.add_argument("--fx2fx", default="", help="'EffectA,EffectB' to decode a "
                   "transformed example")
    p.add_argument("--fx2fx-steps", type=int, default=35)
    p.add_argument("--umap", action="store_true",
                   help="parametric-UMAP 2-D maps, aligned across knob sweeps")
    p.add_argument("--umap-steps", type=int, default=1500)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from .config import load_model_config
    from .datasets import PadCrop, Stereo, get_audio_filenames
    from .device import resolve_device
    from .given_models import DVAEWrapper
    from .utils.audio_io import load_audio, save_audio
    from .utils.viz import pca_point_cloud

    device = resolve_device(args.device)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    files = get_audio_filenames([args.source_dir])[: args.max_clips]
    crop, stereo = PadCrop(args.chunk_size, randomize=False), Stereo()
    clips = np.stack([crop(stereo(load_audio(f, sr=args.sample_rate))) for f in files])
    print(f"{len(clips)} clips")

    model_kwargs, extra_args = load_model_config(args.model_config)
    w = DVAEWrapper(args_dict={'sample_size': args.chunk_size, **extra_args},
                    model_kwargs=model_kwargs, device=device)
    w.setup(gdrive=False)

    seconds, t0 = {}, time.perf_counter()
    embs = {}
    for name in [e.strip() for e in args.effects.split(",") if e.strip()]:
        embs[name] = sweep_embeddings(w, clips, name, args.knob_steps, args.sample_rate)
        print(f"encoded {name}: {embs[name].shape}")

    seconds["sweep_encode"] = time.perf_counter() - t0
    geo = effect_directions(embs)
    all_pts = np.concatenate([e.reshape(-1, *e.shape[2:]) for e in embs.values()])
    cloud = pca_point_cloud(all_pts)
    labels = sum(([n] * (e.shape[0] * e.shape[1]) for n, e in embs.items()), [])

    np.savez(out / "embeddings.npz", **embs)
    np.save(out / "pca_cloud.npy", cloud)
    np.savez(out / "effect_means.npz", **geo["means"])
    np.savez(out / "effect_dirs.npz", **geo["dirs"])
    with open(out / "labels.json", "w") as f:
        json.dump(labels, f)
    print(f"wrote embeddings + PCA cloud + {len(geo['dirs'])} effect directions")
    written = ["embeddings.npz", "pca_cloud.npy", "effect_means.npz", "effect_dirs.npz",
               "labels.json"]

    if args.umap:
        # one shared parametric map over every (clip x knob) time-mean
        # embedding -> aligned 2-D maps per effect sweep
        from .umap_param import aligned_sweep_maps
        t0 = time.perf_counter()
        sweeps = {name: e.mean(axis=-1).reshape(-1, e.shape[2]) for name, e in embs.items()}
        maps, _ = aligned_sweep_maps(sweeps, steps=args.umap_steps, device=device)
        seconds["umap"] = time.perf_counter() - t0
        np.savez(out / "umap_maps.npz", **maps)
        print(f"wrote aligned parametric-UMAP maps for {len(maps)} sweeps")
        written.append("umap_maps.npz")

    if args.fx2fx:
        a, b = [s.strip() for s in args.fx2fx.split(",")]
        t0 = time.perf_counter()
        z = w.encode(clips[:1])
        audio_out = w.decode(fx2fx(z, geo["dirs"][f"{a}->{b}"]), demo_steps=args.fx2fx_steps)
        name = f"fx2fx_{a}_to_{b}.wav"
        audio_out = audio_out.float().cpu().numpy()
        seconds["fx2fx"] = time.perf_counter() - t0
        save_audio(str(out / name), np.clip(audio_out, -1, 1), args.sample_rate)
        print(f"wrote {name}")
        written.append(name)
    return {"embeddings": {k: v.shape for k, v in embs.items()}, "written": written,
            "out_dir": str(out), "seconds": seconds}


if __name__ == "__main__":
    main()
