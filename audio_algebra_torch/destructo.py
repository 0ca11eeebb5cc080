"""Destructo — encode -> mathemangle -> diffusion-decode, on the card.

Port of the repository's destructo.py: load audio, chunk it
(batch_it_crazy), DVAE-encode to (b, 64, n) latents, apply a latent op,
v-DDIM decode, write a WAV.

    python -m audio_algebra_torch.destructo input.wav --op destructo \
        --steps 35 --out destructo_out.wav [--device cuda] [--dtype bfloat16]
        [--turbo --max-batch 16]

Latent ops: destructo (sign flip), dimswap, timereverse, ewma ("latent
reverb"), overdrive (tanh), none, or a Python expression over `z` with
`torch` and `np` in scope (--op-expr). --effect-dry/--effect-wet apply
z + scale * mean(encode(wet) - encode(dry)) instead.

`--num-devices N` (0: the process group's size) splits the chunk batch
over N processes, one a card, as JAX shards it over N devices:

    torchrun --nproc_per_node N -m audio_algebra_torch.destructo in.wav \
        --num-devices N ...

The batch is padded with zero chunks to a multiple of N; each rank
encodes, mangles and decodes its rows, from its rows of the noise one
process would draw for the whole batch, so the output is one process's;
rank 0 gathers the rows, drops the pad and writes the file. Outside a
group of N it raises and says how to launch.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def mathemangle(z: torch.Tensor, op: str, op_expr: str | None = None) -> torch.Tensor:
    """Latent ops on (B, D, n) latents."""
    if op_expr:
        return eval(op_expr, {"z": z, "torch": torch, "np": np})
    if op == "destructo":
        return -z
    if op == "dimswap":
        perm = np.random.default_rng(0).permutation(z.shape[1])
        return z[:, torch.as_tensor(perm, device=z.device), :]
    if op == "timereverse":
        return torch.flip(z, dims=(-1,))
    if op == "ewma":            # "latent reverb": exponential moving average
        alpha = 0.15
        outs, carry = [], z[..., 0]
        for i in range(z.shape[-1]):
            carry = alpha * z[..., i] + (1 - alpha) * carry
            outs.append(carry)
        return torch.stack(outs, dim=-1)
    if op == "overdrive":
        return torch.tanh(3.0 * z)
    return z


def load_model_config(path: str | None) -> tuple:
    """Read a model-config JSON -> (model_kwargs, args_dict); accepts the
    nested {"model_kwargs", "args_dict"} form or a flat dict of kwargs."""
    if not path:
        return None, {}
    with open(path) as f:
        cfg = json.load(f)
    if "model_kwargs" in cfg or "args_dict" in cfg:
        return cfg.get("model_kwargs"), cfg.get("args_dict", {})
    return cfg, {}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("audio", help="input audio file (wav/mp3)")
    p.add_argument("--op", default="destructo",
                   choices=["destructo", "dimswap", "timereverse", "ewma",
                            "overdrive", "none"])
    p.add_argument("--op-expr", default=None, help="python expression over z")
    p.add_argument("--effect-dry", default=None, help="dry example for fx vector")
    p.add_argument("--effect-wet", default=None, help="wet example for fx vector")
    p.add_argument("--effect-scale", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=35)
    p.add_argument("--chunk-size", type=int, default=65536)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--out", default="destructo_out.wav")
    p.add_argument("--model-config", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--num-devices", type=int, default=1,
                   help="split the chunk batch over this many processes, one a card "
                        "(0: the process group's size); more than one needs torchrun")
    p.add_argument("--turbo", action="store_true",
                   help="int8 turbo decode (the UNet's int8 convs with the amax "
                        "carry). It engages only at a batch of 16 chunks or more, "
                        "so it needs --max-batch 16; below that the decode is the "
                        "float one")
    args = p.parse_args(argv)

    from .device import resolve_device
    from .given_models import DVAEWrapper
    from .parallel.mesh import make_mesh
    from .parallel.multihost import launched_world_size
    from .utils.audio_io import batch_it_crazy, load_audio, save_audio

    device = resolve_device(args.device)
    launched_world_size(args.num_devices, device, "destructo", "--num-devices")
    world = make_mesh(device=device)
    model_kwargs, extra_args = load_model_config(args.model_config)
    args_dict = {"demo_steps": args.steps, "sample_size": args.chunk_size}
    args_dict.update(extra_args)
    w = DVAEWrapper(args_dict=args_dict, model_kwargs=model_kwargs, seed=args.seed,
                    device=world.device, dtype=getattr(torch, args.dtype),
                    turbo=args.turbo)

    def chunks(path):
        return batch_it_crazy(load_audio(path, sr=48000), args.chunk_size,
                              max_batch_size=args.max_batch)

    batch = chunks(args.audio)
    print(f"chunked: {batch.shape}")
    n_real = len(batch)
    pad = (-n_real) % world.size
    if pad:          # zero chunks to a multiple of the ranks, as JAX pads
        batch = np.concatenate([batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)])
    rows = world.rows(len(batch))
    if world.size > 1:
        print(f"split over {world.size} processes (pad {pad}), rank {world.rank}: rows "
              f"{rows.start}-{rows.stop - 1}")
    t0 = time.time()
    state = w.generator.get_state()
    z = w.encode(batch[rows])
    if world.size > 1:   # the noise one process's encode draws for the real rows
        w.generator.set_state(state)
        w.noise = w._draw_noise(n_real)
    print(f"encoded {tuple(z.shape)} in {time.time() - t0:.1f}s")
    if args.effect_dry and args.effect_wet:
        dry, wet = chunks(args.effect_dry), chunks(args.effect_wet)
        n = min(len(dry), len(wet))
        diff = (w.encode(wet[:n]) - w.encode(dry[:n])).mean(dim=0, keepdim=True)
        z = z + args.effect_scale * diff
        print(f"applied effect vector, |diff|={float(diff.abs().mean()):.4f}")
    else:
        z = mathemangle(z, args.op, args.op_expr)
    if world.size > 1:   # my rows of the noise one process's decode takes
        noise = w.noise
        if noise is None or noise.shape[0] != n_real:
            noise = w._draw_noise(n_real)
        w.noise = torch.cat([noise, noise.new_zeros((pad, *noise.shape[1:]))])[rows]
    t0 = time.time()
    out = w.decode(z, demo_steps=args.steps)
    if world.size > 1:   # (2, b * T) of my rows -> every row, the pad dropped
        local = out.reshape(2, -1, args.chunk_size).transpose(0, 1).contiguous()
        out = world.all_gather_rows(local)[:n_real].transpose(0, 1).reshape(2, -1)
    out = out.float().cpu().numpy()
    dt = time.time() - t0
    audio_sec = n_real * args.chunk_size / 48000
    print(f"decoded {args.steps} steps in {dt:.1f}s ({audio_sec / dt:.1f}x realtime)")
    if world.rank == 0:
        save_audio(args.out, np.clip(out, -1, 1), 48000)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
