"""Where the time of one sampler step, or one training step, goes on the
card.

    python -m audio_algebra_torch.profile_decode [--model destructo]
        [--batch 4] [--sample-size 65536] [--iters 3] [--out PATH] [--turbo]
        [--tf32] [--bf16]

`--model` picks the UNet forward that one step runs, in bf16 with seeded
random weights:
  destructo     the reference DiffusionDVAE's UNet (a Destructo decode step;
                --batch chunks of --sample-size samples)
  mirage_inner  the MIRAGE UNetCFG1d (songs config) at --sample-size / 512
                latents, CFG scale 4 over the doubled batch, with the rel-pos
                biases hoisted (a DPM++(2M) step)
  mirage_outer  the MIRAGE outer DiffusionAttnUnet1D (depth 10, 512 ch, no
                attention) at --sample-size / 32 first-stage latents (a
                v-DDIM step)
  mirage_train  one optimiser step of the MIRAGE trainer
                (train_clapdae.make_train_step: v_objective_loss forward and
                backward of the songs UNetCFG1d through K4 and K5, Adam, EMA)
                in f32 on --batch x (32, --sample-size / 512) latents, the
                frozen encoders left out; TF32 off unless --tf32; --bf16:
                the bf16 step (make_train_step's compute_dtype bf16, f32
                masters)
`--turbo` (destructo only) runs the UNet's int8 route as a decode step
after the first does: with the amax carry of one earlier forward (K2a,
K2b, K2c and the int8 convs); it engages at --batch 16 or more.
It runs two warm-up forwards, times `--iters` forwards with CUDA events,
then traces `--iters` forwards with torch.profiler. Prints one JSON line:
wall ms per forward (and of each timed forward, from an event recorded
after each), device kernel ms per forward (the sum of kernel
times), the device's busy share, device ms per forward grouped by kind of
kernel, and the top kernels; `--out` gets the same with the top 40. Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

KINDS = [("k2_turbo_gn_apply", ("gn_turbo_kernel",)),
         ("k3_k4a_flash_attention_forward", ("flash_fwd", "flash_serve")),
         ("k4b_flash_attention_dkv", ("flash_dkv",)),
         ("k4c_flash_attention_dq", ("flash_dq",)),
         ("k5_grouped_gn", ("ggn_apply_kernel", "ggn_cluster_kernel")),
         ("k1_groupnorm_apply", ("gn_apply_kernel",)),
         ("gn_stats_k1_k5", ("gn_stats_kernel",)),
         ("convolution", ("conv", "cudnn", "implicit", "fprop", "winograd")),
         ("int8_matmul", ("gemm_s8", "i16832", "imma", "s8s8")),
         ("matmul", ("gemm", "cutlass", "gemv", "xmma", "nvjet")),
         ("optimizer", ("multi_tensor", "foreach", "adam")),
         ("elementwise_and_glue", ("elementwise", "vectorized", "reduce", "cat",
                                   "copy", "fill", "index", "softmax"))]


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _forward(model: str, b: int, n: int, dev: torch.device, turbo: bool = False,
             bf16_train: bool = False):
    """The UNet forward of one sampler step of `model`, on bf16 inputs."""
    from .models.unet1d import DiffusionAttnUnet1D
    from .utils.params import random_init_

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    t = torch.full((b,), 0.5, device=dev, dtype=bf16)
    if model == "destructo":
        from .models.dvae import DiffusionDVAE
        dvae = random_init_(DiffusionDVAE(), 0).to(dev, bf16).eval()
        x, cond = randn(b, 2, n), torch.tanh(randn(b, 64, n // dvae.downsampling_ratio))
        if turbo:
            with torch.inference_mode():
                _, aux = dvae.decode_v_aux(x, t, cond)      # step 0 sets the carry
            return lambda: dvae.decode_v_aux(x, t, cond, q_aux=aux)
        return lambda: dvae.decode_v(x, t, cond)
    if turbo:
        raise SystemExit("--turbo profiles the destructo model only")
    if model == "mirage_train":
        from .models.stacked import StackedAELatentDiffusionCond
        from .train_clapdae import make_state, make_train_step
        state = make_state(random_init_(StackedAELatentDiffusionCond(), 0).to(dev))
        shape = (b, 32, n // 512)
        latents = torch.tanh(torch.randn(shape, generator=g, device=dev))
        noise = torch.randn(shape, generator=g, device=dev)
        emb = torch.nn.functional.normalize(
            torch.randn((b, 1, 512), generator=g, device=dev), dim=-1)
        steps = torch.rand((b,), generator=g, device=dev)
        keep = torch.arange(b, device=dev) != 1            # one row's embedding dropped
        step = make_train_step(state, compute_dtype=bf16 if bf16_train else torch.float32)
        return lambda: step(latents, emb, steps, noise, keep)
    if model == "mirage_inner":
        from .models.unet_cfg1d import UNetCFG1d, precompute_rel_biases
        unet = random_init_(UNetCFG1d(), 0).to(dev, bf16).eval()
        x, emb = randn(b, 32, n // 512), randn(1, 1, 512)
        rb = precompute_rel_biases(unet, n // 512)
        return lambda: unet(x, t, embedding=emb, embedding_scale=4.0, rel_biases=rb)
    outer = random_init_(DiffusionAttnUnet1D(io_channels=32, cond_dim=32, n_attn_layers=0,
                                             c_mults=[512] * 10, depth=10), 0)
    outer = outer.to(dev, bf16).eval()
    x, cond = randn(b, 32, n // 32), torch.tanh(randn(b, 32, n // 512))
    return lambda: outer(x, t, cond)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="destructo",
                   choices=["destructo", "mirage_inner", "mirage_outer", "mirage_train"])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--sample-size", type=int, default=65536)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--out", default="chiprun_out/profile_decode.json")
    p.add_argument("--turbo", action="store_true",
                   help="destructo: profile an int8 turbo step (amax carry)")
    p.add_argument("--tf32", action="store_true",
                   help="mirage_train: allow TF32 in cuDNN and cuBLAS (off: strict f32)")
    p.add_argument("--bf16", action="store_true",
                   help="mirage_train: the bf16 step on f32 masters")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    training = args.model == "mirage_train"
    if training:
        torch.backends.cuda.matmul.allow_tf32 = args.tf32
        torch.backends.cudnn.allow_tf32 = args.tf32
    if args.bf16 and not training:
        raise SystemExit("--bf16 profiles the mirage_train step only")
    forward = _forward(args.model, args.batch, args.sample_size, dev, args.turbo, args.bf16)
    b, n = args.batch, args.sample_size
    with torch.enable_grad() if training else torch.inference_mode():
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(args.iters + 1)]
        marks[0].record()
        for i in range(args.iters):
            forward()
            marks[i + 1].record()
        marks[-1].synchronize()
        each_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        wall_ms = sum(each_ms) / args.iters
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                forward()
            torch.cuda.synchronize()

    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.key.startswith(("Optimizer.", "ProfilerStep")):
            continue                     # kernels only: no host rows, no annotated spans
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append({"kernel": e.key[:160], "kind": kind_of(e.key),
                     "ms_per_forward": us / 1e3 / args.iters,
                     "calls_per_forward": e.count / args.iters})
    rows.sort(key=lambda r: -r["ms_per_forward"])
    by_kind: dict[str, float] = {}
    for r in rows:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["ms_per_forward"]
    device_ms = sum(by_kind.values())
    result = {"device": torch.cuda.get_device_name(0), "model": args.model,
              "batch": b, "sample_size": n,
              "dtype": "float32" if training and not args.bf16 else "bfloat16",
              "turbo": args.turbo,
              "allow_tf32": args.tf32 if training else None,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "wall_ms_per_forward": wall_ms, "wall_ms_each": each_ms,
              "device_kernel_ms_per_forward": device_ms,
              "busy_share": device_ms / wall_ms if wall_ms else None,
              "ms_by_kind": by_kind}
    print(json.dumps({**result, "top": rows[:12]}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({**result, "top": rows[:40]}, indent=1))


if __name__ == "__main__":
    main()
