"""Where the time of one Destructo decode step goes on the card.

    python -m audio_algebra_torch.profile_decode [--batch 4] [--sample-size 65536]
        [--iters 3] [--out chiprun_out/profile_decode.json]

Builds the reference DiffusionDVAE in bf16 with seeded random weights,
runs two warm-up UNet forwards (one decode step each), times `--iters`
forwards with CUDA events, then traces `--iters` forwards with
torch.profiler. Prints one JSON line: wall ms per forward, device kernel ms
per forward (the sum of kernel times), the device's busy share, device ms
per forward grouped by kind of kernel, and the top kernels; `--out` gets
the same with the top 40. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

KINDS = [("k1_groupnorm", ("gn_apply_kernel", "gn_stats_kernel")),
         ("convolution", ("conv", "cudnn", "xmma", "implicit", "fprop", "winograd")),
         ("matmul", ("gemm", "cutlass", "gemv")),
         ("elementwise_and_glue", ("elementwise", "vectorized", "reduce", "cat",
                                   "copy", "fill", "index", "softmax"))]


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--sample-size", type=int, default=65536)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--out", default="chiprun_out/profile_decode.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from .models.dvae import DiffusionDVAE
    from .utils.params import random_init_

    dev = torch.device("cuda")
    model = random_init_(DiffusionDVAE(), 0).to(dev, torch.bfloat16).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    b, n = args.batch, args.sample_size
    x = torch.randn((b, 2, n), generator=g, device=dev).bfloat16()
    t = torch.full((b,), 0.5, device=dev, dtype=torch.bfloat16)
    cond = torch.tanh(torch.randn((b, 64, n // model.downsampling_ratio),
                                  generator=g, device=dev)).bfloat16()

    def forward():
        return model.decode_v(x, t, cond)

    with torch.inference_mode():
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            forward()
        end.record()
        end.synchronize()
        wall_ms = start.elapsed_time(end) / args.iters
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                forward()
            torch.cuda.synchronize()

    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
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
    result = {"device": torch.cuda.get_device_name(0), "batch": b, "sample_size": n,
              "dtype": "bfloat16", "wall_ms_per_forward": wall_ms,
              "device_kernel_ms_per_forward": device_ms,
              "busy_share": device_ms / wall_ms if wall_ms else None,
              "ms_by_kind": by_kind}
    print(json.dumps({**result, "top": rows[:12]}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({**result, "top": rows[:40]}, indent=1))


if __name__ == "__main__":
    main()
