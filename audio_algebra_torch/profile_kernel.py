"""Launch one kernel of the port a few times at a main-path shape, for a
profiler that wraps the process, such as Nsight Compute:

    ncu -k regex:flash_dkv python3 audio_algebra_torch/profile_kernel.py --kernel k4b

Run from the root of a checkout: the package is imported from the current
directory. Kernels: k4b (dK/dV of the rel-pos flash attention at the
trainer's (8, 16, 1024, 64), f32 or bf16) and k2a / k2b / k2c (the turbo
GroupNorm modes at the decode's level 0, (16, 256, 65536) bf16). Prints
one JSON line with the CUDA-event time a launch and the card's name.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=["k4b", "k2a", "k2b", "k2c"], required=True)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                    help="k4b: float32 (default) or bfloat16; K2 runs in bfloat16")
    ap.add_argument("--launches", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("profile_kernel: no CUDA device", file=sys.stderr)
        return 2
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if args.kernel == "k4b":
        dt = getattr(torch, args.dtype or "float32")
        shape = (8, 16, 1024, 64)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dt) for _ in range(4))
        bias_t = (torch.randn((16, 1024, 1024), generator=g, device=dev) * 0.5).to(dt)
        o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
        delta = fa.flash_delta(o, do)

        def launch():
            return fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m, delta, 0.125)
    else:
        dt = torch.bfloat16
        shape = (16, 256, 65536)
        x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.2).to(dt)
        res = (torch.randn(shape, generator=g, device=dev) * 2.0).to(dt)
        scale = (torch.rand(256, generator=g, device=dev) + 0.5).to(dt)
        bias = (torch.rand(256, generator=g, device=dev) - 0.5).to(dt)
        grid = torch.rand(256, generator=g, device=dev) * 0.06 + 0.02

        def launch():
            if args.kernel == "k2a":
                return gn.groupnorm1_gelu_quant(x, scale, bias, grid)
            q = grid if args.kernel == "k2c" else None
            return gn.groupnorm1_gelu_res_amax(x, scale, bias, res, q_emit_scale=q)
    launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.launches):
        launch()
    end.record()
    end.synchronize()
    print(json.dumps({"kernel": args.kernel, "shape": list(shape),
                      "dtype": str(dt).removeprefix("torch."),
                      "ms": start.elapsed_time(end) / args.launches,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
