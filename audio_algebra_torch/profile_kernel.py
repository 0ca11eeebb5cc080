"""Launch one kernel of the port at its main-path shapes and time it, or
run it a few times for a profiler that wraps the process, such as Nsight
Compute:

    ncu -k regex:flash_dkv python3 audio_algebra_torch/profile_kernel.py --kernel k4b
    python3 audio_algebra_torch/profile_kernel.py --kernel k5 --host-split

Run from the root of a checkout: the package is imported from the current
directory, so the same script times another checkout's kernels when run
from that checkout's root. Kernels: k1 (the fused GroupNorm(1) at
chip_smoke.py's K1 cases, with a SHA-256 of each output's bits: run from
two checkouts' roots, equal digests show that K1's results did not
change), k4b (dK/dV of the rel-pos flash
attention at the trainer's (8, 16, 1024, 64), f32 or bf16), k2a / k2b / k2c
(the turbo GroupNorm modes at the decode's level 0, (16, 256, 65536)
bf16), k3 (the bf16 serving attention at the MIRAGE inner UNet's flash
sites, B = 2, 16 heads of 64, T = 1024 / 3072 / 1536, and B = 1 / 4 at T =
1024) and k5 (the grouped GroupNorm + FiLM + SiLU at the inner UNet's
shapes and the trainer's (8, 512, 2048) f32). k3 and k5 print one JSON
line a shape with the CUDA-event ms a call and the device ms a call (the
card kept busy while the host queues the calls); `--host-split` (k5) adds
the wrapper's host microseconds a call, split into its parts. k4a (the
f32 training forward with its residuals, 3xTF32 on the tensor cores) at
the trainer's (8, 16, 1024 / 512, 64), at B = 1 and at K3's f32 row (2,
16, 1024, 64), one JSON line a shape like k3's; `--variants` adds the
device ms of each block the f32 route can take (1 or 2 batch rows, 64 or
128 query rows, 64 or 32 keys a tile), in turns. k4a and k4b with
`--dtype bfloat16`: the bf16 routes at the bf16 training step's (8 and
16, 16, 1024, 64) and (8, 16, 512, 64), each with a bf16 and an f32 bias;
they call only the wrappers, so an earlier checkout's bf16 kernels are
timed by running this script from that checkout's root. k4c (dQ and the
batch-summed d-bias) the same way: f32 at the trainer's (8, 16, 1024 /
512, 64), `--dtype bfloat16` at the bf16 shapes above with both bias
dtypes. r1 (the biquad cascade
at chip_smoke.py's xae and apps shapes: the TPT filters' (128, 262144),
the phaser's (1024, 32768) x 2 sections, loudness's (2, 1440000) x 2
shared, the apps' (16, 65536)), r2 (the compressor's envelope at the xae
path's (4, 262144) on noise and on a gate whose level jumps on chunk
starts, and on its one-chunk route at (4, 96) and (4096, 4096), each line
with a SHA-256 of the output's bits and, where the checkout has them, the
chunk plan and the rounds) and r3 (Freeverb's responses, 64 x 262144 and
16 x 65536), one JSON line a shape with the CUDA-event ms and the device
ms a call (`--trace`: each CUDA kernel's device µs a call, by
torch.profiler); they call only the wrappers `sosfilt_rows`, `envelope`
and `freeverb_irs`, so this script times an earlier checkout's R1-R3 when
it runs from that checkout's root. k6 (the fused STFT at shapes every
checkout since the FFT route takes on one route: powers of two 16-4096 at a
quarter hop, chip_smoke.py's CLAP, DMAE and PitchShift rows, hop 1 and hop
480, the DFT product at n_fft 1018, 999 and 1001 on grids of 24 to
2,304 blocks, and the mixed radices at 1000 / 250, 1920 / 480 and 1408 /
128), one JSON line a shape with
the route, a SHA-256 of the output's bits and the device ms a call; it
calls only `stft_fused`, so run from two checkouts' roots, equal digests
show that K6's results did not change; each line has the route `plan`
gives where the checkout has it, and torch.stft's device ms beside K6's.
The shapes the DFT product took before the chirp-z and cluster routes
(1018, 1102, 999, 1001, 1538, 2018, 10000, 16384, 8194) and 8192 / 2048 come
last. `--variants`: K6 on a candidate route (`_launch`'s route_plan and
slots, this checkout only) beside the planned one, in turns: 8192 / 2048
on the FFT route's one frame a block and on one CTA of four frames
against the planned cluster of four CTAs, 2402 / 600 (M = 4096) on the
cluster kernel against the chirp route's one transform a block, 16384 /
4096 with four transforms in each CTA against the planned one a CTA,
and 10000 / 2500 by chirp-z on 4 CTAs against the planned 2 mixed-radix
parts. Every line names the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# chip_smoke.py's K1 cases, in its order and with its seeds (case i from seed i)
K1_CASES = [(shape, dt, gelu, res) for shape in [(4, 256, 65536), (4, 512, 8)]
            for dt in ("bfloat16", "float32") for gelu in (True, False) for res in (True, False)]
K1_CASES += [((2, 128, 1000), "float32", True, True), ((1, 512, 32768), "bfloat16", True, True),
             ((1, 256, 65536), "float32", True, True), ((1, 512, 8), "float32", True, True)]
K3_SHAPES = [(2, 16, 1024, 64), (2, 16, 3072, 64), (2, 16, 1536, 64), (1, 16, 1024, 64),
             (4, 16, 1024, 64)]
K4A_SHAPES = [(8, 16, 1024, 64), (8, 16, 512, 64), (1, 16, 1024, 64), (2, 16, 1024, 64)]
K4A_BLOCKS = [(1, 64, 64), (2, 64, 64), (2, 64, 32), (1, 128, 64), (2, 128, 64),
              (2, 128, 32)]                     # (batch rows, query rows, keys a tile)
# the bf16 training step's flash sites (batch 8 and the tool's 16) and T = 512
K4_BF16_SHAPES = [(8, 16, 1024, 64), (16, 16, 1024, 64), (8, 16, 512, 64)]
R1_SHAPES = [("tpt", 128, 262144, 1), ("phaser", 1024, 32768, 2), ("loudness", 2, 1440000, 2),
             ("apps", 16, 65536, 1)]        # (case, rows, T, sections)
R3_SHAPES = [(64, 262144), (16, 65536)]      # (responses, samples)
R2_CASES = [("noise", 4, 262144), ("gate", 4, 262144), ("one_chunk", 4, 96),
            ("one_chunk", 4096, 4096)]      # (input, rows, T)
# (rows, T, n_fft, hop, center): K6 where every checkout takes one route
K6_CASES = [(32, 65536, n, n // 4, c) for n in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
            for c in (True, False)]
K6_CASES += [(1, 1048576, 1024, 480, True), (8, 66304, 1024, 256, False),
             (4, 262144, 2048, 512, True), (40, 9000, 256, 480, True), (1, 5000, 64, 1, True),
             (32, 65536, 1018, 250, True), (3, 5000, 999, 160, False),
             (1, 16000, 1001, 160, True), (4, 8000, 1018, 250, True), (8, 48000, 1018, 250, True),
             (32, 65536, 1000, 250, True), (32, 65536, 1920, 480, True),
             (32, 65536, 1408, 128, True)]
# shapes the DFT product took before the chirp-z and cluster routes, and
# 8192 / 2048 (the FFT route's one frame a block before the cluster route)
K6_CASES += [(32, 65536, 1102, 441, True), (32, 65536, 999, 250, True),
             (8, 48000, 2018, 2018, True), (1, 9000, 1538, 480, True),
             (4, 262144, 8192, 2048, True), (4, 262144, 16384, 4096, True),
             (4, 262144, 10000, 2500, True), (4, 262144, 8194, 2048, True)]
# --variants: K6 on a candidate route beside the planned one, in turns:
# (rows, T, n_fft, hop, route, radices, cluster slots)
K6_VARIANTS = [(4, 262144, 8192, 2048, "fft", (8, 8, 8, 8), None),    # a frame a block
               (16, 65536, 8192, 2048, "fft", (8, 8, 8, 8), None),
               (4, 262144, 8192, 2048, "cluster", (1, 8, 8, 8, 8), 4),   # 4 frames a CTA
               (32, 65536, 2402, 600, "cluster", (1, 8, 8, 8, 8), 1),    # M = 4096 chirp-z
               (4, 262144, 16384, 4096, "cluster", (2, 8, 8, 8, 8), 4),
               (4, 262144, 10000, 2500, "cluster", (4, 8, 8, 8, 8), None)]  # chirp-z
K5_SHAPES = [((2, 512, 2048), "bfloat16", True), ((2, 1536, 2048), "bfloat16", False),
             ((2, 1024, 32), "bfloat16", True), ((2, 512, 2048), "float32", True),
             ((8, 512, 2048), "float32", True)]


def events_ms(fn, iters: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device ms a call: the card sleeps while the host queues the calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 300) -> float:
    """Host microseconds a call, the card kept busy so that no call waits
    for it."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def k5_inputs(shape, dtype, film, seed):
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b, c, _ = shape
    dt = getattr(torch, dtype)
    x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.2).to(dt)
    scale = (torch.rand(c, generator=g, device=dev) + 0.5).to(dt)
    bias = (torch.rand(c, generator=g, device=dev) - 0.5).to(dt)
    ts = (torch.randn((b, 2 * c), generator=g, device=dev) * 0.3).to(dt)
    fs, sh = ts.chunk(2, dim=1) if film else (None, None)
    return x, scale, bias, fs, sh


def k5_host_split(x, scale, bias, fs, sh) -> dict:
    """The wrapper's host cost a call and its parts, in microseconds: the
    input checks, wants_grad, the output (and scratch) allocation, the
    stream lookup, the ctypes call of the C entry with arguments it refuses
    before launching (groups = 0), and the whole call; `launch` is what the
    whole call spends beyond its parts."""
    import ctypes
    import torch
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    b, c, t = x.shape
    split = {"check": host_us(lambda: ggn._check(x, scale, bias, 8, fs, sh)),
             "wants_grad": host_us(lambda: gn.wants_grad(x, scale, bias, fs, sh)),
             "alloc_y": host_us(lambda: torch.empty_like(x)),
             "stream": host_us(lambda: torch.cuda.current_stream(x.device).cuda_stream)}
    stride = fs.stride(0) if fs is not None else 0
    fsp = fs.data_ptr() if fs is not None else None
    shp = sh.data_ptr() if sh is not None else None
    if hasattr(ggn, "_fn"):          # one launch, a plan array per shape
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        if raw is not None:
            split["stream_raw"] = host_us(lambda: raw(x.get_device()))
        split["plan"] = host_us(lambda: ggn._plan(x, 8, stride))
        plan, ints, _ = ggn._plan(x, 8, stride)
        bad = (ctypes.c_int * len(ints))(*ints)
        bad[3] = 0
        entry = ggn._fn("aa_ggn_cluster" if plan.route == "cluster" else "aa_ggn_two_pass")
        extra = [] if plan.route == "cluster" else [None]
        split["ctypes_no_launch"] = host_us(lambda: entry(
            bad, 7, 1e-6, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), fsp, shp,
            x.data_ptr(), *extra, 0))
        split["route"] = plan.route
    else:                            # the two-launch design: partials, 19 arguments
        n = c // 8 * t
        n_split, apply_blocks = gn._launch_shape(b * 8, n, 16 // x.element_size())
        split["alloc_partials"] = host_us(lambda: torch.empty(
            (b * 8, n_split, 2), dtype=torch.float32, device=x.device))
        fn = ggn._lib()
        split["ctypes_no_launch"] = host_us(lambda: fn(
            gn._DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), bias.data_ptr(), fsp, shp,
            stride, x.data_ptr(), x.data_ptr(), b, c, t, 0, n_split, apply_blocks, 1, 1e-6,
            1, 0))
    split["whole_call"] = host_us(lambda: ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh))
    used = "stream_raw" if "stream_raw" in split else "stream"    # the wrapper's lookup
    parts = sum(v for k, v in split.items() if k not in (
        "whole_call", "route", "stream", "stream_raw")) + split[used]
    split["launch"] = split["whole_call"] - parts
    return split


def kernel_device_us(fn, iters: int) -> dict:
    """Device µs a call of each CUDA kernel that `fn` launches, by
    torch.profiler, keyed by the kernel's name without its namespace and
    arguments."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if total:
            name = re.search(r"(\w+_kernel\w*(<\d+>)?)", e.key)
            key = name.group(1) if name else e.key[:60]
            out[key] = out.get(key, 0.0) + total / iters
    return out


def profile_envelope(dev, card, g, trace: bool) -> int:
    """R2 through the wrapper alone: R2_CASES, the gate a decaying 220 Hz
    tone on for 1,024 samples from every multiple of 2,048."""
    import hashlib
    import math
    import torch
    from audio_algebra_torch.ops import recurrence as rec
    a_att, a_rel = math.exp(-1.0 / 48.0), math.exp(-1.0 / 4800.0)
    for kind, rows, t_len in R2_CASES:
        x = 0.3 * torch.randn((rows, t_len), generator=g, device=dev)
        if kind == "gate":
            t = torch.arange(t_len, device=dev, dtype=torch.float32)
            tone = torch.sin(2 * math.pi * 220.0 * t / 48000) * torch.exp(-(t % 2048) / 600)
            x = torch.where(t % 2048 < 1024, 0.8 * tone, 0.0).repeat(rows, 1)

        def call():
            return rec.envelope(x, a_att, a_rel)
        y = call()
        torch.cuda.synchronize()
        row = {"kernel": "r2", "tree": os.getcwd(), "case": kind, "shape": [rows, t_len],
               "sha256": hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest(),
               "ms": events_ms(call, 20), "device_ms": device_ms(call, 20), "device": card}
        if hasattr(rec, "envelope_stats"):
            stats = rec.envelope_stats()
            row |= {"chunk_len": stats["chunk_len"], "chunks": stats["chunks"],
                    "resident": stats.get("resident"), "rounds": max(stats["rounds"]),
                    "rows_repaired": sum(stats["repaired"])}
        if trace:
            row["kernel_device_us"] = kernel_device_us(call, 20)
        print(json.dumps(row), flush=True)
    return 0


def profile_recurrence(kernel, dev, card, g, trace: bool) -> int:
    """R1, R2 or R3 at their main-path shapes, through the wrappers alone."""
    import torch
    from audio_algebra_torch.ops import recurrence as rec
    from audio_algebra_torch.ops.filters import butter_sos
    from audio_algebra_torch.ops.loudness import _k_weighting_sos
    if kernel == "r2":
        return profile_envelope(dev, card, g, trace)
    if kernel == "r1":
        for case, rows, t_len, n_sec in R1_SHAPES:
            x = 0.3 * torch.randn((rows, t_len), generator=g, device=dev)
            if case == "loudness":
                sos = _k_weighting_sos(48000).to(dev)[None]
            else:
                cut = torch.linspace(1500.0, 12000.0, rows, device=dev)
                sos = butter_sos(2, cut, 48000, "lowpass").repeat(1, n_sec, 1)

            def call():
                return rec.sosfilt_rows(sos, x)
            row = {"kernel": "r1", "tree": os.getcwd(), "case": case, "shape": [rows, t_len],
                   "sections": sos.shape[1], "ms": events_ms(call, 10),
                   "device_ms": device_ms(call, 10), "device": card}
            if hasattr(rec, "chunk_plan"):
                row["chunk_len"], row["chunks"] = rec.chunk_plan(rows, t_len)
            if trace:
                row["kernel_device_us"] = kernel_device_us(call, 10)
            print(json.dumps(row), flush=True)
        return 0
    for n_ir, t_len in R3_SHAPES:
        fb = torch.linspace(0.7, 0.98, n_ir // 2, device=dev).repeat(2)
        dm = torch.full_like(fb, 0.2)
        spreads = [0] * (n_ir // 2) + [23] * (n_ir // 2)

        def call():
            return rec.freeverb_irs(fb, dm, spreads, t_len)
        row = {"kernel": "r3", "tree": os.getcwd(), "shape": [n_ir, t_len],
               "ms": events_ms(call, 5), "device_ms": device_ms(call, 5), "device": card}
        if trace:
            row["kernel_device_us"] = kernel_device_us(call, 5)
        print(json.dumps(row), flush=True)
    return 0


def profile_k4_bf16(kernel: str, dev, card, g) -> int:
    """K4a's, K4b's or K4c's bf16 route at K4_BF16_SHAPES with a bf16 and an
    f32 bias: one JSON line a case, CUDA-event and device ms a call. Only the
    wrappers flash_attention_relpos_fwd / _dkv / _dq are called, so an
    earlier checkout's kernels are timed from its root."""
    import torch
    from audio_algebra_torch.ops import flash_attention as fa
    for shape in K4_BF16_SHAPES:
        h, t = shape[1], shape[2]
        for bias_dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(shape, generator=g, device=dev).bfloat16()
                           for _ in range(4))
            bias_t = (torch.randn((h, t, t), generator=g, device=dev) * 0.5).to(bias_dtype)
            o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
            delta = fa.flash_delta(o, do)
            if kernel == "k4a":
                def call():
                    return fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
            elif kernel == "k4b":
                def call():
                    return fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m, delta, 0.125)
            else:
                def call():
                    return fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m, delta, 0.125)
            row = {"kernel": kernel, "tree": os.getcwd(), "shape": list(shape),
                   "dtype": "bfloat16", "bias_dtype": str(bias_dtype).removeprefix("torch."),
                   "ms": events_ms(call, 20), "device_ms": device_ms(call, 20), "device": card}
            print(json.dumps(row), flush=True)
            del q, k, v, do, bias_t, o, l, m, delta
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=["k1", "k4a", "k4b", "k4c", "k2a", "k2b", "k2c", "k3",
                                         "k5", "k6", "r1", "r2", "r3"], required=True)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                    help="k4a, k4b, k4c: float32 (default) or bfloat16 (the bf16 "
                         "training step's shapes, both bias dtypes); K2 runs in bfloat16")
    ap.add_argument("--launches", type=int, default=3)
    ap.add_argument("--host-split", action="store_true",
                    help="k5: the wrapper's host microseconds a call, by part")
    ap.add_argument("--variants", action="store_true",
                    help="k5: device ms at every cluster size that fits; k3: the 64- "
                         "and 128-row query tiles at B <= 2, in turns; k4a: each block "
                         "(batch rows, query rows, keys a tile) of the f32 route, "
                         "in turns; k6: candidate routes beside the planned one, in "
                         "turns")
    ap.add_argument("--trace", action="store_true",
                    help="r1, r2, r3: the device µs a call of each CUDA kernel, by "
                         "torch.profiler")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("profile_kernel: no CUDA device", file=sys.stderr)
        return 2
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.ops import groupnorm_grouped as ggn

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device=dev).manual_seed(0)
    if args.kernel == "k1":
        import hashlib
        for i, (shape, dt, gelu, res) in enumerate(K1_CASES):
            gi = torch.Generator(device=dev).manual_seed(i)
            dtype = getattr(torch, dt)
            x = (torch.randn(shape, generator=gi, device=dev) * 1.5 + 0.2).to(dtype)
            r = torch.randn(shape, generator=gi, device=dev).to(dtype) if res else None
            scale = (torch.rand(shape[1], generator=gi, device=dev) + 0.5).to(dtype)
            bias = (torch.rand(shape[1], generator=gi, device=dev) - 0.5).to(dtype)

            def call():
                return gn.groupnorm1_gelu(x, scale, bias, gelu, r)
            y = call()
            torch.cuda.synchronize()
            digest = hashlib.sha256(y.view(torch.int16 if dt == "bfloat16" else torch.int32)
                                    .cpu().numpy().tobytes()).hexdigest()
            print(json.dumps({"kernel": "k1", "tree": os.getcwd(), "shape": list(shape),
                              "dtype": dt, "gelu": gelu, "residual": res, "sha256": digest,
                              "ms": events_ms(call, 20), "device": card}), flush=True)
            del x, r, y
        return 0
    if args.kernel == "k6":
        import hashlib
        from audio_algebra_torch.ops import stft_kernel as stk
        plan = getattr(stk, "plan", None)
        for rows, t_len, n_fft, hop, center in ([] if args.variants else K6_CASES):
            gi = torch.Generator(device=dev).manual_seed(n_fft * 7 + hop)
            x = torch.randn((rows, t_len), generator=gi, device=dev) * 0.5
            win = torch.hann_window(n_fft, device=dev)

            def call():
                return stk.stft_fused(x, n_fft, hop, center)
            before = stk.fft_launches
            y = call()
            torch.cuda.synchronize()
            route = plan(n_fft).route if plan else ("fft" if stk.fft_launches > before else "dft")
            print(json.dumps({
                "kernel": "k6", "tree": os.getcwd(), "shape": [rows, t_len], "n_fft": n_fft,
                "hop": hop, "center": center, "route": route,
                "sha256": hashlib.sha256(torch.view_as_real(y).contiguous().cpu().numpy()
                                         .tobytes()).hexdigest(),
                "device_ms": device_ms(call, 20),
                "library_device_ms": device_ms(lambda: torch.stft(
                    x, n_fft, hop, window=win, center=center, pad_mode="reflect",
                    return_complex=True), 20), "device": card}), flush=True)
            del x, y
        for rows, t_len, n_fft, hop, route, radices, slots in (K6_VARIANTS if args.variants
                                                                else []):
            gi = torch.Generator(device=dev).manual_seed(n_fft * 7 + hop)
            x = torch.randn((rows, t_len), generator=gi, device=dev) * 0.5
            candidate = stk.StftPlan(route, radices)
            planned = stk._launch(x, n_fft, hop, True)
            got = stk._launch(x, n_fft, hop, True, candidate, slots)
            torch.cuda.synchronize()
            row = {"kernel": "k6", "variant": True, "shape": [rows, t_len], "n_fft": n_fft,
                   "hop": hop, "planned": list(plan(n_fft)),
                   "candidate": [route, list(radices), slots],
                   "candidate_vs_planned_max_abs": float((got - planned).abs().max()),
                   "device": card}
            times = {"planned": [], "candidate": []}
            for turn in ("planned", "candidate", "candidate", "planned"):
                p, n = (None, None) if turn == "planned" else (candidate, slots)
                times[turn].append(device_ms(
                    lambda: stk._launch(x, n_fft, hop, True, p, n), 20))
            print(json.dumps({**row, "planned_device_ms": times["planned"],
                              "candidate_device_ms": times["candidate"]}), flush=True)
            del x, planned, got
        return 0
    if args.kernel == "k3":
        for shape in K3_SHAPES:
            q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16() for _ in range(3))
            h, t = shape[1], shape[2]
            bias_t = (torch.randn((h, t, t), generator=g, device=dev) * 0.5).bfloat16()

            def call():
                return fa.flash_attention_relpos(q, k, v, bias_t, 0.125)
            row = {"kernel": "k3", "tree": os.getcwd(), "shape": list(shape),
                   "dtype": "bfloat16", "bias_dtype": "bfloat16",
                   "ms": events_ms(call, 20), "device_ms": device_ms(call, 20), "device": card}
            if args.variants and shape[0] <= 2:     # the query tiles, in turns
                calls = {bq: (lambda bq=bq: fa._serve_cuda(q, k, v, bias_t, 0.125, bq))
                         for bq in (64, 128)}
                row["device_ms_by_query_tile_in_turns"] = [
                    [bq, device_ms(calls[bq], 20)] for bq in (64, 128, 128, 64)]
            print(json.dumps(row), flush=True)
            del q, k, v, bias_t
        return 0
    if args.kernel in ("k4a", "k4b", "k4c") and args.dtype == "bfloat16":
        return profile_k4_bf16(args.kernel, dev, card, g)
    if args.kernel == "k4c":
        for shape in K4A_SHAPES[:2]:               # the f32 trainer's sites
            q, k, v, do = (torch.randn(shape, generator=g, device=dev) for _ in range(4))
            h, t = shape[1], shape[2]
            bias_t = torch.randn((h, t, t), generator=g, device=dev) * 0.5
            o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
            delta = fa.flash_delta(o, do)

            def call():
                return fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m, delta, 0.125)
            print(json.dumps({"kernel": "k4c", "tree": os.getcwd(), "shape": list(shape),
                              "dtype": "float32", "bias_dtype": "float32",
                              "ms": events_ms(call, 20), "device_ms": device_ms(call, 20),
                              "device": card}), flush=True)
            del q, k, v, do, bias_t, o, l, m, delta
        return 0
    if args.kernel == "k4a":
        for shape in K4A_SHAPES:
            q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
            h, t = shape[1], shape[2]
            bias_t = torch.randn((h, t, t), generator=g, device=dev) * 0.5

            def call():
                return fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
            row = {"kernel": "k4a", "tree": os.getcwd(), "shape": list(shape),
                   "dtype": "float32", "bias_dtype": "float32",
                   "ms": events_ms(call, 20), "device_ms": device_ms(call, 20), "device": card}
            if args.variants:                       # the blocks, in turns
                blocks = [blk for blk in K4A_BLOCKS if blk[0] <= shape[0]]
                calls = {blk: (lambda blk=blk: fa._forward_cuda(
                    q, k, v, bias_t, 0.125, True, blk)) for blk in blocks}
                row["device_ms_by_block_in_turns"] = [
                    [*blk, device_ms(calls[blk], 20)] for blk in blocks + blocks[::-1]]
            print(json.dumps(row), flush=True)
            del q, k, v, bias_t
        return 0
    if args.kernel in ("r1", "r2", "r3"):
        return profile_recurrence(args.kernel, dev, card, g, args.trace)
    if args.kernel == "k5":
        for i, (shape, dtype, film) in enumerate(K5_SHAPES):
            x, scale, bias, fs, sh = k5_inputs(shape, dtype, film, 200 + i)

            def call():
                return ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh)
            row = {"kernel": "k5", "tree": os.getcwd(), "shape": list(shape), "dtype": dtype,
                   "film": film, "ms": events_ms(call, 200), "device_ms": device_ms(call, 200),
                   "device": card}
            if args.host_split:
                row["host_us"] = k5_host_split(x, scale, bias, fs, sh)
            if args.variants:
                b, c, t = shape
                n, esize = c // 8 * t, x.element_size()
                plans = [p for p in (ggn.cluster_plan(n, c // 8, t, esize, cs)
                                     for cs in ggn.CLUSTER_SIZES) if p is not None]
                row["device_ms_by_cluster"] = {
                    f"{p.cs}x{p.threads}": [device_ms(lambda p=p: ggn._launch(
                        x, scale, bias, 8, fs, sh, True, 1e-6, plan=p), 200) for _ in range(2)]
                    for p in plans}
            print(json.dumps(row), flush=True)
        return 0
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
                      "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
