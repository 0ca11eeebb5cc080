#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py

Runs from the root of a checkout of the repository, on a machine with a
CUDA card (sm_90a: H100). It imports nothing of JAX or of the JAX package.
Phases, each printing one JSON line:

  build         compile every CUDA source of audio_algebra_torch/csrc with
                nvcc, all started together
  kernels       hold each kernel against its plain PyTorch twin on the card,
                at the main paths' shapes, and time it beside the twin, one
                PyTorch library call and its bound: K1 (fused GroupNorm(1)
                [+GELU] [+residual]), K3 (rel-pos flash attention) and K5
                (grouped GroupNorm + FiLM + SiLU)
  model         one full-width Destructo UNet forward, (2, 2, 16384) bf16,
                through K1 and through the twin with the same weights:
                rel-RMS under a bound
  destructo     the Destructo pipeline at the reference width in bf16 with
                seeded random weights: a 44.1 kHz WAV is loaded, resampled
                and chunked into 4 x 65536 samples, encoded, negated and
                decoded in 35 v-DDIM steps; K1 must launch 35 x 191 times
  kernels (K2)  the turbo GroupNorm modes (int8 emit, residual + amax, +
                int8 twin) against their twins at the turbo decode's level
                0 and 2 shapes, each timed beside the twin, the library
                chain and its byte bound, with the rate it reached (TB/s of
                the bound's bytes); and the int8 conv against the bf16 cuDNN
                conv at level 0
  destructo_turbo  the same pipeline at B = 16 x 65536 chunks, decoded in 35
                steps once in bf16 and once through the turbo int8 route with
                the amax carry, from the same noise: both realtime factors,
                the rel-RMS between the decodes (< 0.08), and the K1/K2
                launch counts of the turbo decode
  mirage_model  one full-width MIRAGE UNetCFG1d forward (songs config, CFG
                scale 4, batch 1 -> 2, T = 2048) in f32 and bf16, through K3
                and K5 and through their twins with the same weights:
                rel-RMS under a bound; 4 K3 and 63 K5 launches
  mirage        CLAPDAE().half() at full width with seeded random weights:
                22 s (1,048,576 samples), batch 1, CFG 4, 150 DPM++(2M)
                inner steps and 100 v-DDIM outer steps, from the weighted
                algebra of two seeded unit embeddings, run twice; K3, K5 and
                K1 must launch 150 x 4, 150 x 63 and 100 x 119 times
  kernels (K6)  the fused STFT on both routes against its twin (atol 5e-4 +
                rtol 1e-4, the JAX package's own tolerance) and float64: the
                shared-memory FFT at the spectrogram models' (32, 65536)
                1024/256 and CLAP's (1, 1048576) 1024/480 (no further from
                float64 than the twin), the DFT product at (32, 65536)
                1000/250; each timed beside the twin, torch.stft (cuFFT),
                its byte bound and the DFT's operations bound, per call and
                on the device alone (the card kept busy while the host queues)
  spectrogram   the four spectrogram given models at (16, 2, 65536) f32
                (1024/256, 32 Griffin-Lim rounds): the SpectrogramAE and
                MagDPhase (init 'true') round trips under 1e-9 and 1e-8 rel
                MSE (the CPU test's bound at this length); the
                Mag and Mel decodes through K6 against the same decodes
                through the twin from the same angles (rel-RMS under the
                larger of 1e-3 and the twin's own spread under a 1e-6 input
                change); spectral convergence, encode and decode times; K6
                must launch 1 + 33 + 33 + 1 = 68 times, all on the FFT route
  clap          the served model's CLAP module at full width in f32 with
                seeded random weights (HTSAT-base with fusion, RoBERTa-base):
                a 5 s clip (short path), a 22 s clip (fusion path) and two
                texts embedded through CLAPDAE.embed: (1, 1, 512), unit norm,
                finite; the audio embeddings through K6 against the same
                through the twin (rel diff < 1e-4); one K6 launch per clip
  serve         the port's HTTP service in-process on localhost: /health,
                two /generate requests with embeddings (slerp, algebra) and
                one with a text prompt at full width and reduced steps,
                /embed with a text (512 floats and the tokenizer warning)
                and with WAV bytes, and a strict-text service answering 409
  kernels (K4)  the differentiable flash attention: K4a's (o, l, m), K4b's
                (dk, dv) and K4c's (dq, dbT) against the twins at the
                trainer's sites (8, 16, 1024 / 512, 64) in f32 (atol = rtol =
                2e-4, the JAX package's) and bf16, at (16, 16, 1024, 64) bf16
                and at B = 1, each timed beside the twin, SDPA forward /
                backward and its bound (K4b and K4c in f32: 3xTF32 on the
                tensor cores, and the f32 CUDA-core bound beside it); two
                launches each of K4b and K4c at (8, 16, 1024, 64) f32 and
                bf16 give the same bits; and the autograd Functions around
                K1 and K5: forward through the kernel, backward() against
                autograd of the twin
  train_model   one v_objective_loss forward + backward of the full-width
                songs UNetCFG1d at (8, 32, 2048) f32 through K4 and K5 and
                through their twins, from the same weights, noise, t,
                embeddings and keep mask: the loss and every parameter's
                gradient under a bound, all finite, none zero that the
                twin's is not; 8 / 8 / 8 K4, 63 K5 and 0 K3 launches
  train         audio_algebra_torch.train_clapdae.main on 16 seeded synthetic
                48 kHz stereo WAVs of 1,048,576 samples: CLAPDAE() defaults at
                full width in f32, batch 8, 2 epochs (4 steps), a checkpoint;
                then a second main that resumes at step 4 and takes one more
                step; lr and EMA decay against their closed forms, launch
                counts (8 / 8 / 8 K4, 63 + 65 K5 and 1 K6 a step), stage
                times, peak memory

The phases run in the order above, Destructo's first. Then the `kernels`
summary line, the card's name and power limit from nvidia-smi, and last
`{"ok": true, "device": {...}}`. Any failure exits non-zero. Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result. `--only build,kernels_k4,...` (phase function names without
`phase_`) runs those phases alone and prints no result line: for work on
one phase.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TF32_TC_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
GN_CALLS_PER_FORWARD = 191     # 14 levels x 6 blocks x 2 - 1 + 24 attention pre-norms
STEPS = 35
CHUNK = 65536                  # samples per Destructo chunk
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2 ** -7)}   # (atol, rtol)
MODEL_REL_RMS_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
# MIRAGE (22 s, songs config): the inner UNet runs 4 flash sites (level 2,
# T = 1024) and 63 grouped GroupNorms (31 ResnetBlocks x 2 + out_norm) per
# forward; the outer UNet (depth 10, no attention) 10 x 6 x 2 - 1 = 119 K1.
K3_PER_INNER, K5_PER_INNER, K1_PER_OUTER = 4, 63, 119
INNER_STEPS, OUTER_STEPS, MIRAGE_SAMPLES = 150, 100, 1048576
MIRAGE_REL_RMS_BOUND = {"float32": 1e-3, "bfloat16": 5e-2}
# Destructo turbo (B = 16 >= the turbo batch gate): per UNet forward, 83 GN_0
# int8 emits (every block but stack_000.m0, whose 82-channel input fails the
# C % 128 gate), GN_1 with amax in the 20 stacks without attention (59 on
# step 0; on later steps the carry turns m0/m2's 40 into K2c), and K1 at the
# 24 attention pre-norms, the attention stacks' 24 GN_1 and stack_000.m0.
TURBO_B = 16
TURBO_STEP0 = {"k1": 49, "k2a": 83, "k2b": 59, "k2c": 0}
TURBO_STEP = {"k1": 49, "k2a": 83, "k2b": 19, "k2c": 40}
TURBO_REL_RMS_BOUND = 0.08     # turbo vs bf16 decode (the JAX package's band)
INT8_OPS_PER_S = 1979e12       # H100 SXM int8 tensor cores, dense
# the spectrogram models (16, 2, 65536) at 1024 / 256: SpectrogramAE and
# MagDPhase encode once, Mag and Mel encode once and take 32 Griffin-Lim rounds
SPEC_SHAPE, SPEC_ITERS = (16, 2, 65536), 32
K6_SPECTROGRAM = 1 + (1 + SPEC_ITERS) + (1 + SPEC_ITERS) + 1
STFT_TOL = (5e-4, 1e-4)        # (atol, rtol): the JAX package's for its kernel
GL_REL_RMS = 1e-3
# the exact round trips, rel MSE: SpectrogramAE's; MagDPhase integrates f32
# phase increments over 257 frames, where JAX's own round trip reaches 1.9e-9
# (the bound of tests/test_torch_spectrogram_models.py at this length)
ROUND_TRIP = {"SpectrogramAE": 1e-9, "MagDPhaseSpectrogramAE": 1e-8}
CLAP_REL = 1e-4
CLAP_SHORT, CLAP_LONG = 240000, MIRAGE_SAMPLES     # 5 s and 22 s at 48 kHz
# the trainer: batch 8 x 1,048,576 samples -> (8, 32, 2048) latents; per
# forward + backward of the songs UNetCFG1d 4 flash sites at T = 1024 and 4 at
# T = 512 (one launch of K4a, K4b and K4c each) and 63 grouped GroupNorms;
# the frozen stage-1 encode of a batch runs 65 more (Encoder1d: 32
# ResnetBlocks x 2 + its out norm), under no_grad
TRAIN_BATCH, TRAIN_FILES, TRAIN_EPOCHS = 8, 16, 2
K4_PER_STEP, K5_PER_STEP, K5_PER_ENCODE = 8, 63, 65
K4_TOL = {"float32": (2e-4, 2e-4), "bfloat16": TOL["bfloat16"]}      # (atol, rtol)
TRAIN_LOSS_REL, TRAIN_GRAD_REL_RMS = 1e-4, 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time per call: the card is kept busy (torch.cuda._sleep, ~0.1
    s) while the host queues the calls, so the events time the card alone
    and not the host's launch path."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> None:
    from audio_algebra_torch.ops import _build
    sources = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    t0 = time.time()
    logs = _build.build(sources)
    log = "\n".join(logs.values())
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    emit({"phase": "build", "sources": sources, "built": sorted(logs),
          "seconds": time.time() - t0, "max_registers": max(regs, default=None),
          "spill_store_bytes": sum(spills)})


def gn_bound(shape, dtype, gelu: bool, residual: bool) -> tuple[float, str]:
    """Least time for GN(1)[+GELU][+res]: read x (and res) once, write y
    once; or its f32 operations (stats 3, normalise + affine 4, GELU 8,
    residual 1 per element) at the f32 peak, whichever is larger."""
    import torch
    n, c = math.prod(shape), shape[1]
    esize = torch.empty((), dtype=dtype).element_size()
    t_bytes = (n * esize * (3 if residual else 2) + 2 * c * esize) / HBM_BYTES_PER_S * 1e3
    t_ops = n * (7 + 8 * gelu + residual) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    cases = [(shape, dt, gelu, res)
             for shape in [(4, 256, 65536), (4, 512, 8)]
             for dt in (torch.bfloat16, torch.float32)
             for gelu in (True, False) for res in (True, False)]
    cases.append(((2, 128, 1000), torch.float32, True, True))
    cases.append(((1, 512, 32768), torch.bfloat16, True, True))     # MIRAGE outer UNet
    rows = []
    for shape, dt, gelu, res in cases:
        g = torch.Generator(device=dev).manual_seed(len(rows))
        x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.2).to(dt)
        r = torch.randn(shape, generator=g, device=dev).to(dt) if res else None
        scale = (torch.rand(shape[1], generator=g, device=dev) + 0.5).to(dt)
        bias = (torch.rand(shape[1], generator=g, device=dev) - 0.5).to(dt)
        got = gn.groupnorm1_gelu(x, scale, bias, gelu, r)
        torch.cuda.synchronize()
        want = gn.groupnorm1_gelu_ref(x, scale, bias, gelu, r)
        name = str(dt).removeprefix("torch.")
        atol, rtol = TOL[name]
        err = (got.float() - want.float()).abs()
        bad = int((err > atol + rtol * want.float().abs()).sum())

        def library():
            y = F.group_norm(x, 1, scale, bias, 1e-6)
            if gelu:
                y = F.gelu(y, approximate="tanh")
            return y + r if res else y

        iters = 20 if x.numel() > 1 << 20 else 200
        bound_ms, bound_by = gn_bound(shape, dt, gelu, res)
        row = {"shape": list(shape), "dtype": name, "gelu": gelu, "residual": res,
               "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
               "n_outside_tol": bad,
               "kernel_ms": cuda_ms(lambda: gn.groupnorm1_gelu(x, scale, bias, gelu, r), iters),
               "plain_ms": cuda_ms(lambda: gn.groupnorm1_gelu_ref(x, scale, bias, gelu, r), iters),
               "library_ms": cuda_ms(library, iters),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        del x, r, got, want, err
    emit({"phase": "kernels", "kernel": "groupnorm1_gelu", "cases": rows})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K1 disagrees with its twin: {failed}")
    return next(r for r in rows if r["shape"] == [4, 256, 65536]
                and r["dtype"] == "bfloat16" and r["gelu"] and r["residual"])


def _compare(got, want, dtype) -> dict:
    name = str(dtype).removeprefix("torch.")
    atol, rtol = TOL[name]
    err = (got.float() - want.float()).abs()
    return {"dtype": name, "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
            "n_outside_tol": int((err > atol + rtol * want.float().abs()).sum())}


def flash_bound(shape, dtype, bias_dtype) -> tuple[float, str]:
    """Least time for K3: read q, k, v and the (H, T, T) bias once, write o
    once; or its 4 B H T^2 D product operations at the peak of q's type
    (bf16 tensor cores, or f32 outside them), whichever is larger."""
    import torch
    b, h, t, d = shape
    qkv = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * h * t * d * qkv + h * t * t * torch.empty((), dtype=bias_dtype).element_size()
    peak = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * b * h * t * t * d / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels_k3() -> dict:
    """K3 at the MIRAGE inner UNet's flash sites: 22 s (T = 1024) and 66 s
    (T = 3072, 1536), B = 2 from CFG, 16 heads x 64, bf16 with a bf16
    bias; and one f32 row."""
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    cases = [((2, 16, 1024, 64), torch.bfloat16, torch.bfloat16),
             ((2, 16, 3072, 64), torch.bfloat16, torch.bfloat16),
             ((2, 16, 1536, 64), torch.bfloat16, torch.bfloat16),
             ((2, 16, 1024, 64), torch.float32, torch.float32)]
    rows = []
    for shape, dt, bdt in cases:
        g = torch.Generator(device=dev).manual_seed(100 + len(rows))
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt) for _ in range(3))
        h, t = shape[1], shape[2]
        bias_t = (torch.randn((h, t, t), generator=g, device=dev) * 0.5).to(bdt)
        scale = shape[3] ** -0.5
        got = fa.flash_attention_relpos(q, k, v, bias_t, scale)
        torch.cuda.synchronize()
        want = fa.flash_attention_relpos_ref(q, k, v, bias_t, scale)
        row = {"shape": list(shape), "bias_dtype": str(bdt).removeprefix("torch."),
               **_compare(got, want, dt)}
        del got, want
        mask = bias_t.transpose(1, 2)[None].to(dt)           # (1, H, T, S)
        big = t > 1024
        bound_ms, bound_by = flash_bound(shape, dt, bdt)
        row.update({
            "kernel_ms": cuda_ms(lambda: fa.flash_attention_relpos(q, k, v, bias_t, scale),
                                 20),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_relpos_ref(q, k, v, bias_t, scale),
                                3 if big else 10, warmup=1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), 20),
            "bound_ms": bound_ms, "bound_by": bound_by})
        rows.append(row)
        del q, k, v, bias_t, mask
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "flash_attention_relpos", "cases": rows})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K3 disagrees with its twin: {failed}")
    return rows[0]


def ggn_bound(shape, dtype, film: bool) -> tuple[float, str]:
    """Least time for K5: read x once, write y once (plus the per-channel
    planes); or its f32 operations (statistics 3, affine 2, SiLU 4 per
    element) at the f32 peak, whichever is larger."""
    import torch
    b, c, t = shape
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * b * c * t * esize + (2 * c + (2 * b * c if film else 0)) * esize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = b * c * t * 9 / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels_k5() -> dict:
    """K5 at the MIRAGE inner UNet's shapes (8 groups, SiLU): the widest
    level with FiLM, the widest up-level input without FiLM, the deepest
    level; and one f32 row."""
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.ops import groupnorm_grouped as ggn

    dev = torch.device("cuda")
    cases = [((2, 512, 2048), torch.bfloat16, True), ((2, 1536, 2048), torch.bfloat16, False),
             ((2, 1024, 32), torch.bfloat16, True), ((2, 512, 2048), torch.float32, True)]
    rows = []
    for shape, dt, film in cases:
        g = torch.Generator(device=dev).manual_seed(200 + len(rows))
        b, c, _ = shape
        x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.2).to(dt)
        scale = (torch.rand(c, generator=g, device=dev) + 0.5).to(dt)
        bias = (torch.rand(c, generator=g, device=dev) - 0.5).to(dt)
        ts = (torch.randn((b, 2 * c), generator=g, device=dev) * 0.3).to(dt)
        fs, sh = ts.chunk(2, dim=1) if film else (None, None)
        got = ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh)
        torch.cuda.synchronize()
        want = ggn.grouped_gn_film_silu_ref(x, scale, bias, 8, fs, sh)
        row = {"shape": list(shape), "film": film, "silu": True, **_compare(got, want, dt)}

        def library():
            y = F.group_norm(x, 8, scale, bias, 1e-6)
            if film:
                y = y * (1 + fs[:, :, None]) + sh[:, :, None]
            return F.silu(y)

        bound_ms, bound_by = ggn_bound(shape, dt, film)
        row.update({"kernel_ms": cuda_ms(lambda: ggn.grouped_gn_film_silu(x, scale, bias, 8,
                                                                           fs, sh), 200),
                    "plain_ms": cuda_ms(lambda: ggn.grouped_gn_film_silu_ref(x, scale, bias,
                                                                              8, fs, sh), 50),
                    "library_ms": cuda_ms(library, 200),
                    "bound_ms": bound_ms, "bound_by": bound_by})
        rows.append(row)
    emit({"phase": "kernels", "kernel": "grouped_gn_film_silu", "cases": rows})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K5 disagrees with its twin: {failed}")
    return rows[0]


def rel_rms(a, b) -> float:
    return float(((a - b).square().mean() / b.square().mean().clamp_min(1e-12)).sqrt())


def phase_model() -> None:
    """One full-width UNet forward through K1 and through its twin, in f32
    and in bf16. The bf16 twin against the f32 twin gives the size of bf16
    rounding itself, the scale against which the bf16 difference is read."""
    import torch
    from audio_algebra_torch.models import blocks
    from audio_algebra_torch.models.unet1d import DiffusionAttnUnet1D
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.utils.params import random_init_

    dev = torch.device("cuda")
    unet = random_init_(DiffusionAttnUnet1D(io_channels=2, cond_dim=64), 0).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, 2, 16384), generator=g, device=dev)
    t = torch.rand((2,), generator=g, device=dev)
    cond = torch.tanh(torch.randn((2, 64, 128), generator=g, device=dev))
    out, calls = {}, {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            unet.to(dt)
            args = (x.to(dt), t.to(dt), cond.to(dt))
            before = gn.launches
            out["kernel", dt] = unet(*args).float()
            calls[dt] = gn.launches - before
            blocks.groupnorm1_gelu = gn.groupnorm1_gelu_ref
            try:
                out["plain", dt] = unet(*args).float()
            finally:
                blocks.groupnorm1_gelu = gn.groupnorm1_gelu
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"float32": rel_rms(out["kernel", f32], out["plain", f32]),
            "bfloat16": rel_rms(out["kernel", bf16], out["plain", bf16])}
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    emit({"phase": "model", "shape": [2, 2, 16384], "k1_launches": calls[bf16],
          "rel_rms_kernel_vs_plain": errs, "bound": MODEL_REL_RMS_BOUND,
          "rel_rms_plain_bf16_vs_f32": rel_rms(out["plain", bf16], out["plain", f32]),
          "finite": finite})
    if set(calls.values()) != {GN_CALLS_PER_FORWARD}:
        raise AssertionError(f"UNet forward launched K1 {calls} times")
    if not finite or any(errs[k] >= MODEL_REL_RMS_BOUND[k] for k in errs):
        raise AssertionError(f"UNet through K1 vs plain: rel-RMS {errs}")


def phase_destructo() -> int:
    import numpy as np
    import torch
    from audio_algebra_torch.destructo import mathemangle
    from audio_algebra_torch.given_models import DVAEWrapper
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.utils.audio_io import batch_it_crazy, load_audio, write_wav

    chunk, n_chunks, sr_in = 65536, 4, 44100
    n_in = int((n_chunks - 0.25) * chunk * sr_in / 48000)
    tt = np.arange(n_in) / sr_in
    rng = np.random.default_rng(0)
    signal = np.stack([0.3 * np.sin(2 * np.pi * 220 * tt), 0.3 * np.sin(2 * np.pi * 330 * tt)])
    signal = (signal + 0.05 * rng.standard_normal(signal.shape)).astype(np.float32)

    w = DVAEWrapper(args_dict={"sample_size": chunk, "demo_steps": STEPS},
                    device="cuda", dtype=torch.bfloat16)
    t0 = time.time()
    w.ensure_params()
    init_s = time.time() - t0

    def pipeline():
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "in.wav"
            write_wav(path, signal, sr_in)
            batch = batch_it_crazy(load_audio(path, sr=48000), chunk, max_batch_size=8)
        torch.cuda.synchronize()
        t_enc = time.time()
        z = mathemangle(w.encode(batch), "destructo")
        torch.cuda.synchronize()
        t_dec = time.time()
        out = w.decode(z, demo_steps=STEPS)
        torch.cuda.synchronize()
        return batch, out, t_dec - t_enc, time.time() - t_dec

    torch.cuda.reset_peak_memory_stats()
    gn.launches = 0
    batch, out, enc_s, dec_s = pipeline()
    launches = gn.launches
    _, _, enc2_s, dec2_s = pipeline()             # steady state (warm cuDNN plans)
    audio_s = batch.shape[0] * chunk / 48000
    finite = bool(torch.isfinite(out).all())
    emit({"phase": "destructo", "batch": list(batch.shape), "steps": STEPS,
          "dtype": "bfloat16", "out_shape": list(out.shape), "finite": finite,
          "k1_launches": launches, "k1_expected": STEPS * GN_CALLS_PER_FORWARD,
          "init_s": init_s, "first_encode_s": enc_s, "first_decode_s": dec_s,
          "encode_s": enc2_s, "decode_s": dec2_s, "ms_per_step": dec2_s / STEPS * 1e3,
          "realtime_factor": audio_s / (enc2_s + dec2_s),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if tuple(out.shape) != (2, n_chunks * chunk) or batch.shape[0] != n_chunks or not finite:
        raise AssertionError(f"destructo output {tuple(out.shape)} finite={finite}")
    if launches != STEPS * GN_CALLS_PER_FORWARD:
        raise AssertionError(f"K1 launched {launches} times in the decode, "
                             f"expected {STEPS * GN_CALLS_PER_FORWARD}")
    return launches


def k2_bytes(shape, dtype, mode: str) -> int:
    """Bytes K2 must move: x (and the residual) read once, each output
    written once, the (C,) planes."""
    import torch
    n, c = math.prod(shape), shape[1]
    esize = torch.empty((), dtype=dtype).element_size()
    per = {"quant": esize + 1, "res_amax": 3 * esize, "res_amax_q": 3 * esize + 1}[mode]
    return n * per + 4 * c * esize


def k2_bound(shape, dtype, mode: str) -> tuple[float, str]:
    """Least time for K2: read x (and the residual) once, write each output
    once (int8: 1 byte an element, amax and the (C,) planes negligible
    but counted); or its f32 operations (statistics 3, normalise + affine
    4, GELU 8, residual and amax 2, quantise 3 per element) at the f32
    peak, whichever is larger."""
    import torch
    n, c = math.prod(shape), shape[1]
    esize = torch.empty((), dtype=dtype).element_size()
    ops = {"quant": 18, "res_amax": 17, "res_amax_q": 20}[mode]
    t_bytes = k2_bytes(shape, dtype, mode) / HBM_BYTES_PER_S * 1e3
    t_ops = n * ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels_k2() -> dict:
    """K2's three modes at the turbo decode's level 0 (16, 256, 65536) and
    level 2 (16, 512, 16384) in bf16, each against its twin and timed beside
    the twin, the library chain and the bound; then the int8 conv against
    the bf16 cuDNN conv at level 0. Returns the level-0 row of each mode."""
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.models import blocks
    from audio_algebra_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    rows = []
    for shape in [(16, 256, 65536), (16, 512, 16384)]:
        g = torch.Generator(device=dev).manual_seed(300 + len(rows))
        c = shape[1]
        dt = torch.bfloat16
        x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.2).to(dt)
        res = (torch.randn(shape, generator=g, device=dev) * 2.0).to(dt)
        scale = (torch.rand(c, generator=g, device=dev) + 0.5).to(dt)
        bias = (torch.rand(c, generator=g, device=dev) - 0.5).to(dt)
        grid = torch.rand(c, generator=g, device=dev) * 0.06 + 0.02
        for mode in ("quant", "res_amax", "res_amax_q"):
            q = grid if mode == "res_amax_q" else None
            if mode == "quant":
                def kernel():
                    return gn.groupnorm1_gelu_quant(x, scale, bias, grid)

                def plain():
                    return gn.groupnorm1_gelu_quant_ref(x, scale, bias, grid)
            else:
                def kernel():
                    return gn.groupnorm1_gelu_res_amax(x, scale, bias, res, q_emit_scale=q)

                def plain():
                    return gn.groupnorm1_gelu_res_amax_ref(x, scale, bias, res, q_emit_scale=q)

            def library():
                y = F.gelu(F.group_norm(x, 1, scale, bias, 1e-6), approximate="tanh")
                if mode == "quant":
                    return torch.clamp(torch.round(y.float() / grid[:, None]), -127,
                                       127).to(torch.int8)
                out = res.float() + y.float()
                amax = out.abs().amax(dim=(0, 2))
                if q is None:
                    return out.to(dt), amax
                return out.to(dt), amax, torch.clamp(torch.round(out / q[:, None]), -127,
                                                      127).to(torch.int8)

            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            row = {"shape": list(shape), "dtype": "bfloat16", "mode": mode}
            errs, bad = [], 0
            for a, b in zip(got, want):
                if a.dtype == torch.int8:
                    d = (a.int() - b.int()).abs()
                    row["int8_max_lsb"] = int(d.max())
                    row["int8_share_off"] = float((d > 0).float().mean())
                    bad += int(d.max() > 1 or row["int8_share_off"] > 1e-3)
                    errs.append(float(d.max()))
                elif a.dim() == 1:
                    row["amax_max_rel_err"] = float(((a - b).abs() / b.abs().clamp_min(1e-12)).max())
                    bad += int(row["amax_max_rel_err"] > 1e-5)
                else:
                    cmp = _compare(a, b, dt)
                    row["out_max_abs_err"] = cmp["max_abs_err"]
                    bad += cmp["n_outside_tol"]
                    errs.append(cmp["max_abs_err"])
            row["max_abs_err"] = max(errs)
            row["n_outside_tol"] = bad
            del got, want
            big = shape[2] > 16384
            bound_ms, bound_by = k2_bound(shape, dt, mode)
            kernel_ms = cuda_ms(kernel, 20)
            row.update({"kernel_ms": kernel_ms,
                        "kernel_tb_s": k2_bytes(shape, dt, mode) / kernel_ms / 1e9,
                        "plain_ms": cuda_ms(plain, 3 if big else 10, warmup=1),
                        "library_ms": cuda_ms(library, 3 if big else 10, warmup=1),
                        "bound_ms": bound_ms, "bound_by": bound_by})
            rows.append(row)
            torch.cuda.empty_cache()
        del x, res

    # the int8 conv of a turbo block at level 0 against the bf16 conv
    g = torch.Generator(device=dev).manual_seed(310)
    b, c, t = 16, 256, 65536
    x = torch.randn((b, c, t), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((c, c, 5), generator=g, device=dev) / math.sqrt(5 * c)).to(torch.bfloat16)
    bias = (torch.randn(c, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    x8, s_x = blocks.quantize_act(x, x.float().abs().amax(dim=(0, 2)))
    w8 = torch.randint(-127, 128, (c, c, 5), generator=g, device=dev, dtype=torch.int8)
    cols = torch.randint(-127, 128, (b * t, 5 * c), generator=g, device=dev, dtype=torch.int8)
    wmat = w8.permute(0, 2, 1).reshape(c, 5 * c)
    conv = {"shape": [b, c, t], "c_out": c, "kernel_size": 5,
            "int8_conv_ms": cuda_ms(lambda: blocks.conv1d_int8(x8, s_x, w, bias,
                                                               torch.bfloat16), 10),
            "int8_acc_ms": cuda_ms(lambda: blocks._int8_conv_acc(x8, w8), 10),
            "int8_product_ms": cuda_ms(lambda: torch._int_mm(wmat, cols.t()), 10),
            "bf16_cudnn_conv_ms": cuda_ms(lambda: blocks.conv1d(x, w, bias), 10),
            "int8_bound_ms": 2 * b * t * c * c * 5 / INT8_OPS_PER_S * 1e3,
            "bf16_bound_ms": 2 * b * t * c * c * 5 / BF16_TC_OPS_PER_S * 1e3}
    del x, x8, cols
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "groupnorm1_turbo", "cases": rows, "int8_conv": conv})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K2 disagrees with its twin: {failed}")
    return {r["mode"]: r for r in rows if r["shape"] == [16, 256, 65536]}


def phase_destructo_turbo() -> dict:
    """Destructo at B = 16 x 65536, bf16, 35 steps, through the user's
    entry points: one wrapper encodes, then decodes the negated latents
    from the same noise in bf16 and through the turbo int8 route (after a
    2-step warm-up of each). Returns the turbo decode's launch counts."""
    import numpy as np
    import torch
    from audio_algebra_torch.destructo import mathemangle
    from audio_algebra_torch.given_models import DVAEWrapper
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.utils.audio_io import batch_it_crazy, load_audio, write_wav

    chunk, sr_in = CHUNK, 44100
    n_in = int((TURBO_B - 0.25) * chunk * sr_in / 48000)
    tt = np.arange(n_in) / sr_in
    rng = np.random.default_rng(3)
    signal = np.stack([0.3 * np.sin(2 * np.pi * 220 * tt), 0.3 * np.sin(2 * np.pi * 277 * tt)])
    signal = (signal + 0.05 * rng.standard_normal(signal.shape)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "in.wav"
        write_wav(path, signal, sr_in)
        batch = batch_it_crazy(load_audio(path, sr=48000), chunk, max_batch_size=TURBO_B)
    w = DVAEWrapper(args_dict={"sample_size": chunk, "demo_steps": STEPS},
                    device="cuda", dtype=torch.bfloat16, turbo=True)
    w.ensure_params()
    torch.cuda.synchronize()
    t0 = time.time()
    z = mathemangle(w.encode(batch), "destructo")
    torch.cuda.synchronize()
    enc_s = time.time() - t0

    def counts():
        return {"k1": gn.launches, "k2a": gn.quant_launches, "k2b": gn.amax_launches,
                "k2c": gn.amax_q_launches}

    def decode(turbo: bool, steps: int):
        w.turbo = turbo
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.time()
        out = w.decode(z, demo_steps=steps)
        torch.cuda.synchronize()
        return out, time.time() - start, torch.cuda.max_memory_allocated() / 1e9

    decode(False, 2)                                  # warm-ups: plans, allocator
    decode(True, 2)
    out_bf16, bf16_s, bf16_mem = decode(False, STEPS)
    gn.launches = gn.quant_launches = gn.amax_launches = gn.amax_q_launches = 0
    out_turbo, turbo_s, turbo_mem = decode(True, STEPS)
    launches = counts()
    expected = {k: TURBO_STEP0[k] + (STEPS - 1) * TURBO_STEP[k] for k in TURBO_STEP}
    audio_s = batch.shape[0] * chunk / 48000
    err = rel_rms(out_turbo.float(), out_bf16.float())
    finite = bool(torch.isfinite(out_turbo).all() and torch.isfinite(out_bf16).all())
    emit({"phase": "destructo_turbo", "batch": list(batch.shape), "steps": STEPS,
          "dtype": "bfloat16", "out_shape": list(out_turbo.shape), "finite": finite,
          "encode_s": enc_s,
          "bf16": {"decode_s": bf16_s, "ms_per_step": bf16_s / STEPS * 1e3,
                   "realtime_factor": audio_s / (enc_s + bf16_s),
                   "decode_realtime_factor": audio_s / bf16_s, "peak_mem_gb": bf16_mem},
          "turbo": {"decode_s": turbo_s, "ms_per_step": turbo_s / STEPS * 1e3,
                    "realtime_factor": audio_s / (enc_s + turbo_s),
                    "decode_realtime_factor": audio_s / turbo_s, "peak_mem_gb": turbo_mem},
          "turbo_over_bf16_time": turbo_s / bf16_s,
          "rel_rms_turbo_vs_bf16": err, "bound": TURBO_REL_RMS_BOUND,
          "launches": launches, "launches_expected": expected})
    if tuple(out_turbo.shape) != (2, TURBO_B * chunk) or batch.shape[0] != TURBO_B \
            or not finite:
        raise AssertionError(f"turbo output {tuple(out_turbo.shape)} finite={finite}")
    if not err < TURBO_REL_RMS_BOUND:
        raise AssertionError(f"turbo vs bf16 decode rel-RMS {err} >= {TURBO_REL_RMS_BOUND}")
    if launches != expected:
        raise AssertionError(f"turbo decode launches {launches}, expected {expected}")
    return launches


def phase_mirage_model() -> None:
    """One full-width MIRAGE UNetCFG1d forward (the songs config, CFG
    scale 4 over a doubled batch, T = 2048) through K3 and K5 and through
    their twins with the same weights, in f32 and in bf16. The bf16 twin
    against the f32 twin gives the size of bf16 rounding itself."""
    import torch
    from audio_algebra_torch.models import blocks, unet_cfg1d
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.utils.params import random_init_

    dev = torch.device("cuda")
    t_len = MIRAGE_SAMPLES // 512
    unet = random_init_(unet_cfg1d.UNetCFG1d(), 0).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((1, 32, t_len), generator=g, device=dev)
    t = torch.rand((1,), generator=g, device=dev)
    emb = torch.randn((1, 1, 512), generator=g, device=dev)
    emb = emb / emb.norm()
    out, calls, fwd_ms = {}, {}, {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            unet.to(dt)
            rb = unet_cfg1d.precompute_rel_biases(unet, t_len)
            kw = dict(embedding=emb.to(dt), embedding_scale=4.0, rel_biases=rb)
            args = (x.to(dt), t.to(dt))
            before = (fa.launches, ggn.launches)
            out["kernel", dt] = unet(*args, **kw).float()
            calls[str(dt).removeprefix("torch.")] = [fa.launches - before[0],
                                                     ggn.launches - before[1]]
            fwd_ms[str(dt).removeprefix("torch.")] = cuda_ms(lambda: unet(*args, **kw), 5)
            unet_cfg1d.flash_attention_relpos = fa.flash_attention_relpos_ref
            blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu_ref
            try:
                out["plain", dt] = unet(*args, **kw).float()
            finally:
                unet_cfg1d.flash_attention_relpos = fa.flash_attention_relpos
                blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"float32": rel_rms(out["kernel", f32], out["plain", f32]),
            "bfloat16": rel_rms(out["kernel", bf16], out["plain", bf16])}
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    emit({"phase": "mirage_model", "shape": [1, 32, t_len], "cfg_scale": 4.0,
          "k3_k5_launches": calls, "forward_ms": fwd_ms,
          "rel_rms_kernel_vs_plain": errs, "bound": MIRAGE_REL_RMS_BOUND,
          "rel_rms_plain_bf16_vs_f32": rel_rms(out["plain", bf16], out["plain", f32]),
          "finite": finite})
    if any(c != [K3_PER_INNER, K5_PER_INNER] for c in calls.values()):
        raise AssertionError(f"UNetCFG1d forward launched (K3, K5) {calls} times")
    if not finite or any(errs[k] >= MIRAGE_REL_RMS_BOUND[k] for k in errs):
        raise AssertionError(f"UNetCFG1d through K3/K5 vs plain: rel-RMS {errs}")


def phase_mirage():
    """Full-width 22 s MIRAGE generate in bf16 with seeded random weights,
    run twice (the second is the steady state). Returns the model (warm,
    for the serve phase) and the first run's launch counts."""
    import numpy as np
    import torch
    from audio_algebra_torch.embedding_math import weighted_algebra
    from audio_algebra_torch.given_models import CLAPDAE
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.ops import groupnorm_grouped as ggn

    t0 = time.time()
    model = CLAPDAE(device="cuda", seed=0).setup(model_len="22s").half()
    init_s = time.time() - t0
    rng = np.random.default_rng(0)
    a, b = (v / np.linalg.norm(v) for v in rng.standard_normal((2, 1, 1, 512)).astype("f4"))
    emb = weighted_algebra([a, b], [1.0, -0.5])

    def run():
        torch.cuda.synchronize()
        start = time.perf_counter()
        fakes, lat = model.generate(emb, cfg_scales=4, demo_steps=INNER_STEPS,
                                    outer_steps=OUTER_STEPS, batch_size=1, stage_times=True)
        torch.cuda.synchronize()
        return fakes, lat, time.perf_counter() - start, dict(model.last_stage_times)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = ggn.launches = gn.launches = 0
    fakes, lat, first_s, first_stages = run()
    counts = {"k3": fa.launches, "k5": ggn.launches, "k1": gn.launches}
    _, _, gen_s, stages = run()
    expected = {"k3": INNER_STEPS * K3_PER_INNER, "k5": INNER_STEPS * K5_PER_INNER,
                "k1": OUTER_STEPS * K1_PER_OUTER}
    finite = bool(torch.isfinite(fakes).all())
    in_range = bool((lat.abs() <= 1).all())
    emit({"phase": "mirage", "samples": MIRAGE_SAMPLES, "batch": 1, "cfg_scale": 4,
          "inner_steps": INNER_STEPS, "outer_steps": OUTER_STEPS, "dtype": "bfloat16",
          "init_s": init_s, "first_generate_s": first_s, "first_stages_s": first_stages,
          "inner_s": stages["inner_s"], "outer_s": stages["outer_s"],
          "ae_decode_s": stages["decode_s"], "generate_s": gen_s,
          "inner_ms_per_step": stages["inner_s"] / INNER_STEPS * 1e3,
          "outer_ms_per_step": stages["outer_s"] / OUTER_STEPS * 1e3,
          "realtime_factor": MIRAGE_SAMPLES / 48000 / gen_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "out_shape": list(fakes.shape), "finite": finite, "latents_in_range": in_range,
          "launches": counts, "launches_expected": expected})
    if tuple(fakes.shape) != (2, MIRAGE_SAMPLES) or not finite or not in_range:
        raise AssertionError(f"mirage output {tuple(fakes.shape)} finite={finite} "
                             f"latents in range={in_range}")
    if counts != expected:
        raise AssertionError(f"mirage launches {counts}, expected {expected}")
    return model, counts


def stft_bounds(rows: int, t_len: int, n_fft: int, n_frames: int) -> dict:
    """Least time for the STFT: read the signal once and write the complex64
    output once, or an FFT's ~5 (n_fft / 2) log2(n_fft / 2) f32 operations a
    frame at the f32 peak, whichever is larger; and beside it, under its own
    name, the DFT product's 4 n_fft n_bins operations a frame at that peak
    (what the DFT route does)."""
    n_bins = n_fft // 2 + 1
    t_bytes = (rows * t_len * 4 + rows * n_bins * n_frames * 8) / HBM_BYTES_PER_S * 1e3
    half = n_fft // 2
    t_fft = 5 * half * math.log2(half) * rows * n_frames / F32_OPS_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_fft else (t_fft, "operations")
    return {"bound_ms": bound[0], "bound_by": bound[1],
            "dft_operations_ms": 4 * n_fft * n_bins * rows * n_frames / F32_OPS_PER_S * 1e3}


def phase_kernels_k6() -> dict:
    """K6 on both routes, each against its twin and float64 and timed beside
    the twin, torch.stft and the bounds: the FFT at the spectrogram models'
    shape and at CLAP's 22 s clip, the DFT product at a non-power-of-two
    n_fft. Returns the rows by route, the first of each."""
    import torch
    from audio_algebra_torch.ops import stft_kernel as stk

    dev = torch.device("cuda")
    rows = []
    for shape, n_fft, hop in [((32, 65536), 1024, 256), ((1, CLAP_LONG), 1024, 480),
                              ((32, 65536), 1000, 250)]:
        g = torch.Generator(device=dev).manual_seed(400 + len(rows))
        x = torch.randn(shape, generator=g, device=dev) * 0.5
        route = "fft" if stk.uses_fft(n_fft) else "dft"
        before = (stk.fft_launches, stk.dft_launches)
        got = stk.stft_fused(x, n_fft, hop)
        torch.cuda.synchronize()
        took = {"fft": stk.fft_launches - before[0], "dft": stk.dft_launches - before[1]}
        want = stk.stft_ref(x, n_fft, hop)
        atol, rtol = STFT_TOL
        err = (got - want).abs()
        window = torch.hann_window(n_fft, device=dev)
        # both against the same STFT in float64: how far each is from exact
        exact = torch.stft(x.double(), n_fft, hop, window=window.double(), center=True,
                           pad_mode="reflect", return_complex=True)
        rows.append({
            "route": route, "route_launches": took,
            "shape": list(shape), "n_fft": n_fft, "hop": hop, "dtype": "float32",
            "out_shape": list(got.shape), "max_abs_err": float(err.max()), "atol": atol,
            "rtol": rtol, "n_outside_tol": int((err > atol + rtol * want.abs()).sum()),
            "kernel_max_abs_err_vs_f64": float((got - exact).abs().max()),
            "plain_max_abs_err_vs_f64": float((want - exact).abs().max()),
            "kernel_ms": cuda_ms(lambda: stk.stft_fused(x, n_fft, hop), 20),
            "plain_ms": cuda_ms(lambda: stk.stft_ref(x, n_fft, hop), 20),
            "library_ms": cuda_ms(lambda: torch.stft(
                x, n_fft, hop, window=window, center=True, pad_mode="reflect",
                return_complex=True), 20),
            "kernel_device_ms": device_ms(lambda: stk.stft_fused(x, n_fft, hop), 20),
            "library_device_ms": device_ms(lambda: torch.stft(
                x, n_fft, hop, window=window, center=True, pad_mode="reflect",
                return_complex=True), 20),
            **stft_bounds(shape[0], shape[1], n_fft, got.shape[-1])})
        del x, got, want, err, exact
    emit({"phase": "kernels", "kernel": "stft", "cases": rows})
    failed = [r for r in rows if r["n_outside_tol"] or r["route_launches"] != {
        k: int(k == r["route"]) for k in ("fft", "dft")}]
    if failed:
        raise AssertionError(f"K6 disagrees with its twin or took the wrong route: {failed}")
    # the FFT rounds like log n_fft, the DFT product like sqrt(n_fft)
    farther = [r for r in rows if r["route"] == "fft"
               and r["kernel_max_abs_err_vs_f64"] > r["plain_max_abs_err_vs_f64"]]
    if farther:
        raise AssertionError(f"K6's FFT is farther from float64 than its twin: {farther}")
    return {route: next(r for r in rows if r["route"] == route) for route in ("fft", "dft")}


def _synced_s(fn):
    import torch
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def _with_twin_stft(fn):
    """Run fn with the port's stft routed through K6's plain twin."""
    from audio_algebra_torch.ops import stft_kernel as stk
    kernel = stk.stft_fused
    stk.stft_fused = stk.stft_ref
    try:
        return fn()
    finally:
        stk.stft_fused = kernel


def phase_spectrogram() -> int:
    """The four spectrogram given models at full size through their entry
    points, K6's launches counted over the run; then, outside the count,
    the Mag and Mel decodes again through the twin. Returns the count."""
    import numpy as np
    import torch
    from audio_algebra_torch import given_models as gm
    from audio_algebra_torch.ops import stft_kernel as stk

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    t = np.arange(SPEC_SHAPE[-1]) / 48000
    tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000, (SPEC_SHAPE[0], 2, 1)) * t)
    clip = (tone + 0.05 * rng.standard_normal(SPEC_SHAPE)).astype(np.float32)
    models = {"SpectrogramAE": gm.SpectrogramAE(device="cuda"),
              "MagSpectrogramAE": gm.MagSpectrogramAE(device="cuda", n_iter=SPEC_ITERS),
              "MelSpectrogramAE": gm.MelSpectrogramAE(device="cuda", n_iter=SPEC_ITERS),
              "MagDPhaseSpectrogramAE": gm.MagDPhaseSpectrogramAE(device="cuda")}
    x = torch.from_numpy(clip).to(dev)
    angles = torch.rand((*SPEC_SHAPE[:2], 513, SPEC_SHAPE[-1] // 256 + 1),
                        generator=torch.Generator(device=dev).manual_seed(6),
                        device=dev) * (2 * math.pi)
    for name, m in models.items():                          # warm-up: first-use loads
        kw = {"init_angle": angles[:1]} if name in ("MagSpectrogramAE",
                                                    "MelSpectrogramAE") else {}
        m.decode(m.encode(x[:1]), **kw)
    rows, reps, outs = {}, {}, {}
    stk.launches = stk.fft_launches = 0
    for name, m in models.items():
        reps[name], enc_s = _synced_s(lambda: m.encode(x))
        kw = {"init_angle": angles} if name in ("MagSpectrogramAE", "MelSpectrogramAE") else {}
        outs[name], dec_s = _synced_s(lambda: m.decode(reps[name], **kw))
        rows[name] = {"encode_ms": enc_s * 1e3, "decode_ms": dec_s * 1e3,
                      "reps_shape": list(reps[name].shape), "out_shape": list(outs[name].shape)}
    launches, fft_launches = stk.launches, stk.fft_launches

    def rel_mse(a):
        return float((a - x).square().mean() / x.square().mean())

    ref_mag = stk.stft_ref(x, 1024, 256).abs()
    for name, out in outs.items():
        sc = (stk.stft_ref(out, 1024, 256).abs() - ref_mag).norm() / ref_mag.norm()
        rows[name].update({"spectral_convergence": float(sc), "rel_mse": rel_mse(out),
                           "finite": bool(torch.isfinite(out).all())})
    for name in ("MagSpectrogramAE", "MelSpectrogramAE"):
        m = models[name]
        twin = _with_twin_stft(lambda: m.decode(reps[name], init_angle=angles))
        nudge = 1 + 1e-6 * torch.randn(reps[name].shape, device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(7))
        spread = _with_twin_stft(lambda: m.decode(reps[name] * nudge, init_angle=angles))
        rows[name].update({"rel_rms_kernel_vs_twin": rel_rms(outs[name], twin),
                           "twin_spread_1e-6": rel_rms(spread, twin)})
    emit({"phase": "spectrogram", "shape": list(SPEC_SHAPE), "n_fft": 1024, "hop": 256,
          "n_iter": SPEC_ITERS, "models": rows, "round_trip_bounds": ROUND_TRIP,
          "gl_rel_rms_bound": GL_REL_RMS, "k6_launches": launches,
          "k6_expected": K6_SPECTROGRAM})
    for name, r in rows.items():
        if r["out_shape"] != list(SPEC_SHAPE) or not r["finite"]:
            raise AssertionError(f"{name} decoded {r}")
    for name, bound in ROUND_TRIP.items():
        if not rows[name]["rel_mse"] < bound:
            raise AssertionError(f"{name} round trip rel MSE {rows[name]['rel_mse']}")
    for name in ("MagSpectrogramAE", "MelSpectrogramAE"):
        r = rows[name]
        if not r["rel_rms_kernel_vs_twin"] < max(GL_REL_RMS, r["twin_spread_1e-6"]):
            raise AssertionError(f"{name} through K6 vs twin: {r}")
    if launches != K6_SPECTROGRAM or fft_launches != launches:
        raise AssertionError(f"K6 launched {launches} times ({fft_launches} on the FFT "
                             f"route), expected {K6_SPECTROGRAM}, all FFT")
    return launches


def phase_clap(model) -> int:
    """CLAP at full width through CLAPDAE.embed: two clips and two texts;
    the clips again through K6's twin, outside the count. Returns K6's
    launches."""
    import numpy as np
    import torch
    from audio_algebra_torch.ops import stft_kernel as stk

    clap = model.clap_module
    t0 = time.perf_counter()
    clap.ensure_params()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(8)
    clips = {}
    for name, n in (("short_5s", CLAP_SHORT), ("fusion_22s", CLAP_LONG)):
        t = np.arange(n) / 48000
        clips[name] = (np.stack([0.3 * np.sin(2 * np.pi * 220 * t),
                                 0.3 * np.sin(2 * np.pi * 331 * t)])
                       + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
    texts = ["low brass ensemble", "a bright piano arpeggio"]
    for prompt in [*clips.values(), texts[0]]:              # warm-up: cuDNN plans
        model.embed(prompt)
    embs, ms = {}, {}
    stk.launches = 0
    for name, prompt in [*clips.items(), *zip(("text_0", "text_1"), texts)]:
        embs[name], sec = _synced_s(lambda: model.embed(prompt))
        ms[name] = sec * 1e3
    launches = stk.launches
    twin = {name: _with_twin_stft(lambda: model.embed(clips[name])) for name in clips}
    norms = {k: float(torch.linalg.vector_norm(e)) for k, e in embs.items()}
    rel = {k: float((embs[k] - twin[k]).abs().max() / twin[k].abs().max()) for k in clips}
    result = {"phase": "clap", "audio": "HTSAT-base fusion", "text": "RoBERTa-base",
              "dtype": "float32", "init_s": init_s, "embed_ms": ms,
              "shapes": {k: list(e.shape) for k, e in embs.items()}, "norms": norms,
              "finite": all(bool(torch.isfinite(e).all()) for e in embs.values()),
              "rel_diff_kernel_vs_twin": rel, "bound": CLAP_REL,
              "text_tokenizer": clap.tokenizer_backend()[0],
              "k6_launches": launches, "k6_expected": len(clips)}
    emit(result)
    if any(v != [1, 1, 512] for v in result["shapes"].values()) or not result["finite"] \
            or any(abs(v - 1.0) > 1e-4 for v in norms.values()):
        raise AssertionError(f"CLAP embeddings {result}")
    if any(not v < CLAP_REL for v in rel.values()):
        raise AssertionError(f"CLAP audio embeddings through K6 vs twin: {rel}")
    if launches != len(clips):
        raise AssertionError(f"K6 launched {launches} times over {len(clips)} clips")
    return launches


def phase_serve(model) -> int:
    """The HTTP service in-process on localhost, around the warm model; a
    second service over the same model in strict-text mode. Returns K6's
    launches over the requests."""
    import io
    import threading
    import urllib.error
    import urllib.request
    import wave

    import numpy as np
    from audio_algebra_torch import serve
    from audio_algebra_torch.ops import stft_kernel as stk

    def start(svc):
        server = serve.make_server(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, thread, f"http://127.0.0.1:{server.server_address[1]}"

    def post(base, path, body, ctype="application/json", timeout=600):
        data = json.dumps(body).encode() if ctype == "application/json" else body
        req = urllib.request.Request(f"{base}{path}", data=data,
                                     headers={"Content-Type": ctype})
        return urllib.request.urlopen(req, timeout=timeout)

    rng = np.random.default_rng(1)
    embs = [(v / np.linalg.norm(v)).tolist() for v in rng.standard_normal((2, 512))]
    specs = {"slerp": {"embeddings": embs, "interp": 0.3, "steps": 8, "outer_steps": 4,
                       "seed": 1},
             "algebra": {"embeddings": embs, "algebra": True, "weights": [1.0, -0.5],
                         "steps": 8, "outer_steps": 4, "seed": 2},
             "text": {"text": ["low brass"], "steps": 8, "outer_steps": 4, "seed": 3}}
    clip = io.BytesIO()
    t = np.arange(3 * 48000) / 48000
    with wave.open(clip, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(48000)
        pcm = (np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)]) * 9000)
        w.writeframes(pcm.T.astype("<i2").tobytes())
    result = {"phase": "serve", "requests": {}}
    servers = []
    try:
        server, thread, base = start(serve.MirageService(model=model, verbose=False))
        servers.append((server, thread))
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            result["health"] = json.loads(r.read())
        stk.launches = 0
        for name, spec in specs.items():
            start_s = time.perf_counter()
            with post(base, "/generate", spec) as r:
                status, ctype, body = r.status, r.headers["Content-Type"], r.read()
                info = json.loads(r.headers["X-Generate-Info"])
            with wave.open(io.BytesIO(body)) as w:
                fmt = [w.getnchannels(), w.getframerate(), w.getnframes()]
                pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
            result["requests"][name] = {
                "status": status, "content_type": ctype, "wav": fmt,
                "tokenizer_warning": "tokenizer_warning" in info,
                "seconds": time.perf_counter() - start_s, "rms": float(np.sqrt(
                    np.mean((pcm / 32767.0) ** 2)))}
        for name, body, ctype in (("embed_text", {"text": "low brass"}, "application/json"),
                                  ("embed_wav", clip.getvalue(), "audio/wav")):
            start_s = time.perf_counter()
            with post(base, "/embed", body, ctype) as r:
                answer = json.loads(r.read())
            emb = np.asarray(answer["embedding"], np.float64)
            result["requests"][name] = {
                "status": r.status, "floats": int(emb.size), "norm": float(np.linalg.norm(emb)),
                "tokenizer_warning": "tokenizer_warning" in answer,
                "seconds": time.perf_counter() - start_s}
        launches = stk.launches
        server, thread, base = start(serve.MirageService(model=model, verbose=False,
                                                         strict_text=True))
        servers.append((server, thread))
        try:
            post(base, "/generate", specs["text"], timeout=60)
            result["strict_text"] = None
        except urllib.error.HTTPError as e:
            result["strict_text"] = {"code": e.code, "error": json.loads(e.read())["error"]}
    finally:
        for server, thread in servers:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
    result["k6_launches"] = launches
    emit(result)
    if not result["health"].get("ok"):
        raise AssertionError(f"/health answered {result['health']}")
    for name in specs:
        r = result["requests"][name]
        if r["status"] != 200 or r["content_type"] != "audio/wav" \
                or r["wav"] != [2, 48000, MIRAGE_SAMPLES]:
            raise AssertionError(f"/generate ({name}) answered {r}")
    fallback = result["health"]["text_tokenizer"] == "byte-fallback"
    if result["requests"]["text"]["tokenizer_warning"] != fallback:
        raise AssertionError(f"text prompt's tokenizer warning: {result['requests']['text']}")
    for name, warned in (("embed_text", fallback), ("embed_wav", False)):
        r = result["requests"][name]
        if r["status"] != 200 or r["floats"] != 512 or abs(r["norm"] - 1) > 1e-4 \
                or r["tokenizer_warning"] != warned:
            raise AssertionError(f"/embed ({name}) answered {r}")
    if fallback and result["strict_text"] != {"code": 409,
                                              "error": "text_tokenizer_unavailable"}:
        raise AssertionError(f"strict-text service answered {result['strict_text']}")
    if launches != 1:
        raise AssertionError(f"the requests launched K6 {launches} times, expected 1 "
                             "(the WAV posted to /embed)")
    if any(thread.is_alive() for _, thread in servers):
        raise AssertionError("a server thread did not stop")
    return launches


def k4_bounds(shape, dtype, bias_dtype) -> dict:
    """Least times for K4a, K4b and K4c: each input read once and each
    output written once, or the products' operations (2, 4 and 3 products
    of 2 B H T^2 D operations) at the peak of q's type, whichever is
    larger. Inputs of the backward kernels: q, k, v, do, biasT and the
    three (H, B, T) f32 rows; K4c returns dq and dbT, which is like biasT.
    In f32, K4b and K4c run their products as 3xTF32 on the tensor cores:
    their bounds are three TF32 passes of each product at the dense TF32
    peak ("k4b", "k4c"), and the f32 CUDA-core bounds stand beside them as
    "k4b_f32_cuda_cores" and "k4c_f32_cuda_cores"."""
    import torch
    b, h, t, d = shape
    e = torch.empty((), dtype=dtype).element_size()
    eb = torch.empty((), dtype=bias_dtype).element_size()
    qkv, bias, row = b * h * t * d * e, h * t * t * eb, h * b * t * 4
    peak = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    product = 2 * b * h * t * t * d
    out = {}
    for name, nbytes, n_products in (("k4a", 4 * qkv + bias + 2 * row, 2),
                                     ("k4b", 6 * qkv + bias + 3 * row, 4),
                                     ("k4c", 5 * qkv + 2 * bias + 3 * row, 3)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_products * product / peak * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        if dtype == torch.float32 and name != "k4a":
            out[f"{name}_f32_cuda_cores"] = out[name]
            t_tf32 = 3 * n_products * product / TF32_TC_OPS_PER_S * 1e3
            out[name] = (t_bytes, "bytes") if t_bytes >= t_tf32 else (t_tf32, "operations")
    return out


def phase_kernels_k4() -> dict:
    """K4a, K4b and K4c at the trainer's flash sites and beside them, each
    against its twin and timed beside the twin, SDPA and its bound; then the
    autograd Functions around K1 and K5. Returns the rows of the
    (8, 16, 1024, 64) f32 case, one per kernel."""
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.ops import groupnorm_grouped as ggn

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((8, 16, 1024, 64), f32), ((8, 16, 512, 64), f32), ((8, 16, 1024, 64), bf16),
             ((8, 16, 512, 64), bf16), ((16, 16, 1024, 64), bf16), ((1, 16, 1024, 64), f32)]
    rows = []
    for shape, dt in cases:
        g = torch.Generator(device=dev).manual_seed(500 + len(rows))
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dt) for _ in range(4))
        h, t = shape[1], shape[2]
        bias_t = (torch.randn((h, t, t), generator=g, device=dev) * 0.5).to(dt)
        scale = shape[3] ** -0.5
        name = str(dt).removeprefix("torch.")
        atol, rtol = K4_TOL[name]

        def compare(got, want):
            err = (got.float() - want.float()).abs()
            return float(err.max()), int((err > atol + rtol * want.float().abs()).sum())

        o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, scale)
        delta = fa.flash_delta(o, do)
        dk, dv = fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m, delta, scale)
        dq, db = fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m, delta, scale)
        torch.cuda.synchronize()
        o_ref, l_ref, m_ref = fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, scale)
        # the twin of the backward from the kernel's own residuals
        dq_ref, dk_ref, dv_ref, db_ref = fa.flash_attention_relpos_bwd_ref(
            q, k, v, bias_t, o, l, m, do, scale)
        # l is a sum of T f32 terms of exp: relative; m a max of scores: absolute
        resid = {"l_max_rel_err": float(((l - l_ref).abs() / l_ref).max()),
                 "m_max_abs_err": float((m - m_ref).abs().max())}
        def both(a, b):
            return max(a[0], b[0]), a[1] + b[1]

        errs = {"k4a": compare(o, o_ref),
                "k4b": both(compare(dk, dk_ref), compare(dv, dv_ref)),
                "k4c": both(compare(dq, dq_ref), compare(db, db_ref))}
        bad_resid = int(resid["l_max_rel_err"] > 1e-3) + int(resid["m_max_abs_err"] > 1e-3)
        del o_ref, l_ref, m_ref, dq_ref, dk_ref, dv_ref, db_ref, dk, dv, dq, db
        torch.cuda.empty_cache()

        mask = bias_t.transpose(1, 2)[None].to(dt)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, mask)]
        o_lib = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=scale)

        def sdpa_backward():
            return torch.autograd.grad(o_lib, leaves, do, retain_graph=True)

        big = shape[0] * t >= 8192
        times = {
            "k4a": (cuda_ms(lambda: fa.flash_attention_relpos_fwd(q, k, v, bias_t, scale), 10),
                    cuda_ms(lambda: fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, scale),
                            3 if big else 10, warmup=1),
                    cuda_ms(sdpa, 10)),
            "k4b": (cuda_ms(lambda: fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m,
                                                                  delta, scale), 10),),
            "k4c": (cuda_ms(lambda: fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m,
                                                                 delta, scale), 10),)}
        # the twin and SDPA compute dq, dk, dv and the bias gradient in one
        # backward: their time stands beside K4b and K4c together
        bwd_plain = cuda_ms(lambda: fa.flash_attention_relpos_bwd_ref(
            q, k, v, bias_t, o, l, m, do, scale), 3 if big else 10, warmup=1)
        bwd_library = cuda_ms(sdpa_backward, 10)
        bounds = k4_bounds(shape, dt, dt)
        for kern in ("k4a", "k4b", "k4c"):
            rows.append({
                "kernel": kern, "shape": list(shape), "dtype": name, "atol": atol, "rtol": rtol,
                "max_abs_err": errs[kern][0],
                "n_outside_tol": errs[kern][1] + (bad_resid if kern == "k4a" else 0),
                **(resid if kern == "k4a" else {}),
                "kernel_ms": times[kern][0],
                "plain_ms": times[kern][1] if kern == "k4a" else bwd_plain,
                "library_ms": times[kern][2] if kern == "k4a" else bwd_library,
                "plain_and_library_cover": "K4a" if kern == "k4a" else "K4b + K4c",
                "bound_ms": bounds[kern][0], "bound_by": bounds[kern][1],
                **({"bound_f32_cuda_cores_ms": bounds[f"{kern}_f32_cuda_cores"][0]}
                   if f"{kern}_f32_cuda_cores" in bounds else {})})
        del q, k, v, do, bias_t, mask, o, l, m, delta, leaves, o_lib
        torch.cuda.empty_cache()
    main = {r["kernel"]: r for r in rows
            if r["shape"] == [8, 16, 1024, 64] and r["dtype"] == "float32"}
    emit({"phase": "kernels", "kernel": "flash_attention_relpos_train", "cases": rows,
          "k4b_f32_under_sdpa_backward": main["k4b"]["kernel_ms"] <= main["k4b"]["library_ms"]})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K4 disagrees with its twin: {failed}")

    # K4b and K4c sum in a fixed order: two launches of each, the same bits
    same = {}
    for dt in (f32, bf16):
        g = torch.Generator(device=dev).manual_seed(530)
        q, k, v, do = (torch.randn((TRAIN_BATCH, 16, 1024, 64), generator=g,
                                   device=dev).to(dt) for _ in range(4))
        bias_t = (torch.randn((16, 1024, 1024), generator=g, device=dev) * 0.5).to(dt)
        o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
        delta = fa.flash_delta(o, do)
        for kern, fn in (("k4b", fa.flash_attention_relpos_dkv),
                         ("k4c", fa.flash_attention_relpos_dq)):
            first = fn(q, k, v, bias_t, do, l, m, delta, 0.125)
            second = fn(q, k, v, bias_t, do, l, m, delta, 0.125)
            same[f"{kern}_{str(dt).removeprefix('torch.')}"] = all(
                torch.equal(a, b) for a, b in zip(first, second))
            del first, second
        del q, k, v, do, bias_t, o, l, m, delta
    emit({"phase": "kernels", "kernel": "flash_attention_relpos_train_dkv_dq",
          "shape": [TRAIN_BATCH, 16, 1024, 64], "bitwise_equal_across_two_runs": same})
    if not all(same.values()):
        raise AssertionError(f"K4b or K4c gave other bits on a second run: {same}")

    # the Functions around K1 and K5: forward through the kernel, backward()
    # against autograd of the twin, relative to each gradient's peak
    grads = []
    g = torch.Generator(device=dev).manual_seed(520)
    x = (torch.randn((2, 256, 16384), generator=g, device=dev) * 1.5 + 0.2).requires_grad_()
    res = torch.randn((2, 256, 16384), generator=g, device=dev).requires_grad_()
    scale_p = (torch.rand(256, generator=g, device=dev) + 0.5).requires_grad_()
    bias_p = (torch.rand(256, generator=g, device=dev) - 0.5).requires_grad_()
    dout = torch.randn((2, 256, 16384), generator=g, device=dev)
    before = gn.launches
    y = gn.groupnorm1_gelu(x, scale_p, bias_p, True, res)
    got = torch.autograd.grad(y, (x, scale_p, bias_p, res), dout)
    want = torch.autograd.grad(gn.groupnorm1_gelu_ref(x, scale_p, bias_p, True, res),
                               (x, scale_p, bias_p, res), dout)
    grads.append({"kernel": "groupnorm1_gelu", "shape": [2, 256, 16384], "dtype": "float32",
                  "has_grad_fn": y.grad_fn is not None, "launches": gn.launches - before,
                  "rel_err": {n: float((a - b).abs().max() / b.abs().max())
                              for n, a, b in zip(("dx", "dscale", "dbias", "dres"), got, want)}})
    b, c, t = TRAIN_BATCH, 512, 2048
    x = (torch.randn((b, c, t), generator=g, device=dev) * 1.5 + 0.2).requires_grad_()
    scale_p = (torch.rand(c, generator=g, device=dev) + 0.5).requires_grad_()
    bias_p = (torch.rand(c, generator=g, device=dev) - 0.5).requires_grad_()
    ts = (torch.randn((b, 2 * c), generator=g, device=dev) * 0.3).requires_grad_()
    dout = torch.randn((b, c, t), generator=g, device=dev)
    fs, sh = ts.chunk(2, dim=1)
    before = ggn.launches
    y = ggn.grouped_gn_film_silu(x, scale_p, bias_p, 8, fs, sh)
    got = torch.autograd.grad(y, (x, scale_p, bias_p, ts), dout)
    want = torch.autograd.grad(ggn.grouped_gn_film_silu_ref(x, scale_p, bias_p, 8, fs, sh),
                               (x, scale_p, bias_p, ts), dout)
    grads.append({"kernel": "grouped_gn_film_silu", "shape": [b, c, t], "dtype": "float32",
                  "has_grad_fn": y.grad_fn is not None, "launches": ggn.launches - before,
                  "rel_err": {n: float((a - b).abs().max() / b.abs().max())
                              for n, a, b in zip(("dx", "dscale", "dbias", "dfilm"), got, want)}})
    emit({"phase": "kernels", "kernel": "autograd functions (K1, K5)", "bound": 1e-4,
          "cases": grads})
    for r in grads:
        if not r["has_grad_fn"] or r["launches"] != 1 \
                or any(not e < 1e-4 for e in r["rel_err"].values()):
            raise AssertionError(f"autograd through the kernel wrapper: {r}")
    return main


def _k4_k5_counts():
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.ops import stft_kernel as stk
    return {"k3": fa.launches, "k4a": fa.train_fwd_launches, "k4b": fa.dkv_launches,
            "k4c": fa.dq_launches, "k5": ggn.launches, "k6": stk.launches}


def _zero_train_counts():
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.ops import stft_kernel as stk
    fa.launches = fa.train_fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    ggn.launches = stk.launches = 0


def phase_train_model() -> None:
    """One training forward + backward of the full-width songs UNetCFG1d
    through the kernels and through their twins: the check that no kernel
    wrapper cuts the graph."""
    import torch
    from audio_algebra_torch.models import blocks, unet_cfg1d
    from audio_algebra_torch.models.stacked import v_objective_loss
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.utils.params import random_init_

    dev = torch.device("cuda")
    t_len = MIRAGE_SAMPLES // 512
    unet = random_init_(unet_cfg1d.UNetCFG1d(), 0).to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    latents = torch.tanh(torch.randn((TRAIN_BATCH, 32, t_len), generator=g, device=dev))
    noise = torch.randn((TRAIN_BATCH, 32, t_len), generator=g, device=dev)
    t = torch.rand((TRAIN_BATCH,), generator=g, device=dev)
    emb = torch.randn((TRAIN_BATCH, 1, 512), generator=g, device=dev)
    emb = emb / emb.norm(dim=-1, keepdim=True)
    keep = torch.tensor([True, False, True, True, True, False, True, True], device=dev)

    def run():
        unet.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        loss = v_objective_loss(unet, latents, emb, t, noise, keep=keep)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() if p.grad is not None else None
                 for n, p in unet.named_parameters()}
        return float(loss.detach()), grads, time.perf_counter() - start, \
            torch.cuda.max_memory_allocated() / 1e9

    run()                                               # warm-up: cuDNN plans
    _zero_train_counts()
    loss_k, grads_k, secs_k, mem_k = run()
    counts = _k4_k5_counts()
    unet_cfg1d.flash_attention_relpos_train = fa.flash_attention_relpos_train_ref
    blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu_ref
    try:
        loss_p, grads_p, secs_p, mem_p = run()
    finally:
        unet_cfg1d.flash_attention_relpos_train = fa.flash_attention_relpos_train
        blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu
    missing = [n for n, gk in grads_k.items() if gk is None]
    not_finite = [n for n, gk in grads_k.items() if gk is not None
                  and not bool(torch.isfinite(gk).all())]
    zero = [n for n, gk in grads_k.items() if gk is not None and not bool(gk.any())
            and bool(grads_p[n].any())]
    errs = {n: rel_rms(gk, grads_p[n]) for n, gk in grads_k.items() if gk is not None}
    worst = sorted(errs, key=errs.get, reverse=True)[:5]
    named = [n for n in errs if n.endswith("rel_pos_bias") or n == "fixed_embedding"]
    flash_tables = [n for n in named if re.search(r"attn[23]_", n)]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit({"phase": "train_model", "shape": [TRAIN_BATCH, 32, t_len], "dtype": "float32",
          "parameters": len(grads_k), "loss_kernels": loss_k, "loss_twins": loss_p,
          "loss_rel_diff": loss_rel, "loss_bound": TRAIN_LOSS_REL,
          "grad_rel_rms_max": max(errs.values()), "grad_rel_rms_bound": TRAIN_GRAD_REL_RMS,
          "grad_rel_rms_worst": {n: errs[n] for n in worst},
          "grad_rel_rms_named": {n: errs[n] for n in named},
          "grad_abs_max_named": {n: float(grads_k[n].abs().max()) for n in named},
          "missing": missing, "not_finite": not_finite, "zero_where_twin_is_not": zero,
          "launches": counts, "forward_backward_ms": {"kernels": secs_k * 1e3,
                                                      "twins": secs_p * 1e3},
          "peak_mem_gb": {"kernels": mem_k, "twins": mem_p}})
    if missing or not_finite or zero:
        raise AssertionError(f"gradients missing {missing}, not finite {not_finite}, "
                             f"zero where the twin's is not {zero}")
    if len(flash_tables) != K4_PER_STEP or "fixed_embedding" not in named \
            or any(not float(grads_k[n].abs().max()) > 0 for n in flash_tables +
                   ["fixed_embedding"]):
        raise AssertionError(f"the flash sites' bucket tables or the null embedding got no "
                             f"gradient: {named}")
    if not loss_rel < TRAIN_LOSS_REL or not max(errs.values()) < TRAIN_GRAD_REL_RMS:
        raise AssertionError(f"kernels vs twins: loss rel {loss_rel}, worst gradients "
                             f"{ {n: errs[n] for n in worst} }")
    want = {"k3": 0, "k4a": K4_PER_STEP, "k4b": K4_PER_STEP, "k4c": K4_PER_STEP,
            "k5": K5_PER_STEP, "k6": 0}
    if counts != want:
        raise AssertionError(f"training forward + backward launched {counts}, expected {want}")


def phase_train(clap_module) -> dict:
    """The trainer's entry point at full width: 4 steps and a checkpoint,
    then a resumed run of one more step. Returns the launch counts of the
    first run."""
    import numpy as np
    import torch
    from audio_algebra_torch import train_clapdae
    from audio_algebra_torch.models.ema import EMASchedule
    from audio_algebra_torch.utils.audio_io import write_wav

    steps = TRAIN_EPOCHS * TRAIN_FILES // TRAIN_BATCH
    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(11)
        tt = np.arange(MIRAGE_SAMPLES, dtype=np.float32) / 48000
        (Path(tmp) / "wavs").mkdir()
        t0 = time.perf_counter()
        for i in range(TRAIN_FILES):
            f0, f1 = rng.uniform(80, 1200, 2)
            clip = np.stack([0.3 * np.sin(2 * np.pi * f0 * tt), 0.3 * np.sin(2 * np.pi * f1 * tt)])
            clip += 0.05 * rng.standard_normal(clip.shape).astype(np.float32)
            write_wav(Path(tmp) / "wavs" / f"clip{i:02d}.wav", clip.astype(np.float32), 48000)
        corpus_s = time.perf_counter() - t0
        argv = ["--training_dir", str(Path(tmp) / "wavs"), "--batch_size", str(TRAIN_BATCH),
                "--sample_size", str(MIRAGE_SAMPLES), "--num_workers", "4", "--num_gpus", "1",
                "--name", "smoke", "--seed", "0"]
        os.chdir(tmp)                    # the run directory (runs/) is made beside the cwd
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_train_counts()
            t0 = time.perf_counter()
            run = train_clapdae.main([*argv, "--load_frac", "1.0", "--max_epochs",
                                      str(TRAIN_EPOCHS)], clap_module=clap_module)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = _k4_k5_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            digests = (run["start_digest"], run["end_digest"])
            del run["state"]
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            again = train_clapdae.main([*argv, "--load_frac", "0.5", "--max_epochs", "1",
                                        "--ckpt_path", f"{run['run_dir']}/ckpt"],
                                       clap_module=clap_module)
            torch.cuda.synchronize()
            again_s = time.perf_counter() - t0
            del again["state"]
            torch.cuda.empty_cache()
        finally:
            os.chdir(home)
    records = run["records"] + again["records"]
    ema = EMASchedule(0.9999, 0.75)
    closed_forms = all(
        abs(r["train_lr"] - train_clapdae.cosine_lr(r["step"], 4e-5, 500)) < 1e-12
        and r["train_ema_decay"] == ema.decay(r["step"]) for r in records)
    steady = run["records"][1:]
    expected = {"k3": 0, "k4a": steps * K4_PER_STEP, "k4b": steps * K4_PER_STEP,
                "k4c": steps * K4_PER_STEP, "k5": steps * (K5_PER_STEP + K5_PER_ENCODE),
                "k6": steps}
    emit({"phase": "train", "batch": [TRAIN_BATCH, 2, MIRAGE_SAMPLES], "dtype": "float32",
          "allow_tf32": False, "files": TRAIN_FILES, "corpus_s": corpus_s,
          "steps": [{k: r[k] for k in ("step", "train_loss", "train_lr", "train_ema_decay",
                                       "encode_ms", "embed_ms", "step_ms")} for r in records],
          "ms_per_step": float(np.mean([r["step_ms"] for r in steady])),
          "encode_ms": float(np.mean([r["encode_ms"] for r in steady])),
          "embed_ms": float(np.mean([r["embed_ms"] for r in steady])),
          "run_s": run_s, "resumed_run_s": again_s, "peak_mem_gb": peak,
          "launches": counts, "launches_expected": expected,
          "start_step": [run["start_step"], again["start_step"]],
          "end_step": [run["end_step"], again["end_step"]],
          "params_moved": digests[0]["params"] != digests[1]["params"],
          "ema_differs_from_params": digests[1]["ema"] != digests[1]["params"],
          "resume_reproduces_saved_state": again["start_digest"] == digests[1],
          "closed_forms": closed_forms})
    if not all(math.isfinite(r["train_loss"]) for r in records) or not closed_forms:
        raise AssertionError(f"losses or schedules: {records}")
    if [run["start_step"], run["end_step"], again["start_step"], again["end_step"]] != \
            [0, steps, steps, steps + 1]:
        raise AssertionError(f"steps: first run {run['start_step']}..{run['end_step']}, "
                             f"resumed {again['start_step']}..{again['end_step']}")
    if digests[0]["params"] == digests[1]["params"] or digests[1]["ema"] == digests[1]["params"]:
        raise AssertionError("the parameters did not move, or the EMA equals them")
    if again["start_digest"] != digests[1]:
        raise AssertionError("the resumed run did not reproduce the saved parameters and EMA")
    if counts != expected:
        raise AssertionError(f"training launches {counts}, expected {expected}")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "audio_algebra_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout: audio_algebra_torch/ is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": False, "cudnn": False}})
    only = None
    if "--only" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        for name in only:
            if name in ("clap", "serve"):
                raise SystemExit(f"--only: phase {name} needs the served model")
            globals()[f"phase_{name}"](*([None] if name == "train" else []))
        emit({"partial": True, "phases": only})
        return 0
    phase_build()
    k1 = phase_kernels()
    k3 = phase_kernels_k3()
    k5 = phase_kernels_k5()
    phase_model()
    destructo_k1 = phase_destructo()
    k2 = phase_kernels_k2()
    turbo = phase_destructo_turbo()
    phase_mirage_model()
    model, counts = phase_mirage()
    k6 = phase_kernels_k6()
    spectrogram_k6 = phase_spectrogram()
    clap_k6 = phase_clap(model)
    serve_k6 = phase_serve(model)
    clap_module = model.clap_module
    del model
    torch.cuda.empty_cache()
    k4 = phase_kernels_k4()
    phase_train_model()
    train = phase_train(clap_module)

    def entry(name, source, replaces, launches, row, **extra):
        """One kernel of the summary line; `row` from a kernels phase."""
        return {"name": name, "route": "cuda", "source": f"audio_algebra_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"], **extra}

    emit({"kernels": [
        entry("groupnorm1_gelu", "groupnorm.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm.py:721", counts["k1"], k1,
              launches_by_path={"destructo": destructo_k1, "destructo_turbo": turbo["k1"],
                                "mirage": counts["k1"]}),
        entry("groupnorm1_gelu_quant", "groupnorm.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm.py:107", turbo["k2a"], k2["quant"]),
        entry("groupnorm1_gelu_res_amax", "groupnorm.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm.py:298", turbo["k2b"], k2["res_amax"]),
        entry("groupnorm1_gelu_res_amax_q", "groupnorm.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm.py:321", turbo["k2c"],
              k2["res_amax_q"]),
        entry("flash_attention_relpos", "flash_attention.cu",
              "audio_algebra_tpu/ops/pallas/flash_attention.py:70", counts["k3"], k3),
        entry("flash_attention_relpos_train_fwd", "flash_attention.cu",
              "audio_algebra_tpu/ops/pallas/flash_attention.py:294", train["k4a"], k4["k4a"]),
        entry("flash_attention_relpos_train_dkv", "flash_attention_dkv.cu",
              "audio_algebra_tpu/ops/pallas/flash_attention.py:170", train["k4b"], k4["k4b"],
              plain_and_library_cover="K4b + K4c",
              bound_f32_cuda_cores_ms=k4["k4b"]["bound_f32_cuda_cores_ms"]),
        entry("flash_attention_relpos_train_dq", "flash_attention_dq.cu",
              "audio_algebra_tpu/ops/pallas/flash_attention.py:211", train["k4c"], k4["k4c"],
              plain_and_library_cover="K4b + K4c",
              bound_f32_cuda_cores_ms=k4["k4c"]["bound_f32_cuda_cores_ms"]),
        entry("grouped_gn_film_silu", "grouped_gn.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm_grouped.py:142", counts["k5"], k5,
              launches_by_path={"mirage": counts["k5"], "train": train["k5"]}),
        entry("stft", "stft.cu", "audio_algebra_tpu/ops/pallas/stft_kernel.py:35",
              spectrogram_k6 + clap_k6 + serve_k6 + train["k6"], k6["fft"],
              launches_by_path={"spectrogram": spectrogram_k6, "clap": clap_k6,
                                "serve": serve_k6, "train": train["k6"]},
              dft_operations_ms=k6["fft"]["dft_operations_ms"],
              routes={route: {key: row[key] for key in (
                  "shape", "n_fft", "hop", "max_abs_err", "kernel_ms", "plain_ms",
                  "library_ms", "kernel_device_ms", "library_device_ms", "bound_ms",
                  "bound_by", "dft_operations_ms", "kernel_max_abs_err_vs_f64",
                  "plain_max_abs_err_vs_f64")}
                  for route, row in k6.items()},
              route_rule="fft: power-of-two n_fft from 16 to 4096 (every caller on "
                         "the main paths); dft: any other n_fft")]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
