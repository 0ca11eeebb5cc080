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
                0 and 2 shapes, and the int8 conv against the bf16 cuDNN
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
  serve         the port's HTTP service in-process on localhost: /health,
                two /generate requests with embeddings (slerp, algebra) at
                full width and reduced steps, and a text prompt refused

The phases run in the order above, Destructo's first. Then the `kernels` summary line, the card's name and power limit from
nvidia-smi, and last `{"ok": true, "device": {...}}`. Any failure exits
non-zero. Without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
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


def k2_bound(shape, dtype, mode: str) -> tuple[float, str]:
    """Least time for K2: read x (and the residual) once, write each output
    once (int8: 1 byte an element, amax and the (C,) planes negligible
    but counted); or its f32 operations (statistics 3, normalise + affine
    4, GELU 8, residual and amax 2, quantise 3 per element) at the f32
    peak, whichever is larger."""
    import torch
    n, c = math.prod(shape), shape[1]
    esize = torch.empty((), dtype=dtype).element_size()
    per = {"quant": esize + 1, "res_amax": 3 * esize, "res_amax_q": 3 * esize + 1}[mode]
    ops = {"quant": 18, "res_amax": 17, "res_amax_q": 20}[mode]
    t_bytes = (n * per + 4 * c * esize) / HBM_BYTES_PER_S * 1e3
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
            row.update({"kernel_ms": cuda_ms(kernel, 20),
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
    model = CLAPDAE(device="cuda", seed=0).setup("22s").half()
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


def phase_serve(model) -> None:
    """The HTTP service in-process on localhost, around the warm model."""
    import io
    import threading
    import urllib.error
    import urllib.request
    import wave

    import numpy as np
    from audio_algebra_torch import serve
    from audio_algebra_torch.given_models import CLAP_NOT_PORTED

    svc = serve.MirageService(model=model, verbose=False)
    server = serve.make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, obj, timeout=600):
        req = urllib.request.Request(f"{base}{path}", data=json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=timeout)

    rng = np.random.default_rng(1)
    embs = [(v / np.linalg.norm(v)).tolist() for v in rng.standard_normal((2, 512))]
    specs = {"slerp": {"embeddings": embs, "interp": 0.3, "steps": 8, "outer_steps": 4,
                       "seed": 1},
             "algebra": {"embeddings": embs, "algebra": True, "weights": [1.0, -0.5],
                         "steps": 8, "outer_steps": 4, "seed": 2}}
    result = {"phase": "serve", "requests": {}}
    try:
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            result["health"] = json.loads(r.read())
        for name, spec in specs.items():
            start = time.perf_counter()
            with post("/generate", spec) as r:
                status, ctype, body = r.status, r.headers["Content-Type"], r.read()
            with wave.open(io.BytesIO(body)) as w:
                fmt = [w.getnchannels(), w.getframerate(), w.getnframes()]
                pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
            result["requests"][name] = {
                "status": status, "content_type": ctype, "wav": fmt,
                "seconds": time.perf_counter() - start, "rms": float(np.sqrt(
                    np.mean((pcm / 32767.0) ** 2)))}
        try:
            post("/generate", {"text": ["low brass"]}, 60)
            refused = None
        except urllib.error.HTTPError as e:
            refused = {"code": e.code, "detail": json.loads(e.read())["detail"]}
        result["text_prompt"] = refused
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    emit(result)
    if not result["health"].get("ok"):
        raise AssertionError(f"/health answered {result['health']}")
    for name, r in result["requests"].items():
        if r["status"] != 200 or r["content_type"] != "audio/wav" \
                or r["wav"] != [2, 48000, MIRAGE_SAMPLES]:
            raise AssertionError(f"/generate ({name}) answered {r}")
    if refused is None or refused["code"] != 501 or refused["detail"] != CLAP_NOT_PORTED:
        raise AssertionError(f"a text prompt was not refused with the CLAP message: {refused}")
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")


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
    phase_serve(model)

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
        entry("grouped_gn_film_silu", "grouped_gn.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm_grouped.py:142", counts["k5"], k5)]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
