#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py

Runs from the root of a checkout of the repository, on a machine with a
CUDA card (sm_90a: H100). It imports nothing of JAX or of the JAX package.
Phases, each printing one JSON line:

  build      compile every CUDA source of audio_algebra_torch/csrc with nvcc,
             all started together
  kernels    hold kernel K1 (fused GroupNorm(1) [+GELU] [+residual]) against
             its plain PyTorch twin on the card, at the main path's shapes,
             and time it beside the twin, the PyTorch library calls and its
             bound
  model      one full-width UNet forward, (2, 2, 16384) bf16, through K1 and
             through the twin with the same weights: rel-RMS under a bound
  destructo  the Destructo pipeline at the reference width in bf16 with
             seeded random weights: a 44.1 kHz WAV is loaded, resampled and
             chunked into 4 x 65536 samples, encoded, negated and decoded in
             35 v-DDIM steps; K1 must launch 35 x 191 times

Then the `kernels` summary line, the card's name and power limit from
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
GN_CALLS_PER_FORWARD = 191     # 14 levels x 6 blocks x 2 - 1 + 24 attention pre-norms
STEPS = 35
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2 ** -7)}   # (atol, rtol)
MODEL_REL_RMS_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}


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
    phase_model()
    launches = phase_destructo()
    emit({"kernels": [{
        "name": "groupnorm1_gelu", "route": "cuda",
        "source": "audio_algebra_torch/csrc/groupnorm.cu",
        "replaces": "audio_algebra_tpu/ops/pallas/groupnorm.py:721",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
