"""Fused STFT — kernel K6.

`stft_fused` is the port of audio_algebra_tpu's
`ops/pallas/stft_kernel.py:pallas_stft`: the complex STFT of (..., T) with
the periodic Hann window, reflect-padded centre, as complex64
(..., n_bins, F), the framed signal never in device memory. On a CUDA
tensor it launches a hand-written CUDA kernel of `csrc/stft.cu` (built for
sm_90a at first use) or raises; on a CPU tensor it takes the plain twin
`stft_ref`, the matmul formulation of ops/stft.py. The JAX package takes
its kernel only at n_fft and hop that are multiples of the TPU's 128
lanes; the port has no such gate, and refuses no shape the JAX package
computes: any hop, any number of rows, any T >= 1 when centred (the
reflect padding folds its index as numpy's does, as often as a short clip
needs).

The route is chosen by shape alone, never on a failure, by `plan`: every
even n_fft from 16 to 8192 whose half m = n_fft / 2 has no prime factor
above 13 (the models' and CLAP's 1024, CLAP's tiny 256, PitchShift's
2048, and 384, 640, 960, 1000, 1536, 1920, 400, ...) takes the
shared-memory mixed-radix FFT (`aa_stft_fft`), to which the plan passes
its radices; any other n_fft the DFT product (`aa_stft`). `launches`
counts K6's launches on either route, `fft_launches` and `dft_launches`
each route's.

The STFT is linear in x: with grad enabled and an x that requires grad,
the launch runs inside a `torch.autograd.Function` whose backward is the
VJP of the f32 twin, exact for the kernel's function (as K1 and K5 do,
ops/groupnorm.py).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .groupnorm import wants_grad
from .stft import _dft_bases, device_table, hann_window, stft_plain

SOURCE = "stft.cu"
BINS_PER_BLOCK = 64             # the kernel's bin tile: the bases' columns pad to it
FFT_N_FFT = (16, 8192)          # the FFT route's even n_fft: m = n_fft / 2 <= 4096 points
FFT_PRIMES = (3, 5, 7, 11, 13)  # the odd radices the kernel has butterflies for

launches = 0
fft_launches = 0
dft_launches = 0


def stft_ref(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
             center: bool = True) -> torch.Tensor:
    """Plain twin: frames x window @ DFT bases in full f32."""
    return stft_plain(x, n_fft, hop_length, None, center)


def _padded_bases(n_fft: int) -> np.ndarray:
    """[2][n_fft][kp] f32: cos then sin bases, bins zero-padded to kp."""
    cos_b, sin_b = _dft_bases(n_fft)
    n_bins = cos_b.shape[1]
    kp = -(-n_bins // BINS_PER_BLOCK) * BINS_PER_BLOCK
    out = np.zeros((2, n_fft, kp), np.float32)
    out[0, :, :n_bins] = cos_b
    out[1, :, :n_bins] = sin_b
    return out


def _twiddles(n_fft: int) -> np.ndarray:
    """(n_fft, 2) f32: exp(-2 pi i j / n_fft) as (re, im), computed in
    float64 and rounded once."""
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


class StftPlan(NamedTuple):
    """K6's route for an n_fft ("fft" or "dft") and, for the FFT, the
    radices of its Stockham stages, first stage first (their product is
    n_fft / 2)."""
    route: str
    radices: tuple[int, ...]


@functools.lru_cache(maxsize=None)
def plan(n_fft: int) -> StftPlan:
    """The route, by shape alone: the FFT for an even n_fft in FFT_N_FFT
    whose half m has no prime factor above 13, else the DFT product. The
    power-of-two part of m is staged as a radix-2 or radix-4 stage where
    its log2 is not a multiple of 3, then radix-8 stages; the odd primes
    follow, ascending, one stage each."""
    if n_fft % 2 or not FFT_N_FFT[0] <= n_fft <= FFT_N_FFT[1]:
        return StftPlan("dft", ())
    m, log2 = n_fft // 2, 0
    while m % 2 == 0:
        m //= 2
        log2 += 1
    odd = []
    for prime in FFT_PRIMES:
        while m % prime == 0:
            m //= prime
            odd.append(prime)
    if m != 1:
        return StftPlan("dft", ())
    head = {0: [], 1: [2], 2: [4]}[log2 % 3]
    return StftPlan("fft", tuple(head + [8] * (log2 // 3) + odd))


@functools.lru_cache(maxsize=None)
def _radix_array(radices: tuple[int, ...]):
    return (ctypes.c_int * len(radices))(*radices)


def _lib():
    from ._build import load
    lib = load(SOURCE)
    if lib.aa_stft.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.aa_stft.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.aa_stft_fft.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                    ctypes.POINTER(ci), ci, vp]
        lib.aa_stft.restype = lib.aa_stft_fft.restype = ci
    return lib


def stft_fused(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
               center: bool = True) -> torch.Tensor:
    """Complex STFT (Hann window) of (..., T) -> complex64 (..., n_bins, F).
    CPU tensors take the twin; CUDA tensors launch the CUDA kernel, in f32
    (x is cast to f32 as the JAX kernel casts it), on the route `plan`
    gives; inside an autograd.Function when x requires grad."""
    if x.dim() < 1:
        raise ValueError("stft wants a signal of shape (..., T)")
    *batch, t_len = x.shape
    pad = n_fft // 2 if center else 0
    if t_len < 1 or n_fft < 1 or hop_length < 1 or \
            t_len + 2 * pad < n_fft:                  # 1 + (t_len + 2 pad - n_fft) // hop frames
        raise ValueError(f"stft: {t_len} samples give no frame at n_fft {n_fft}, "
                         f"hop {hop_length}")
    if x.device.type == "cpu":
        return stft_ref(x, n_fft, hop_length, center)
    if x.device.type != "cuda":
        raise ValueError(f"stft_fused: unsupported device {x.device}")
    if wants_grad(x):
        return _STFT.apply(x, n_fft, hop_length, center)
    return _launch(x, n_fft, hop_length, center)


class _STFT(torch.autograd.Function):
    """K6's launch with the twin's VJP as its backward (the STFT is linear
    in x, so the twin's VJP is the kernel's)."""

    @staticmethod
    def forward(ctx, x, n_fft, hop_length, center):
        ctx.save_for_backward(x)
        ctx.args = (n_fft, hop_length, center)
        return _launch(x, n_fft, hop_length, center)

    @staticmethod
    def backward(ctx, dout):
        x, = ctx.saved_tensors
        with torch.enable_grad():
            leaf = x.detach().float().requires_grad_()
            dx, = torch.autograd.grad(stft_ref(leaf, *ctx.args), leaf, dout)
        return dx.to(x.dtype), None, None, None


def _launch(x: torch.Tensor, n_fft: int, hop_length: int, center: bool) -> torch.Tensor:
    global launches, fft_launches, dft_launches
    *batch, t_len = x.shape
    pad = n_fft // 2 if center else 0
    n_frames = 1 + (t_len + 2 * pad - n_fft) // hop_length
    rows = math.prod(batch)
    lib = _lib()
    route, radices = plan(n_fft)
    n_bins = n_fft // 2 + 1
    x2 = x.float().contiguous()                 # the kernel reads (rows, t_len)
    win = device_table(f"hann{n_fft}", lambda: hann_window(n_fft).numpy(), x.device)
    out = torch.empty((*batch, n_bins, n_frames), dtype=torch.complex64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "fft":
        tw = device_table(f"twiddles{n_fft}", lambda: _twiddles(n_fft), x.device)
        err = lib.aa_stft_fft(x2.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(),
                              rows, t_len, n_fft, hop_length, pad, n_frames,
                              _radix_array(radices), len(radices), stream)
    else:
        bases = device_table(f"dft_padded{n_fft}", lambda: _padded_bases(n_fft), x.device)
        err = lib.aa_stft(x2.data_ptr(), win.data_ptr(), bases.data_ptr(), out.data_ptr(),
                          rows, t_len, n_fft, hop_length, pad, n_frames, n_bins,
                          bases.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"stft kernel launch failed: CUDA error {err}")
    launches += 1
    if route == "fft":
        fft_launches += 1
    else:
        dft_launches += 1
    return out
