"""Fused STFT — kernel K6.

`stft_fused` is the port of audio_algebra_tpu's
`ops/pallas/stft_kernel.py:pallas_stft`: the complex STFT of (..., T) with
the periodic Hann window, reflect-padded centre, as complex64
(..., n_bins, F), the framed signal never in device memory. On a CUDA
tensor it launches a hand-written CUDA kernel of `csrc/stft.cu` (built for
sm_90a at first use) or raises; on a CPU tensor it takes the plain twin
`stft_ref`, the matmul formulation of ops/stft.py. The JAX package takes
its kernel only at n_fft and hop that are multiples of the TPU's 128
lanes; the port has no such gate.

The route is chosen by shape alone, never on a failure: a power-of-two
n_fft from 16 to 4096 (every caller in the port: 1024 in the models and
CLAP, 256 in CLAP's tiny config) takes the shared-memory FFT
(`aa_stft_fft`); any other n_fft the DFT product (`aa_stft`), at any hop
whose frame span fits a block's shared memory. `launches` counts K6's
launches on either route, `fft_launches` and `dft_launches` each route's.

The STFT is linear in x: with grad enabled and an x that requires grad,
the launch runs inside a `torch.autograd.Function` whose backward is the
VJP of the f32 twin, exact for the kernel's function (as K1 and K5 do,
ops/groupnorm.py).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .groupnorm import wants_grad
from .stft import _dft_bases, device_table, hann_window, stft_plain

SOURCE = "stft.cu"
BINS_PER_BLOCK = 64             # the kernel's bin tile: the bases' columns pad to it
MAX_SMEM = 232448               # shared memory one block may use on an H100
MAX_ROWS = 65535                # grid.z (DFT) and grid.y (FFT)
FFT_N_FFT = (16, 4096)          # the FFT route's power-of-two n_fft range

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


def uses_fft(n_fft: int) -> bool:
    """The route, by shape: the FFT for a power-of-two n_fft in FFT_N_FFT."""
    return FFT_N_FFT[0] <= n_fft <= FFT_N_FFT[1] and n_fft & (n_fft - 1) == 0


def _lib():
    from ._build import load
    lib = load(SOURCE)
    if lib.aa_stft.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.aa_stft.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.aa_stft_fft.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.aa_stft.restype = lib.aa_stft_fft.restype = ci
        lib.aa_stft_smem_bytes.argtypes = [ci, ci]
        lib.aa_stft_smem_bytes.restype = ctypes.c_longlong
    return lib


def stft_fused(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
               center: bool = True) -> torch.Tensor:
    """Complex STFT (Hann window) of (..., T) -> complex64 (..., n_bins, F).
    CPU tensors take the twin; CUDA tensors launch the CUDA kernel, in f32
    (x is cast to f32 as the JAX kernel casts it): the FFT for a
    power-of-two n_fft from 16 to 4096, else the DFT product; inside an
    autograd.Function when x requires grad."""
    if x.dim() < 1:
        raise ValueError("stft wants a signal of shape (..., T)")
    *batch, t_len = x.shape
    pad = n_fft // 2 if center else 0
    if center and pad >= t_len:
        raise ValueError(f"stft: reflect padding of {pad} needs more than {t_len} samples")
    n_frames = 1 + (t_len + 2 * pad - n_fft) // hop_length
    if n_frames < 1 or n_fft < 1 or hop_length < 1:
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
    if rows > MAX_ROWS:
        raise ValueError(f"stft_fused: {rows} rows exceed the kernel's {MAX_ROWS}")
    lib = _lib()
    fft = uses_fft(n_fft)
    if not fft and lib.aa_stft_smem_bytes(n_fft, hop_length) > MAX_SMEM:
        raise ValueError(f"stft_fused: the frame span at n_fft {n_fft}, hop {hop_length} "
                         f"exceeds a block's shared memory")
    n_bins = n_fft // 2 + 1
    x2 = x.float().contiguous()                 # the kernel reads (rows, t_len)
    win = device_table(f"hann{n_fft}", lambda: hann_window(n_fft).numpy(), x.device)
    out = torch.empty((*batch, n_bins, n_frames), dtype=torch.complex64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if fft:
        tw = device_table(f"twiddles{n_fft}", lambda: _twiddles(n_fft), x.device)
        err = lib.aa_stft_fft(x2.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(),
                              rows, t_len, n_fft, hop_length, pad, n_frames, stream)
    else:
        bases = device_table(f"dft_padded{n_fft}", lambda: _padded_bases(n_fft), x.device)
        err = lib.aa_stft(x2.data_ptr(), win.data_ptr(), bases.data_ptr(), out.data_ptr(),
                          rows, t_len, n_fft, hop_length, pad, n_frames, n_bins,
                          bases.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"stft kernel launch failed: CUDA error {err}")
    launches += 1
    if fft:
        fft_launches += 1
    else:
        dft_launches += 1
    return out
