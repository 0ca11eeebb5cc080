"""Fused STFT — kernel K6.

`stft_fused` is the port of audio_algebra_tpu's
`ops/pallas/stft_kernel.py:pallas_stft`: the complex STFT of (..., T) with
the periodic Hann window, reflect-padded centre, as complex64
(..., n_bins, F), the framed signal never in device memory. On a CUDA
tensor it launches the hand-written CUDA kernel of `csrc/stft.cu` (built
for sm_90a at first use) or raises, at any n_fft and hop whose frame span
fits the block's shared memory; on a CPU tensor it takes the plain twin
`stft_ref`, the matmul formulation of ops/stft.py. The JAX package takes
its kernel only at n_fft and hop that are multiples of the TPU's 128
lanes; the port has no such gate. `launches` counts the kernel's launches.
The kernel has no backward (`pallas_stft` has none either): on the card it
refuses an input that requires grad.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .groupnorm import refuse_grad
from .stft import _dft_bases, device_table, hann_window, stft_plain

SOURCE = "stft.cu"
BINS_PER_BLOCK = 64             # the kernel's bin tile: the bases' columns pad to it
MAX_SMEM = 232448               # shared memory one block may use on an H100
MAX_ROWS = 65535                # grid.z

launches = 0


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


def _lib():
    from ._build import load
    lib = load(SOURCE)
    fn = lib.aa_stft
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        lib.aa_stft_smem_bytes.argtypes = [ci, ci]
        lib.aa_stft_smem_bytes.restype = ctypes.c_longlong
    return lib


def stft_fused(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
               center: bool = True) -> torch.Tensor:
    """Complex STFT (Hann window) of (..., T) -> complex64 (..., n_bins, F).
    CPU tensors take the twin; CUDA tensors launch the CUDA kernel, in f32
    (x is cast to f32 as the JAX kernel casts it)."""
    global launches
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
    refuse_grad("stft_fused (K6, forward only)", x)
    rows = math.prod(batch)
    lib = _lib()
    if rows > MAX_ROWS:
        raise ValueError(f"stft_fused: {rows} rows exceed the kernel's {MAX_ROWS}")
    if lib.aa_stft_smem_bytes(n_fft, hop_length) > MAX_SMEM:
        raise ValueError(f"stft_fused: the frame span at n_fft {n_fft}, hop {hop_length} "
                         f"exceeds a block's shared memory")
    n_bins = n_fft // 2 + 1
    x2 = x.reshape(rows, t_len).float().contiguous()
    win = device_table(f"hann{n_fft}", lambda: hann_window(n_fft).numpy(), x.device)
    bases = device_table(f"dft_padded{n_fft}", lambda: _padded_bases(n_fft), x.device)
    out = torch.empty((rows, n_bins, n_frames), dtype=torch.complex64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.aa_stft(x2.data_ptr(), win.data_ptr(), bases.data_ptr(), out.data_ptr(),
                      rows, t_len, n_fft, hop_length, pad, n_frames, n_bins,
                      bases.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"stft kernel launch failed: CUDA error {err}")
    launches += 1
    return out.reshape(*batch, n_bins, n_frames)
