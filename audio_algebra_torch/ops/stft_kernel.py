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

The route is chosen by shape alone, never on a failure, by `plan`:
- every even n_fft from 16 below 8192 whose half m = n_fft / 2 has no
  prime factor above 13 (the models' and CLAP's 1024, CLAP's tiny 256,
  PitchShift's 2048, and 384, 640, 960, 1000, 1536, 1920, 400, ...) takes
  the shared-memory mixed-radix FFT (`aa_stft_fft`), to which the plan
  passes its radices;
- any other n_fft from 16 takes a DFT of length L (m, or n_fft itself
  when odd, two frames packed a transform) as a power-of-two transform of
  M points: M = L where L is a power of two, else Bluestein's chirp-z
  transform with M >= 2 L - 1. M up to 4096 (1018, 1102, 2018, odd n_fft
  up to 2048) fits one block: the chirp route (`aa_stft_chirp`); M from
  4096 points of a power of two (8192) up to 65536 (16384, 10000, 8194,
  odd n_fft up to 32767, even ones up to 65536 and powers of two up to
  131072) spans M / 4096 CTAs a frame, four frames a thread-block cluster:
  the cluster route (`aa_stft_cluster`); an even n_fft above 8192 whose
  13-smooth half splits into 2 or 4 parts of at most 4096 points (10000,
  12000, 16000, 24000) takes it with those parts' mixed-radix stages and
  no chirp (`aa_stft_cluster_mixed`);
- n_fft below 16, and frames beyond the cluster route's largest, the DFT
  product (`aa_stft`).
`launches` counts K6's launches on any route; `fft_launches`,
`chirp_launches`, `cluster_launches` and `dft_launches` each route's.

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
FFT_N_FFT = (16, 8192)          # the FFT route's even n_fft, below the end (m < 4096
                                # points: 8192, one frame a block there, takes the
                                # cluster route); below 16 every n_fft takes the DFT product
FFT_PRIMES = (3, 5, 7, 11, 13)  # the odd radices the kernel has butterflies for
CHIRP_POINTS = 4096             # one block's points: the chirp route's largest M
CLUSTER_POINTS = 65536          # 16 CTAs of 4096 points: the cluster route's largest M
ONE_SLOT_POINTS = 16384         # the cluster route's M up to which a CTA holds one transform
POW2_PART = (8, 8, 8, 8)        # a cluster part's 4096-point stages
MIXED_PARTS = (2, 4)            # parts a frame of the mixed-radix cluster route

launches = 0
fft_launches = 0
chirp_launches = 0
cluster_launches = 0
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
    """K6's route for an n_fft ("fft", "chirp", "cluster" or "dft") and the
    radices of the FFT it runs, first stage first: for "fft" the Stockham
    stages of n_fft / 2 points; for "chirp" the power-of-two stages of the
    M-point transform (M their product); for "cluster" the F-point DFT
    across a frame's F CTAs, then each CTA's stages: four radix-8 stages
    of 4096 points (M = F x 4096), or a mixed-radix part's (`mixed_cluster`:
    M = n_fft / 2); none for "dft"."""
    route: str
    radices: tuple[int, ...]


def _pow2_radices(log2: int) -> list[int]:
    """A power of two's stages: one radix-2 or radix-4 stage where log2 is
    not a multiple of 3, then radix-8 stages."""
    return {0: [], 1: [2], 2: [4]}[log2 % 3] + [8] * (log2 // 3)


def dft_length(n_fft: int) -> int:
    """The length L of the complex DFT a frame takes: n_fft / 2 points of
    the packed even and odd samples for an even n_fft, n_fft for an odd one
    (two frames packed as real and imaginary parts)."""
    return n_fft // 2 if n_fft % 2 == 0 else n_fft


def _stockham_radices(m: int) -> tuple[int, ...] | None:
    """The Stockham stages of an m-point FFT: the power-of-two part of m as
    `_pow2_radices`, then each odd prime factor (3 to 13), ascending; None
    where m has a prime factor above 13."""
    log2 = 0
    while m % 2 == 0:
        m //= 2
        log2 += 1
    odd = []
    for prime in FFT_PRIMES:
        while m % prime == 0:
            m //= prime
            odd.append(prime)
    return tuple(_pow2_radices(log2) + odd) if m == 1 else None


@functools.lru_cache(maxsize=None)
def plan(n_fft: int) -> StftPlan:
    """The route, by shape alone. n_fft below 16: the DFT product. An even
    n_fft below 8192 whose half m has no prime factor above 13: the FFT
    (`_stockham_radices(m)`). An even n_fft above 8192 whose half is such a
    length, not a power of two, and splits into F = 2 or 4 parts of at
    most 4096 points: the cluster route without chirp, radices (F, the
    part's stages). Any other: the DFT of length L = `dft_length(n_fft)` as
    an M-point power-of-two transform, M = L where L is a power of two,
    else the least power of two >= 2 L - 1 (Bluestein's chirp-z); "chirp"
    where M fits one block (CHIRP_POINTS) and L does not fill it, "cluster"
    up to CLUSTER_POINTS (8192's m = 4096 points too: four frames a
    cluster, one a CTA, beat the FFT route's one frame a block in turns),
    radices (M / 4096, 8, 8, 8, 8); beyond that the DFT product."""
    if n_fft < FFT_N_FFT[0]:
        return StftPlan("dft", ())
    length = dft_length(n_fft)
    stages = _stockham_radices(length) if n_fft % 2 == 0 else None
    if stages and n_fft < FFT_N_FFT[1]:
        return StftPlan("fft", stages)
    if stages and length & (length - 1):
        for parts in MIXED_PARTS:
            part_stages = _stockham_radices(length // parts) if length % parts == 0 else None
            if part_stages and length // parts <= CHIRP_POINTS:
                return StftPlan("cluster", (parts, *part_stages))
    points = length if n_fft % 2 == 0 and length & (length - 1) == 0 else \
        1 << (2 * length - 2).bit_length()
    log2 = points.bit_length() - 1
    if points <= CHIRP_POINTS and points != length:
        return StftPlan("chirp", tuple(_pow2_radices(log2)))
    if points <= CLUSTER_POINTS:
        return StftPlan("cluster", (points // CHIRP_POINTS, *POW2_PART))
    return StftPlan("dft", ())


def mixed_cluster(p: StftPlan) -> bool:
    """A cluster plan whose parts run mixed-radix stages (no chirp)."""
    return p.route == "cluster" and p.radices[1:] != POW2_PART


def plan_points(p: StftPlan) -> int:
    """The points of the transform a chirp or cluster plan runs."""
    return math.prod(p.radices)


@functools.lru_cache(maxsize=16)
def _chirp_tables(n_fft: int, points: int) -> tuple[np.ndarray, np.ndarray]:
    """Bluestein's tables for length L = dft_length(n_fft) at M = points,
    in float64 and rounded once to f32, each (., 2) as (re, im): the chirp
    w[n] = exp(-i pi (n^2 mod 2 L) / L), n < L, and B' = the M-point DFT of
    conj w wrapped to M (b[j] = b[M - j] = conj w[j]), over M."""
    length = dft_length(n_fft)
    n = np.arange(length, dtype=np.int64)
    w = np.exp(-1j * np.pi * ((n * n) % (2 * length)) / length)
    b = np.zeros(points, np.complex128)
    b[:length] = np.conj(w)
    b[points - length + 1:] = np.conj(w[1:])[::-1]
    bhat = np.fft.fft(b) / points

    def f32(z):
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return f32(w), f32(bhat)


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
        lib.aa_stft_chirp.argtypes = [vp] * 7 + [ci] * 8 + [vp]
        lib.aa_stft_cluster.argtypes = [vp] * 8 + [ci] * 9 + [vp]
        lib.aa_stft_cluster_mixed.argtypes = [vp] * 6 + [ci] * 7 + [ctypes.POINTER(ci), ci, vp]
        for fn in (lib.aa_stft, lib.aa_stft_fft, lib.aa_stft_chirp, lib.aa_stft_cluster,
                   lib.aa_stft_cluster_mixed):
            fn.restype = ci
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


def cluster_slots(points: int) -> int:
    """Transforms a CTA of the cluster route holds: one (the cluster's four
    transforms on four groups of CTAs, 33.8 KB of shared memory a CTA)
    while four groups fit 16 CTAs, else four (135 KB a CTA)."""
    return 1 if points <= ONE_SLOT_POINTS else 4


def _launch(x: torch.Tensor, n_fft: int, hop_length: int, center: bool,
            route_plan: StftPlan | None = None, slots: int | None = None) -> torch.Tensor:
    """One launch on `plan(n_fft)`'s route (`route_plan` and, for the
    cluster route, `slots` override it: the profiler times candidates with
    them)."""
    global launches, fft_launches, chirp_launches, cluster_launches, dft_launches
    *batch, t_len = x.shape
    pad = n_fft // 2 if center else 0
    n_frames = 1 + (t_len + 2 * pad - n_fft) // hop_length
    rows = math.prod(batch)
    lib = _lib()
    route, radices = route_plan or plan(n_fft)
    n_bins = n_fft // 2 + 1
    x2 = x.float().contiguous()                 # the kernel reads (rows, t_len)
    win = device_table(f"hann{n_fft}", lambda: hann_window(n_fft).numpy(), x.device)
    out = torch.empty((*batch, n_bins, n_frames), dtype=torch.complex64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def tw(n):
        return device_table(f"twiddles{n}", lambda: _twiddles(n), x.device).data_ptr()

    args = (rows, t_len, n_fft, hop_length, pad, n_frames)
    if route == "fft":
        err = lib.aa_stft_fft(x2.data_ptr(), win.data_ptr(), tw(n_fft), out.data_ptr(), *args,
                              _radix_array(radices), len(radices), stream)
    elif route in ("chirp", "cluster"):
        points, length = plan_points(StftPlan(route, radices)), dft_length(n_fft)
        chirp = bhat = None
        if points != length:
            chirp, bhat = (device_table(f"{name}{n_fft}_{points}",
                                        lambda i=i: _chirp_tables(n_fft, points)[i], x.device)
                           .data_ptr() for i, name in enumerate(("chirp", "bhat")))
        log_n = points.bit_length() - 1
        if mixed_cluster(StftPlan(route, radices)):
            part = points // radices[0]
            err = lib.aa_stft_cluster_mixed(
                x2.data_ptr(), win.data_ptr(), tw(points), tw(2 * part), tw(n_fft),
                out.data_ptr(), *args, radices[0], _radix_array(radices[1:]),
                len(radices) - 1, stream)
        elif route == "chirp":
            err = lib.aa_stft_chirp(x2.data_ptr(), win.data_ptr(), chirp, bhat, tw(2 * points),
                                    tw(n_fft), out.data_ptr(), *args, log_n, length, stream)
        else:
            err = lib.aa_stft_cluster(x2.data_ptr(), win.data_ptr(), chirp, bhat, tw(points),
                                      tw(2 * CHIRP_POINTS), tw(n_fft), out.data_ptr(), *args,
                                      log_n, length, slots or cluster_slots(points), stream)
    else:
        bases = device_table(f"dft_padded{n_fft}", lambda: _padded_bases(n_fft), x.device)
        err = lib.aa_stft(x2.data_ptr(), win.data_ptr(), bases.data_ptr(), out.data_ptr(),
                          *args, n_bins, bases.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"stft kernel launch failed ({route} route): CUDA error {err}")
    launches += 1
    if route == "fft":
        fft_launches += 1
    elif route == "chirp":
        chirp_launches += 1
    elif route == "cluster":
        cluster_launches += 1
    else:
        dft_launches += 1
    return out
