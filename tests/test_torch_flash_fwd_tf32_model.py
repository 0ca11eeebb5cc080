"""A numpy model of kernel K4a's f32 forward arithmetic on the CPU, held
against the JAX package's flash forward.

The card's kernel (csrc/flash_attention.cu, flash_fwd_tf32) runs both
products on the tensor cores as 3xTF32: each f32 operand x is split into
hi = its TF32 rounding (10 mantissa bits, ties away from zero, as
`cvt.rna.tf32.f32`) and lo = the TF32 rounding of x - hi, and lo.hi +
hi.lo + hi.hi are accumulated in f32 one 8-wide k step (one m16n8k8
`mma.sync`) at a time. Its softmax runs online over 64-key tiles in base
2: log2 e is folded into sm_scale and into the bias as it is read, the
running max and the normaliser are f32, and the accumulator is rescaled
before each tile's P.V is added to it. The output is divided by the
normaliser; the residual m is written back in natural units.

The model below does the same, and is held against JAX's `_fwd_impl` (its
Pallas kernel in interpret mode, natural-base softmax, f32 products) on
the same numpy inputs: o within the K4 tolerance (atol = rtol = 2e-4) and
K3's f32 tolerance (1e-4 + 1e-4), l relative and m absolute within 1e-4,
at (2, 2, 128, 64), (2, 2, 128, 16) and a case whose row max arrives in
the last key tile. One TF32 pass (hi.hi alone) misses K3's f32
tolerance: why the kernel pays for three.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.ops.pallas import flash_attention as jflash
from audio_algebra_torch.ops import flash_attention as tflash

LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
TILE = 64
K4_TOL = (2e-4, 2e-4)          # (atol, rtol): the JAX package's own for its training kernels
K3_F32_TOL = (1e-4, 1e-4)      # what the card holds K3's f32 rows to


def tf32(x):
    """x rounded to TF32's 10-bit mantissa, ties away from zero, as f32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, passes: int = 3, c=None):
    """c + a @ b over the last two axes as the tensor cores run it:
    operands split, `passes` TF32 products (3: lo.hi, hi.lo, hi.hi; 1:
    hi.hi) added into the f32 accumulator c one 8-wide k step at a time."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    pairs = ((alo, bhi), (ahi, blo), (ahi, bhi)) if passes == 3 else ((ahi, bhi),)
    if c is None:
        c = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            step = x[..., k0:k0 + 8].astype(np.float64) @ y[..., k0:k0 + 8, :].astype(np.float64)
            c = (c.astype(np.float64) + step).astype(np.float32)
    return c


def fwd_model(q, k, v, bias_t, sm_scale, passes: int = 3):
    """K4a's arithmetic: q, k, v (B, H, T, D) and bias_t (H, S, T), f32.
    Returns (o, l, m): o (B, H, T, D), l and m (H, B, T) as the kernel
    writes them."""
    b, h, t, d = q.shape
    scale2 = np.float32(sm_scale) * LOG2E
    m = np.full((b, h, t), -1e30, np.float32)
    l = np.zeros((b, h, t), np.float32)
    acc = np.zeros((b, h, t, d), np.float32)
    for s0 in range(0, t, TILE):
        kt, vt = k[:, :, s0:s0 + TILE], v[:, :, s0:s0 + TILE]
        bias2 = (np.swapaxes(bias_t[:, s0:s0 + TILE], -1, -2) * LOG2E)[None]   # read once
        qk = product(q, np.swapaxes(kt, -1, -2), passes)
        s = (qk.astype(np.float64) * scale2 + bias2).astype(np.float32)          # one fma
        mn = np.maximum(m, s.max(axis=-1))
        alpha = np.exp2(m - mn)
        p = np.exp2(s - mn[..., None])
        l = l * alpha + p.sum(axis=-1, dtype=np.float32)
        acc = product(p, vt, passes, c=acc * alpha[..., None])
        m = mn
    o = acc / l[..., None]
    return o, np.swapaxes(l, 0, 1), np.swapaxes(m * LN2, 0, 1)


def _case(shape, seed, late=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    if late:                         # the row max sits in the last key tile
        k[:, :, -3:] *= 30.0
    h, t = shape[1], shape[2]
    bias_t = (rng.standard_normal((h, t, t)) * 0.5).astype(np.float32)
    return q, k, v, bias_t, 1 / math.sqrt(shape[3])


def _jax_fwd(q, k, v, bias_t, scale):
    o, l, m = jflash._fwd_impl(*(jnp.asarray(a) for a in (q, k, v, bias_t)), scale, 512, True)
    return np.asarray(o), np.asarray(l), np.asarray(m)


def _excess(got, want, tol):
    """Largest |got - want| beyond atol + rtol |want| (<= 0: inside)."""
    atol, rtol = tol
    return float((np.abs(got - want) - (atol + rtol * np.abs(want))).max())


@pytest.mark.parametrize("shape,seed,late", [((2, 2, 128, 64), 0, False),
                                             ((2, 2, 128, 16), 1, False),
                                             ((2, 2, 128, 64), 2, True)])
def test_3xtf32_forward_holds_jax_tolerance(shape, seed, late):
    q, k, v, bias_t, scale = _case(shape, seed, late)
    o, l, m = fwd_model(q, k, v, bias_t, scale)
    want_o, want_l, want_m = _jax_fwd(q, k, v, bias_t, scale)
    assert o.shape == want_o.shape and l.shape == want_l.shape == m.shape
    assert np.all(np.isfinite(o))
    assert _excess(o, want_o, K4_TOL) <= 0.0
    assert _excess(o, want_o, K3_F32_TOL) <= 0.0
    assert float((np.abs(l - want_l) / want_l).max()) <= 1e-4
    assert float(np.abs(m - want_m).max()) <= 1e-4
    if late:                         # the max moved in the last tile: the rescale ran
        assert float(want_m.max()) > 5.0
    # and the port's twin, the function the card holds the kernel to
    twin = tflash.flash_attention_relpos_fwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v, bias_t)), scale)
    for got, want in zip((o, l, m), twin):
        np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_tf32_pass_misses_the_tolerance(seed):
    q, k, v, bias_t, scale = _case((2, 2, 128, 64), seed)
    o, _, _ = fwd_model(q, k, v, bias_t, scale, passes=1)
    want_o, _, _ = _jax_fwd(q, k, v, bias_t, scale)
    assert _excess(o, want_o, K3_F32_TOL) > 0.0
