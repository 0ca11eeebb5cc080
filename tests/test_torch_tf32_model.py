"""A numpy model of the 3xTF32 products that K4b (and K4c) run on the tensor
cores in f32, held against the JAX package's own backward.

Each f32 operand x is split into hi = its TF32 rounding (10 mantissa bits,
round to nearest with ties away from zero, as `cvt.rna.tf32.f32`) and lo =
the TF32 rounding of x - hi; a product accumulates lo.hi + hi.lo + hi.hi in
f32, one 8-wide k step (one m16n8k8 `mma.sync`) at a time. The model runs
K4b's four products (sT = K.Q^T, dpT = V.dO^T, dv = pT.dO, dk = dsT.Q) with
the kernel's elementwise steps between them, at (2, 2, 128, 64), and its dk
and dv are held against `jax.vjp` of `flash_attention_relpos_ref` on the
same numpy inputs within the K4 tolerance (atol = rtol = 2e-4, the JAX
package's own for its training kernels). One TF32 pass (hi.hi alone) misses
that tolerance: why the kernel pays for three.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.ops.pallas import flash_attention as jflash
from audio_algebra_torch.ops import flash_attention as tflash

SHAPE = (2, 2, 128, 64)
ATOL = RTOL = 2e-4


def tf32(x):
    """x rounded to TF32's 10-bit mantissa, ties away from zero, as f32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, passes: int = 3):
    """a @ b over the last two axes as the tensor cores run it: operands
    split, `passes` TF32 products (3: lo.hi, hi.lo, hi.hi; 1: hi.hi) summed
    into an f32 accumulator one 8-wide k step at a time."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    pairs = ((alo, bhi), (ahi, blo), (ahi, bhi)) if passes == 3 else ((ahi, bhi),)
    c = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            step = x[..., k0:k0 + 8].astype(np.float64) @ y[..., k0:k0 + 8, :].astype(np.float64)
            c = (c.astype(np.float64) + step).astype(np.float32)
    return c


def dkv_model(q, k, v, do, bias_t, l, m, delta, scale, passes: int = 3):
    """K4b's arithmetic in the (key, query) orientation, f32 between the
    products: pT = exp(sT - m) * (1 / l), dsT = pT * (dpT - delta)."""
    s = product(k, np.swapaxes(q, -1, -2), passes) * np.float32(scale) + bias_t[None]
    p = np.exp(s - m[..., None, :]) * (np.float32(1) / l)[..., None, :]
    ds = p * (product(v, np.swapaxes(do, -1, -2), passes) - delta[..., None, :])
    return product(ds, q, passes) * np.float32(scale), product(p, do, passes)


def _case(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4))
    h, t = SHAPE[1], SHAPE[2]
    bias_t = (rng.standard_normal((h, t, t)) * 0.5).astype(np.float32)
    scale = SHAPE[3] ** -0.5
    bias = jnp.swapaxes(jnp.asarray(bias_t), -1, -2)
    _, vjp = jax.vjp(lambda q, k, v: jflash.flash_attention_relpos_ref(q, k, v, bias, scale),
                     *(jnp.asarray(a) for a in (q, k, v)))
    _, want_dk, want_dv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    # the forward's residuals as K4a gives them: (H, B, T) -> (B, H, T)
    o, l, m = tflash.flash_attention_relpos_fwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v, bias_t)), scale)
    l, m = (x.transpose(0, 1).numpy() for x in (l, m))
    delta = (do * o.numpy()).sum(axis=-1)
    return (q, k, v, do, bias_t, l, m, delta, scale), (want_dk, want_dv)


def _excess(got, want):
    """Largest |got - want| beyond atol + rtol |want| (<= 0: inside)."""
    return float((np.abs(got - want) - (ATOL + RTOL * np.abs(want))).max())


def test_tf32_split_keeps_22_bits():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096)).astype(np.float32)
    hi, lo = split(x)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0) and np.all(lo.view(np.uint32) & 0x1FFF == 0)
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0 ** -11)
    assert np.all(np.abs(x - (hi + lo)) <= np.abs(x) * 2.0 ** -21)
    # ties away from zero, as cvt.rna
    tie = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], np.float32)
    np.testing.assert_array_equal(tf32(tie), np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10)],
                                                      np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", ["dk", "dv"])
def test_3xtf32_dkv_holds_jax_tolerance(seed, which):
    args, want = _case(seed)
    got = dict(zip(("dk", "dv"), dkv_model(*args)))[which]
    want = dict(zip(("dk", "dv"), want))[which]
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert _excess(got, want) <= 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_one_tf32_pass_misses_the_tolerance(seed):
    args, (want_dk, want_dv) = _case(seed)
    dk, dv = dkv_model(*args, passes=1)
    assert _excess(dk, want_dk) > 0.0 and _excess(dv, want_dv) > 0.0
