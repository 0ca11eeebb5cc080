"""Kernel K3's plain twin (the CPU route of ops/flash_attention.py) against
the JAX flash attention: its Pallas kernel in interpret mode and its plain
reference, at (1, 2, 1024, 64) in f32 with an f32 and a bf16 bias; the
flash gate; the (transposed) Toeplitz rel-pos bias; and the rel-pos bucket
array, which must equal JAX's exactly for every delta up to the 66 s inner
length."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.models import unet_cfg1d as junet
from audio_algebra_tpu.ops.pallas import flash_attention as jflash
from audio_algebra_torch.models import unet_cfg1d as tunet
from audio_algebra_torch.ops import flash_attention as tflash

TOL = 1e-4       # f32, relative to the output's peak: summation order only


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_flash_and_reference(bias_dtype):
    b, h, t, d = 1, 2, 1024, 64
    q, k, v = _qkv((b, h, t, d))
    rng = np.random.default_rng(1)
    table = (rng.standard_normal((256, h)) * 0.5).astype(np.float32)
    bias_t = np.asarray(junet.toeplitz_rel_pos_bias(jnp.asarray(table), t, 256, 2048,
                                                    transposed=True))
    jdt = jnp.dtype(bias_dtype)
    bias_t_cast = jnp.asarray(bias_t).astype(jdt)
    scale = d ** -0.5
    want_k = jflash.flash_attention_relpos(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           bias_t_cast, sm_scale=scale, interpret=True)
    want_r = jflash.flash_attention_relpos_ref(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v),
                                               jnp.swapaxes(bias_t_cast, 1, 2), scale)
    tbias = torch.from_numpy(np.array(bias_t_cast.astype(jnp.float32))).to(
        getattr(torch, bias_dtype))
    got = tflash.flash_attention_relpos(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), tbias, scale)
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), want_k) < TOL
    assert _rel_err(got.numpy(), want_r) < TOL


def test_twin_keeps_the_kernels_bf16_arithmetic():
    """bf16 q, k, v: P cast to bf16 before P·V, the output in bf16; the
    JAX interpret kernel on the same bf16 inputs agrees to a bf16 ulp."""
    b, h, t, d = 1, 2, 1024, 64
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((b, h, t, d), 2))
    bias_t = torch.from_numpy(np.random.default_rng(3).standard_normal((h, t, t))
                              .astype(np.float32) * 0.1).bfloat16()
    got = tflash.flash_attention_relpos(q, k, v, bias_t, 0.125)
    assert got.dtype == torch.bfloat16
    j = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    want = jflash.flash_attention_relpos(j(q), j(k), j(v), j(bias_t), sm_scale=0.125,
                                         interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= 2 ** -7 * np.abs(want).max()


def test_flash_gate_matches_jax():
    for t in (256, 512, 1000, 1024, 1536, 2048, 3072, 4096):
        assert tflash.flash_ok(t) == jflash.flash_ok(t)


@pytest.mark.parametrize("transposed", [False, True])
def test_toeplitz_bias_matches_jax(transposed):
    table = np.random.default_rng(4).standard_normal((256, 3)).astype(np.float32)
    for t in (64, 1024):
        want = junet.toeplitz_rel_pos_bias(jnp.asarray(table), t, 256, 2048, transposed)
        got = tunet.toeplitz_rel_pos_bias(torch.from_numpy(table), t, 256, 2048, transposed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("buckets,max_distance", [(256, 2048), (32, 128)])
def test_bucket_array_is_exact(buckets, max_distance):
    delta = np.arange(-6143, 6144)
    want = np.asarray(junet._relative_position_bucket(jnp.asarray(delta), buckets,
                                                      max_distance))
    got = tunet._relative_position_bucket(torch.from_numpy(delta), buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_its_inputs():
    q = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError):
        tflash.flash_attention_relpos(q, q, q, torch.zeros(2, 64, 128))
    with pytest.raises(TypeError):
        tflash.flash_attention_relpos(q.half(), q.half(), q.half(), torch.zeros(2, 128, 128))
