"""Kernel K1 of the PyTorch port: GroupNorm(1) [+GELU] [+residual].

On the CPU the port's plain twin `groupnorm1_gelu_ref` (and the wrapper,
which takes it for CPU tensors) is held against the JAX entry point
`groupnorm1_gelu_btc`, which runs its Pallas kernels in interpret mode
here. The same numpy inputs go to both; the port's (B, C, T) is the
transpose of JAX's (B, T, C). The CUDA kernel itself is held against the
twin on the card in test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.ops.pallas.groupnorm import groupnorm1_gelu_btc
from audio_algebra_torch.ops import groupnorm as gn

F32_TOL = 2e-5          # f32 stats and apply; differences are summation order
BF16_TOL = 2e-2         # one bf16 ulp at |y| < 4 (2^-6), plus stats rounding


def _inputs(seed, b, t, c, residual):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, c)) * 1.7 + 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, c).astype(np.float32)
    res = rng.standard_normal((b, t, c)).astype(np.float32) if residual else None
    return x, scale, bias, res


def _btc_to_bct(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(a.transpose(0, 2, 1))).to(dtype)


def _jax(x, scale, bias, gelu, res, dtype=jnp.float32):
    y = groupnorm1_gelu_btc(jnp.asarray(x, dtype), jnp.asarray(scale, dtype),
                            jnp.asarray(bias, dtype), gelu=gelu,
                            residual=None if res is None else jnp.asarray(res, dtype))
    return np.asarray(y.astype(jnp.float32)).transpose(0, 2, 1)


@pytest.mark.parametrize("shape", [(2, 64, 128), (2, 32, 256)])
@pytest.mark.parametrize("gelu", [True, False])
@pytest.mark.parametrize("residual", [False, True])
def test_ref_matches_jax_f32(shape, gelu, residual):
    x, scale, bias, res = _inputs(0, *shape, residual)
    want = _jax(x, scale, bias, gelu, res)
    got = gn.groupnorm1_gelu_ref(_btc_to_bct(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias), gelu, _btc_to_bct(res))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("residual", [False, True])
def test_wrapper_on_cpu_takes_the_twin(residual):
    x, scale, bias, res = _inputs(1, 2, 64, 128, residual)
    args = (_btc_to_bct(x), torch.from_numpy(scale), torch.from_numpy(bias), True,
            _btc_to_bct(res))
    before = gn.launches
    got = gn.groupnorm1_gelu(*args)
    assert gn.launches == before         # no kernel launch on the CPU
    assert torch.equal(got, gn.groupnorm1_gelu_ref(*args))
    np.testing.assert_allclose(got.numpy(), _jax(x, scale, bias, True, res),
                               atol=F32_TOL, rtol=F32_TOL)


def test_ref_matches_jax_bf16():
    x, scale, bias, res = _inputs(2, 2, 64, 128, True)
    want = _jax(x, scale, bias, True, res, dtype=jnp.bfloat16)
    bf = torch.bfloat16
    x_t = _btc_to_bct(np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), bf)
    r_t = _btc_to_bct(np.asarray(jnp.asarray(res, jnp.bfloat16).astype(jnp.float32)), bf)
    got = gn.groupnorm1_gelu_ref(x_t, torch.from_numpy(scale).to(bf),
                                 torch.from_numpy(bias).to(bf), True, r_t)
    assert got.dtype == bf
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("bad", ["dtype", "ndim", "contig", "scale"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.randn(2, 128, 16)
    scale, bias = torch.ones(128), torch.zeros(128)
    if bad == "dtype":
        x = x.half()
        scale, bias = scale.half(), bias.half()
    elif bad == "ndim":
        x = x[0]
    elif bad == "contig":
        x = torch.randn(2, 16, 128).transpose(1, 2)
    else:
        scale = torch.ones(64)
    with pytest.raises((TypeError, ValueError)):
        gn.groupnorm1_gelu(x, scale, bias, True)
