"""The PyTorch port's DiffusionDVAE (encoder and UNet) against the JAX one.

The config has UNet widths of 128/256 at power-of-two lengths and batch 2,
so the JAX side goes through its Pallas GroupNorm kernel (interpret mode
on the CPU); the port's twin takes its place here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.models.dvae import DiffusionDVAE as JaxDVAE
from audio_algebra_tpu.utils.params import fast_random_params
from audio_algebra_torch.models.dvae import DiffusionDVAE
from audio_algebra_torch.utils.params import load_flax_params, random_init_
from test_torch_blocks import rand_tree

CFG = dict(latent_dim=8, capacity=4, c_mults=(2, 4), strides=(4, 2),
           n_attn_layers=1, diffusion_c_mults=(128, 128, 256))
T = 1024
TOL = 1e-4       # f32, relative to the output's peak: 14+ layers of summation order


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err < tol, err


@pytest.fixture(scope="module")
def models():
    jmod = JaxDVAE(**CFG)
    x = jnp.zeros((1, 2, T))
    tree = rand_tree(jmod, 0, x, jnp.zeros((1,)))
    tmod = load_flax_params(DiffusionDVAE(**CFG), tree)
    return jmod, tree, tmod


def test_encode_it(models):
    jmod, tree, tmod = models
    audio = np.random.default_rng(1).standard_normal((2, 2, T)).astype(np.float32)
    want = jax.jit(lambda p, a: jmod.apply({"params": p}, a, method=JaxDVAE.encode_it))(
        tree, jnp.asarray(audio))
    with torch.no_grad():
        got = tmod.encode_it(torch.from_numpy(audio))
    assert got.shape == (2, 8, T // 8)
    _close(got.numpy(), want)


def test_decode_v(models):
    jmod, tree, tmod = models
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2, T)).astype(np.float32)
    t = rng.uniform(0, 1, 2).astype(np.float32)
    cond = np.tanh(rng.standard_normal((2, 8, T // 8))).astype(np.float32)
    want = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, method=JaxDVAE.decode_v))(
        tree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = tmod.decode_v(torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(cond))
    _close(got.numpy(), want)


def test_random_init_draws_the_jax_weights():
    """random_init_(seed) gives exactly the weights fast_random_params(seed)
    draws for the JAX model."""
    tree = fast_random_params(JaxDVAE(**CFG), 3, jnp.zeros((1, 2, T)), jnp.zeros((1,)))
    want = load_flax_params(DiffusionDVAE(**CFG), tree).state_dict()
    got = random_init_(DiffusionDVAE(**CFG), 3).state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.parametrize("kwargs", [dict(num_quantizers=1), dict(pqmf_bands=4)])
def test_unported_options_raise(kwargs):
    """The options num_quantizers and pqmf_bands build: the module takes
    JAX's params tree for them, and encode_it (PQMF analysis, encoder,
    Memcodes, tanh) matches JAX's."""
    jmod = JaxDVAE(**CFG, **kwargs)
    tree = rand_tree(jmod, 0, jnp.zeros((1, 2, T)), jnp.zeros((1,)))
    tmod = load_flax_params(DiffusionDVAE(**CFG, **kwargs), tree)
    audio = np.random.default_rng(3).standard_normal((2, 2, T)).astype(np.float32)
    want = jax.jit(lambda p, a: jmod.apply({"params": p}, a, method=JaxDVAE.encode_it))(
        tree, jnp.asarray(audio))
    with torch.no_grad():
        got = tmod.encode_it(torch.from_numpy(audio))
    assert got.shape == (2, 8, T // 8 // kwargs.get("pqmf_bands", 1))
    _close(got.numpy(), want)
