"""The port's k-diffusion sampler and resample_diffusion against JAX: the
polyexponential sigmas, VDenoiser, DPM++(2M) (kdiff_sample) and the
img2img partial-noise resample, with a toy model that both frameworks
compute alike and the same noise handed to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.samplers import kdiff as jk
from audio_algebra_tpu.samplers import vddim as jv
from audio_algebra_torch.samplers import kdiff as tk
from audio_algebra_torch.samplers import vddim as tv

TOL = 1e-5       # f32 elementwise math, a few ulp per step


def _jax_model(x, t, embedding):
    return jnp.tanh(x) * t[:, None, None] - 0.3 * x + embedding.mean()


def _torch_model(x, t, embedding):
    return torch.tanh(x) * t[:, None, None] - 0.3 * x + embedding.mean()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, 32)).astype(np.float32),
            rng.standard_normal((1, 1, 8)).astype(np.float32))


def test_sigmas_match():
    for n in (1, 5, 150):
        want = np.asarray(jk.get_sigmas_polyexponential(n, 0.11, 50.0))
        got = tk.get_sigmas_polyexponential(n, 0.11, 50.0).numpy()
        np.testing.assert_array_equal(got, want)


def test_vdenoiser_matches():
    x, emb = _inputs(0)
    sigma = np.array([3.0, 0.2], np.float32)
    want = jk.VDenoiser(_jax_model)(jnp.asarray(x), jnp.asarray(sigma),
                                    embedding=jnp.asarray(emb))
    got = tk.VDenoiser(_torch_model)(torch.from_numpy(x), torch.from_numpy(sigma),
                                     embedding=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("steps", [1, 2, 7])
def test_dpmpp_2m_sample_matches(steps):
    x, emb = _inputs(steps)
    want = jk.kdiff_sample(_jax_model, jnp.asarray(x), steps, embedding=jnp.asarray(emb))
    got = tk.kdiff_sample(_torch_model, torch.from_numpy(x), steps,
                          embedding=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_dpmpp_2m_keeps_bf16():
    x, emb = _inputs(3)
    seen = []

    def model(x, t, embedding):
        seen.append((x.dtype, t.dtype))
        return x * 0.5

    out = tk.kdiff_sample(model, torch.from_numpy(x).bfloat16(), 4,
                          embedding=torch.from_numpy(emb))
    assert out.dtype == torch.bfloat16
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 4


@pytest.mark.parametrize("steps,noise_level", [(10, 0.6), (2, 0.5), (4, 0.0)])
def test_resample_diffusion_matches(steps, noise_level):
    lat, emb = _inputs(11)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, lat.shape, jnp.float32))
    want = jv.resample_diffusion(_jax_model, jnp.asarray(lat), steps=steps,
                                 noise_level=noise_level, key=key,
                                 embedding=jnp.asarray(emb))
    got = tv.resample_diffusion(_torch_model, torch.from_numpy(lat), steps=steps,
                                noise_level=noise_level, noise=torch.from_numpy(noise),
                                embedding=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_resample_diffusion_draws_from_the_generator():
    lat, emb = _inputs(12)

    def run(seed):
        return tv.resample_diffusion(_torch_model, torch.from_numpy(lat), steps=6,
                                     noise_level=0.7,
                                     generator=torch.Generator().manual_seed(seed),
                                     embedding=torch.from_numpy(emb))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
