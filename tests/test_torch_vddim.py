"""The PyTorch port's v-DDIM sampler against the JAX one: schedules, and
`sample` / `sample_manual` at eta = 0 from the same noise with a toy model
that both frameworks compute alike."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.samplers import vddim as jv
from audio_algebra_torch.samplers import vddim as tv

TOL = 1e-5       # f32 elementwise math, a few ulp per step


def test_schedules():
    t = np.linspace(0, 1, 37).astype(np.float32)
    for name in ("get_alphas_sigmas", "get_crash_schedule"):
        want = getattr(jv, name)(jnp.asarray(t))
        got = getattr(tv, name)(torch.from_numpy(t))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    a, s = np.cos(t), np.sin(t)
    np.testing.assert_allclose(
        tv.alpha_sigma_to_t(torch.from_numpy(a), torch.from_numpy(s)).numpy(),
        np.asarray(jv.alpha_sigma_to_t(jnp.asarray(a), jnp.asarray(s))), atol=TOL)


def _jax_model(x, t, cond):
    return jnp.tanh(x) * t[:, None, None] - 0.3 * x + cond.mean(axis=(1, 2))[:, None, None]


def _torch_model(x, t, cond):
    return torch.tanh(x) * t[:, None, None] - 0.3 * x + cond.mean(dim=(1, 2))[:, None, None]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 2, 64)).astype(np.float32),
            rng.standard_normal((2, 4, 8)).astype(np.float32))


@pytest.mark.parametrize("steps", [1, 3, 10])
def test_sample_eta0_matches_jax(steps):
    noise, cond = _inputs(steps)
    want = jv.sample(_jax_model, jnp.asarray(noise), steps, 0,
                     jnp.asarray(cond))
    got = tv.sample(_torch_model, torch.from_numpy(noise), steps, 0,
                    torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_sample_manual_eta0_matches_jax():
    noise, cond = _inputs(7)
    want = jv.sample_manual(_jax_model, jnp.asarray(noise), 6, 0,
                            cond=jnp.asarray(cond))
    got = tv.sample_manual(_torch_model, torch.from_numpy(noise), 6, 0,
                           cond=torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_sample_hands_t_in_x_dtype():
    noise, cond = _inputs(3)
    seen = []

    def tmodel(x, t, cond):
        seen.append((x.dtype, t.dtype))
        return x * 0.5

    out = tv.sample(tmodel, torch.from_numpy(noise).bfloat16(), 4, 0,
                    torch.from_numpy(cond).bfloat16())
    assert out.dtype == torch.bfloat16
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 4


def test_sample_eta_draws_from_the_generator():
    noise, cond = _inputs(4)

    def tmodel(x, t, cond):
        return torch.tanh(x) * t[:, None, None]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tv.sample(tmodel, torch.from_numpy(noise), 5, 0.7,
                         torch.from_numpy(cond), generator=g)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all()
    det = tv.sample(tmodel, torch.from_numpy(noise), 5, 0, torch.from_numpy(cond))
    assert not torch.equal(a, det)
