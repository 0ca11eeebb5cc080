"""The zoo's new modules in the port against the JAX package, on the CPU.

Each module is given the JAX module's flax tree (fast_random_params ->
load_flax_params) and the same seeded inputs: PQMF analysis and
synthesis (2 and 16 bands), Memcodes and ResidualMemcodes, the
DiffusionDVAE's PQMF front end and quantizers, DiffusionAE1d (encode
through the mel, decode_v), RAVE (encode, decode with the same noise),
and the DMAE1d and StackedDiffAEWrapper decodes at 2 v-DDIM steps from
the same noise (JAX's `host_normal` draw replaced by it). f32 throughout,
rel-RMS < 1e-4 unless a test states otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu import given_models as jgm
from audio_algebra_tpu.utils.params import fast_random_params
from audio_algebra_torch import given_models as tgm
from audio_algebra_torch.utils.params import load_flax_params
from test_torch_convert import DMAE, RAVE
from test_torch_pour_forward import FIRST_STAGE, STACKED_KWARGS, rel_rms

TOL = 1e-4
MEL = dict(mel_n_fft=64, mel_hop=16)


def apply(module, method=None, **kw):
    """The JAX module's apply, jitted (an eager flax apply dispatches op by
    op)."""
    return jax.jit(lambda p, *a: module.apply(p, *a, method=method, **kw))


def seeded(shape, seed, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("bands", [2, 16])
def test_pqmf_analysis_and_synthesis(bands):
    from audio_algebra_tpu.ops.pqmf import PQMF as JaxPQMF
    from audio_algebra_torch.ops.pqmf import PQMF

    j, t = JaxPQMF(bands), PQMF(bands)
    assert t.taps == j.taps
    x = seeded((2, 2, 4096), bands)
    want = np.asarray(j.analysis(jnp.asarray(x)))
    got = t.analysis(torch.from_numpy(x))
    assert got.shape == (2, 2 * bands, 4096 // bands)
    assert rel_rms(got, want) < TOL
    y = seeded(want.shape, bands + 1)
    assert rel_rms(t.synthesis(torch.from_numpy(y)), j.synthesis(jnp.asarray(y))) < TOL
    # near-perfect reconstruction away from the ends (the causal analysis
    # has no future samples for the last taps)
    edge = 2 * t.taps
    assert rel_rms(t.synthesis(got)[..., edge:-edge], x[..., edge:-edge]) < 1e-2


@pytest.mark.parametrize("num_quantizers", [1, 2])
def test_memcodes(num_quantizers):
    from audio_algebra_tpu.models import memcodes as jmc
    from audio_algebra_torch.models import memcodes as tmc

    kw = dict(dim=16, heads=4, num_codes=32)
    if num_quantizers == 1:
        jm, tm = jmc.Memcodes(**kw), tmc.Memcodes(**kw)
    else:
        jm = jmc.ResidualMemcodes(**kw, num_quantizers=num_quantizers)
        tm = tmc.ResidualMemcodes(**kw, num_quantizers=num_quantizers)
    x = seeded((2, 10, 16), 3)
    tree = fast_random_params(jm, 0, jnp.zeros((1, 10, 16)))
    load_flax_params(tm, tree)
    q_want, idx_want = apply(jm)(tree, jnp.asarray(x))
    with torch.no_grad():
        q_got, idx_got = tm(torch.from_numpy(x))
    assert np.array_equal(idx_got.numpy(), np.asarray(idx_want))
    assert rel_rms(q_got, q_want) < TOL


@pytest.mark.parametrize("kw", [dict(pqmf_bands=2), dict(num_quantizers=1),
                                dict(num_quantizers=2)], ids=["pqmf2", "memcodes", "residual"])
def test_dvae_encode_it_with_pqmf_and_quantizers(kw):
    from audio_algebra_tpu.models.dvae import DiffusionDVAE as JaxDVAE
    from audio_algebra_torch.models.dvae import DiffusionDVAE

    cfg = dict(latent_dim=8, capacity=4, c_mults=(2, 4), strides=(4, 2), n_attn_layers=1,
               diffusion_c_mults=(16, 32), num_heads=2, codebook_size=16, **kw)
    jm = JaxDVAE(**cfg)
    tree = fast_random_params(jm, 0, jnp.zeros((1, 2, 256)), jnp.zeros((1,)))
    tm = load_flax_params(DiffusionDVAE(**cfg), tree).eval()
    x = seeded((2, 2, 512), 1, 0.3)
    want = apply(jm, JaxDVAE.encode_it)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = tm.encode_it(torch.from_numpy(x))
    assert got.shape == (2, 8, 512 // 8 // kw.get("pqmf_bands", 1))
    assert rel_rms(got, want) < TOL


@pytest.fixture(scope="module")
def dmae():
    from audio_algebra_tpu.models.dmae import DiffusionAE1d as J
    from audio_algebra_torch.models.dmae import DiffusionAE1d as T

    jm = J(**DMAE, **MEL)
    tree = fast_random_params(jm, 0, jnp.zeros((1, 2, 256)), jnp.zeros((1,)))
    return jm, tree, load_flax_params(T(**DMAE, **MEL), tree).eval()


def test_dmae_encode_through_the_mel(dmae):
    from audio_algebra_tpu.models.dmae import DiffusionAE1d as J

    jm, tree, tm = dmae
    x = seeded((2, 2, 1024), 4, 0.3)
    want = apply(jm, J.encode)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(x))
    assert got.shape == (2, 4, 1024 // 32)
    assert rel_rms(got, want) < TOL


def test_dmae_decode_v(dmae):
    from audio_algebra_tpu.models.dmae import DiffusionAE1d as J

    jm, tree, tm = dmae
    x, t, z = seeded((2, 2, 1024), 5, 0.5), np.array([0.2, 0.9], np.float32), \
        np.tanh(seeded((2, 4, 32), 6))
    want = apply(jm, J.decode_v)(tree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))
    with torch.no_grad():
        got = tm.decode_v(*(torch.from_numpy(a) for a in (x, t, z)))
    assert rel_rms(got, want) < TOL


def test_rave_encode_and_decode_with_the_same_noise():
    from audio_algebra_tpu.models.rave import RAVE as J
    from audio_algebra_torch.models.rave import RAVE as T

    jm = J(**RAVE)
    tree = fast_random_params(jm, 0, jnp.zeros((1, 1, 256)))
    tm = load_flax_params(T(**RAVE), tree).eval()
    x = seeded((2, 1, 1024), 7, 0.3)
    z_want = apply(jm, J.encode)(tree, jnp.asarray(x))
    with torch.no_grad():
        z_got = tm.encode(torch.from_numpy(x))
    assert z_got.shape == (2, 8, 1024 // 32)
    assert rel_rms(z_got, z_want) < TOL
    noise = np.random.default_rng(8).uniform(-1, 1, (2, 64, 4, 4)).astype(np.float32)
    want = jax.jit(lambda p, z, n: jm.apply(p, z, noise=n, method=J.decode))(
        tree, z_want, jnp.asarray(noise))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(np.asarray(z_want)), noise=torch.from_numpy(noise))
    assert got.shape == (2, 1, 1024)
    assert rel_rms(got, want) < TOL


def _patch_noise(monkeypatch, noise: np.ndarray) -> None:
    """JAX's wrappers draw their decode noise with host_normal: hand them
    `noise` instead."""
    def host_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape, (shape, noise.shape)
        return jnp.asarray(noise, dtype)
    monkeypatch.setattr(jgm, "host_normal", host_normal)


def test_dmae1d_wrapper_encode_and_decode(monkeypatch):
    """The wrapper's whole path: 48 -> 44.1 kHz, zero pad, mel encoder;
    a 2-step v-DDIM decode from the same noise, back to 48 kHz."""
    jw = jgm.DMAE1d(model_kwargs=dict(**DMAE, **MEL))
    jw._ensure_params()
    tw = tgm.DMAE1d(model_kwargs=dict(**DMAE, **MEL), device="cpu")
    tw.load_flax_params(jw.params)
    x = seeded((2, 2, 3000), 9, 0.3)
    z_want = np.asarray(jw.encode(x))
    z_got = tw.encode(x)
    assert z_got.shape == z_want.shape == (2, 4, 4096 // 32)
    assert rel_rms(z_got, z_want) < TOL
    noise = seeded((2, 2, 4096), 10)
    _patch_noise(monkeypatch, noise)
    want = jw.decode(z_want, num_steps=2)
    got = tw.decode(z_want, num_steps=2, noise=noise)
    assert got.shape == want.shape == (2, 2, 3000)
    assert rel_rms(got, want) < TOL


def test_stacked_wrapper_decode(monkeypatch):
    """Stage-2 latents -> a 2-step v-DDIM over diffusion_v from the same
    noise -> the AE decode."""
    jw = jgm.StackedDiffAEWrapper(first_stage_config=FIRST_STAGE, model_kwargs=STACKED_KWARGS)
    jw._ensure_params()
    tw = tgm.StackedDiffAEWrapper(first_stage_config=FIRST_STAGE,
                                  model_kwargs=STACKED_KWARGS, device="cpu")
    tw.load_flax_params(jw.params)
    x = seeded((2, 2, 1024), 11, 0.3)
    reps = np.asarray(jw.encode(x))
    assert rel_rms(tw.encode(x), reps) < TOL
    noise = seeded((2, 8, reps.shape[-1] * 4), 12)
    _patch_noise(monkeypatch, noise)
    want = jw.decode(jnp.asarray(reps), steps=2)
    got = tw.decode(reps, steps=2, noise=noise)
    assert got.shape == want.shape == (2, 2, 1024)
    assert rel_rms(got, want) < TOL
