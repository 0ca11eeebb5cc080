"""The port's MIRAGE stack modules against JAX with the same weights
(through the flax bridge): the SoundStream-XL decoder (flax SAME transposed
convs), the AudioAutoencoder, Encoder1d (GroupNorm + SiLU through K5's
twin) and LatentAudioDiffusionAutoencoder.encode / diffusion_v /
decode_first_stage, in f32 at small widths."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.models import audio_ae as jae
from audio_algebra_tpu.models import encoder1d as jenc
from audio_algebra_tpu.models import soundstream as jss
from audio_algebra_tpu.models import stacked as jst
from audio_algebra_torch.models import audio_ae as tae
from audio_algebra_torch.models import encoder1d as tenc
from audio_algebra_torch.models import soundstream as tss
from audio_algebra_torch.models import stacked as tst
from audio_algebra_torch.utils.params import load_flax_params
from test_torch_blocks import rand_tree

TOL = 1e-4       # f32, relative to the output's peak

AE = dict(capacity=4, c_mults=(2, 4), strides=(2, 4), latent_dim=8)
ENC = dict(in_channels=8, out_channels=4, channels=8, multipliers=(1, 2, 2),
           factors=(2, 2), num_blocks=(2, 1))
LDAE = dict(latent_dim=8, second_stage_latent_dim=4, factors=(2, 2), ae_capacity=4,
            ae_c_mults=(2, 4), ae_strides=(2, 2), latent_channels=8,
            latent_multipliers=(1, 2, 2), latent_num_blocks=(1, 1),
            diffusion_c_mults=(8, 16), diffusion_depth=2)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("strides", [(2, 2), (4, 2), (1, 2)])
def test_soundstream_decoder(strides):
    z = _randn(2, 8, 16)
    jm = jss.SoundStreamXLDecoder(out_channels=2, capacity=4, latent_dim=8, c_mults=(2, 4),
                                  strides=strides)
    tree = rand_tree(jm, 1, jnp.asarray(z))
    want = jm.apply({"params": tree}, jnp.asarray(z))
    tm = load_flax_params(tss.SoundStreamXLDecoder(out_channels=2, capacity=4, latent_dim=8,
                                                   c_mults=(2, 4), strides=strides), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(z))
    assert _rel_err(got.numpy(), want) < TOL


def test_audio_autoencoder_encode_decode():
    x = _randn(2, 2, 256, seed=2)
    jm = jae.AudioAutoencoder(**AE)
    tree = rand_tree(jm, 2, jnp.asarray(x))
    z_j, y_j = jm.apply({"params": tree}, jnp.asarray(x))
    tm = load_flax_params(tae.AudioAutoencoder(**AE), tree)
    with torch.no_grad():
        z_t = tm.encode(torch.from_numpy(x))
        y_t = tm.decode(z_t)
    assert tm.downsampling_ratio == 8
    assert _rel_err(z_t.numpy(), z_j) < TOL
    assert _rel_err(y_t.numpy(), y_j) < TOL


def test_encoder1d():
    x = _randn(2, 8, 64, seed=3)
    jm = jenc.Encoder1d(**ENC)
    tree = rand_tree(jm, 3, jnp.asarray(x))
    want = jm.apply({"params": tree}, jnp.asarray(x))
    tm = load_flax_params(tenc.Encoder1d(**ENC), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert _rel_err(got.numpy(), want) < TOL


def test_latent_diffae_methods():
    x = _randn(1, 2, 256, seed=4)
    t = np.array([0.6], np.float32)
    jm = jst.LatentAudioDiffusionAutoencoder(**LDAE)
    tree = rand_tree(jm, 4, jnp.asarray(x), jnp.asarray(t))
    tm = load_flax_params(tst.LatentAudioDiffusionAutoencoder(**LDAE), tree)
    assert tm.downsampling_ratio == jm.downsampling_ratio == 16
    p = {"params": tree}
    lat_j = jm.apply(p, jnp.asarray(x), method=jst.LatentAudioDiffusionAutoencoder.encode)
    first = _randn(1, 8, 64, seed=5)
    v_j = jm.apply(p, jnp.asarray(first), jnp.asarray(t), lat_j,
                   method=jst.LatentAudioDiffusionAutoencoder.diffusion_v)
    y_j = jm.apply(p, jnp.asarray(first),
                   method=jst.LatentAudioDiffusionAutoencoder.decode_first_stage)
    with torch.no_grad():
        lat_t = tm.encode(torch.from_numpy(x))
        v_t = tm.diffusion_v(torch.from_numpy(first), torch.from_numpy(t),
                             torch.from_numpy(np.array(lat_j)))
        y_t = tm.decode_first_stage(torch.from_numpy(first))
    assert _rel_err(lat_t.numpy(), lat_j) < TOL
    assert _rel_err(v_t.numpy(), v_j) < TOL
    assert _rel_err(y_t.numpy(), y_j) < TOL
