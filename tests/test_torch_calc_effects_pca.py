"""The port's calc_effects_pca against the JAX package's root script, on
the CPU: the streaming covariance step through a tiny DVAEWrapper holding
JAX's weights against `make_streaming_cov_step` over JAX's encode (the
accumulators within 1e-5 rel, the count equal); `finalize_cov` and
`sorted_eig` against JAX's; `main` on a two-file corpus."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calc_effects_pca as jpca
from audio_algebra_tpu.models.dvae import DiffusionDVAE as JDVAE
from audio_algebra_torch import calc_effects_pca as tpca
from audio_algebra_torch.aa_mixer import given_model_encode_fn
from audio_algebra_torch.given_models import DVAEWrapper
from audio_algebra_torch.utils.audio_io import write_wav
from test_torch_blocks import rand_tree

DVAE = dict(capacity=4, c_mults=(2, 4), strides=(4, 2), n_attn_layers=0,
            diffusion_c_mults=(8, 16))
LATENT, SAMPLES = 8, 2048


@pytest.fixture(scope="module")
def encoders():
    """(JAX encode fn, the port's wrapper) holding the same DVAE weights."""
    jdvae = JDVAE(latent_dim=LATENT, **DVAE)
    tree = rand_tree(jdvae, 0, jnp.zeros((1, 2, SAMPLES)), jnp.zeros((1,)))
    wrapper = DVAEWrapper(args_dict={"latent_dim": LATENT, "sample_size": SAMPLES},
                          model_kwargs=DVAE, device="cpu")
    wrapper.load_flax_params(tree)
    return (lambda x: jdvae.apply({"params": tree}, x, method=JDVAE.encode_it)), wrapper


def _batches():
    rng = np.random.default_rng(4)
    return [(0.4 * rng.standard_normal((3, 2, SAMPLES))).astype(np.float32) for _ in range(2)]


def test_streaming_step_matches_jax(encoders):
    jencode, wrapper = encoders
    jstep = jpca.make_streaming_cov_step(jencode)
    tstep = tpca.make_streaming_cov_step(given_model_encode_fn(wrapper))
    jacc = (jnp.zeros((LATENT, LATENT)), jnp.zeros((LATENT,)), jnp.zeros(()))
    tacc = (torch.zeros((LATENT, LATENT)), torch.zeros((LATENT,)), 0)
    for b in _batches():
        jacc = jstep(*jacc, jnp.asarray(b))
        tacc = tstep(*tacc, torch.from_numpy(b))
    for got, want in zip(tacc[:2], jacc[:2]):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert tacc[2] == int(jacc[2]) == 2 * 3 * SAMPLES // 8
    np.testing.assert_allclose(tpca.finalize_cov(*tacc), jpca.finalize_cov(*jacc),
                               rtol=1e-5, atol=1e-5 * np.abs(jpca.finalize_cov(*jacc)).max())


def test_finalize_and_sorted_eig_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((500, 5))
    cov_num, mean_num = x.T @ x, x.sum(0)
    got = tpca.finalize_cov(torch.from_numpy(cov_num).float(), torch.from_numpy(mean_num).float(),
                            500)
    want = jpca.finalize_cov(cov_num.astype(np.float32), mean_num.astype(np.float32), 500)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.cov(x.T), rtol=1e-5, atol=1e-6)
    for g, w in zip(tpca.sorted_eig(got), jpca.sorted_eig(want)):
        np.testing.assert_array_equal(g, w)
    vals, vecs = tpca.sorted_eig(np.diag([1.0, 5.0, 3.0]))
    np.testing.assert_allclose(vals, [5.0, 3.0, 1.0])
    assert abs(abs(vecs[1, 0]) - 1.0) < 1e-9


def test_main_on_a_two_file_corpus(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "wavs").mkdir()
    t = np.arange(6000) / 48000
    for i in range(2):
        tone = 0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t)
        write_wav(tmp_path / "wavs" / f"c{i}.wav", np.stack([tone, 0.5 * tone])
                  .astype(np.float32), 48000)
    (tmp_path / "dvae.json").write_text(json.dumps(
        {"model_kwargs": DVAE, "args_dict": {"latent_dim": LATENT}}))
    run = tpca.main(["--training_dir", str(tmp_path / "wavs"), "--batch_size", "1",
                     "--sample_size", str(SAMPLES), "--model_config",
                     str(tmp_path / "dvae.json"), "--num_workers", "0", "--device", "cpu"])
    assert run["batches"] == 2 and run["count"] == 2 * SAMPLES // 8
    cov = np.load(f"{run['run_dir']}/cov.npy")
    vals = np.load(f"{run['run_dir']}/eigvals.npy")
    assert cov.shape == (LATENT, LATENT) and np.allclose(cov, cov.T)
    assert (np.diff(vals) <= 1e-12).all() and vals[-1] > -1e-9
    log = [json.loads(line) for line in open(f"{run['run_dir']}/log.jsonl")]
    assert [r["step"] for r in log] == [0, 1] and "lambda00" in log[0]
