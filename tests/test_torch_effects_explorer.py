"""The port's effects_explorer against the JAX package's root script, on
the CPU: `effect_directions` and `fx2fx` against JAX's; the batched sweep
(one ops.effects call over a clip's knobs, then one encode of the stack)
against JAX's per-knob `apply_effect` + encode, through a tiny DVAE
holding JAX's weights (rel-RMS 1e-4; LowpassFilter runs R1's twin, held
at 1e-4 as tests/test_torch_effects.py holds it); `main` with --umap and
--fx2fx writing the files of JAX's end-to-end test."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import effects_explorer as jfx
from audio_algebra_tpu.ops import effects as jeffects
from audio_algebra_torch import effects_explorer as tfx
from audio_algebra_torch.utils.audio_io import write_wav
from test_torch_calc_effects_pca import DVAE, LATENT, SAMPLES, encoders  # noqa: F401

SR = 48000


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def test_effect_directions_and_fx2fx_match_jax():
    rng = np.random.default_rng(0)
    embs = {n: rng.standard_normal((2, k, 4, 6)).astype(np.float32)
            for n, k in (("Clean", 1), ("Gain", 3), ("Reverb", 3))}
    got, want = tfx.effect_directions(embs), jfx.effect_directions(embs)
    for part in ("means", "dirs"):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            np.testing.assert_array_equal(got[part][k], want[part][k])
    z = rng.standard_normal((2, 4, 6)).astype(np.float32)
    d = want["dirs"]["Clean->Gain"]
    np.testing.assert_array_equal(tfx.fx2fx(z, d, 0.5), jfx.fx2fx(z, d, 0.5))
    np.testing.assert_allclose(tfx.fx2fx(torch.from_numpy(z), d, 0.5).numpy(),
                               jfx.fx2fx(z, d, 0.5), rtol=1e-7)


@pytest.mark.parametrize("name", ["Gain", "LowpassFilter"])
def test_batched_sweep_matches_per_knob_jax(encoders, name):  # noqa: F811
    jencode, wrapper = encoders
    clips = (0.3 * np.random.default_rng(1).standard_normal((2, 2, SAMPLES))).astype(np.float32)
    got = tfx.sweep_embeddings(wrapper, clips, name, 2, SR)
    # jitted with the knob traced: eager, JAX's associative scan compiles
    # for seconds a call
    apply = jax.jit(lambda x, k: jeffects.apply_effect(name, x, k, SR))
    encode = jax.jit(jencode)
    want = np.stack([np.concatenate([np.asarray(encode(apply(jnp.asarray(clip), float(k))[None]))
                                     for k in jeffects.knob_sweep(name, 2)]) for clip in clips])
    assert got.shape == want.shape == (2, 2, LATENT, SAMPLES // 8)
    assert _rel_rms(got, want) < 1e-4, _rel_rms(got, want)


def test_main_writes_the_study(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(1)
    t = np.arange(SR // 3) / SR
    for i in range(3):
        x = 0.4 * np.sin(2 * np.pi * (220 + 110 * i) * t) + 0.02 * rng.standard_normal(t.size)
        write_wav(corpus / f"s{i}.wav", np.stack([x, x]).astype(np.float32), SR)
    cfg = tmp_path / "tiny_dvae.json"
    cfg.write_text(json.dumps({"model_kwargs": DVAE, "args_dict": {"latent_dim": LATENT}}))
    out = tmp_path / "fx_out"
    run = tfx.main(["--source-dir", str(corpus), "--out-dir", str(out), "--chunk-size",
                    str(SAMPLES), "--knob-steps", "2", "--max-clips", "2", "--effects",
                    "Clean,Gain", "--model-config", str(cfg), "--umap", "--umap-steps", "20",
                    "--fx2fx", "Clean,Gain", "--fx2fx-steps", "2", "--device", "cpu"])
    # the files tests/test_toy_and_scripts.py::test_effects_explorer_e2e
    # reads, the others JAX's script writes, and the FX2FX decode
    assert {p.name for p in out.iterdir()} == set(run["written"]) == {
        "embeddings.npz", "pca_cloud.npy", "effect_means.npz", "effect_dirs.npz",
        "labels.json", "umap_maps.npz", "fx2fx_Clean_to_Gain.wav"}
    embs = np.load(out / "embeddings.npz")
    assert embs["Clean"].shape == (2, 1, LATENT, SAMPLES // 8)
    assert embs["Gain"].shape == (2, 2, LATENT, SAMPLES // 8)
    assert np.load(out / "pca_cloud.npy").shape == (6, 3)
    assert "Clean->Gain" in np.load(out / "effect_dirs.npz").files
    maps = np.load(out / "umap_maps.npz")
    assert set(maps.files) == {"Clean", "Gain"}
    for m in maps.files:
        assert maps[m].shape[-1] == 2 and np.isfinite(maps[m]).all()
    assert json.loads((out / "labels.json").read_text()) == ["Clean"] * 2 + ["Gain"] * 4
