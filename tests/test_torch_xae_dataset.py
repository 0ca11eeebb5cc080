"""The port's XAE corpus factory (audio_algebra_torch/xae_dataset.py) against
the root app's `xae_dataset.main` on the same two tiny source files (a
FLAC and an OGG): the manifests equal, clips.npy and every fx_*.npy within
the effect bank's tolerances (tests/test_torch_effects.py), on the CPU; the
--encode step through the port's DVAEWrapper on a tiny config; and the
command as a user runs it, which wants a card unless given --device cpu."""
import json
import sys

import numpy as np
import pytest
import torch

import xae_dataset as jxae
from audio_algebra_torch import xae_dataset as txae
from audio_algebra_torch.given_models import DVAEWrapper
from audio_algebra_torch.utils import audio_io as tio
from audio_algebra_torch.utils.flac_write import write_flac
from test_torch_effects import TOL

pytestmark = pytest.mark.skipif(not tio.NATIVE_LIB.exists(),
                                reason="native codec not built (make -C native)")
EFFECTS = ",".join(TOL)
CHUNK = 4096


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    src = tmp_path_factory.mktemp("xae_src")
    rng = np.random.default_rng(0)
    t = np.arange(9000) / 44100
    x = np.stack([0.4 * np.sin(2 * np.pi * 220 * t), 0.3 * np.sin(2 * np.pi * 330 * t)])
    x = np.clip(x + 0.05 * rng.standard_normal((2, 9000)), -1, 1).astype(np.float32)
    write_flac(str(src / "a.flac"), x, 44100)
    tio.encode_ogg(str(src / "b.ogg"), x[:, ::-1].copy() * 0.5, 44100)
    return src


def _argv(src, out, *extra):
    return ["--source-dir", str(src), "--out-dir", str(out), "--chunk-size", str(CHUNK),
            "--knob-steps", "3", "--effects", EFFECTS, *extra]


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30)))


def test_main_matches_jax(sources, tmp_path, monkeypatch):
    monkeypatch.setattr(txae, "SWEEP_CLIPS", 3)          # two calls over the 4 clips
    summary = txae.main(_argv(sources, tmp_path / "t", "--device", "cpu"))
    monkeypatch.setattr(sys, "argv", ["xae_dataset.py", *_argv(sources, tmp_path / "j")])
    jxae.main()
    got = json.loads((tmp_path / "t" / "manifest.json").read_text())
    want = json.loads((tmp_path / "j" / "manifest.json").read_text())
    assert got == want
    assert summary["rows"] == len(want["rows"])
    clips = np.load(tmp_path / "t" / "clips.npy")
    np.testing.assert_allclose(clips, np.load(tmp_path / "j" / "clips.npy"), rtol=1e-5,
                               atol=1e-7)
    assert clips.shape == (4, 2, CHUNK)                # 2 files x 2 chunks of 9,796 samples
    for name in TOL:
        a = np.load(tmp_path / "t" / f"fx_{name}.npy")
        b = np.load(tmp_path / "j" / f"fx_{name}.npy")
        assert a.shape == b.shape == (4, 1 if name in ("Clean", "TimeReverse") else 3, 2, CHUNK)
        assert rel_rms(a, b) <= TOL[name], name


def test_encode_writes_each_effect_banks_latents(sources, tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model_kwargs": {"capacity": 4, "c_mults": [2, 4],
                                                "strides": [4, 2], "n_attn_layers": 0,
                                                "diffusion_c_mults": [8, 16]},
                               "args_dict": {"latent_dim": 8}}))
    out = tmp_path / "o"
    summary = txae.main(_argv(sources, out, "--device", "cpu", "--effects", "Clean,Gain",
                              "--normalize", "maxabs", "--encode", "--encode-batch", "5",
                              "--model-config", str(cfg)))
    fx = np.load(out / "fx_Gain.npy")
    emb = np.load(out / "emb_Gain.npy")
    assert summary["embeddings"]["Gain"] == emb.shape and emb.shape[:3] == (4, 3, 8)
    w = DVAEWrapper(args_dict={"sample_size": CHUNK, "latent_dim": 8}, device="cpu",
                    model_kwargs={"capacity": 4, "c_mults": [2, 4], "strides": [4, 2],
                                  "n_attn_layers": 0, "diffusion_c_mults": [8, 16]})
    w.setup(gdrive=False)
    want = w.encode(torch.from_numpy(fx.reshape(-1, 2, CHUNK))).numpy()
    np.testing.assert_allclose(emb.reshape(want.shape), want, rtol=1e-5, atol=1e-6)
    peak = np.abs(np.load(out / "clips.npy")).max()
    assert abs(peak - 0.95) < 1e-6                     # maxabs: each file to 0.95


def test_entry_point_wants_a_card_unless_asked(sources, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        txae.main(_argv(sources, tmp_path / "x"))
