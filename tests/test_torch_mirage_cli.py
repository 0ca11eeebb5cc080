"""The port's MIRAGE command line (audio_algebra_torch/mirage.py) on the CPU:
the audio-tuple marshalling against the root app's (tests/test_apps.py),
the model cache, `process_audio` end to end on a tiny config (slerp and
algebra, an audio prompt, init audio) with its WAV and PCA files, the PCA
cloud and its HTML against the JAX package's on the same latents, and
`python -m audio_algebra_torch.mirage ... --device cpu` as a user runs it."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mirage as jmirage
from audio_algebra_tpu.utils import viz as jviz
from audio_algebra_torch import embedding_math, mirage
from audio_algebra_torch.models import clap as tclap
from audio_algebra_torch.utils import viz as tviz
from audio_algebra_torch.utils.audio_io import read_wav, write_wav

ROOT = Path(__file__).resolve().parents[1]
SAMPLES = 4096
TINY = dict(sample_size=SAMPLES,
            first_stage_config={"capacity": 4, "c_mults": [2, 4], "strides": [2, 2],
                                "latent_dim": 8},
            model_kwargs=dict(second_stage_latent_dim=4, factors=[2, 2], latent_channels=8,
                              latent_multipliers=[1, 2, 2], latent_num_blocks=[1, 1],
                              diffusion_c_mults=[8, 16], diffusion_depth=2, channels=8,
                              multipliers=[1, 2], factors2=[2], num_blocks=[1],
                              attentions=[0, 1], attention_heads=2, attention_features=16),
            clap_kwargs=dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG),
                             text_cfg=dict(tclap.TINY_TEXT_CFG)))


@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(embedding_math, "_model_cache", {})


def test_unpack_repack_match_the_root_app():
    rng = np.random.default_rng(0)
    for pcm, sr in (((rng.standard_normal((1000, 2)) * 8000).astype(np.int16), 48000),
                    ((rng.standard_normal(700) * 1e8).astype(np.int32), 48000),
                    (rng.integers(0, 255, (500, 2)).astype(np.uint8), 48000),
                    (np.zeros(44100, np.float32), 44100),
                    ((rng.standard_normal((441, 2)) * 0.3).astype(np.float32), 44100)):
        got, info = mirage.unpack_audio_tup((sr, pcm), verbose=False)
        want, jinfo = jmirage.unpack_audio_tup((sr, pcm), verbose=False)
        assert info == jinfo and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6)
        back = mirage.repack_audio_tup(got, info, verbose=False)
        jback = jmirage.repack_audio_tup(want, jinfo, verbose=False)
        assert back[0] == jback[0] == 48000
        np.testing.assert_array_equal(back[1], jback[1])
    assert mirage.unpack_audio_tup(None) == (None, None)
    pcm = (rng.standard_normal((1000, 2)) * 8000).astype(np.int16)
    audio, info = mirage.unpack_audio_tup((48000, pcm), verbose=False)
    np.testing.assert_allclose(mirage.repack_audio_tup(audio, info, verbose=False)[1], pcm,
                               atol=2)


def test_pca_cloud_and_html_match_jax():
    z = np.random.default_rng(1).standard_normal((2, 8, 64)).astype(np.float32)
    for mean_axis in (None, -1):
        got = tviz.pca_point_cloud(torch.from_numpy(z), mean_axis=mean_axis)
        want = jviz.pca_point_cloud(z, mean_axis=mean_axis)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    cloud = jviz.pca_point_cloud(z, mean_axis=None)
    assert tviz.point_cloud_html(cloud, title="t") == jviz.point_cloud_html(cloud, title="t")
    with pytest.raises(ValueError):
        tviz.point_cloud_html(np.zeros((4, 2)))


def test_model_cache_is_keyed_by_request(fresh_cache):
    a = embedding_math.get_model_ready("22s", device="cpu", verbose=False, half=False, **TINY)
    assert embedding_math.get_model_ready("22s", device="cpu", verbose=False, half=False,
                                          **TINY) is a
    b = embedding_math.get_model_ready("22s", device="cpu", verbose=False, half=True, **TINY)
    assert b is not a and b.dtype == torch.bfloat16 and a.dtype == torch.float32
    # another configuration is another model, never the cached one
    longer = dict(TINY, sample_size=2 * SAMPLES)
    assert embedding_math.model_cache_key("22s", False, "cpu", **longer) not in \
        embedding_math._model_cache
    assert set(embedding_math._model_cache) == {
        embedding_math.model_cache_key("22s", half, "cpu", **TINY) for half in (False, True)}
    # the key orders the configuration's keys and names the resolved device
    assert (embedding_math.model_cache_key("22s", True, torch.device("cpu"),
                                           **dict(reversed(list(TINY.items()))))
            == embedding_math.model_cache_key("22s", True, "cpu", **TINY))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            embedding_math.get_model_ready("22s", verbose=False, **TINY)


def test_process_audio_end_to_end(fresh_cache, tmp_path):
    rng = np.random.default_rng(2)
    tone = (0.3 * np.sin(2 * np.pi * 220 * np.arange(3000) / 44100)).astype(np.float32)
    common = dict(demo_steps=2, outer_steps=2, model_kwargs=TINY, device="cpu",
                  verbose=False)
    wav, pca, out = mirage.process_audio(
        audio_tups=[(44100, tone)], text_prompts=["low brass", "warm pad"],
        batch_size=2, seed=5, output_dir=str(tmp_path / "a"), **common)
    audio, sr = read_wav(wav)
    assert sr == 48000 and audio.shape == (2, 2 * SAMPLES - SAMPLES // 2)   # one crossfade
    assert out.shape == audio.shape and np.isfinite(out).all()
    cloud = np.load(pca)
    assert cloud.shape == (2 * SAMPLES // 16, 3) and np.isfinite(cloud).all()
    assert "<canvas" in (tmp_path / "a" / "mirage_latents_pca.html").read_text()
    # the same seed gives the same take; algebra and init audio run too
    _, _, again = mirage.process_audio(
        audio_tups=[(44100, tone)], text_prompts=["low brass", "warm pad"],
        batch_size=2, seed=5, output_dir=str(tmp_path / "b"), **common)
    np.testing.assert_array_equal(again, out)
    _, _, alg = mirage.process_audio(text_prompts=["a", "b"], weights=[1.0, -0.5],
                                     use_algebra=True, output_dir=str(tmp_path / "c"),
                                     save_pca=False, **common)
    assert alg.shape == (2, SAMPLES) and not (tmp_path / "c" / "mirage_latents_pca.npy").exists()
    init = (48000, (0.2 * rng.standard_normal((1500, 2))).astype(np.float32))
    _, _, img = mirage.process_audio(text_prompts=["a"], init_audio_tup=init, batch_size=2,
                                     init_strength=0.5, output_dir=str(tmp_path / "d"),
                                     **common)
    assert img.shape == (2, SAMPLES)          # the img2img path makes one take a clip
    with pytest.raises(ValueError, match="no inputs"):
        mirage.process_audio(output_dir=str(tmp_path / "e"), **common)


def test_xla_only_switches_are_refused(fresh_cache, monkeypatch):
    """--turbo is ported and refused with --mesh only (the sequence-parallel
    outer stage is float); --mesh seq=4 is ported and, outside a group of
    4, says how to launch; --mesh with --init-audio is refused as JAX
    refuses it."""
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit) as exc:
        mirage.main(["--text", "a", "--turbo", "--mesh", "seq=4", "--device", "cpu"])
    assert exc.value.code == 2
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4 -m "
                                         "audio_algebra_torch.mirage"):
        mirage.main(["--text", "a", "--mesh", "seq=4", "--device", "cpu"])
    with pytest.raises(ValueError, match="does not support --init-audio"):
        mirage.process_audio(text_prompts=["a"], init_audio_tup=(48000, np.zeros(16)),
                             mesh_spec="seq=1", device="cpu")
    with pytest.raises(ValueError, match="'seq' axis"):
        mirage.process_audio(text_prompts=["a"], mesh_spec="data=1", device="cpu")


def test_gui_without_gradio_says_so(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "gradio", None)
    assert mirage.main(["--gui", "--device", "cpu"]) == {}
    assert "gradio is not installed" in capsys.readouterr().out


def test_examples_csv_and_hosting_page(tmp_path):
    csv = tmp_path / "ex.csv"
    csv.write_text("# a comment\na.wav,,low brass,None,0.5,4,150,-1\n")
    assert mirage.load_examples_csv(str(csv)) == jmirage.load_examples_csv(str(csv))
    html = mirage.save_html_hosting_info("https://x.example", str(tmp_path / "m.html"))
    assert html == jmirage.save_html_hosting_info("https://x.example", str(tmp_path / "j.html"))


def test_cli_as_a_user_runs_it(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    write_wav(str(tmp_path / "in.wav"),
              (0.3 * np.sin(np.arange(5000) / 9.0)).astype(np.float32)[None], 48000)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "audio_algebra_torch.mirage", "--text", "a", "--text", "b",
         "--audio", str(tmp_path / "in.wav"), "--device", "cpu", "--model-config", str(cfg),
         "--steps", "2", "--outer-steps", "2", "--seed", "1",
         "--output-dir", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    audio, sr = read_wav(result["wav"])
    assert sr == 48000 and audio.shape == (2, SAMPLES)
    assert np.load(result["pca"]).shape == (SAMPLES // 16, 3)
