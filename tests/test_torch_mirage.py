"""The PyTorch port's MIRAGE slice as a whole against the JAX package:
CLAPDAE.generate (DPM++(2M) with CFG over the UNetCFG1d, whose attention
level has T = 1024 so that the port takes kernel K3's route; the outer
v-DDIM; the AE decode) on a tiny config with the same weights and the same
noise on both sides, with and without init-audio latents; the embedding
math; and the HTTP service on the CPU: embedding and text prompts, /embed
for text and for WAV bytes, and the strict-text refusal (409)."""
import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu import embedding_math as jem
from audio_algebra_tpu import given_models as jgm
from audio_algebra_tpu.models.clap import TINY_AUDIO_CFG, TINY_TEXT_CFG
from audio_algebra_tpu.utils.prng import host_split
from audio_algebra_torch import embedding_math as tem
from audio_algebra_torch import serve as tserve
from audio_algebra_torch.given_models import CLAPDAE
from audio_algebra_torch.models import clap as tclap
from audio_algebra_torch.utils.audio_io import write_wav
from test_torch_blocks import rand_tree

FIRST_STAGE = {"capacity": 4, "c_mults": [2, 4], "strides": [2, 2], "latent_dim": 8}
MODEL_KWARGS = dict(second_stage_latent_dim=4, factors=(2, 2), latent_channels=8,
                    latent_multipliers=(1, 2, 2), latent_num_blocks=(1, 1),
                    diffusion_c_mults=(8, 16), diffusion_depth=2, channels=8,
                    multipliers=(1, 2), factors2=(2,), num_blocks=(1,),
                    attentions=(0, 1), attention_heads=2, attention_features=16)
SAMPLES = 32768          # 2048 stage-2 latents: the attention level runs at T = 1024
TOL = 1e-4               # f32, relative to the output's peak


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _unit(rng, n=512):
    e = rng.standard_normal((1, 1, n)).astype(np.float32)
    return e / np.linalg.norm(e)


@pytest.fixture(scope="module")
def pair():
    """The JAX wrapper and the port's, holding the same random weights."""
    jw = jgm.CLAPDAE(sample_size=SAMPLES, first_stage_config=FIRST_STAGE,
                     model_kwargs=MODEL_KWARGS,
                     clap_kwargs=dict(audio_cfg=dict(**TINY_AUDIO_CFG),
                                      text_cfg=dict(**TINY_TEXT_CFG)))
    x = jnp.zeros((1, 2, 1024))
    diffae = rand_tree(jw.latent_diffae, 1, x, jnp.zeros((1,)))
    ldm = rand_tree(jw.latent_diffusion_model, 2, jnp.zeros((1, 4, 64)), jnp.zeros((1,)),
                    jnp.zeros((1, 1, 512)))
    jw.diffae_params, jw.ldm_params = {"params": diffae}, {"params": ldm}
    tw = CLAPDAE(sample_size=SAMPLES, first_stage_config=FIRST_STAGE,
                 model_kwargs=MODEL_KWARGS, device="cpu")
    tw.load_flax_params(diffae, ldm)
    return jw, tw


def _feed_host_normal(monkeypatch, arrays):
    queue = list(arrays)

    def fake(key, shape, dtype=None):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape)
        return arr

    monkeypatch.setattr(jgm, "host_normal", fake)
    return queue


def test_generate_matches_jax(monkeypatch, pair):
    jw, tw = pair
    rng = np.random.default_rng(0)
    emb = _unit(rng)
    latent_noise = rng.standard_normal((1, 4, SAMPLES // 16)).astype(np.float32)
    s1_noise = rng.standard_normal((1, 8, SAMPLES // 4)).astype(np.float32)
    left = _feed_host_normal(monkeypatch, [latent_noise, s1_noise])
    fakes_j, lat_j = jw.generate(jnp.asarray(emb), cfg_scales=2, demo_steps=3,
                                 outer_steps=2)
    assert not left
    fakes_t, lat_t = tw.generate(emb, cfg_scales=2, demo_steps=3, outer_steps=2,
                                 latent_noise=latent_noise, s1_noise=s1_noise)
    assert fakes_t.shape == (2, SAMPLES)
    assert _rel_err(lat_t.numpy(), lat_j) < TOL
    assert _rel_err(fakes_t.numpy(), fakes_j) < TOL


def test_generate_from_init_audio_matches_jax(monkeypatch, pair):
    jw, tw = pair
    rng = np.random.default_rng(1)
    emb = _unit(rng)
    audio = (0.3 * rng.standard_normal((1, 2, SAMPLES))).astype(np.float32)
    init_j = jw.encode_audio_latents(jnp.asarray(audio))
    init_t = tw.encode_audio_latents(audio)
    assert _rel_err(init_t.numpy(), init_j) < TOL
    _, key = host_split(jw._key)          # the key generate() draws its noise from
    init_noise = np.array(jax.random.normal(key, init_j.shape, jnp.float32))
    s1_noise = rng.standard_normal((1, 8, SAMPLES // 4)).astype(np.float32)
    _feed_host_normal(monkeypatch, [s1_noise])
    fakes_j, lat_j = jw.generate(jnp.asarray(emb), cfg_scales=2, demo_steps=3,
                                 outer_steps=2, init_audio_latents=init_j,
                                 init_strength=0.5)
    fakes_t, lat_t = tw.generate(emb, cfg_scales=2, demo_steps=3, outer_steps=2,
                                 init_audio_latents=np.array(init_j), init_strength=0.5,
                                 init_noise=init_noise, s1_noise=s1_noise)
    assert _rel_err(lat_t.numpy(), lat_j) < TOL
    assert _rel_err(fakes_t.numpy(), fakes_j) < TOL


def test_embedding_math_matches_jax():
    rng = np.random.default_rng(2)
    a, b, c = _unit(rng), _unit(rng), _unit(rng)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(tem.slerp(a, b, t).numpy(),
                                   np.asarray(jem.slerp(a, b, t)), atol=1e-6)
        np.testing.assert_allclose(tem.interp_embeddings(a, b, t, "lerp").numpy(),
                                   np.asarray(jem.interp_embeddings(a, b, t, "lerp")),
                                   atol=1e-6)
    np.testing.assert_allclose(tem.slerp(a, a, 0.5).numpy(), a, atol=1e-6)
    got = tem.weighted_algebra([a, torch.from_numpy(b), c], [1.0, -0.5, 0.25])
    want = jem.weighted_algebra([a, b, c], [1.0, -0.5, 0.25])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _small_service(strict_text: bool = False):
    model = CLAPDAE(sample_size=4096, first_stage_config=FIRST_STAGE,
                    model_kwargs=MODEL_KWARGS, device="cpu", seed=3,
                    clap_kwargs=dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG),
                                     text_cfg=dict(tclap.TINY_TEXT_CFG)))
    return tserve.MirageService(model=model, verbose=False, strict_text=strict_text)


def _wav_info(data: bytes):
    with wave.open(io.BytesIO(data)) as w:
        return w.getnchannels(), w.getframerate(), w.getnframes()


def test_service_generate_wav_and_checks(tmp_path):
    svc = _small_service()
    rng = np.random.default_rng(4)
    spec = {"embeddings": [_unit(rng).ravel().tolist(), _unit(rng).ravel().tolist()],
            "algebra": True, "weights": [1.0, -0.5], "steps": 2, "outer_steps": 1,
            "batch_size": 2, "seed": 7}
    wav, info = svc.generate_wav(spec)
    assert _wav_info(wav) == (2, 48000, info["samples"])
    assert info["samples"] == 2 * 4096 - 4096 // 2          # one crossfade
    again, _ = svc.generate_wav(spec)
    assert again == wav                                    # seeded
    for bad in ({"steps": 0}, {"batch_size": 9}, {"cfg_scale": float("nan")}, {}):
        with pytest.raises(ValueError):
            svc.generate_wav({**({"embeddings": spec["embeddings"][:1]} if bad else {}),
                              **bad})
    with pytest.warns(UserWarning, match="byte-level"):
        wav, info = svc.generate_wav({"text": ["low brass"], "steps": 2, "outer_steps": 1,
                                      "seed": 1})
    assert _wav_info(wav) == (2, 48000, 4096)
    assert "byte-level fallback" in info["tokenizer_warning"]
    mono = (0.2 * rng.standard_normal((1, 3000))).astype(np.float32)   # looped, doubled
    write_wav(tmp_path / "init.wav", mono, 48000)
    init_b64 = base64.b64encode((tmp_path / "init.wav").read_bytes()).decode()
    wav, info = svc.generate_wav({"embeddings": spec["embeddings"][:1], "steps": 3,
                                  "outer_steps": 1, "init_strength": 0.5,
                                  "init_audio_b64": init_b64})
    assert info["samples"] == 4096 and _wav_info(wav)[2] == 4096
    assert svc.requests_served == 4


def test_http_server_answers():
    svc = _small_service()
    server = tserve.make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["sample_size"] == 4096
        emb = _unit(np.random.default_rng(5)).ravel().tolist()
        body = json.dumps({"embeddings": [emb], "steps": 2, "outer_steps": 1}).encode()
        req = urllib.request.Request(f"{base}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
            assert _wav_info(r.read()) == (2, 48000, 4096)
        body = json.dumps({"text": "piano", "steps": 2, "outer_steps": 1}).encode()
        with urllib.request.urlopen(urllib.request.Request(f"{base}/generate", data=body),
                                    timeout=120) as r:
            assert r.status == 200 and _wav_info(r.read()) == (2, 48000, 4096)
            assert "tokenizer_warning" in json.loads(r.headers["X-Generate-Info"])
        req = urllib.request.Request(f"{base}/embed", data=json.dumps({"text": "x"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
        assert np.asarray(answer["embedding"]).shape == (1, 1, 512)
        assert "byte-level fallback" in answer["tokenizer_warning"]
        clip = io.BytesIO()
        with wave.open(clip, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(48000)
            w.writeframes((np.sin(np.arange(6000) / 9.0) * 8000).astype("<i2").tobytes())
        with urllib.request.urlopen(urllib.request.Request(f"{base}/embed",
                                                           data=clip.getvalue()),
                                    timeout=60) as r:
            answer = json.loads(r.read())
        emb = np.asarray(answer["embedding"])
        assert emb.shape == (1, 1, 512) and "tokenizer_warning" not in answer
        np.testing.assert_allclose(np.linalg.norm(emb), 1.0, atol=1e-5)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_entry_points_want_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLAPDAE(first_stage_config=FIRST_STAGE, model_kwargs=MODEL_KWARGS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.MirageService(verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tclap.CLAPModule()


def test_strict_text_refuses_text_prompts_with_409():
    svc = _small_service(strict_text=True)
    assert svc.health()["text_tokenizer"] == "byte-fallback" and svc.health()["strict_text"]
    with pytest.raises(tserve.TokenizerUnavailable):
        svc.generate_wav({"text": ["low brass"], "steps": 2, "outer_steps": 1})
    assert svc.requests_served == 0
    server = tserve.make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for path in ("/generate", "/embed"):
            req = urllib.request.Request(f"{base}{path}", data=json.dumps(
                {"text": "piano", "steps": 2, "outer_steps": 1}).encode())
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 409
            assert json.loads(err.value.read())["error"] == "text_tokenizer_unavailable"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
