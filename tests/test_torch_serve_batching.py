"""The port's service beyond its generate and embed routes, on the CPU,
against the JAX service's contract (tests/test_serve.py): the magic-byte sniff, the
micro-batcher coalescing concurrent requests into one generate (the group
at its own size: no power-of-two padding), the GUI page, basic auth from
MIRAGE_USERNAME / MIRAGE_PASSWORD, FLAC and OGG bodies on /embed reaching
the right decoder, and the CLI's refusal of JAX's XLA-only switches."""
import base64
import http.client
import json
import threading

import numpy as np
import pytest
import torch

from audio_algebra_tpu import serve as jserve
from audio_algebra_torch import serve as tserve
from audio_algebra_torch.given_models import CLAPDAE
from audio_algebra_torch.models import clap as tclap
from audio_algebra_torch.utils import audio_io as tio
from audio_algebra_torch.utils.flac_write import write_flac

FIRST_STAGE = {"capacity": 4, "c_mults": [2, 4], "strides": [2, 2], "latent_dim": 8}
MODEL_KWARGS = dict(second_stage_latent_dim=4, factors=(2, 2), latent_channels=8,
                    latent_multipliers=(1, 2, 2), latent_num_blocks=(1, 1),
                    diffusion_c_mults=(8, 16), diffusion_depth=2, channels=8,
                    multipliers=(1, 2), factors2=(2,), num_blocks=(1,),
                    attentions=(0, 1), attention_heads=2, attention_features=16)


def _model(seed=3):
    return CLAPDAE(sample_size=4096, first_stage_config=FIRST_STAGE, model_kwargs=MODEL_KWARGS,
                   device="cpu", seed=seed,
                   clap_kwargs=dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG),
                                    text_cfg=dict(tclap.TINY_TEXT_CFG)))


@pytest.fixture(scope="module")
def model():
    return _model()


def _serve(service):
    srv = tserve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _conn(srv):
    return http.client.HTTPConnection(*srv.server_address, timeout=300)


def _unit(i):
    e = np.zeros(512)
    e[i] = 1.0
    return e.tolist()


@pytest.mark.parametrize("data,suffix", [(b"RIFF....WAVE", ".wav"), (b"fLaC\x00", ".flac"),
                                         (b"OggS\x00", ".ogg"), (b"ID3\x04", ".mp3"),
                                         (b"\xff\xfb\x90", ".mp3"), (b"", ".mp3")])
def test_sniff_suffix_matches_jax(data, suffix):
    assert tserve._sniff_suffix(data) == jserve._sniff_suffix(data) == suffix


def test_micro_batcher_coalesces_concurrent_requests(model):
    service = tserve.MirageService(model=model, verbose=False, batch_window_s=0.5,
                                   max_batch=8)
    calls = []
    real = model.generate

    def spy(emb, **kw):
        calls.append((tuple(torch.as_tensor(emb).shape), kw["batch_size"]))
        return real(emb, **kw)

    model.generate = spy
    try:
        spec = {"embeddings": [_unit(3)], "steps": 2, "outer_steps": 2}
        results, errors = [None] * 3, []

        def worker(i):
            try:
                results[i] = service.generate_wav(dict(spec, embeddings=[_unit(3 + i)]))
            except Exception as exc:             # surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not errors and all(r is not None for r in results)
        # one generate of the group at its own size (3), not padded to 4
        assert calls == [((3, 1, 512), 3)]
        h = service.health()
        assert h["batched_runs"] == 1 and h["coalesced_requests"] == 3
        assert h["requests_served"] == 3
        pcms = [np.frombuffer(r[0][44:], "<i2") for r in results]
        assert any(not np.array_equal(pcms[0], p) for p in pcms[1:])
        # a seeded request, and one of another sampler config, bypass or
        # start their own group
        service.generate_wav(dict(spec, seed=11))
        assert service.batcher.coalesced_requests == 3 and len(calls) == 2
        service.generate_wav(dict(spec, steps=1))
        assert service.batcher.batched_runs == 2 and calls[-1] == ((1, 1, 512), 1)
    finally:
        model.generate = real


def test_micro_batcher_hands_a_failure_to_every_request(model):
    service = tserve.MirageService(model=model, verbose=False, batch_window_s=0.01)

    def broken(*a, **k):
        raise RuntimeError("card lost")

    real, model.generate = model.generate, broken
    try:
        with pytest.raises(RuntimeError, match="card lost"):
            service.generate_wav({"embeddings": [_unit(1)], "steps": 2, "outer_steps": 2})
    finally:
        model.generate = real
    assert tserve.MirageService(model=model, verbose=False).batcher is None


def test_gui_page_and_health_over_http(model):
    srv, thread = _serve(tserve.MirageService(model=model, verbose=False, batch_window_s=0.05))
    try:
        c = _conn(srv)
        c.request("GET", "/")
        r = c.getresponse()
        body = r.read()
        assert r.status == 200 and r.getheader("Content-Type").startswith("text/html")
        assert body == jserve._GUI_HTML.encode()
        c = _conn(srv)
        c.request("GET", "/health")
        h = json.loads(c.getresponse().read())
        assert h["ok"] and h["batched_runs"] == 0 and h["coalesced_requests"] == 0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def test_basic_auth(model, monkeypatch):
    monkeypatch.setenv("MIRAGE_USERNAME", "alice")
    monkeypatch.setenv("MIRAGE_PASSWORD", "s3cret")
    srv, thread = _serve(tserve.MirageService(model=model, verbose=False))
    token = base64.b64encode(b"alice:s3cret").decode()
    try:
        c = _conn(srv)
        c.request("GET", "/health")                        # probes stay open
        assert c.getresponse().status == 200
        for method, path, body in (("GET", "/", None), ("POST", "/embed", b'{"text": "hi"}'),
                                   ("POST", "/generate", b"{}")):
            c = _conn(srv)
            c.request(method, path, body, {"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 401 and r.getheader("WWW-Authenticate").startswith("Basic")
            r.read()
        c = _conn(srv)
        c.request("POST", "/embed", b'{"text": "hi"}', {
            "Content-Type": "application/json",
            "Authorization": "Basic " + base64.b64encode(b"alice:wrong").decode()})
        assert c.getresponse().status == 401
        c = _conn(srv)
        c.request("POST", "/embed", b'{"text": "hi"}',
                  {"Content-Type": "application/json", "Authorization": f"Basic {token}"})
        r = c.getresponse()
        assert r.status == 200 and len(json.loads(r.read())["embedding"][0][0]) == 512
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


@pytest.mark.skipif(not tio.NATIVE_LIB.exists(), reason="native codec not built")
def test_embed_takes_flac_and_ogg_bodies(model, tmp_path):
    t = np.arange(24000) / 48000
    audio = np.stack([0.4 * np.sin(2 * np.pi * 330 * t), 0.3 * np.sin(2 * np.pi * 550 * t)])
    audio = audio.astype(np.float32)
    write_flac(str(tmp_path / "a.flac"), audio, 48000)
    tio.encode_ogg(str(tmp_path / "a.ogg"), audio, 48000)
    decoded = {".flac": tio.load_audio(str(tmp_path / "a.flac")),
               ".ogg": tio.load_audio(str(tmp_path / "a.ogg"))}
    srv, thread = _serve(tserve.MirageService(model=model, verbose=False))
    try:
        for name, suffix in (("a.flac", ".flac"), ("a.ogg", ".ogg")):
            data = (tmp_path / name).read_bytes()
            np.testing.assert_array_equal(tserve._decode_audio_bytes(data), decoded[suffix])
            c = _conn(srv)
            c.request("POST", "/embed", data, {"Content-Type": "application/octet-stream"})
            r = c.getresponse()
            assert r.status == 200, r.read()
            got = np.asarray(json.loads(r.read())["embedding"], np.float32)
            want = model.embed(decoded[suffix]).numpy()
            np.testing.assert_allclose(got, want, atol=1e-6)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


@pytest.mark.parametrize("flag,item", [(["--turbo"], "A8"), (["--mesh", "seq=4"], "A7")])
def test_cli_refuses_what_is_not_ported(flag, item, monkeypatch):
    """--turbo (A8) is ported and refused with --mesh only, at parsing (the
    sequence-parallel outer stage is float); --mesh seq=4 (A7) is ported,
    and outside a group of 4 processes it is refused with the torchrun
    line."""
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    if item == "A8":
        with pytest.raises(SystemExit) as exc:
            tserve.main([*flag, "--mesh", "seq=4", "--device", "cpu"])
        assert exc.value.code == 2
    else:
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 4 -m "
                                             "audio_algebra_torch.serve"):
            tserve.main([*flag, "--device", "cpu"])
