"""The port's spans (audio_algebra_torch.tracing) on tiny models: off, every
site gets the shared no-op context and nothing is kept; on, the spans nest
dvae.decode > vddim.step > unet.stack_NNN, request ids follow a request
through the micro-batcher's thread, outputs keep their bits either way,
and `CLAPDAE.last_stage_times` comes from the stage spans. The card's
device intervals: the `cuda` test. The file imports no JAX."""
import threading

import numpy as np
import pytest
import torch

from audio_algebra_torch import serve as tserve
from audio_algebra_torch import tracing
from audio_algebra_torch.given_models import CLAPDAE, DVAEWrapper
from audio_algebra_torch.models import clap as tclap

DVAE_KWARGS = dict(capacity=2, c_mults=(2, 2), strides=(2, 2), n_attn_layers=1,
                   diffusion_c_mults=(8, 16, 16))
DEPTH = len(DVAE_KWARGS["diffusion_c_mults"])
FIRST_STAGE = {"capacity": 4, "c_mults": [2, 4], "strides": [2, 2], "latent_dim": 8}
CLAP_KWARGS = dict(second_stage_latent_dim=4, factors=(2, 2), latent_channels=8,
                   latent_multipliers=(1, 2, 2), latent_num_blocks=(1, 1),
                   diffusion_c_mults=(8, 16), diffusion_depth=2, channels=8,
                   multipliers=(1, 2), factors2=(2,), num_blocks=(1,),
                   attentions=(0, 1), attention_heads=2, attention_features=16)
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)             # the tiny models' ops: a pool only costs
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def dvae():
    return DVAEWrapper(args_dict={"sample_size": 256, "latent_dim": 4, "demo_steps": STEPS},
                       model_kwargs=DVAE_KWARGS, device="cpu")


@pytest.fixture(scope="module")
def clapdae():
    return CLAPDAE(sample_size=4096, first_stage_config=FIRST_STAGE, model_kwargs=CLAP_KWARGS,
                   device="cpu", seed=3,
                   clap_kwargs=dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG),
                                    text_cfg=dict(tclap.TINY_TEXT_CFG)))


def _destructo(w, noise):
    z = w.encode(torch.linspace(-0.5, 0.5, 2 * 2 * 256).reshape(2, 2, 256))
    w.noise = noise
    return z, w.decode(-z)


def _noises(m, batch):
    g = torch.Generator().manual_seed(5)
    n = m.demo_samples // m.downsampling_ratio
    la = m.latent_diffae
    return {"latent_noise": torch.randn((batch, m.latent_dim, n), generator=g),
            "s1_noise": torch.randn((batch, la.latent_dim, n * la.latent_downsampling_ratio),
                                    generator=g)}


def _unit(i):
    e = np.zeros((1, 1, 512), np.float32)
    e[..., i] = 1.0
    return e


def test_off_every_site_gets_the_shared_null_and_nothing_is_kept(dvae, monkeypatch):
    got, real = [], tracing.span
    monkeypatch.setattr(tracing, "span", lambda *a, **k: got.append(real(*a, **k)) or got[-1])
    _destructo(dvae, torch.randn(2, 2, 256))
    assert len(got) == 2 + STEPS * (1 + 2 * DEPTH)
    assert all(c is tracing.NULL for c in got)
    assert tracing.drain() == []


def test_spans_nest_decode_steps_and_stacks(dvae, monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("a span synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    tracing.enable()
    with tracing.request(41):
        _destructo(dvae, torch.randn(2, 2, 256))
    tracing.disable()
    rows = tracing.drain()
    by = {}
    for r in rows:
        by.setdefault(r["name"].split("_")[0] if r["name"].startswith("unet.") else r["name"],
                      []).append(r)
    (enc,), (dec,) = by["dvae.encode"], by["dvae.decode"]
    assert enc["parent"] is None and dec["parent"] is None
    steps = sorted(by["vddim.step"], key=lambda r: r["step"])
    assert [r["step"] for r in steps] == list(range(STEPS))
    assert all(r["parent"] == dec["id"] for r in steps)
    for s in steps:
        stacks = sorted((r for r in by["unet.stack"] if r["parent"] == s["id"]),
                        key=lambda r: r["t0_ns"])
        assert [r["name"] for r in stacks] == [f"unet.stack_{i:03d}" for i in range(2 * DEPTH)]
        assert all(s["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= s["t1_ns"] for r in stacks)
    assert len(by["unet.stack"]) == STEPS * 2 * DEPTH
    assert all(r["requests"] == [41] and r["device_ms"] is None for r in rows)


def test_tracing_keeps_the_outputs_bits(dvae, clapdae):
    noise = torch.randn(2, 2, 256)
    z_off, off = _destructo(dvae, noise)
    tracing.enable()
    z_on, on = _destructo(dvae, noise)
    tracing.disable()
    assert torch.equal(z_off, z_on) and torch.equal(off, on)
    tracing.drain()

    emb = np.concatenate([_unit(3), _unit(9)])
    kw = dict(demo_steps=2, outer_steps=1, batch_size=2, **_noises(clapdae, 2))
    a_off, l_off = clapdae.generate(emb, **kw)
    assert clapdae.last_stage_times == {}
    tracing.enable()
    a_on, l_on = clapdae.generate(emb, **kw)
    tracing.disable()
    assert torch.equal(a_off, a_on) and torch.equal(l_off, l_on)
    names = [r["name"] for r in tracing.drain()]
    assert names.count("kdiff.step") == 2 and names.count("vddim.step") == 1
    assert names.count("clapdae.generate") == 1 and names.count("clapdae.inner") == 1


def test_last_stage_times_come_from_the_stage_spans(clapdae, monkeypatch):
    monkeypatch.setattr(clapdae, "decode_batch", 1)
    kw = dict(demo_steps=1, outer_steps=1, batch_size=2, stage_times=True,
              **_noises(clapdae, 2))
    clapdae.generate(np.concatenate([_unit(3), _unit(9)]), **kw)
    assert set(clapdae.last_stage_times) == {"inner_s", "outer_s", "decode_s"}
    assert all(v > 0 for v in clapdae.last_stage_times.values())
    assert tracing.drain() == []                      # kept for the caller only
    tracing.enable()
    clapdae.generate(np.concatenate([_unit(3), _unit(9)]), **kw)
    tracing.disable()
    rows = tracing.drain()
    for name, key, n in (("clapdae.inner", "inner_s", 1), ("clapdae.outer", "outer_s", 2),
                         ("clapdae.ae_decode", "decode_s", 2)):
        mine = [r for r in rows if r["name"] == name]
        assert len(mine) == n                         # one outer / decode a micro-batch
        assert clapdae.last_stage_times[key] == pytest.approx(
            sum((r["t1_ns"] - r["t0_ns"]) * 1e-9 for r in mine))


def test_request_ids_follow_the_micro_batcher(clapdae):
    service = tserve.MirageService(model=clapdae, verbose=False, batch_window_s=0.5)
    spec = {"steps": 1, "outer_steps": 1}
    errors = []

    def client(i):
        try:
            service.generate_wav(dict(spec, embeddings=[_unit(3 + i).ravel().tolist()]))
        except Exception as exc:              # surfaced below
            errors.append(exc)

    tracing.enable()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    tracing.disable()
    assert not errors and not any(t.is_alive() for t in threads)
    rows = tracing.drain()
    named = {}
    for r in rows:
        named.setdefault(r["name"], []).append(r)
    ids = sorted(r["requests"][0] for r in named["serve.request"])
    assert len(set(ids)) == 3 and all(len(r["requests"]) == 1 for r in named["serve.request"])
    assert sorted(r["requests"][0] for r in named["serve.queue"]) == ids
    (batch,) = named["serve.batch"]
    assert sorted(batch["requests"]) == ids and batch["step"] is None
    (gen,) = named["clapdae.generate"]
    assert gen["parent"] == batch["id"] and sorted(gen["requests"]) == ids
    assert all(sorted(r["requests"]) == ids for r in named["kdiff.step"])
    request_of = {r["id"]: r["requests"] for r in named["serve.request"]}
    assert sorted(request_of[r["parent"]][0] for r in named["serve.wav"]) == ids
    assert all(request_of[r["parent"]] == r["requests"] for r in named["serve.wav"])
    h = service.health()
    assert h["coalesced_requests"] == 3
    assert h["queue_wait_s"] == pytest.approx(
        sum((r["t1_ns"] - r["t0_ns"]) * 1e-9 for r in named["serve.queue"]))
    assert h["queue_wait_s"] > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device spans time the card by CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_spans_time_the_card_without_a_synchronise(cuda_device, monkeypatch):
    x = torch.randn(4096, 4096, device=cuda_device)
    x @ x
    torch.cuda.synchronize()
    real = torch.cuda.synchronize

    def no_sync(*a, **k):
        raise AssertionError("a span synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    tracing.enable()
    with tracing.span("outer", x):
        with tracing.span("inner", x, step=1):
            for _ in range(8):
                y = x @ x
    tracing.disable()
    monkeypatch.setattr(torch.cuda, "synchronize", real)
    torch.cuda.synchronize()
    inner, outer = tracing.drain()
    assert inner["parent"] == outer["id"] and inner["step"] == 1
    assert 0 < inner["device_ms"] <= outer["device_ms"]
    assert bool(torch.isfinite(y).all())
