"""MIRAGE's and the stacked AE's turbo routes in the port against the JAX
package's, on the CPU.

`CLAPDAE(turbo=True).generate` on its two outer-stage routes: int8 inside
the fold (B = 1 below the batch gate; a depth-4 outer UNet at T = 1024
folds 2 levels) and the amax carry (`turbo_min_b=1`; JAX's
AA_TURBO_MIN_B=1) on an outer UNet of 128 channels, whose shapes pass the
turbo gates; `StackedDiffAEWrapper(turbo=True).decode_stage1to2` on JAX's
own test config (its shapes fail the gates: the carry contract runs with
every site float) and on the 128-channel one; `--turbo` of the port's
MIRAGE CLI and service reaching the int8 route; `--turbo` with `--mesh`
refused; `generate_seqpar` refusing a turbo model. `CLAPDAE(decode_batch=n)`
against JAX's generate under AA_MIRAGE_DECODE_BATCH=n at batch 4 (the
carry at a micro-batch of AA_TURBO_MIN_B = 4, the fold below it, uneven
parts, 0 taken as 1), and the variable reaching the model of the port's
CLI and service and their cache key. JAX's side turns turbo on with
monkeypatch.setenv AA_TURBO_INT8=1. Both sides hold the same weights (the
flax bridge) and take the same noise."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu import given_models as jgm
from audio_algebra_torch import embedding_math, mirage
from audio_algebra_torch import serve as tserve
from audio_algebra_torch.given_models import CLAPDAE, StackedDiffAEWrapper
from audio_algebra_torch.models import blocks as tb
from audio_algebra_torch.models import clap as tclap
from test_torch_blocks import rand_tree
from test_torch_fold import turbo_bound
from test_torch_turbo import rel_rms

FIRST_STAGE = {"capacity": 4, "c_mults": [2, 4], "strides": [2, 2], "latent_dim": 8}
INNER = dict(second_stage_latent_dim=4, factors=(2, 2), latent_channels=8,
             latent_multipliers=(1, 2, 2), latent_num_blocks=(1, 1), channels=8,
             multipliers=(1, 2), factors2=(2,), num_blocks=(1,), attentions=(0, 1),
             attention_heads=2, attention_features=16)
OUTER = {"fold": dict(diffusion_c_mults=(8, 8, 16, 16), diffusion_depth=4),
         "carry": dict(diffusion_c_mults=(128, 128), diffusion_depth=2)}
SAMPLES = 4096           # the outer stage at T = 1024
STEPS = (2, 3)           # inner, outer
ENGAGED = (1e-5, 0.08)   # turbo vs the port's own float route (JAX's band)
TINY_CLI = dict(sample_size=SAMPLES, first_stage_config=FIRST_STAGE,
                model_kwargs={**INNER, "factors": [2, 2], "factors2": [2],
                              "latent_multipliers": [1, 2, 2], "latent_num_blocks": [1, 1],
                              "multipliers": [1, 2], "num_blocks": [1], "attentions": [0, 1],
                              "diffusion_c_mults": [8, 8, 16, 16], "diffusion_depth": 4},
                clap_kwargs=dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG),
                                 text_cfg=dict(tclap.TINY_TEXT_CFG)))


def _count(monkeypatch, name):
    """Calls of blocks.`name` (the int8 conv, or K2a's wrapper)."""
    calls = []
    real = getattr(tb, name)

    def spy(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(tb, name, spy)
    return calls


def _pair(route):
    kwargs = {**INNER, **OUTER[route]}
    jw = jgm.CLAPDAE(sample_size=SAMPLES, first_stage_config=FIRST_STAGE, model_kwargs=kwargs,
                     clap_kwargs=dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG),
                                      text_cfg=dict(tclap.TINY_TEXT_CFG)))
    diffae = rand_tree(jw.latent_diffae, 51, jnp.zeros((1, 2, 1024)), jnp.zeros((1,)))
    ldm = rand_tree(jw.latent_diffusion_model, 52, jnp.zeros((1, 4, 64)), jnp.zeros((1,)),
                    jnp.zeros((1, 1, 512)))
    jw.diffae_params, jw.ldm_params = {"params": diffae}, {"params": ldm}
    ports = {}
    for turbo in (True, False):
        tw = CLAPDAE(sample_size=SAMPLES, first_stage_config=FIRST_STAGE, model_kwargs=kwargs,
                     device="cpu", turbo=turbo, turbo_min_b=1 if route == "carry" else 16)
        tw.load_flax_params(diffae, ldm)
        ports[turbo] = tw
    return jw, ports


@pytest.mark.parametrize("route", ["fold", "carry"])
def test_turbo_generate_matches_jax(route, monkeypatch):
    """The whole generate, turbo on both sides: the inner stage is float
    (f32 agreement), the outer stage held to twice JAX's own spread under a
    small change of its noise (test_torch_fold.turbo_bound), and to the int8
    band from the port's float generate."""
    jw, ports = _pair(route)
    rng = np.random.default_rng(53)
    emb = rng.standard_normal((1, 1, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb)
    latent_noise = rng.standard_normal((1, 4, SAMPLES // 16)).astype(np.float32)
    s1_noise = rng.standard_normal((1, 8, SAMPLES // 4)).astype(np.float32)
    monkeypatch.setenv("AA_TURBO_INT8", "1")
    if route == "carry":
        monkeypatch.setenv("AA_TURBO_MIN_B", "1")

    def jgen(s1):
        queue = [latent_noise, s1]
        monkeypatch.setattr(jgm, "host_normal", lambda key, shape, dtype=None: queue.pop(0))
        fakes, lat = jw.generate(jnp.asarray(emb), cfg_scales=2, demo_steps=STEPS[0],
                                 outer_steps=STEPS[1])
        assert not queue
        return np.asarray(fakes), np.asarray(lat)

    want, lat_j = jgen(s1_noise)
    int8_convs = _count(monkeypatch, "conv1d_int8")
    k2a = _count(monkeypatch, "groupnorm1_gelu_quant")
    out = {}
    for turbo, tw in ports.items():
        out[turbo] = tw.generate(emb, cfg_scales=2, demo_steps=STEPS[0], outer_steps=STEPS[1],
                                 latent_noise=latent_noise, s1_noise=s1_noise)
        if turbo:
            counts = (len(int8_convs), len(k2a))
    fakes, lat = (v.numpy() for v in out[True])
    assert rel_rms(lat, lat_j) < 1e-5 and fakes.shape == want.shape == (2, SAMPLES)
    if route == "fold":      # 2 folded levels x 2 stacks x 3 blocks x 2 conv5s a step
        assert counts == (24 * STEPS[1], 0)
    else:                    # every block's GN_0 but the 28-channel stem's emits int8
        assert counts[1] == 11 * STEPS[1]
    assert rel_rms(fakes, want) < turbo_bound(lambda s1: jgen(s1)[0], s1_noise, want)
    assert ENGAGED[0] < rel_rms(fakes, out[False][0].numpy()) < ENGAGED[1]


def test_turbo_generate_from_init_audio_takes_the_same_outer_routes(monkeypatch):
    """The init-audio path shares the outer stage: its turbo generate runs
    the int8 convs of the fold and lands in the int8 band of its float
    twin."""
    _, ports = _pair("fold")
    rng = np.random.default_rng(54)
    emb = rng.standard_normal((1, 1, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb)
    init = ports[True].encode_audio_latents(0.3 * rng.standard_normal((1, 2, SAMPLES)))
    noises = dict(init_noise=rng.standard_normal(tuple(init.shape)).astype(np.float32),
                  s1_noise=rng.standard_normal((1, 8, SAMPLES // 4)).astype(np.float32))
    calls = _count(monkeypatch, "conv1d_int8")
    out = {turbo: tw.generate(emb, cfg_scales=2, demo_steps=STEPS[0], outer_steps=STEPS[1],
                              init_audio_latents=init, init_strength=0.5, **noises)[0]
           for turbo, tw in ports.items()}
    assert len(calls) == 24 * STEPS[1]
    assert ENGAGED[0] < rel_rms(out[True].numpy(), out[False].numpy()) < ENGAGED[1]


STACKED_CFGS = {
    # JAX's test_stacked_diffae_turbo_aux_decode: every site fails the gates
    "jax_test": dict(second_stage_latent_dim=4, factors=(2, 2), latent_channels=8,
                     latent_multipliers=(1, 2, 2), latent_num_blocks=(1, 1),
                     diffusion_c_mults=(8, 16, 16), diffusion_depth=3),
    "engaged": dict(second_stage_latent_dim=4, factors=(2, 2), latent_channels=8,
                    latent_multipliers=(1, 2, 2), latent_num_blocks=(1, 1),
                    diffusion_c_mults=(128, 128), diffusion_depth=2)}


@pytest.mark.parametrize("cfg", sorted(STACKED_CFGS))
def test_stacked_wrapper_turbo_matches_jax(cfg, monkeypatch):
    jw = jgm.StackedDiffAEWrapper(first_stage_config=FIRST_STAGE,
                                  model_kwargs=STACKED_CFGS[cfg])
    jw._ensure_params()
    rng = np.random.default_rng(55)
    small = np.tanh(rng.standard_normal((1, 4, 64))).astype(np.float32)
    noise = rng.standard_normal((1, 8, 256)).astype(np.float32)
    monkeypatch.setenv("AA_TURBO_INT8", "1")
    monkeypatch.setenv("AA_TURBO_MIN_B", "1")

    def jdecode(nz):
        monkeypatch.setattr(jgm, "host_normal", lambda key, shape, dtype=None: jnp.asarray(nz))
        return np.asarray(jw.decode_stage1to2(jnp.asarray(small), steps=3))

    want = jdecode(noise)
    k2a = _count(monkeypatch, "groupnorm1_gelu_quant")
    out = {}
    for turbo in (True, False):
        tw = StackedDiffAEWrapper(first_stage_config=FIRST_STAGE,
                                  model_kwargs=STACKED_CFGS[cfg], device="cpu", turbo=turbo,
                                  turbo_min_b=1)
        tw.load_flax_params(jw.params)
        out[turbo] = tw.decode_stage1to2(small, steps=3, noise=noise).numpy()
    assert out[True].shape == want.shape == (1, 8, 256)
    if cfg == "jax_test":     # the carry contract with every site float: no int8, and
        assert not k2a        # only the amax-emitting GroupNorms' f32 rounding apart
        assert rel_rms(out[True], out[False]) < 1e-5
        assert rel_rms(out[True], want) < 1e-5
    else:
        assert len(k2a) == 11 * 3
        assert rel_rms(out[True], want) < turbo_bound(jdecode, noise, want)
        assert ENGAGED[0] < rel_rms(out[True], out[False]) < ENGAGED[1]


MICRO_BATCH = {  # case: (outer UNet, turbo, AA_MIRAGE_DECODE_BATCH, micro-batches of 4 rows)
    "carry": ("carry", True, 4, [4]),      # AA_TURBO_MIN_B=4: the amax carry
    "fold": ("carry", True, 2, [2, 2]),    # below the gate: int8 inside the fold
    "uneven": ("fold", False, 3, [3, 1]),
    "zero": ("fold", False, 0, [1, 1, 1, 1])}


@pytest.mark.parametrize("case", sorted(MICRO_BATCH))
def test_decode_batch_matches_jax_env(case, monkeypatch):
    """CLAPDAE(decode_batch=n) against JAX's generate under
    AA_MIRAGE_DECODE_BATCH=n at batch 4: the same micro-batches (JAX's
    outer programs by their noise shape, the port's _outer calls), the
    carry route (K2a's wrapper called) at a micro-batch of turbo_min_b = 4
    (JAX's AA_TURBO_MIN_B=4), the fold below it (int8 conv5s, no K2a),
    uneven parts and 0 taken as 1 on the float route."""
    outer, turbo, mdb, parts = MICRO_BATCH[case]
    kwargs = {**INNER, **OUTER[outer]}
    jw = jgm.CLAPDAE(sample_size=SAMPLES, first_stage_config=FIRST_STAGE, model_kwargs=kwargs,
                     clap_kwargs=dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG),
                                      text_cfg=dict(tclap.TINY_TEXT_CFG)))
    diffae = rand_tree(jw.latent_diffae, 56, jnp.zeros((1, 2, 1024)), jnp.zeros((1,)))
    ldm = rand_tree(jw.latent_diffusion_model, 57, jnp.zeros((1, 4, 64)), jnp.zeros((1,)),
                    jnp.zeros((1, 1, 512)))
    jw.diffae_params, jw.ldm_params = {"params": diffae}, {"params": ldm}
    tw = CLAPDAE(sample_size=SAMPLES, first_stage_config=FIRST_STAGE, model_kwargs=kwargs,
                 device="cpu", turbo=turbo, turbo_min_b=4, decode_batch=mdb)
    tw.load_flax_params(diffae, ldm)
    assert tw.decode_batch == max(mdb, 1)
    rng = np.random.default_rng(58)
    emb = rng.standard_normal((1, 1, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb)
    latent_noise = rng.standard_normal((4, 4, SAMPLES // 16)).astype(np.float32)
    s1_noise = rng.standard_normal((4, 8, SAMPLES // 4)).astype(np.float32)
    monkeypatch.setenv("AA_MIRAGE_DECODE_BATCH", str(mdb))
    monkeypatch.setenv("AA_TURBO_MIN_B", "4")
    if turbo:
        monkeypatch.setenv("AA_TURBO_INT8", "1")
    jparts = []
    jit = jw._cached_jit

    def spied_jit(name, fn):
        if name.startswith("outer_decode"):
            jparts.append(int(name.split("_(")[1].split(",")[0]))
        return jit(name, fn)

    monkeypatch.setattr(jw, "_cached_jit", spied_jit)

    def jgen(s1):
        queue = [latent_noise, s1]
        monkeypatch.setattr(jgm, "host_normal", lambda key, shape, dtype=None: queue.pop(0))
        fakes, _ = jw.generate(jnp.asarray(emb), cfg_scales=2, demo_steps=STEPS[0],
                               outer_steps=STEPS[1], batch_size=4)
        assert not queue
        return np.asarray(fakes)

    want = jgen(s1_noise)
    assert jparts == parts
    tparts = []
    real_outer = CLAPDAE._outer

    def spied_outer(self, noise, lat, steps):
        tparts.append(noise.shape[0])
        return real_outer(self, noise, lat, steps)

    monkeypatch.setattr(CLAPDAE, "_outer", spied_outer)
    int8_convs = _count(monkeypatch, "conv1d_int8")
    k2a = _count(monkeypatch, "groupnorm1_gelu_quant")
    fakes, _ = tw.generate(emb, cfg_scales=2, demo_steps=STEPS[0], outer_steps=STEPS[1],
                           batch_size=4, latent_noise=latent_noise, s1_noise=s1_noise)
    assert tparts == parts and fakes.shape == want.shape == (2, 4 * SAMPLES)
    if case == "carry":      # every block's GN_0 but the stem's emits int8, a step
        assert len(k2a) == 11 * STEPS[1]
    elif case == "fold":
        assert not k2a and int8_convs
    else:
        assert not k2a and not int8_convs
    if turbo:
        jparts.clear()
        assert rel_rms(fakes.numpy(), want) < turbo_bound(jgen, s1_noise, want)
    else:
        assert rel_rms(fakes.numpy(), want) < 1e-5


@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(embedding_math, "_model_cache", {})


def test_cli_turbo_reaches_the_int8_route(fresh_cache, tmp_path, monkeypatch):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_CLI))
    calls = _count(monkeypatch, "conv1d_int8")
    result = mirage.main(["--text", "a", "--turbo", "--device", "cpu", "--model-config",
                          str(cfg), "--steps", "2", "--outer-steps", "2", "--seed", "1",
                          "--output-dir", str(tmp_path / "out")])
    assert len(calls) == 24 * 2 and result["wav"]
    (key, model), = embedding_math._model_cache.items()
    assert model.turbo and key == embedding_math.model_cache_key(
        "22s", True, "cpu", turbo=True, **TINY_CLI)
    assert key != embedding_math.model_cache_key("22s", True, "cpu", **TINY_CLI)


def test_serve_turbo_reaches_the_int8_route(monkeypatch):
    """serve's main with --turbo builds MirageService(turbo=True), whose
    model comes from get_model_ready(..., turbo=True); a generate through
    it runs the int8 convs. The model is the tiny config and the server a
    stand-in that returns at once."""
    built, services = {}, []

    def ready(model_choice, device, verbose, half, turbo):
        built.update(turbo=turbo, device=device)
        return embedding_math.get_model_ready(model_choice, device=device, verbose=verbose,
                                              half=half, turbo=turbo, **TINY_CLI)

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def make_server(service, host, port):
        services.append(service)
        return Server()

    monkeypatch.setattr(embedding_math, "_model_cache", {})
    monkeypatch.setattr(tserve, "get_model_ready", ready)
    monkeypatch.setattr(tserve, "make_server", make_server)
    tserve.main(["--turbo", "--device", "cpu", "--batch-window", "0"])
    assert built == {"turbo": True, "device": "cpu"}
    calls = _count(monkeypatch, "conv1d_int8")
    wav, _ = services[0].generate_wav({"embeddings": [[1.0] + [0.0] * 511], "steps": 2,
                                    "outer_steps": 2, "seed": 0})
    assert wav[:4] == b"RIFF" and len(calls) == 24 * 2


def test_cli_decode_batch_env_reaches_the_model(fresh_cache, tmp_path, monkeypatch):
    """AA_MIRAGE_DECODE_BATCH, as JAX's CLI reads it, is the CLI model's
    decode_batch: a batch of 2 runs in micro-batches of 1, and the cache
    keys on the value (unset, the model keeps its default 4)."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_CLI))
    parts = []
    real_outer = CLAPDAE._outer

    def spied_outer(self, noise, lat, steps):
        parts.append(noise.shape[0])
        return real_outer(self, noise, lat, steps)

    monkeypatch.setattr(CLAPDAE, "_outer", spied_outer)
    monkeypatch.setenv("AA_MIRAGE_DECODE_BATCH", "1")
    args = ["--text", "a", "--device", "cpu", "--model-config", str(cfg), "--steps", "2",
            "--outer-steps", "2", "--seed", "1", "--batch-size", "2"]
    result = mirage.main(args + ["--output-dir", str(tmp_path / "one")])
    assert parts == [1, 1] and result["wav"]
    (key, model), = embedding_math._model_cache.items()
    assert model.decode_batch == 1
    assert key == embedding_math.model_cache_key("22s", True, "cpu", decode_batch=1,
                                                 **TINY_CLI)
    monkeypatch.delenv("AA_MIRAGE_DECODE_BATCH")
    parts.clear()
    mirage.main(args + ["--output-dir", str(tmp_path / "default")])
    assert parts == [2] and len(embedding_math._model_cache) == 2
    assert embedding_math.get_model_ready("22s", device="cpu", verbose=False,
                                          **TINY_CLI).decode_batch == 4


def test_serve_decode_batch_env_reaches_the_model(monkeypatch):
    """serve's main passes a set AA_MIRAGE_DECODE_BATCH to get_model_ready
    as decode_batch (0 taken as 1, as JAX's max(mdb, 1)); the service's
    model and its cache key carry it; unset, nothing is passed."""
    built, services = [], []

    def ready(model_choice, device, verbose, half, turbo, **kwargs):
        built.append(kwargs)
        return embedding_math.get_model_ready(model_choice, device=device, verbose=verbose,
                                              half=half, turbo=turbo, **kwargs, **TINY_CLI)

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def make_server(service, host, port):
        services.append(service)
        return Server()

    monkeypatch.setattr(embedding_math, "_model_cache", {})
    monkeypatch.setattr(tserve, "get_model_ready", ready)
    monkeypatch.setattr(tserve, "make_server", make_server)
    for value in ("3", "0", None):
        if value is None:
            monkeypatch.delenv("AA_MIRAGE_DECODE_BATCH")
        else:
            monkeypatch.setenv("AA_MIRAGE_DECODE_BATCH", value)
        tserve.main(["--device", "cpu", "--batch-window", "0"])
    assert built == [{"decode_batch": 3}, {"decode_batch": 0}, {}]
    assert [s.model.decode_batch for s in services] == [3, 1, 4]
    assert set(embedding_math._model_cache) == {
        embedding_math.model_cache_key("22s", True, "cpu", decode_batch=n, **TINY_CLI)
        for n in (3, 1, 4)}


def test_turbo_with_mesh_is_refused(capsys):
    for main in (mirage.main, tserve.main):
        with pytest.raises(SystemExit) as exc:
            main(["--turbo", "--mesh", "seq=2", "--device", "cpu"])
        assert exc.value.code == 2
        assert "sequence-parallel outer stage runs the float route" in capsys.readouterr().err


def test_generate_seqpar_refuses_a_turbo_model():
    model = CLAPDAE(device="cpu", turbo=True, **TINY_CLI)
    with pytest.raises(ValueError, match="float route"):
        model.generate_seqpar(np.ones((1, 1, 512), np.float32), world=None)
