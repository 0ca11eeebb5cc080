"""The call surface of the port's model wrappers (DVAEWrapper,
StackedDiffAEWrapper, DMAE1d, RAVEWrapper, CLAPDAE) against the JAX
package's: each is a GivenModelClass with JAX's public method names and
`setup` signatures, `setup(gdrive=False)` runs (the root trainer's call),
`DVAEWrapper()(x)` returns (reps, recons) with recons matched to the
input's length, and `get_checkpoint` checks a file's SHA-256 and fetches
only from a URL it is given. Tiny configs on the CPU; subprocess.run is
replaced in the tests that could reach it, so no test fetches anything."""
import hashlib
import inspect
import subprocess

import numpy as np
import pytest
import torch

from audio_algebra_tpu import given_models as jgm
from audio_algebra_torch import given_models as tgm

DVAE_KWARGS = dict(args_dict={"sample_size": 1024, "latent_dim": 8, "demo_steps": 2},
                   model_kwargs=dict(capacity=4, c_mults=(2, 4), strides=(4, 2),
                                     n_attn_layers=1, diffusion_c_mults=(128, 128, 256)))
FIRST_STAGE = {"capacity": 4, "c_mults": [2, 4], "strides": [2, 2], "latent_dim": 8}
CLAPDAE_KWARGS = dict(sample_size=4096, first_stage_config=FIRST_STAGE,
                      model_kwargs=dict(second_stage_latent_dim=4, factors=(2, 2),
                                        latent_channels=8, latent_multipliers=(1, 2, 2),
                                        latent_num_blocks=(1, 1), diffusion_c_mults=(8, 16),
                                        diffusion_depth=2, channels=8, multipliers=(1, 2),
                                        factors2=(2,), num_blocks=(1,), attentions=(0, 1),
                                        attention_heads=2, attention_features=16))
# JAX-only names, each for a reason the port states: `next_key` splits
# JAX's PRNG key (the port draws from the torch.Generator `generator`).
# The sequence-parallel decodes (`decode_seqpar`, `generate_seqpar`) are
# ported and held by tests/test_torch_seqpar.py.
JAX_ONLY = {"next_key"}
TINY_DMAE = dict(channels=(8, 16), factors=(1, 2), items=(1, 1), linear_attentions=(0, 1),
                 attention_features=4, attention_heads=2, inject_depth=1, latent_dim=4,
                 resnet_groups=4, num_filters=8, window_length=32, lt_stride=16,
                 enc_channels=16, enc_multipliers=(1, 1), enc_factors=(2,),
                 enc_num_blocks=(1,), n_mels=16, mel_n_fft=64, mel_hop=16)
WRAPPERS = ["DVAEWrapper", "StackedDiffAEWrapper", "DMAE1d", "RAVEWrapper", "CLAPDAE"]


def _public(cls) -> set:
    return {n for n, _ in inspect.getmembers(cls, callable) if not n.startswith("_")}


@pytest.mark.parametrize("name", WRAPPERS)
def test_port_class_has_jax_surface(name):
    jcls, tcls = getattr(jgm, name), getattr(tgm, name)
    assert issubclass(tcls, tgm.GivenModelClass)
    missing = _public(jcls) - _public(tcls)
    assert missing <= JAX_ONLY, sorted(missing - JAX_ONLY)
    for method in ("forward", "__call__", "match_sizes", "setup", "encode", "decode",
                   "zero_pad_po2", "next_power_of_2"):
        assert callable(getattr(tcls, method)), method
    assert inspect.signature(tcls.setup).parameters.keys() == \
        inspect.signature(jcls.setup).parameters.keys()
    for p, q in zip(inspect.signature(tcls.setup).parameters.values(),
                    inspect.signature(jcls.setup).parameters.values()):
        assert p.default == q.default, p.name


def test_setup_without_gdrive_runs():
    w = tgm.DVAEWrapper(device="cpu", **DVAE_KWARGS)
    assert w.setup(gdrive=False) is w and w._loaded
    m = tgm.CLAPDAE(device="cpu", **CLAPDAE_KWARGS)
    assert m.setup(gdrive=False) is m and m.demo_samples == 4096
    assert m.setup(False, "66s").sample_size == 4096           # explicit sample_size kept
    big = tgm.CLAPDAE(device="cpu", sample_size=tgm.CLAPDAE.SAMPLES_22S, **{
        k: v for k, v in CLAPDAE_KWARGS.items() if k != "sample_size"})
    assert big.setup(gdrive=False, model_len="66s").sample_size == 3 * tgm.CLAPDAE.SAMPLES_22S
    with pytest.raises(ValueError):
        m.setup(model_len="5s")


def test_dvae_wrapper_call_returns_reps_and_matched_recons():
    w = tgm.DVAEWrapper(device="cpu", **DVAE_KWARGS).setup(gdrive=False)
    x = np.random.default_rng(0).standard_normal((1, 2, 1024)).astype(np.float32) * 0.1
    reps, recons = w(x)
    assert w.orig_shape == (1, 2, 1024)
    assert reps.shape[:2] == (1, 8) and recons.shape == (2, 1024)
    assert bool(torch.isfinite(recons).all())
    torch.testing.assert_close(w.match_sizes(torch.ones(2, 1500)), torch.ones(2, 1024))
    torch.testing.assert_close(w.match_sizes(torch.ones(2, 1000))[:, 1000:],
                               torch.zeros(2, 24))


def test_clapdae_decode_is_generate():
    m = tgm.CLAPDAE(device="cpu", **CLAPDAE_KWARGS).setup(gdrive=False)
    emb = np.random.default_rng(1).standard_normal((1, 1, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb)
    m.generator.manual_seed(5)
    fakes, lat = m.decode(emb, demo_steps=2, outer_steps=2)
    m.generator.manual_seed(5)
    want, want_lat = m.generate(emb, demo_steps=2, outer_steps=2)
    assert fakes.shape == (2, 4096)
    torch.testing.assert_close(fakes, want)
    torch.testing.assert_close(lat, want_lat)


def _file(tmp_path, data: bytes = b"weights"):
    path = tmp_path / "model.ckpt"
    path.write_bytes(data)
    return path, hashlib.sha256(data).hexdigest()


@pytest.fixture
def no_fetch(monkeypatch):
    """subprocess.run replaced by a recorder: a test that reaches it
    fetches nothing."""
    calls = []

    def run(argv, **kwargs):
        calls.append((argv, kwargs))
        raise subprocess.CalledProcessError(22, argv)
    monkeypatch.setattr(subprocess, "run", run)
    return calls


def test_get_checkpoint_raises_on_a_hash_mismatch(tmp_path, no_fetch):
    path, digest = _file(tmp_path)
    w = tgm.GivenModelClass(device="cpu", ckpt_info={
        "ckpt_path": str(path), "ckpt_hash": "0" * 64, "ckpt_url": "", "gdrive_path": ""})
    with pytest.raises(RuntimeError, match="Hashes don't match"):
        w.get_checkpoint()
    assert not no_fetch


def test_get_checkpoint_passes_a_file_with_its_hash(tmp_path, no_fetch, capsys):
    path, digest = _file(tmp_path)
    w = tgm.GivenModelClass(device="cpu", ckpt_info={
        "ckpt_path": str(path), "ckpt_hash": digest, "ckpt_url": "", "gdrive_path": ""})
    w.get_checkpoint()
    assert "Checkpoint hash checks out." in capsys.readouterr().out
    assert not no_fetch


@pytest.mark.parametrize("name", WRAPPERS)
def test_setup_without_a_url_never_fetches(name, tmp_path, no_fetch, monkeypatch, capsys):
    """The wrappers carry no URL: a missing file leaves the random weights
    and subprocess.run is never called."""
    for var in ("LATENT_DIFFAE_CKPT", "CLAP_CKPT", "CLAPDAE_CKPT_22s"):
        monkeypatch.delenv(var, raising=False)
    kwargs = {"DVAEWrapper": DVAE_KWARGS, "CLAPDAE": CLAPDAE_KWARGS,
              "StackedDiffAEWrapper": dict(first_stage_config=FIRST_STAGE,
                                           model_kwargs=dict(
                                               second_stage_latent_dim=4, factors=(2, 2),
                                               latent_channels=8, latent_multipliers=(1, 2, 2),
                                               latent_num_blocks=(1, 1),
                                               diffusion_c_mults=(8, 16), diffusion_depth=2)),
              "DMAE1d": dict(model_kwargs=TINY_DMAE),
              "RAVEWrapper": dict(capacity=4, strides=(2, 2))}[name]
    w = getattr(tgm, name)(device="cpu", **kwargs)
    assert not w.ckpt_info.get("ckpt_url")
    if name != "CLAPDAE":
        w.ckpt_info["ckpt_path"] = str(tmp_path / "missing.ckpt")
        w.get_checkpoint()
    if name in ("DVAEWrapper", "CLAPDAE"):
        w.setup(gdrive=False)
    assert not no_fetch


def test_get_checkpoint_fetches_from_a_given_url_and_drops_a_bad_file(tmp_path, monkeypatch,
                                                                      capsys):
    """With a URL, the fetch is JAX's curl argv; a file failing its hash
    is removed."""
    calls = []

    def run(argv, **kwargs):
        calls.append((argv, kwargs))
        (tmp_path / "sub" / "model.ckpt").write_bytes(b"not the weights")
    monkeypatch.setattr(subprocess, "run", run)
    target = tmp_path / "sub" / "model.ckpt"
    w = tgm.GivenModelClass(device="cpu", ckpt_info={
        "ckpt_path": str(target), "ckpt_hash": "0" * 64,
        "ckpt_url": "https://example.invalid/model.ckpt", "gdrive_path": ""})
    w.get_checkpoint()
    assert calls == [(["curl", "-L", "--fail", "--connect-timeout", "5", "--max-time", "300",
                       "https://example.invalid/model.ckpt", "-o", str(target)],
                      {"check": True, "timeout": 330})]
    assert not target.exists()
    assert "failed its SHA-256 check; removed" in capsys.readouterr().out
