"""The PyTorch port's Destructo slice as a whole against the JAX package:
load and chunk -> DVAEWrapper.encode -> mathemangle -> v-DDIM decode ->
flatten, with the same weights (through the flax bridge) and the same
decode noise injected on both sides."""
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.given_models import DVAEWrapper as JaxWrapper
from audio_algebra_tpu.models.dvae import DiffusionDVAE as JaxDVAE
from audio_algebra_tpu.ops.resample import resample_np as jax_resample_np
from audio_algebra_tpu.utils import audio_io as jio
from audio_algebra_torch import destructo as tdestructo
from audio_algebra_torch.given_models import DVAEWrapper
from audio_algebra_torch.models.dvae import DiffusionDVAE
from audio_algebra_torch.ops.resample import resample_np
from audio_algebra_torch.utils import audio_io as tio
from audio_algebra_torch.utils.params import load_flax_params, to_flax_params
from test_torch_blocks import rand_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL_KWARGS = dict(capacity=4, c_mults=(2, 4), strides=(4, 2), n_attn_layers=1,
                    diffusion_c_mults=(128, 128, 256))
ARGS = {"sample_size": 1024, "latent_dim": 8, "demo_steps": 3}
TOL = 1e-4       # f32, relative to the output's peak, after 3 UNet steps


def _jax_destructo():
    spec = importlib.util.spec_from_file_location("jax_destructo", ROOT / "destructo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, (*prefix, k)) if isinstance(v, dict) else {(*prefix, k): v})
    return out


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def tree():
    return rand_tree(JaxDVAE(latent_dim=8, **MODEL_KWARGS), 11,
                     jnp.zeros((1, 2, 1024)), jnp.zeros((1,)))


def test_destructo_slice_matches_jax(tree):
    rng = np.random.default_rng(0)
    signal = rng.standard_normal((2, 3 * 1024 - 100)).astype(np.float32) * 0.3
    batch = tio.batch_it_crazy(signal, 1024)          # 3 chunks: no seqfold in JAX
    np.testing.assert_array_equal(batch, jio.batch_it_crazy(signal, 1024))
    noise = rng.standard_normal((3, 2, 1024)).astype(np.float32)

    jw = JaxWrapper(args_dict=ARGS, model_kwargs=MODEL_KWARGS, debug=False)
    jw.params = jw.params_ema = {"params": tree}
    z_j = jw.encode(jnp.asarray(batch))
    jw.noise = jnp.asarray(noise)
    out_j = jw.decode(_jax_destructo().mathemangle(z_j, "destructo"))

    tw = DVAEWrapper(args_dict=ARGS, model_kwargs=MODEL_KWARGS, device="cpu")
    tw.load_flax_params(tree)
    z_t = tw.encode(batch)
    tw.noise = torch.from_numpy(noise)
    out_t = tw.decode(tdestructo.mathemangle(z_t, "destructo"))

    assert _rel_err(z_t, z_j) < TOL
    assert out_t.shape == (2, 3 * 1024)
    assert _rel_err(out_t, out_j) < TOL


@pytest.mark.parametrize("op,expr", [("destructo", None), ("dimswap", None),
                                     ("timereverse", None), ("ewma", None),
                                     ("overdrive", None), ("none", None),
                                     ("none", "z * 0.5 - 1")])
def test_mathemangle_matches_jax(op, expr):
    z = np.random.default_rng(1).standard_normal((2, 8, 16)).astype(np.float32)
    want = _jax_destructo().mathemangle(jnp.asarray(z), op, expr)
    got = tdestructo.mathemangle(torch.from_numpy(z), op, expr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_bridge_round_trip_is_exact(tree):
    mod = load_flax_params(DiffusionDVAE(latent_dim=8, **MODEL_KWARGS), tree)
    want, got = _leaves(tree), _leaves(to_flax_params(mod))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg="/".join(k))


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DVAEWrapper(args_dict=ARGS, model_kwargs=MODEL_KWARGS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdestructo.main(["x.wav"])
    DVAEWrapper(args_dict=ARGS, model_kwargs=MODEL_KWARGS, device="cpu")


def test_audio_io_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    audio = np.clip(rng.standard_normal((2, 4410)) * 0.3, -1, 1).astype(np.float32)
    for subtype in ("pcm16", "float32"):
        path = tmp_path / f"a_{subtype}.wav"
        tio.write_wav(path, audio, 44100, subtype=subtype)
        got, sr = tio.read_wav(path)
        want, sr_j = jio.read_wav(path)
        assert sr == sr_j == 44100
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.load_audio(tmp_path / "a_float32.wav", sr=48000),
                                  jio.load_audio(tmp_path / "a_float32.wav", sr=48000))
    np.testing.assert_array_equal(resample_np(audio, 48000, 44100),
                                  jax_resample_np(audio, 48000, 44100))


def test_destructo_cli_runs_on_cpu(tmp_path):
    audio = np.random.default_rng(3).standard_normal((2, 1500)).astype(np.float32) * 0.2
    tio.write_wav(tmp_path / "in.wav", audio, 48000)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_kwargs": MODEL_KWARGS,
                               "args_dict": {"latent_dim": 8}}))
    out = tmp_path / "out.wav"
    tdestructo.main([str(tmp_path / "in.wav"), "--op", "ewma", "--steps", "2",
                     "--chunk-size", "1024", "--model-config", str(cfg),
                     "--out", str(out), "--device", "cpu", "--dtype", "float32"])
    got, sr = tio.read_wav(out)
    assert sr == 48000 and got.shape == (2, 2048)
    assert np.isfinite(got).all()
