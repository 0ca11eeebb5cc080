"""The PyTorch port's turbo Destructo decode as a whole against the JAX
package's: a tiny DiffusionDVAE (a 2-level UNet of 128 channels, no
attention) at T = 1024, B = 2, 3 v-DDIM steps with the amax carry, the same
weights through the flax bridge and the same noise on both sides; and the
`--turbo` flag of the port's destructo CLI."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.given_models import DVAEWrapper as JaxWrapper
from audio_algebra_tpu.models.dvae import DiffusionDVAE as JaxDVAE
from audio_algebra_torch import destructo as tdestructo
from audio_algebra_torch.given_models import DVAEWrapper
from audio_algebra_torch.models import blocks as tb
from audio_algebra_torch.models.dvae import DiffusionDVAE
from audio_algebra_torch.utils import audio_io as tio
from audio_algebra_torch.utils.params import load_flax_params, to_flax_params
from test_torch_blocks import rand_tree
from test_torch_turbo import jax_self_rel, rel_rms

MODEL_KWARGS = dict(capacity=4, c_mults=(2, 4), strides=(4, 2), n_attn_layers=0,
                    diffusion_c_mults=(128, 128))
ARGS = {"sample_size": 1024, "latent_dim": 8, "demo_steps": 3}
ENGAGED = (1e-5, 0.08)          # turbo vs the port's own float decode (JAX's band)


@pytest.fixture(scope="module")
def tree():
    return rand_tree(JaxDVAE(latent_dim=8, **MODEL_KWARGS), 12,
                     jnp.zeros((1, 2, 1024)), jnp.zeros((1,)))


def test_turbo_adds_no_parameter(tree):
    """The turbo route adds no leaf: the same tree loads, and goes back out
    unchanged, in a model that runs turbo."""
    mod = load_flax_params(DiffusionDVAE(latent_dim=8, **MODEL_KWARGS), tree)
    assert set(map(tuple, _paths(to_flax_params(mod)))) == set(map(tuple, _paths(tree)))


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, (*prefix, k))
        else:
            yield (*prefix, k)


def test_turbo_decode_matches_jax(tree, monkeypatch):
    """The port's turbo decode against JAX's. Exact agreement ends at the
    first flipped rounding tie (test_torch_turbo.jax_self_rel), so the
    port is held to JAX's own spread under a 1e-6 relative change of the
    noise; the carry itself is checked step by step below."""
    rng = np.random.default_rng(13)
    reps = np.tanh(rng.standard_normal((2, 8, 128))).astype(np.float32)
    noise = rng.standard_normal((2, 2, 1024)).astype(np.float32)

    monkeypatch.setenv("AA_TURBO_INT8", "1")
    monkeypatch.setenv("AA_TURBO_MIN_B", "1")
    jw = JaxWrapper(args_dict=ARGS, model_kwargs=MODEL_KWARGS, debug=False)
    jw.params = jw.params_ema = {"params": tree}

    def jdecode(nz):
        jw.noise = jnp.asarray(nz)
        return np.asarray(jw.decode(jnp.asarray(reps)))

    want = jdecode(noise)
    outs, seen = {}, []
    for turbo in (True, False):
        tw = DVAEWrapper(args_dict=ARGS, model_kwargs=MODEL_KWARGS, device="cpu",
                         turbo=turbo, turbo_min_b=1)
        tw.load_flax_params(tree)
        tw.noise = torch.from_numpy(noise)
        if turbo:
            real = tw.model.decode_v_aux

            def spy(x, t, cond, q_aux=None, **kw):
                out = real(x, t, cond, q_aux=q_aux, **kw)
                seen.append((q_aux, out[1]))
                return out
            monkeypatch.setattr(tw.model, "decode_v_aux", spy)
        outs[turbo] = tw.decode(torch.from_numpy(reps)).numpy()
    assert outs[True].shape == want.shape == (2, 2 * 1024)
    assert rel_rms(outs[True], want) < 2 * jax_self_rel(jdecode, noise, want)
    assert ENGAGED[0] < rel_rms(outs[True], outs[False]) < ENGAGED[1]
    # the carry: step 0 has none, step k gets step k - 1's, every stack emits
    assert len(seen) == 3 and seen[0][0] is None
    assert all(seen[k][0] is seen[k - 1][1] for k in (1, 2))
    assert all(q is not None and len(q) == 2 for q in seen[0][1])


def test_destructo_cli_turbo_reaches_the_int8_route(tmp_path, monkeypatch):
    """--turbo --max-batch 16 on 16 chunks: GN_0 of every block past the
    first emits int8 (the K2a twin on the CPU)."""
    audio = np.random.default_rng(14).standard_normal((2, 16 * 1024 - 300))
    tio.write_wav(tmp_path / "in.wav", (audio * 0.2).astype(np.float32), 48000)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_kwargs": MODEL_KWARGS, "args_dict": {"latent_dim": 8}}))
    calls = []
    real = tb.groupnorm1_gelu_quant
    monkeypatch.setattr(tb, "groupnorm1_gelu_quant",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    out = tmp_path / "out.wav"
    tdestructo.main([str(tmp_path / "in.wav"), "--op", "destructo", "--steps", "2",
                     "--chunk-size", "1024", "--max-batch", "16", "--turbo",
                     "--model-config", str(cfg), "--out", str(out), "--device", "cpu",
                     "--dtype", "float32"])
    got, sr = tio.read_wav(out)
    assert sr == 48000 and got.shape == (2, 16 * 1024) and np.isfinite(got).all()
    # 2 steps x (4 stacks x 3 blocks - stack_000.m0, whose input has 26 channels)
    assert len(calls) == 2 * 11 and all(s[0] == 16 for s in calls)
