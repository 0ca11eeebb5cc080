"""The PyTorch port's UNetCFG1d against the JAX one: a tiny config with one
attention level, at T = 1024 (the K3 route of the port; JAX with its flash
kernel in interpret mode and with its plain route) and at T = 256 (the
plain route), with classifier-free guidance at scale 4 and the rel-pos
biases hoisted on both sides. Also: the flax bridge round trip and the
seeded random weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.models import unet_cfg1d as junet
from audio_algebra_tpu.utils.params import fast_random_params
from audio_algebra_torch.models import unet_cfg1d as tunet
from audio_algebra_torch.ops import flash_attention as tflash
from audio_algebra_torch.ops import groupnorm_grouped as tggn
from audio_algebra_torch.utils.params import load_flax_params, random_init_, to_flax_params
from test_torch_blocks import rand_tree

CFG = dict(in_channels=4, channels=16, multipliers=(1, 1), factors=(1,), num_blocks=(1,),
           attentions=(0, 1), attention_heads=2, attention_features=16, resnet_groups=4)
DEEP = dict(in_channels=4, channels=16, multipliers=(1, 2, 2), factors=(2, 2),
            num_blocks=(1, 1), attentions=(0, 1, 1), attention_heads=2,
            attention_features=16, resnet_groups=4)
TOL = 1e-4       # f32, relative to the output's peak


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _inputs(t_len, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 4, t_len)).astype(np.float32)
    t = np.array([0.4], np.float32)
    emb = rng.standard_normal((1, 1, 512)).astype(np.float32)
    return x, t, emb / np.linalg.norm(emb)


def _port(cfg, tree):
    model = tunet.UNetCFG1d(**cfg)
    load_flax_params(model, tree)
    return model.eval()


@pytest.mark.parametrize("t_len,mode", [(1024, "interpret"), (1024, "0"), (256, "0")])
def test_unet_cfg_matches_jax(monkeypatch, t_len, mode):
    x, t, emb = _inputs(t_len)
    jmodel = junet.UNetCFG1d(**CFG)
    tree = rand_tree(jmodel, 3, jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb))
    monkeypatch.setenv("AA_FLASH_ATTN", mode)
    rb = junet.precompute_rel_biases(jmodel, {"params": tree}, t_len)
    assert isinstance(rb["mid_attn1_0"], junet.TransposedBias) == (mode == "interpret")
    want = jmodel.apply({"params": tree}, jnp.asarray(x), jnp.asarray(t),
                        embedding=jnp.asarray(emb), embedding_scale=4.0, rel_biases=rb)

    model = _port(CFG, tree)
    trb = tunet.precompute_rel_biases(model, t_len)
    assert isinstance(trb["mid_attn1_0"], tunet.TransposedBias) == (t_len == 1024)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    embedding=torch.from_numpy(emb), embedding_scale=4.0, rel_biases=trb)
        unhoisted = model(torch.from_numpy(x), torch.from_numpy(t),
                          embedding=torch.from_numpy(emb), embedding_scale=4.0)
    assert _rel_err(got.numpy(), want) < TOL
    torch.testing.assert_close(unhoisted, got, rtol=1e-6, atol=1e-6)


def test_unet_cfg_deeper_levels_and_no_embedding():
    """Strided down convs, SAME transposed up convs and the null embedding."""
    x, t, _ = _inputs(256, seed=1)
    x = np.concatenate([x, -x])
    t = np.array([0.3, 0.7], np.float32)
    jmodel = junet.UNetCFG1d(**DEEP)
    tree = rand_tree(jmodel, 4, jnp.asarray(x), jnp.asarray(t))
    want = jmodel.apply({"params": tree}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = _port(DEEP, tree)(torch.from_numpy(x), torch.from_numpy(t))
    assert _rel_err(got.numpy(), want) < TOL


def test_launch_counts_untouched_on_cpu():
    """On CPU tensors the wrappers take their twins and count nothing."""
    x, t, emb = _inputs(1024)
    model = random_init_(tunet.UNetCFG1d(**CFG), 0)
    before = (tflash.launches, tggn.launches)
    with torch.no_grad():
        model(torch.from_numpy(x), torch.from_numpy(t), embedding=torch.from_numpy(emb),
              embedding_scale=4.0)
    assert (tflash.launches, tggn.launches) == before


def test_bridge_round_trip_is_exact():
    x, t, emb = _inputs(256)
    tree = rand_tree(junet.UNetCFG1d(**CFG), 5, jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(emb))
    back = to_flax_params(_port(CFG, tree))
    flat = {}

    def walk(a, b, path=()):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], (*path, k))
            else:
                flat[(*path, k)] = np.array_equal(np.asarray(a[k]), b[k])

    walk(dict(tree), back)
    assert flat and all(flat.values())


def test_random_init_equals_fast_random_params():
    x, t, emb = _inputs(256)
    want = fast_random_params(junet.UNetCFG1d(**DEEP), 7, jnp.asarray(x), jnp.asarray(t),
                              embedding=jnp.asarray(emb))["params"]
    got = to_flax_params(random_init_(tunet.UNetCFG1d(**DEEP), 7))
    leaves = []

    def walk(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(b[k], dict):
                walk(a[k], b[k])
            else:
                leaves.append(np.array_equal(np.asarray(a[k]), b[k]))

    walk(dict(want), got)
    assert leaves and all(leaves)
