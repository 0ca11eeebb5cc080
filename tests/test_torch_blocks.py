"""The PyTorch port's blocks against their flax counterparts.

Each flax block gets a random param tree (every leaf nonzero, so biases
and norm affines are exercised too); the same tree goes into the port's
module through utils/params.load_flax_params, the same numpy input through
both, and the outputs are compared in f32. JAX works in (B, T, C), the
port in (B, C, T).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.models import blocks as jb
from audio_algebra_torch.models import blocks as tb
from audio_algebra_torch.utils.params import load_flax_params, to_flax_params

TOL = 2e-5       # f32 on the CPU: only summation order differs


def rand_tree(module, seed, *args):
    """A flax param tree for `module` with every leaf drawn at random."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if len(leaf.shape) == 1:
            base = 1.0 if name == "scale" else 0.0
            return base + 0.2 * rng.standard_normal(leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)["params"]


def run_both(jmod, tmod, x_btc, seed=0):
    """Apply the flax module to x (B, T, C) and the port's module, loaded
    with the same params, to x transposed; return both as (B, C, T)."""
    tree = rand_tree(jmod, seed, jnp.asarray(x_btc))
    want = jmod.apply({"params": tree}, jnp.asarray(x_btc))
    load_flax_params(tmod, tree)
    with torch.no_grad():
        got = tmod(torch.from_numpy(np.ascontiguousarray(x_btc.transpose(0, 2, 1))))
    return got.numpy(), np.asarray(want).transpose(0, 2, 1)


def _x(seed, b, t, c):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(np.float32)


@pytest.mark.parametrize("c_in,c_out,k,stride,dilation,t", [
    (3, 5, 5, 1, 1, 20),        # SAME, symmetric (2, 2)
    (4, 6, 8, 4, 1, 32),        # the encoder's kernel-2s stride-s conv
    (4, 6, 3, 2, 1, 16),        # SAME asymmetric: (0, 1)
    (4, 4, 7, 1, 3, 30),        # dilated conv7: (9, 9)
])
def test_conv1d(c_in, c_out, k, stride, dilation, t):
    got, want = run_both(jb.Conv1d(c_out, k, stride=stride, dilation=dilation),
                         tb.Conv1d(c_in, c_out, k, stride=stride, dilation=dilation),
                         _x(1, 2, t, c_in))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("c_in,c_mid,c_out,t,is_last", [
    (6, 8, 16, 20, False),       # JAX takes its jnp GroupNorm path
    (64, 128, 128, 32, False),   # JAX takes its Pallas GroupNorm kernel
    (128, 128, 128, 32, False),  # identity skip
    (128, 128, 2, 32, True),     # the io head
])
def test_resconvblock(c_in, c_mid, c_out, t, is_last):
    got, want = run_both(jb.ResConvBlock(c_mid, c_out, is_last=is_last),
                         tb.ResConvBlock(c_in, c_mid, c_out, is_last=is_last),
                         _x(2, 2, t, c_in))
    np.testing.assert_allclose(got, want, atol=5 * TOL, rtol=5 * TOL)


@pytest.mark.parametrize("c,n_head,t", [(128, 4, 16), (64, 2, 8)])
def test_self_attention(c, n_head, t):
    got, want = run_both(jb.SelfAttention1d(n_head), tb.SelfAttention1d(c, n_head),
                         _x(3, 2, t, c))
    np.testing.assert_allclose(got, want, atol=5 * TOL, rtol=5 * TOL)


@pytest.mark.parametrize("jcls,tcls", [(jb.Downsample1d, tb.Downsample1d),
                                       (jb.Upsample1d, tb.Upsample1d)])
def test_resample_blocks(jcls, tcls):
    x = _x(4, 2, 16, 8)
    want = np.asarray(jcls().apply({}, jnp.asarray(x))).transpose(0, 2, 1)
    got = tcls()(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_fourier_features():
    t = np.random.default_rng(5).uniform(0, 1, 4).astype(np.float32)
    jmod = jb.FourierFeatures(16)
    tree = rand_tree(jmod, 5, jnp.asarray(t))
    want = np.asarray(jmod.apply({"params": tree}, jnp.asarray(t)))
    tmod = load_flax_params(tb.FourierFeatures(16), tree)
    got = tmod(torch.from_numpy(t)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,t_len", [(8, 32), (8, 8), (6, 20)])
def test_upsample_to(n, t_len):
    cond = _x(6, 2, n, 3)
    want = np.asarray(jb.upsample_to(jnp.asarray(cond), t_len)).transpose(0, 2, 1)
    got = tb.upsample_to(torch.from_numpy(np.ascontiguousarray(cond.transpose(0, 2, 1))),
                         t_len).numpy()
    np.testing.assert_array_equal(got, want)


def test_timestep_broadcast():
    emb = _x(7, 1, 2, 16)[0]
    want = np.asarray(jb.timestep_broadcast(jnp.asarray(emb), 5)).transpose(0, 2, 1)
    got = tb.timestep_broadcast(torch.from_numpy(emb), 5).numpy()
    np.testing.assert_array_equal(got, want)


def test_same_padding_rule():
    assert tb.same_padding(65536, 5) == (2, 2)
    assert tb.same_padding(1000, 7, dilation=9) == (27, 27)
    assert tb.same_padding(64, 8, stride=4) == (2, 2)
    assert tb.same_padding(16, 3, stride=2) == (0, 1)
    assert tb.same_padding(4, 1) == (0, 0)


def test_bridge_rejects_a_mismatched_tree():
    mod = tb.ResConvBlock(6, 8, 16)
    tree = to_flax_params(mod)
    del tree["Conv1d_0"]["bias"]
    with pytest.raises(KeyError):
        load_flax_params(mod, tree)
    tree = to_flax_params(mod)
    tree["extra"] = {"kernel": np.zeros((1, 1))}
    with pytest.raises(KeyError):
        load_flax_params(mod, tree)
