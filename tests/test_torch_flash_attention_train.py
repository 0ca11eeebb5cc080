"""Kernel K4's plain twins (the CPU route of ops/flash_attention.py's
differentiable flash attention) against the JAX package's training kernels
in interpret mode: the forward's (o, l, m) against `_fwd_impl`, and dq, dk,
dv, d(biasT) of the autograd.Function against `jax.grad` of
`flash_attention_relpos_train`, in f32 at JAX's own tolerance (atol = rtol =
2e-4, tests/test_flash_attention.py) and in bf16 at 5e-2; d(biasT)'s sum
over the batch at B = 1, 2, 3; the training gate; a float64 gradcheck of
the twin path; and RelPosSelfAttention's output and parameter gradients,
the rel-pos bucket table included, against JAX under
AA_TRAIN_FLASH=interpret."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.models import unet_cfg1d as junet
from audio_algebra_tpu.ops.pallas import flash_attention as jflash
from audio_algebra_torch.models import unet_cfg1d as tunet
from audio_algebra_torch.ops import flash_attention as tflash
from audio_algebra_torch.utils.params import load_flax_params, to_flax_grads
from test_torch_blocks import rand_tree

F32 = dict(rtol=2e-4, atol=2e-4)        # JAX's own, for its training kernels
BF16 = dict(rtol=5e-2, atol=5e-2)


def _inputs(shape, seed, bias_scale=0.5):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    h, t = shape[1], shape[2]
    bias_t = (rng.standard_normal((h, t, t)) * bias_scale).astype(np.float32)
    return q, k, v, cot, bias_t


def _jax_grads(q, k, v, cot, bias_t, scale, dtype=jnp.float32):
    q, k, v, cot, bias_t = (jnp.asarray(a).astype(dtype) for a in (q, k, v, cot, bias_t))

    def loss(q, k, v, bias_t):
        o = jflash.flash_attention_relpos_train(q, k, v, bias_t, scale, 512, True)
        return jnp.sum(o.astype(jnp.float32) * cot.astype(jnp.float32))

    return jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, bias_t)


def _torch_grads(q, k, v, cot, bias_t, scale, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v, bias_t)]
    o = tflash.flash_attention_relpos_train(*leaves, scale)
    assert o.grad_fn is not None and o.dtype == dtype
    return o, torch.autograd.grad(o, leaves, torch.from_numpy(cot).to(dtype))


@pytest.mark.parametrize("shape", [(2, 2, 1024, 64), (1, 2, 512, 32)])
def test_forward_residuals_match_jax(shape):
    q, k, v, _, bias_t = _inputs(shape, 0)
    scale = shape[3] ** -0.5
    want_o, want_l, want_m = jflash._fwd_impl(*(jnp.asarray(a) for a in (q, k, v, bias_t)),
                                              scale, 512, True)
    o, l, m = tflash.flash_attention_relpos_fwd(*(torch.from_numpy(a) for a in (q, k, v, bias_t)),
                                                scale)
    assert l.shape == m.shape == (shape[1], shape[0], shape[2]) and l.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **F32)
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(want_l), rtol=1e-4, atol=1e-4)


def test_residuals_with_the_row_max_in_the_last_block():
    """JAX's stability case: the max arrives late, (l, m) are the final ones."""
    q, k, v, _, bias_t = _inputs((1, 1, 1024, 64), 3)
    bias_t[:, -256:, :] += 60.0
    want = jflash._fwd_impl(*(jnp.asarray(a) for a in (q, k, v, bias_t)), 1.0, 512, True)
    got = tflash.flash_attention_relpos_fwd(*(torch.from_numpy(a) for a in (q, k, v, bias_t)))
    assert np.isfinite(got[0].numpy()).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 2, 1024, 64), (1, 2, 512, 32)])
def test_function_grads_match_jax_grad(shape):
    q, k, v, cot, bias_t = _inputs(shape, 7)
    scale = shape[3] ** -0.5
    want = _jax_grads(q, k, v, cot, bias_t, scale)
    _, got = _torch_grads(q, k, v, cot, bias_t, scale)
    for name, a, b in zip(("dq", "dk", "dv", "dbiasT"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **F32)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_dbias_is_summed_over_the_batch(batch):
    """d(biasT) is shared by the batch: right at B = 1 and wrong at B > 1
    is the fault to expect of a blocked backward."""
    q, k, v, cot, bias_t = _inputs((batch, 2, 512, 16), 11 + batch)
    want = _jax_grads(q, k, v, cot, bias_t, 0.25)
    _, got = _torch_grads(q, k, v, cot, bias_t, 0.25)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **F32)
    per_row = sum(_torch_grads(q[i:i + 1], k[i:i + 1], v[i:i + 1], cot[i:i + 1], bias_t,
                               0.25)[1][3] for i in range(batch))
    np.testing.assert_allclose(got[3].numpy(), per_row.numpy(), rtol=1e-5, atol=1e-5)


def test_bf16_follows_the_kernels_casts():
    """bf16 q, k, v and bias: p and ds are normalised in f32 and cast before
    their products, the accumulators f32, the outputs bf16."""
    shape = (2, 2, 512, 32)
    q, k, v, cot, bias_t = _inputs(shape, 21, bias_scale=0.1)
    want = _jax_grads(q, k, v, cot, bias_t, 32 ** -0.5, jnp.bfloat16)
    o, got = _torch_grads(q, k, v, cot, bias_t, 32 ** -0.5, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv", "dbiasT"), got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   err_msg=name, **BF16)


@pytest.mark.parametrize("t", [64, 256, 384, 512, 768, 1000, 1024, 1536, 2048, 3072])
def test_train_gate_matches_jax(t):
    assert tflash.flash_train_ok(t) == jflash.flash_train_ok(t)
    assert tflash.flash_train_ok(512) and not tflash.flash_ok(512)


def test_gradcheck_of_the_twin_path():
    rng = np.random.default_rng(5)
    leaves = [torch.from_numpy(rng.standard_normal((2, 2, 8, 4))).requires_grad_()
              for _ in range(3)]
    leaves.append(torch.from_numpy(rng.standard_normal((2, 8, 8)) * 0.3).requires_grad_())
    assert torch.autograd.gradcheck(
        lambda *a: tflash.flash_attention_relpos_train(*a, 0.25), leaves)


def test_bwd_checks_its_inputs():
    q = torch.zeros(1, 2, 128, 16)
    o, l, m = tflash.flash_attention_relpos_fwd(q, q, q, torch.zeros(2, 128, 128))
    with pytest.raises(ValueError):
        tflash.flash_attention_relpos_bwd(q, q, q, torch.zeros(2, 128, 128), o, l, m,
                                          torch.zeros(1, 2, 64, 16))


def test_rel_pos_self_attention_grads_match_jax(monkeypatch):
    """The module at T = 512 (the training gate, below the serving one):
    output and every parameter gradient, the bucket table's through the
    transposed Toeplitz construction, against JAX's interpret kernels."""
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((2, 512, 64)) * 0.5).astype(np.float32)
    jmod = junet.RelPosSelfAttention(heads=2, head_features=32)
    tree = rand_tree(jmod, 32, jnp.asarray(x))
    tree["rel_pos_bias"] = (rng.standard_normal((256, 2)) * 0.5).astype(np.float32)
    monkeypatch.setenv("AA_TRAIN_FLASH", "interpret")

    def loss(p):
        return jnp.sum(jnp.square(jmod.apply({"params": p}, jnp.asarray(x))))

    want_l, want_g = jax.value_and_grad(loss)(tree)
    tmod = tunet.RelPosSelfAttention(64, 2, 32)
    load_flax_params(tmod, tree)
    before = (tflash.launches, tflash.train_fwd_launches)
    y = tmod(torch.from_numpy(x))
    assert y.grad_fn is not None
    got_l = y.square().sum()
    got_l.backward()
    assert (tflash.launches, tflash.train_fwd_launches) == before     # the CPU counts nothing
    np.testing.assert_allclose(float(got_l.detach()), float(want_l), rtol=1e-4)
    got_g = to_flax_grads(tmod)
    assert set(got_g) == set(want_g) and "rel_pos_bias" in got_g
    assert np.abs(got_g["rel_pos_bias"]).max() > 0

    def walk(a, b, path=""):
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key], f"{path}/{key}")
            else:
                np.testing.assert_allclose(a[key], np.asarray(b[key]), rtol=3e-3, atol=3e-3,
                                           err_msg=f"{path}/{key}")

    walk(got_g, want_g)


def test_module_routes_by_grad_mode_and_hoisted_bias():
    """Under no_grad, or with a hoisted bias, or with train_flash off, the
    training kernels are not taken (the value is the same)."""
    rng = np.random.default_rng(41)
    x = torch.from_numpy((rng.standard_normal((1, 512, 32)) * 0.5).astype(np.float32))
    mod = tunet.RelPosSelfAttention(32, 2, 16)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.2))
    calls = []
    real = tunet.flash_attention_relpos_train

    def spy(*a):
        calls.append(1)
        return real(*a)

    tunet.flash_attention_relpos_train = spy
    try:
        trained = mod(x)
        assert calls == [1]
        with torch.no_grad():
            served = mod(x)
        hoisted = mod(x, bias=mod._bias(512, transposed=False))
        mod.train_flash = False
        plain = mod(x)
        assert calls == [1]
    finally:
        tunet.flash_attention_relpos_train = real
    for other in (served, hoisted, plain):
        torch.testing.assert_close(other, trained, rtol=1e-4, atol=1e-4)


def test_untrained_flash_site_under_grad_takes_the_plain_route(monkeypatch):
    """T = 1024 passes the serving gate, but under grad with train_flash off
    the module must not take the forward-only K3 (its wrapper refuses such
    inputs on the card): it takes the plain route, JAX's AA_TRAIN_FLASH=0
    training route, and matches jax.value_and_grad of it."""
    rng = np.random.default_rng(37)
    x = (rng.standard_normal((1, 1024, 32)) * 0.5).astype(np.float32)
    jmod = junet.RelPosSelfAttention(heads=2, head_features=16)
    tree = rand_tree(jmod, 37, jnp.asarray(x))
    tree["rel_pos_bias"] = (rng.standard_normal((256, 2)) * 0.5).astype(np.float32)
    monkeypatch.setenv("AA_TRAIN_FLASH", "0")

    def loss(p):
        return jnp.sum(jnp.square(jmod.apply({"params": p}, jnp.asarray(x))))

    want_l, want_g = jax.value_and_grad(loss)(tree)
    tmod = tunet.RelPosSelfAttention(32, 2, 16, train_flash=False)
    load_flax_params(tmod, tree)
    assert tflash.flash_ok(1024)
    calls = []
    real = tunet.flash_attention_relpos

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tunet, "flash_attention_relpos", spy)
    y = tmod(torch.from_numpy(x))
    got_l = y.square().sum()
    got_l.backward()
    assert calls == [] and y.grad_fn is not None
    np.testing.assert_allclose(float(got_l.detach()), float(want_l), rtol=1e-5)
    got_g, want_g = (jax.tree_util.tree_flatten_with_path(g) for g in (to_flax_grads(tmod),
                                                                     want_g))
    assert [p for p, _ in got_g[0]] == [p for p, _ in want_g[0]]
    for (path, a), (_, b) in zip(got_g[0], want_g[0]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=str(path))
