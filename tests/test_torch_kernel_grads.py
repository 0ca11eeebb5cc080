"""Autograd through the port's kernel wrappers. On the CPU the wrappers
take their twins, whose gradients must equal `jax.grad` through the JAX
functions: K1 (`groupnorm1_gelu_btc`, with and without GELU and residual;
its backward is JAX's plain `_gn_bwd_core`) and K5 (`grouped_gn_film_silu`,
with and without FiLM, the path through the statistics included). The
backward helpers the card's autograd.Functions call (`gn1_backward`, the
grouped twin's autograd) are held against the same gradients, and the
inference-only kernels' guard (`refuse_grad`) is exercised directly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.ops.pallas import groupnorm as jgn
from audio_algebra_tpu.ops.pallas import groupnorm_grouped as jggn
from audio_algebra_torch.ops import groupnorm as tgn
from audio_algebra_torch.ops import groupnorm_grouped as tggn

TOL = dict(rtol=2e-4, atol=2e-5)     # f32: the order of the statistics' sums


def _gn_inputs(seed, b=2, c=128, t=64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c, t)) * 1.5 + 0.2).astype(np.float32)
    res = rng.standard_normal((b, c, t)).astype(np.float32)
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = (rng.random(c) - 0.5).astype(np.float32)
    cot = rng.standard_normal((b, c, t)).astype(np.float32)
    return x, res, scale, bias, cot


def _btc(a):
    return jnp.swapaxes(jnp.asarray(a), 1, 2)


@pytest.mark.parametrize("gelu,residual", [(True, True), (True, False), (False, True),
                                           (False, False)])
def test_groupnorm1_grads_match_jax(gelu, residual):
    x, res, scale, bias, cot = _gn_inputs(1)

    def loss(x, scale, bias, res):
        y = jgn.groupnorm1_gelu_btc(x, scale, bias, gelu=gelu,
                                    residual=res if residual else None)
        return jnp.sum(y * _btc(cot))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(_btc(x), jnp.asarray(scale),
                                                jnp.asarray(bias), _btc(res))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias, res)]
    y = tgn.groupnorm1_gelu(leaves[0], leaves[1], leaves[2], gelu,
                            leaves[3] if residual else None)
    got = torch.autograd.grad(y, leaves[:3 + residual], torch.from_numpy(cot))
    np.testing.assert_allclose(got[0].numpy(), np.swapaxes(np.asarray(want[0]), 1, 2), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=2e-4, atol=2e-3)
    if residual:
        np.testing.assert_array_equal(got[3].numpy(), cot)
    # what the card's Function calls in its backward
    dx, dscale, dbias = tgn.gn1_backward(*(torch.from_numpy(a) for a in (x, scale, bias, cot)),
                                         gelu)
    for a, b in zip((dx, dscale, dbias), got):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_groupnorm1_backward_casts_to_each_inputs_dtype():
    x, _, scale, bias, cot = _gn_inputs(2, c=32, t=16)
    args = [torch.from_numpy(a).bfloat16() for a in (x, scale, bias, cot)]
    grads = tgn.gn1_backward(*args, True)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    want = tgn.gn1_backward(*(a.float() for a in args), True)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w, rtol=2e-2, atol=2e-2 * float(w.abs().max()))


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("silu", [True, False])
def test_grouped_gn_grads_match_jax(film, silu):
    rng = np.random.default_rng(3)
    b, c, t, groups = 2, 32, 48, 8
    x = (rng.standard_normal((b, c, t)) * 1.5 + 0.3).astype(np.float32)
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = (rng.random(c) - 0.5).astype(np.float32)
    ts = (rng.standard_normal((b, 2 * c)) * 0.3).astype(np.float32)
    cot = rng.standard_normal((b, c, t)).astype(np.float32)

    def loss(x, scale, bias, ts):
        fs, sh = (ts[:, None, :c], ts[:, None, c:]) if film else (None, None)
        y = jggn.grouped_gn_film_silu(x, scale, bias, groups, film_scale=fs, film_shift=sh,
                                      silu=silu)
        return jnp.sum(y * _btc(cot))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(_btc(x), jnp.asarray(scale),
                                                jnp.asarray(bias), jnp.asarray(ts))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias, ts)]
    fs, sh = leaves[3].chunk(2, dim=1) if film else (None, None)
    y = tggn.grouped_gn_film_silu(leaves[0], leaves[1], leaves[2], groups, fs, sh, silu)
    got = torch.autograd.grad(y, leaves[:3 + film], torch.from_numpy(cot))
    np.testing.assert_allclose(got[0].numpy(), np.swapaxes(np.asarray(want[0]), 1, 2), **TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-3)


def test_grouped_function_backward_equals_autograd_of_the_twin():
    """The Function's backward, driven by hand on CPU tensors: it recomputes
    the twin in f32 from the saved inputs, absent FiLM planes included."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, 24)).astype(np.float32))
    scale = torch.from_numpy((rng.random(16) + 0.5).astype(np.float32))
    bias = torch.from_numpy((rng.random(16) - 0.5).astype(np.float32))
    shift = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32) * 0.3)
    cot = torch.from_numpy(rng.standard_normal((2, 16, 24)).astype(np.float32))

    class Ctx:
        saved_tensors = (x, scale, bias, None, shift)
        groups, silu, eps = 4, True, 1e-6

    got = tggn._GroupedGN.backward(Ctx, cot)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias, shift)]
    y = tggn.grouped_gn_film_silu_ref(leaves[0], leaves[1], leaves[2], 4, None, leaves[3])
    want = torch.autograd.grad(y, leaves, cot)
    assert got[3] is None and got[5:] == (None, None, None)
    for a, b in zip((got[0], got[1], got[2], got[4]), want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_inference_only_guard():
    """K2, K3 and K6 call this guard on the card: it raises only when grad
    is enabled and a tensor requires grad."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tgn.refuse_grad("a kernel", torch.zeros(3), None, x)
    with torch.no_grad():
        tgn.refuse_grad("a kernel", x)
    tgn.refuse_grad("a kernel", x.detach(), None)
    assert tgn.wants_grad(None, x) and not tgn.wants_grad(x.detach())
    with torch.no_grad():
        assert not tgn.wants_grad(x)
