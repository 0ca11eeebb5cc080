"""Kernel K5's plain twin (the CPU route of ops/groupnorm_grouped.py)
against the JAX grouped GroupNorm + FiLM + SiLU: its Pallas apply kernel
in interpret mode (AA_LDM_GN_PALLAS=1) and the flax GroupNorm + FiLM + SiLU
route of unet_cfg1d.GroupNormFoldable, at (B, C, T) = (2, 128, 64) with
8 groups, FiLM on and off, SiLU on and off. JAX works in (B, T, C)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.models import unet_cfg1d as junet
from audio_algebra_tpu.ops.pallas import groupnorm_grouped as jggn
from audio_algebra_torch.models.blocks import GroupNorm
from audio_algebra_torch.ops import groupnorm_grouped as tggn

B, C, T, G = 2, 128, 64, 8
TOL = 1e-5       # f32 on the CPU: summation order only


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, C, T)) * 1.7 + 0.4).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(C)).astype(np.float32)
    ts = (0.5 * rng.standard_normal((B, 2 * C))).astype(np.float32)   # (B, 2C) FiLM
    return x, scale, bias, ts


def _btc(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1)))


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_twin_matches_jax(monkeypatch, film, silu):
    x, scale, bias, ts = _inputs(int(film) * 2 + int(silu))
    fs, sh = (ts[:, :C], ts[:, C:]) if film else (None, None)
    monkeypatch.setenv("AA_LDM_GN_PALLAS", "1")
    assert jggn.supported((B, T, C), G)
    jfilm = (lambda a: None if a is None else jnp.asarray(a)[:, None, :])
    want_k = jggn.grouped_gn_film_silu(_btc(x), jnp.asarray(scale), jnp.asarray(bias), G,
                                       film_scale=jfilm(fs), film_shift=jfilm(sh), silu=silu)
    monkeypatch.setenv("AA_LDM_GN", "0")
    want_f = junet.GroupNormFoldable(G).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, _btc(x),
        film_scale=jfilm(fs), film_shift=jfilm(sh), silu=silu)
    tts = torch.from_numpy(ts)
    tfs, tsh = tts.chunk(2, dim=1) if film else (None, None)     # strided rows
    got = tggn.grouped_gn_film_silu(torch.from_numpy(x), torch.from_numpy(scale),
                                    torch.from_numpy(bias), G, tfs, tsh, silu)
    got = got.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, np.asarray(want_k), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(want_f), atol=TOL, rtol=TOL)


def test_module_runs_the_twin_in_bf16():
    x, scale, bias, ts = _inputs(5)
    gn = GroupNorm(C, G)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    xb = torch.from_numpy(x).bfloat16()
    fs, sh = torch.from_numpy(ts).bfloat16().chunk(2, dim=1)
    got = gn(xb, fs, sh)
    assert got.dtype == torch.bfloat16
    want = tggn.grouped_gn_film_silu_ref(xb.float(), gn.weight, gn.bias, G, fs.float(),
                                         sh.float())
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2 ** -7)


def test_wrapper_checks_its_inputs():
    x = torch.zeros(2, 12, 8)
    with pytest.raises(ValueError):
        tggn.grouped_gn_film_silu(x, torch.ones(12), torch.zeros(12), 5)
    with pytest.raises(ValueError):
        tggn.grouped_gn_film_silu(x, torch.ones(12), torch.zeros(12), 4,
                                  film_scale=torch.zeros(2, 6))
