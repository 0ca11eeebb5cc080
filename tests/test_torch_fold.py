"""The port's parallel/fold.py and the dynamic-int8 ResConvBlock against the
JAX package's parallel/fold.py on the CPU.

The pickers line for line; `decode_unet_seqfold` in float (the fold is
layout only: the port runs the whole sequence) and with `quantized=True`
(the folded levels' conv5s int8 on an exact per-channel amax) on a depth-4
UNet (c_mults 8, 8, 16, 16; io 4, cond 8, T = 1024), which folds 2 levels
at B = 1 (n = 32) and 3 at B = 4 (n = 8), with a float level below; one
dynamic-int8 block at channel counts no turbo gate would pass (the 28- and
80-channel stem, a 32-channel head) against JAX's `_resconv(q=True)`. The
weights come through the flax bridge; inputs from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.models import blocks as jb
from audio_algebra_tpu.models.unet1d import DiffusionAttnUnet1D as JaxUnet
from audio_algebra_tpu.parallel import fold as jfold
from audio_algebra_torch.models import blocks as tb
from audio_algebra_torch.models.unet1d import DiffusionAttnUnet1D
from audio_algebra_torch.parallel import fold as tfold
from audio_algebra_torch.utils.params import load_flax_params
from test_torch_blocks import rand_tree
from test_torch_turbo import ENGAGED as BLOCK_ENGAGED
from test_torch_turbo import TURBO_REL_RMS, bct, btc, jax_self_rel, rel_rms

CFG = dict(io_channels=4, cond_dim=8, n_attn_layers=0, c_mults=(8, 8, 16, 16))
T_LEN = 1024
F32_REL = 1e-5
ENGAGED = (1e-5, 0.08)          # int8 in the fold vs the port's float forward
INT8_LEVELS = {1: 2, 4: 3}      # batch -> levels that fold (n = 32 / 8)


def turbo_bound(fn, x, want):
    """The bound of an int8 route against JAX's: twice JAX's own spread
    under a 1e-6 relative input change (test_torch_turbo.jax_self_rel),
    and never below the f32 agreement F32_REL. Past a flipped rounding tie
    two exact implementations agree only to that spread; where the change
    flips no tie (a B = 1 forward: spread 1.9e-7, the port 4.5e-6 from
    JAX), the two agree to f32 rounding carried through the int8 convs, and
    the floor holds them there. Printed, so a run shows the bound it used."""
    spread = jax_self_rel(fn, x, want)
    bound = max(2 * spread, F32_REL)
    print(f"turbo_bound: JAX spread {spread:.3g}, bound {bound:.3g}")
    return bound


@pytest.fixture(scope="module")
def unets():
    tree = rand_tree(JaxUnet(**CFG), 21, jnp.zeros((1, 4, T_LEN)), jnp.zeros((1,)),
                     jnp.zeros((1, 8, 64)))
    return tree, load_flax_params(DiffusionAttnUnet1D(**CFG), tree).eval()


def _inputs(batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 4, T_LEN)).astype(np.float32),
            rng.uniform(0.1, 0.9, batch).astype(np.float32),
            np.tanh(rng.standard_normal((batch, 8, 64))).astype(np.float32))


def _count_int8_convs(monkeypatch):
    calls = []
    real = tb.conv1d_int8

    def spy(x8, *args, **kwargs):
        calls.append(tuple(x8.shape))
        return real(x8, *args, **kwargs)

    monkeypatch.setattr(tb, "conv1d_int8", spy)
    return calls


def test_pickers_match_jax(monkeypatch):
    monkeypatch.delenv("AA_SEQFOLD", raising=False)
    monkeypatch.delenv("AA_SEQFOLD_MAX_B", raising=False)
    for b in range(1, 41):
        assert tfold.seqfold_ok(b) == jfold.seqfold_ok(b)
        for rows in (16, 32):
            assert tfold.pick_fold_blocks(b, rows) == jfold.pick_fold_blocks(b, rows)
    for t_len in (256, 512, 1000, 1024, 4096, 32768, 98304):
        for n in (1, 2, 4, 8, 16, 32, 64):
            for depth in (2, 4, 10, 14):
                for attn_start in (0, 1, 3, 6, depth):
                    assert tfold.pick_folded_levels(t_len, n, depth, attn_start) == \
                        jfold.pick_folded_levels(t_len, n, depth, attn_start)
    # JAX's own test_pickers, and the 22 s outer stage at B = 1 / 2 / 4 (turbo)
    assert [tfold.pick_fold_blocks(b) for b in (1, 4, 16, 9)] == [16, 4, 1, 2]
    assert tfold.pick_folded_levels(32768, 16, 10, attn_start=6) == 6
    assert tfold.pick_folded_levels(512, 16, 4, attn_start=3) == 2
    assert tfold.pick_folded_levels(512, 64, 4, attn_start=3) == 0
    assert [tfold.pick_folded_levels(32768, tfold.pick_fold_blocks(b, 32), 10, 10)
            for b in (1, 2, 4)] == [7, 8, 9]
    assert [tfold.pick_folded_levels(T_LEN, tfold.pick_fold_blocks(b, 32), 4, 4)
            for b in sorted(INT8_LEVELS)] == [INT8_LEVELS[b] for b in sorted(INT8_LEVELS)]


@pytest.mark.parametrize("batch", [1, 2])
def test_seqfold_float_matches_jax(unets, batch):
    tree, unet = unets
    x, t, cond = _inputs(batch, 22 + batch)
    want = np.asarray(jfold.decode_unet_seqfold(
        {"params": tree}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), **CFG))
    with torch.no_grad():
        got = tfold.decode_unet_seqfold(unet, *map(torch.from_numpy, (x, t, cond)))
        plain = unet(*map(torch.from_numpy, (x, t, cond)))
    assert rel_rms(got.numpy(), want) <= F32_REL
    assert torch.equal(got, plain)                 # no levels quantised: the plain forward


@pytest.mark.parametrize("batch", sorted(INT8_LEVELS))
def test_seqfold_quantized_matches_jax(unets, batch, monkeypatch):
    """Held to JAX's within `turbo_bound`, and to the int8 band from the
    port's own float forward."""
    tree, unet = unets
    x, t, cond = _inputs(batch, 30 + batch)

    def jfn(xx):
        return np.asarray(jfold.decode_unet_seqfold(
            {"params": tree}, jnp.asarray(xx), jnp.asarray(t), jnp.asarray(cond),
            quantized=True, **CFG))

    want = jfn(x)
    calls = _count_int8_convs(monkeypatch)
    with torch.no_grad():
        args = tuple(map(torch.from_numpy, (x, t, cond)))
        got = tfold.decode_unet_seqfold(unet, *args, quantized=True)
        plain = unet(*args)
    # 2 stacks a level x 3 blocks x 2 conv5s, nothing deeper
    assert len(calls) == 12 * INT8_LEVELS[batch]
    assert {c[-1] for c in calls} == {T_LEN >> j for j in range(INT8_LEVELS[batch])}
    assert rel_rms(got.numpy(), want) < turbo_bound(jfn, x, want)
    assert ENGAGED[0] < rel_rms(got.numpy(), plain.numpy()) < ENGAGED[1]


def test_seqfold_levels_are_checked(unets):
    _, unet = unets
    x, t, cond = map(torch.from_numpy, _inputs(1, 40))
    with torch.no_grad():
        assert torch.equal(tfold.decode_unet_seqfold(unet, x, t, cond, folded_levels=0,
                                                     quantized=True), unet(x, t, cond))
        with pytest.raises(ValueError, match="int8_levels=4"):
            tfold.decode_unet_seqfold(unet, x, t, cond, folded_levels=4, quantized=True)
        with pytest.raises(ValueError, match="turbo off"):
            unet(x, t, cond, int8_levels=1, turbo=True)


@pytest.mark.parametrize("c_in,c_mid,c_out,is_last", [(80, 48, 48, False),
                                                      (28, 8, 8, False),
                                                      (96, 48, 32, True)])
def test_dynamic_int8_block_matches_jax(c_in, c_mid, c_out, is_last):
    """JAX's fold `_resconv(q=True)` on one block (n = 1: the halo is SAME
    padding) at channel counts the turbo gates refuse: both conv5s int8 on
    an exact amax, GN_0 / GN_1 in float."""
    rng = np.random.default_rng(c_in + c_out)
    x = (0.7 * rng.standard_normal((2, 256, c_in))).astype(np.float32)
    jmod = jb.ResConvBlock(c_mid, c_out, is_last=is_last)
    tree = rand_tree(jmod, c_in, jnp.asarray(x))
    tmod = load_flax_params(tb.ResConvBlock(c_in, c_mid, c_out, is_last=is_last), tree)
    want = np.asarray(jfold._resconv(jnp.asarray(x)[:, None], tree, is_last=is_last,
                                     q=True))[:, 0]
    plain_j = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(bct(x), dynamic_int8=True)
        plain = tmod(bct(x))
    assert rel_rms(btc(got), want) < TURBO_REL_RMS
    assert rel_rms(btc(plain), plain_j) < F32_REL
    assert BLOCK_ENGAGED[0] < rel_rms(btc(got), btc(plain)) < BLOCK_ENGAGED[1]


def test_quantize_dynamic_matches_jax():
    """The int8 values and per-channel grid of one activation equal JAX's
    quantize_act on its exact amax over (B, T)."""
    rng = np.random.default_rng(41)
    x = torch.from_numpy((rng.standard_normal((2, 8, 64)) *
                          np.linspace(0.5, 2.0, 8)[None, :, None]).astype(np.float32))
    x8, s = tb.quantize_dynamic(x)
    j8, js = jb.quantize_act(jnp.asarray(btc(x)), jnp.max(jnp.abs(jnp.asarray(btc(x))),
                                                            axis=(0, 1)))
    np.testing.assert_array_equal(btc(x8.float()).astype(np.int8), np.asarray(j8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
