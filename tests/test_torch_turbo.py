"""The PyTorch port's turbo int8 route against the JAX package's.

K2's plain twins (int8 emit, residual + amax, + int8 twin) against JAX's
`groupnorm1_gelu_btc`, which runs its Pallas bodies in interpret mode here;
`quantize_act` and `conv1d_int8` (with the two-part split skip join and a
2-channel head); a turbo ResConvBlock and _Stack3; the v-DDIM aux mode.
JAX turns turbo on with AA_TURBO_INT8 and gates it with AA_TURBO_MIN_B (set
here per test with monkeypatch); the port takes `turbo=True` and
`turbo_min_b=1`. The shapes pass JAX's `supported` (C % 128 == 0, T a power
of two), so both take their kernels. Inputs come from numpy seeds; JAX works
in (B, T, C), the port in (B, C, T).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.models import blocks as jb
from audio_algebra_tpu.models import unet1d as ju
from audio_algebra_tpu.ops.pallas.groupnorm import groupnorm1_gelu_btc
from audio_algebra_tpu.samplers import vddim as jvddim
from audio_algebra_torch.models import blocks as tb
from audio_algebra_torch.models import unet1d as tu
from audio_algebra_torch.ops import groupnorm as gn
from audio_algebra_torch.samplers import vddim as tvddim
from audio_algebra_torch.utils.params import load_flax_params
from test_torch_blocks import rand_tree

F32_TOL = 1e-5                       # f32: the statistics' summation order
BF16_ATOL, BF16_RTOL = 1e-2, 2 ** -7  # bf16: one rounding flip of the output
# port vs JAX, turbo, f32. Summation order alone differs by ~1e-7, but it
# can flip an int8 rounding tie (allowed above), and one flipped value of
# GN_0's int8 moves a (2, 256, 512) block's output by ~1e-4 rel-RMS.
TURBO_REL_RMS = 5e-4
ENGAGED = (1e-5, 0.05)               # turbo vs the port's own float route
SHAPE = (2, 256, 512)                # (B, C, T)


def bct(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)
                                                 .transpose(0, 2, 1))).to(dtype)


def btc(t):
    return np.ascontiguousarray(t.detach().float().numpy().transpose(0, 2, 1))


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / max(np.mean(want ** 2), 1e-30)))


def assert_int8_close(got, want):
    """Equal int8 values, but for rounding ties: at most 1 LSB apart, on
    at most 0.1 % of the elements."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


def _gn_inputs(seed):
    rng = np.random.default_rng(seed)
    b, c, t = SHAPE
    x = (rng.standard_normal((b, t, c)) * 1.7 + 0.3).astype(np.float32)
    res = (rng.standard_normal((b, t, c)) * 2.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, c).astype(np.float32)
    grid = rng.uniform(0.02, 0.08, c).astype(np.float32)
    return x, res, scale, bias, grid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["quant", "res_amax", "res_amax_q"])
def test_k2_twins_match_jax(dtype, mode):
    x, res, scale, bias, grid = _gn_inputs(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jr, js, jbias = (jnp.asarray(a, jdt) for a in (x, res, scale, bias))
    tx, tr = bct(np.asarray(jx.astype(jnp.float32)), tdt), bct(np.asarray(jr.astype(jnp.float32)), tdt)
    ts = torch.from_numpy(np.array(js.astype(jnp.float32))).to(tdt)
    tbias = torch.from_numpy(np.array(jbias.astype(jnp.float32))).to(tdt)
    tgrid = torch.from_numpy(grid)
    if mode == "quant":
        want = groupnorm1_gelu_btc(jx, js, jbias, quant_scale=jnp.asarray(grid))
        got = gn.groupnorm1_gelu_quant_ref(tx, ts, tbias, tgrid)
        assert got.dtype == torch.int8
        assert_int8_close(btc(got), np.asarray(want))
        return
    q = jnp.asarray(grid) if mode == "res_amax_q" else None
    want = groupnorm1_gelu_btc(jx, js, jbias, residual=jr, emit_amax=True, q_emit_scale=q)
    got = gn.groupnorm1_gelu_res_amax_ref(tx, ts, tbias, tr,
                                          q_emit_scale=tgrid if q is not None else None)
    assert len(got) == len(want) == (3 if q is not None else 2)
    w_out = np.asarray(want[0].astype(jnp.float32))
    assert got[0].dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(btc(got[0]), w_out, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(btc(got[0]), w_out, atol=BF16_ATOL, rtol=BF16_RTOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=F32_TOL, atol=0)
    if q is not None:
        assert_int8_close(btc(got[2]), np.asarray(want[2]))


def test_k2_wrappers_on_cpu_take_the_twins():
    x, res, scale, bias, grid = _gn_inputs(1)
    args = (bct(x), torch.from_numpy(scale), torch.from_numpy(bias))
    before = (gn.quant_launches, gn.amax_launches, gn.amax_q_launches)
    q = gn.groupnorm1_gelu_quant(*args, torch.from_numpy(grid))
    assert torch.equal(q, gn.groupnorm1_gelu_quant_ref(*args, torch.from_numpy(grid)))
    out, amax = gn.groupnorm1_gelu_res_amax(*args, bct(res))
    out2, amax2, o8 = gn.groupnorm1_gelu_res_amax(*args, bct(res),
                                                  q_emit_scale=torch.from_numpy(grid))
    assert torch.equal(out, out2) and torch.equal(amax, amax2)
    assert torch.equal(amax, out.abs().amax(dim=(0, 2)))        # f32: no cast in between
    assert (gn.quant_launches, gn.amax_launches, gn.amax_q_launches) == before
    with pytest.raises(ValueError):
        gn.groupnorm1_gelu_quant(*args, torch.ones(7))


def test_quantize_act_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 64, 128)) * 2.0).astype(np.float32)
    amax = np.abs(x).max(axis=(0, 1)) * rng.uniform(0.8, 1.3, 128).astype(np.float32)
    amax[:3] = 0.0                                  # the 1e-6 floor
    w8, ws = jb.quantize_act(jnp.asarray(x), jnp.asarray(amax))
    g8, gs = tb.quantize_act(bct(x), torch.from_numpy(amax))
    np.testing.assert_array_equal(btc(g8.float()).astype(np.int8), np.asarray(w8))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("parts,c_out", [((128,), 128), ((128, 128), 128), ((256,), 2)])
def test_conv1d_int8_matches_jax(parts, c_out):
    """Per part: its slice of the kernel, its own s_w, its output cast to
    out_dtype, the bias on part 0 only (the split skip join); and the
    2-channel io head, whose Cout the port pads for the int8 product."""
    rng = np.random.default_rng(3)
    c_in, t = sum(parts), 64
    kernel = (rng.standard_normal((5, c_in, c_out)) / np.sqrt(5 * c_in)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    xs = [rng.integers(-127, 128, (2, t, c), dtype=np.int8) for c in parts]
    scales = [rng.uniform(0.005, 0.05, c).astype(np.float32) for c in parts]
    jconv = jb.Conv1d(c_out, 5)
    tree = {"kernel": kernel, "bias": bias}
    jx = tuple(jnp.asarray(a) for a in xs)
    js = tuple(jnp.asarray(s) for s in scales)
    want = jconv.apply({"params": tree}, jx if len(parts) > 1 else jx[0],
                       x_scale=js if len(parts) > 1 else js[0], out_dtype=jnp.float32)
    tconv = load_flax_params(tb.Conv1d(c_in, c_out, 5), tree)
    tx = tuple(torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))) for a in xs)
    tsc = tuple(torch.from_numpy(s) for s in scales)
    with torch.no_grad():
        got = tconv.forward_int8(tx if len(parts) > 1 else tx[0],
                                 tsc if len(parts) > 1 else tsc[0], torch.float32)
    assert got.shape == (2, c_out, t) and got.dtype == torch.float32
    np.testing.assert_allclose(btc(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL * np.abs(np.asarray(want)).max())
    # the int8 weights and their products are the same integers as JAX's
    w = kernel[:, :parts[0]] * scales[0][None, :, None]
    s_w = np.maximum(np.abs(w).max(axis=(0, 1)), 1e-12) / 127.0
    w8 = np.clip(np.round(w / s_w), -127, 127).astype(np.int8).transpose(2, 1, 0)
    acc = tb._int8_conv_acc(tx[0], torch.from_numpy(np.ascontiguousarray(w8)))
    xp = np.pad(xs[0].astype(np.int64), ((0, 0), (2, 2), (0, 0)))
    ref = sum(np.einsum("btc,oc->obt", xp[:, k:k + t], w8[:, :, k].astype(np.int64))
              for k in range(5))
    np.testing.assert_array_equal(acc.numpy(), ref)


def _block_inputs(seed, c=256):
    rng = np.random.default_rng(seed)
    b, _, t = SHAPE
    return (rng.standard_normal((b, t, c)) * 0.6).astype(np.float32)


def _carry_input(x):
    grid = (np.abs(x).max(axis=(0, 1)) * 1.25 / 127.0).astype(np.float32)
    return np.clip(np.round(x / grid), -127, 127).astype(np.int8), grid


@pytest.mark.parametrize("variant", ["plain", "amax", "carry"])
def test_resconvblock_turbo_matches_jax(variant, monkeypatch):
    """plain: conv1 float, GN_0 int8 (K2a), conv2 int8, GN_1 float (K1);
    amax: conv1 on quantize_act of the bounded input, GN_1 emits amax
    (K2b); carry: conv1 on the given int8 twin, GN_1 emits amax and its own
    twin (K2c)."""
    x = _block_inputs(4)
    jmod = jb.ResConvBlock(256, 256)
    tree = rand_tree(jmod, 4, jnp.asarray(x))
    tmod = load_flax_params(tb.ResConvBlock(256, 256, 256), tree)
    grid = np.random.default_rng(5).uniform(0.02, 0.06, 256).astype(np.float32)
    jkw, tkw = {}, {}
    if variant == "amax":
        amax = np.abs(x).max(axis=(0, 1))
        jkw = dict(x_amax=jnp.asarray(amax), emit_amax=True)
        tkw = dict(x_amax=torch.from_numpy(amax), emit_amax=True)
    elif variant == "carry":
        x8, s8 = _carry_input(x)
        jkw = dict(x_q=jb.Int8Act(jnp.asarray(x8), jnp.asarray(s8)),
                   q_emit_scale=jnp.asarray(grid))
        tkw = dict(x_q=tb.Int8Act(torch.from_numpy(np.ascontiguousarray(x8.transpose(0, 2, 1))),
                                  torch.from_numpy(s8)),
                   q_emit_scale=torch.from_numpy(grid))
    monkeypatch.setenv("AA_TURBO_INT8", "1")
    monkeypatch.setenv("AA_TURBO_MIN_B", "1")
    want = jmod.apply({"params": tree}, jnp.asarray(x), **jkw)
    with torch.no_grad():
        got = tmod(bct(x), turbo=True, **tkw)
        plain = tmod(bct(x))
    if variant == "plain":
        got, want = (got,), (want,)
    assert len(got) == len(want)
    w_out = np.asarray(want[0])
    assert rel_rms(btc(got[0]), w_out) < TURBO_REL_RMS
    assert ENGAGED[0] < rel_rms(btc(got[0]), btc(plain)) < ENGAGED[1]
    if variant != "plain":
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=F32_TOL, atol=0)
    if variant == "carry":
        assert torch.equal(got[2].scale, torch.from_numpy(grid))
        assert_int8_close(btc(got[2].x8.float()), np.asarray(want[2].x8))


def jax_self_rel(fn, x, want, eps=1e-6):
    """rel-RMS of JAX's own turbo output when its input moves by a relative
    `eps` (the size of a summation-order difference, and then some). The
    int8 grids hang on amaxes, so a flipped rounding tie changes a grid and
    with it ~1 % of the next int8 values: past one block, two exact
    implementations agree only to this. The port is held to it."""
    noise = np.random.default_rng(99).standard_normal(x.shape).astype(np.float32)
    return rel_rms(np.asarray(fn(x * (1 + eps * noise))), want)


def _q_scale(bound):
    return (np.maximum(bound, np.float32(1e-6)) * np.float32(1.25) / np.float32(127.0)) \
        .astype(np.float32)


@pytest.mark.parametrize("carry", [False, True])
def test_stack_turbo_matches_jax(carry, monkeypatch):
    """A turbo _Stack3 without attention threads the amax through its three
    blocks; with the carry (the previous step's amaxes) its first two
    blocks' GN_1 emit the int8 twins the next conv1 reads. Block by block,
    each port block fed JAX's block inputs agrees with JAX up to rounding
    ties; the whole stack agrees within JAX's own sensitivity."""
    x = _block_inputs(6)
    jmod = ju._Stack3(256, 256, attn=False)
    tree = rand_tree(jmod, 6, jnp.asarray(x))
    tmod = load_flax_params(tu._Stack3(256, 256, 256, attn=False), tree)
    rng = np.random.default_rng(7)
    q_in = tuple(rng.uniform(2.0, 4.0, 256).astype(np.float32) for _ in range(2)) \
        if carry else None
    monkeypatch.setenv("AA_TURBO_INT8", "1")
    monkeypatch.setenv("AA_TURBO_MIN_B", "1")

    def jstack(xx):
        return jmod.apply({"params": tree}, jnp.asarray(xx),
                          q_in=None if q_in is None else tuple(map(jnp.asarray, q_in)))

    want = jstack(x)
    with torch.no_grad():
        got = tmod(bct(x), q_in=None if q_in is None else tuple(map(torch.from_numpy, q_in)),
                   turbo=True)
        plain, a_plain, q_plain = tmod(bct(x))
    assert a_plain is None and q_plain is None
    assert rel_rms(btc(got[0]), np.asarray(want[0])) \
        < 2 * jax_self_rel(lambda v: jstack(v)[0], x, np.asarray(want[0]))
    assert ENGAGED[0] < rel_rms(btc(got[0]), btc(plain)) < ENGAGED[1]
    assert got[1].shape == (256,) and len(got[2]) == len(want[2]) == 2
    assert bool((got[1] >= torch.from_numpy(btc(got[0])).abs().amax(dim=(0, 1)) - 1e-6).all())

    j_in, t_amax, j_amax, j_q = x, None, None, None          # block by block
    for name, k in (("m0", 0), ("m2", 1), ("m4", None)):
        jkw = {"x_amax": None if j_amax is None else jnp.asarray(j_amax)}
        tkw = {"x_amax": None if j_amax is None else torch.from_numpy(j_amax)}
        if j_q is not None:
            jkw["x_q"] = jb.Int8Act(jnp.asarray(j_q[0]), jnp.asarray(j_q[1]))
            tkw["x_q"] = tb.Int8Act(torch.from_numpy(np.ascontiguousarray(
                j_q[0].transpose(0, 2, 1))), torch.from_numpy(j_q[1]))
        if carry and k is not None:
            grid = _q_scale(q_in[k])
            jkw["q_emit_scale"], tkw["q_emit_scale"] = jnp.asarray(grid), torch.from_numpy(grid)
            assert torch.equal(tu._q_scale(torch.from_numpy(q_in[k])), torch.from_numpy(grid))
        else:
            jkw["emit_amax"] = tkw["emit_amax"] = True
        jo = jb.ResConvBlock(256, 256).apply({"params": tree[name]}, jnp.asarray(j_in), **jkw)
        with torch.no_grad():
            to = getattr(tmod, name)(bct(j_in), turbo=True, **tkw)
        assert len(to) == len(jo)
        assert rel_rms(btc(to[0]), np.asarray(jo[0])) < TURBO_REL_RMS
        # max is 1-Lipschitz: a tie that moved an output moves its amax no more
        dev = np.abs(btc(to[0]) - np.asarray(jo[0])).max(axis=(0, 1))
        assert (np.abs(to[1].numpy() - np.asarray(jo[1]))
                <= dev + F32_TOL * np.asarray(jo[1])).all()
        if len(jo) == 3:
            assert_int8_close(btc(to[2].x8.float()), np.asarray(jo[2].x8))
            j_q = (np.asarray(jo[2].x8), np.asarray(jo[2].scale))
        j_in, j_amax = np.asarray(jo[0]), np.asarray(jo[1])
    np.testing.assert_array_equal(j_in, np.asarray(want[0]))   # the chain is JAX's stack


def test_vddim_aux_mode_matches_jax():
    """Step 0 gets aux=None, step k the aux of step k-1."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 2, 32)).astype(np.float32)
    cond = rng.standard_normal((2, 2, 32)).astype(np.float32)

    def jmodel(x, t, aux, cond):
        bump = 0.0 if aux is None else 0.2 * aux[:, None, None]
        return 0.4 * x + 0.1 * cond + bump, jnp.mean(jnp.abs(x), axis=(1, 2)) + t

    def tmodel(x, t, aux, cond):
        bump = 0.0 if aux is None else 0.2 * aux[:, None, None]
        return 0.4 * x + 0.1 * cond + bump, x.abs().mean(dim=(1, 2)) + t

    want = jvddim.sample(jmodel, jnp.asarray(x), 5, 0, jnp.asarray(cond), aux_mode=True)
    got = tvddim.sample(tmodel, torch.from_numpy(x), 5, 0, torch.from_numpy(cond),
                        aux_mode=True)
    no_aux = tvddim.sample(lambda x, t, cond: tmodel(x, t, None, cond)[0],
                           torch.from_numpy(x), 5, 0, torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert not torch.allclose(got, no_aux)             # the aux reached the model


def test_turbo_below_the_batch_gate_is_the_float_route():
    unet = tu.DiffusionAttnUnet1D(io_channels=2, cond_dim=0, n_attn_layers=0,
                                  c_mults=(128, 128))
    xs = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 2, 64))
                          .astype(np.float32))
    t = torch.full((2,), 0.5)
    with torch.no_grad():
        assert torch.equal(unet(xs, t, turbo=True), unet(xs, t))       # B = 2 < 16
        _, aux = unet(xs, t, turbo=True, turbo_min_b=2, collect_q_aux=True)
        assert len(aux) == 4 and all(a is not None for a in aux)
