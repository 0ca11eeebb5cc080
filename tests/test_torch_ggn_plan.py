"""Kernel K5's host-side planner and the arithmetic of its cluster route,
on the CPU.

`groupnorm_grouped.ggn_plan` chooses, by shape, between the one-launch
cluster route (a (batch, group) row to a cluster of CTAs, each holding its
slice of the row in shared memory) and the two-pass route. The shapes are
those the port's own modules give K5, recorded by walking them on the meta
device: the 22 s inner UNet (UNetCFG1d defaults, a batch of 1 doubled by
CFG, T = 2048, bf16), the trainer's songs UNet (batch 8, f32) and its
frozen Encoder1d (batch 8, T = 32768, f32).

A torch model of the cluster's arithmetic (per-slice f32 sums, folded in
rank order, then the (S, T) planes and the apply) is held against JAX's
`grouped_gn_film_silu` (its Pallas apply in interpret mode, as
tests/test_torch_grouped_gn.py runs it) within 1e-4 in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.ops.pallas import groupnorm_grouped as jggn
from audio_algebra_torch.models import blocks, encoder1d, unet_cfg1d
from audio_algebra_torch.ops import groupnorm_grouped as ggn


def _k5_shapes(monkeypatch, build, x_shape, dtype, **call):
    """(shape, groups) of every K5 call of one forward of `build()`, on the
    meta device (no arithmetic)."""
    seen = []

    def spy(x, scale, bias, groups, film_scale=None, film_shift=None, silu=True, eps=1e-6):
        seen.append((tuple(x.shape), groups))
        return torch.empty_like(x)

    monkeypatch.setattr(blocks, "grouped_gn_film_silu", spy)
    monkeypatch.setattr(unet_cfg1d, "flash_attention_relpos",
                        lambda q, k, v, bias_t, sm_scale=1.0: torch.empty_like(q))
    with torch.device("meta"), torch.no_grad():
        model = build().to(dtype)
        args = [torch.empty(x_shape, dtype=dtype)]
        if "t" in call:
            args.append(torch.empty(call.pop("t"), dtype=dtype))
        if "embedding" in call:
            call["embedding"] = torch.empty(call["embedding"], dtype=dtype)
        model(*args, **call)
    return seen


INNER = dict(build=unet_cfg1d.UNetCFG1d, x_shape=(1, 32, 2048), dtype=torch.bfloat16,
             t=(1,), embedding=(1, 1, 512), embedding_scale=4.0)
SONGS = dict(build=unet_cfg1d.UNetCFG1d, x_shape=(8, 32, 2048), dtype=torch.float32,
             t=(8,), embedding=(8, 1, 512))
ENCODE = dict(build=encoder1d.Encoder1d, x_shape=(8, 32, 32768), dtype=torch.float32)


@pytest.mark.parametrize("model,calls", [(INNER, 63), (SONGS, 63), (ENCODE, 65)],
                         ids=["inner_unet_bf16", "songs_unet_f32", "frozen_encoder_f32"])
def test_every_main_path_shape_gets_a_route_that_fits(monkeypatch, model, calls):
    model = dict(model)
    seen = _k5_shapes(monkeypatch, model.pop("build"), model.pop("x_shape"),
                      model["dtype"], **{k: v for k, v in model.items() if k != "dtype"})
    assert len(seen) == calls                     # chip_smoke.py's launch counts
    esize = torch.empty((), dtype=model["dtype"]).element_size()
    for (b, c, t), groups in seen:
        plan = ggn.ggn_plan(b, c, t, groups, esize)
        n, vec = c // groups * t, 16 // esize
        if plan.route == "cluster":
            assert plan.cs in ggn.CLUSTER_SIZES and plan.threads in (128, 256, 512)
            assert plan.per % vec == 0 and plan.per * plan.cs >= n > plan.per * (plan.cs - 1)
            assert plan.smem <= ggn.SMEM_BUDGET
            assert plan.smem >= plan.per * esize + 24 * min(c // groups, -(-plan.per // t) + 1)
        else:                                     # only when no cluster size fits
            assert all(ggn.cluster_plan(n, c // groups, t, esize, cs) is None
                       for cs in ggn.CLUSTER_SIZES)
        if model["dtype"] == torch.bfloat16:      # the inner UNet: one launch, x read once
            assert plan.route == "cluster"


def test_inner_unet_widest_rows_take_sixteen_ctas():
    """The inner UNet's widest rows are cut into sixteen slices: (2, 512,
    2048) bf16 into 16 KB, (2, 1536, 2048) into 48 KB; its deepest level
    is one CTA a row."""
    assert ggn.ggn_plan(2, 512, 2048, 8, 2)[:2] == ("cluster", 16)
    assert ggn.ggn_plan(2, 512, 2048, 8, 2).per * 2 == 16 << 10
    assert ggn.ggn_plan(2, 1536, 2048, 8, 2)[:2] == ("cluster", 16)
    assert ggn.ggn_plan(2, 1536, 2048, 8, 2).per * 2 == 48 << 10
    assert ggn.ggn_plan(2, 1024, 32, 8, 2)[:2] == ("cluster", 1)


@pytest.mark.parametrize("shape,esize", [((1, 64, 131072), 4), ((1, 64, 262144), 2),
                                         ((2, 8, 1 << 21), 2)])
def test_a_row_too_long_for_sixteen_ctas_takes_two_passes(shape, esize):
    b, c, t = shape
    plan = ggn.ggn_plan(b, c, t, 8, esize)
    assert plan.route == "two_pass" and plan.n_split >= 1 and plan.apply_blocks >= 1
    assert ggn.cluster_plan(c // 8 * t, c // 8, t, esize, 16) is None


def test_a_row_of_two_megabytes_takes_sixteen_ctas():
    """The frozen encoder's f32 rows (2 MB) fit only at Hopper's
    non-portable cluster size."""
    plan = ggn.ggn_plan(8, 128, 32768, 8, 4)
    assert plan.route == "cluster" and plan.cs == 16


def _cluster_model(x, scale, bias, groups, fs, sh, cs):
    """K5's cluster route in torch on the CPU: each row cut into the
    planner's slices, each slice summed in f32 ((sum, sumsq), its
    partials), the partials folded in rank order, then mu, the clamped
    variance, rstd, the per-channel planes in the kernel's order and
    silu(x S + T) = y / (1 + e^-y)."""
    b, c, t = x.shape
    cg = c // groups
    n = cg * t
    per = ggn.cluster_plan(n, cg, t, 4, cs).per
    rows = x.reshape(b * groups, n)
    y = torch.empty_like(rows)
    for r in range(b * groups):
        bi, g = divmod(r, groups)
        a = c2 = torch.zeros((), dtype=torch.float32)
        for rank in range(cs):                       # rank order, as every CTA folds
            piece = rows[r, rank * per:(rank + 1) * per]
            a = a + piece.sum(dtype=torch.float32)
            c2 = c2 + piece.square().sum(dtype=torch.float32)
        mu = a / n
        rstd = torch.rsqrt(torch.clamp(c2 / n - mu * mu, min=0.0) + 1e-6)
        ch = torch.arange(g * cg, (g + 1) * cg)
        s_c = rstd * scale[ch]
        t_c = bias[ch] - mu * s_c
        if fs is not None:
            f = 1.0 + fs[bi, ch]
            s_c, t_c = s_c * f, t_c * f
        if sh is not None:
            t_c = t_c + sh[bi, ch]
        o = rows[r].reshape(cg, t) * s_c[:, None] + t_c[:, None]
        y[r] = (o / (1.0 + torch.exp(-o))).reshape(-1)
    return y.reshape(b, c, t)


@pytest.mark.parametrize("cs", [1, 2, 8])
@pytest.mark.parametrize("film", [False, True])
def test_cluster_arithmetic_matches_jax(monkeypatch, cs, film):
    b, c, t, groups = 2, 128, 64, 8
    rng = np.random.default_rng(cs * 2 + film)
    x = (rng.standard_normal((b, c, t)) * 1.7 + 0.4).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    ts = (0.5 * rng.standard_normal((b, 2 * c))).astype(np.float32)
    fs, sh = (ts[:, :c], ts[:, c:]) if film else (None, None)
    monkeypatch.setenv("AA_LDM_GN_PALLAS", "1")
    jfilm = (lambda a: None if a is None else jnp.asarray(a)[:, None, :])
    want = jggn.grouped_gn_film_silu(jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1))),
                                     jnp.asarray(scale), jnp.asarray(bias), groups,
                                     film_scale=jfilm(fs), film_shift=jfilm(sh), silu=True)
    want = np.asarray(want).transpose(0, 2, 1)
    tf = (lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)))
    got = _cluster_model(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
                         groups, tf(fs), tf(sh), cs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # the twin, which the card holds the kernel to, agrees as closely
    twin = ggn.grouped_gn_film_silu_ref(torch.from_numpy(x), torch.from_numpy(scale),
                                        torch.from_numpy(bias), groups, tf(fs), tf(sh))
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=1e-4, rtol=1e-4)


def test_bf16_silu_in_tanh_form_matches_the_twin():
    """For bf16 outputs the kernel computes SiLU as h + h tanh(h), h = y / 2
    (one MUFU operation; tanh.approx's ~2^-11 relative error is below
    bf16's 2^-9 rounding): rounded to bf16 it stays within the card's bf16
    tolerance of the twin's y sigmoid(y)."""
    y = torch.linspace(-30.0, 30.0, 200001)
    h = 0.5 * y
    got = (h + h * torch.tanh(h)).bfloat16().float()
    want = (y * torch.sigmoid(y)).bfloat16().float()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=2 ** -7)
