"""The operation and launch counts of benchmark/counts against counts made
by hand: torch's FlopCounterMode over the plain reference at tiny widths,
and the launch totals the measured package's own runs recorded."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import k1, k5, soundstream, unet1d, unet_cfg1d
from benchmark.counts.peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S
from benchmark.reference import soundstream as ref_ss
from benchmark.reference import unet1d as ref_unet
from benchmark.reference import unet_cfg1d as ref_cfg
from benchmark.weights import draw


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _params(shapes):
    return draw(shapes, 0, "cpu", torch.float32)


def _unet_shapes(io, cond, c_mults, n_attn):
    """Parameter shapes of the UNet, built from the counts' own stack list."""
    shapes = {"u.timestep_embed.weight": (8, 1)}
    for idx, (j, c_in, c_mid, c_out, attn, is_last) in enumerate(
            unet1d._stacks(io, cond, c_mults, n_attn)):
        blocks = unet1d._blocks(c_in, c_mid, c_out, attn, is_last)
        names = ["m0", "m1", "m2", "m3", "m4", "m5"] if attn else ["m0", "m2", "m4"]
        for name, (kind, a, b) in zip(names, blocks):
            p = f"u.stack_{idx:03d}.{name}"
            if kind == "res":
                for conv, (o, i) in (("Conv1d_0", (c_mid, a)), ("Conv1d_1", (b, c_mid))):
                    shapes[f"{p}.{conv}.weight"], shapes[f"{p}.{conv}.bias"] = (o, i, 5), (o,)
                for norm, c in (("GroupNorm_0", c_mid), ("GroupNorm_1", b)):
                    shapes[f"{p}.{norm}.weight"] = shapes[f"{p}.{norm}.bias"] = (c,)
                if a != b:
                    shapes[f"{p}.skip_proj.weight"] = (b, a)
            else:
                shapes.update({f"{p}.GroupNorm_0.weight": (a,), f"{p}.GroupNorm_0.bias": (a,),
                               f"{p}.qkv_proj.weight": (3 * a, a), f"{p}.qkv_proj.bias": (3 * a,),
                               f"{p}.out_proj.weight": (a, a), f"{p}.out_proj.bias": (a,)})
    return shapes


@pytest.mark.parametrize("io,cond,c_mults,n_attn,batch,t", [
    (2, 8, [16, 16, 32], 1, 3, 256), (4, 4, [32, 32], 0, 2, 128),
    (2, 0, [16, 32, 64, 64], 2, 1, 512)])
def test_unet_flops_match_the_counter(io, cond, c_mults, n_attn, batch, t):
    P = _params(_unet_shapes(io, cond, c_mults, n_attn))
    x, tt = torch.randn(batch, io, t), torch.rand(batch)
    c = torch.randn(batch, cond, t // 4) if cond else None
    got = _counted(lambda: ref_unet.unet_forward(P, "u", x, tt, c, len(c_mults), n_attn))
    assert unet1d.flops(batch, t, io, cond, c_mults, n_attn) == pytest.approx(got, rel=1e-12)


def _ss_shapes(prefix, in_ch, cap, c_mults, strides, latent, decoder):
    shapes = {}

    def conv(name, cin, cout, k):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (cout, cin, k), (cout,)

    def unit(name, c):
        conv(f"{name}.Conv1d_0", c, c, 7)
        conv(f"{name}.Conv1d_1", c, c, 1)
    if not decoder:
        conv(f"{prefix}.l000", in_ch, cap, 7)
        c = cap
        for i, (m, s) in enumerate(zip(c_mults, strides)):
            for j in range(3):
                unit(f"{prefix}.l{i + 1:03d}.u{j}", c)
            conv(f"{prefix}.l{i + 1:03d}.u3", c, cap * m, 2 * s)
            c = cap * m
        conv(f"{prefix}.l{len(strides) + 1:03d}", c, latent, 3)
    else:
        c = cap * c_mults[-1]
        conv(f"{prefix}.l000", latent, c, 7)
        for i, (m, s) in enumerate(zip(list(c_mults[-2::-1]) + [1], strides[::-1])):
            shapes[f"{prefix}.l{i + 1:03d}.u0.weight"] = (c, cap * m, 2 * s)
            shapes[f"{prefix}.l{i + 1:03d}.u0.bias"] = (cap * m,)
            c = cap * m
            for j in range(3):
                unit(f"{prefix}.l{i + 1:03d}.u{j + 1}", c)
        conv(f"{prefix}.l{len(strides) + 1:03d}", c, in_ch, 7)
    return shapes


@pytest.mark.parametrize("cap,c_mults,strides", [(4, [1, 2], [2, 2]), (2, [2, 4, 8], [4, 2, 2])])
def test_soundstream_flops_match_the_counter(cap, c_mults, strides):
    P = _params(_ss_shapes("e", 2, cap, c_mults, strides, 8, False))
    x = torch.randn(2, 2, 256)
    got = _counted(lambda: ref_ss.encoder(P, "e", x, strides))
    assert soundstream.encoder_flops(2, 256, 2, cap, c_mults, strides, 8) == pytest.approx(got)
    P = _params(_ss_shapes("d", 2, cap, c_mults, strides, 8, True))
    z = torch.randn(2, 8, 16)
    got = _counted(lambda: ref_ss.decoder(P, "d", z, strides))
    assert soundstream.decoder_flops(2, 16, 2, cap, c_mults, strides, 8) == pytest.approx(got)


def test_cfg_unet_flops_match_the_counter():
    from benchmark.tests.tiny import mirage
    cfg = mirage()["inner"]
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
    m = StackedAELatentDiffusionCond(
        latent_dim=cfg["in_channels"], channels=cfg["channels"],
        multipliers=tuple(cfg["multipliers"]), factors=tuple(cfg["factors"]),
        num_blocks=tuple(cfg["num_blocks"]), attentions=tuple(cfg["attentions"]),
        resnet_groups=cfg["resnet_groups"], attention_heads=cfg["attention_heads"],
        attention_features=cfg["attention_features"],
        attention_multiplier=cfg["attention_multiplier"],
        attention_rel_pos_max_distance=cfg["attention_rel_pos_max_distance"],
        attention_rel_pos_num_buckets=cfg["attention_rel_pos_num_buckets"])
    P = _params({n: tuple(p.shape) for n, p in m.named_parameters()})
    x, t = torch.randn(2, cfg["in_channels"], 64), torch.rand(2)
    emb = torch.randn(1, 1, 512)
    got = _counted(lambda: ref_cfg.cfg_forward(P, "diffusion", x, t, emb, 4.0, cfg))
    assert unet_cfg1d.core_flops(cfg, 4, 64) == pytest.approx(got, rel=1e-12)


def test_launch_counts_match_the_recorded_runs():
    """K1 191 a Destructo forward (6,685 a 35-step decode) and 119 an outer
    MIRAGE forward; K5 63 a CFG core forward (9,450 a 150-step inner
    stage): the launch totals of the measured package's own card runs."""
    dvae = [256, 256] + [512] * 12
    assert len(unet1d.k1_launches(16, 65536, 2, 64, dvae, 4)) * 35 == 6685
    assert len(unet1d.k1_launches(4, 32768, 32, 32, [512] * 10, 0)) == 119
    from benchmark.tests.tiny import load
    inner = load("mirage_22s")["inner"]
    assert len(unet_cfg1d.k5_launches(inner, 2, 2048)) * 150 == 9450


def test_byte_bounds_by_hand():
    n = 4 * 256 * 65536
    assert k1.bound_s((4, 256, 65536), 2, True, True) == pytest.approx(
        (3 * 2 * n + 2 * 2 * 256) / HBM_BYTES_PER_S)
    assert k1.bound_s((4, 256, 65536), 2, True, False) == pytest.approx(
        (2 * 2 * n + 2 * 2 * 256) / HBM_BYTES_PER_S)
    b, c, t = 8, 512, 2048
    assert k5.bound_s((b, c, t), 2, True) == pytest.approx(
        (2 * 2 * b * c * t + (2 * c + 2 * b * c) * 2) / HBM_BYTES_PER_S)
    assert k5.bound_s((1, 8, 4), 4, False) == pytest.approx(
        max((2 * 4 * 32 + 16 * 4) / HBM_BYTES_PER_S, 32 * 9 / F32_FLOPS_PER_S))
