"""The port's checkpoint pours against the JAX package's, on the CPU.

Every converter of audio_algebra_torch/convert.py and convert_dvae.py is
given the same torch state dict as its JAX twin, with the port module's
own flax-path view (`utils/params.to_flax_params`, loaded from the JAX
template) as the template. The poured trees must hold the same paths and
the same bits (np.array_equal). The state dicts come from the
reference-layout mirrors of tests/torch_mirrors.py at tiny widths (their
main copies perturbed away from the EMA twins), from synthetic laion_clap
names, from a tiny transformers ClapModel and from a TorchScript archive.
Also: load_torch_checkpoint on its three file layouts, remap_ema_weights,
the zero-hit warning and the ambiguity audit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu import checkpoint as jck
from audio_algebra_tpu import convert as jcv
from audio_algebra_tpu.convert_dvae import convert_dvae_state_dict as j_convert_dvae
from audio_algebra_tpu.utils.params import fast_random_params
from audio_algebra_torch import checkpoint as tck
from audio_algebra_torch import convert as tcv
from audio_algebra_torch.convert_dvae import convert_dvae_state_dict as t_convert_dvae
from audio_algebra_torch.utils.params import load_flax_params, to_flax_params
from torch_export import script_state_dict
import torch_mirrors as mirrors

DVAE = dict(latent_dim=8, capacity=4, c_mults=(2, 4), strides=(4, 2),
            n_attn_layers=1, diffusion_c_mults=(16, 32))
STACKED = dict(latent_dim=8, second_stage_latent_dim=4, factors=(2, 2),
               ae_capacity=4, ae_c_mults=(2, 4), ae_strides=(2, 2),
               latent_channels=16, latent_multipliers=(1, 2, 2),
               latent_num_blocks=(2, 2), diffusion_c_mults=(16, 16), diffusion_depth=2)
LDM_MIRROR = dict(in_channels=4, context_embedding_features=16,
                  context_embedding_max_length=1, channels=8, resnet_groups=2,
                  multipliers=(1, 2, 2), factors=(1, 2), num_blocks=(1, 1),
                  attentions=(0, 0, 1), attention_heads=2, attention_features=4,
                  attention_multiplier=2, attention_rel_pos_num_buckets=8,
                  attention_rel_pos_max_distance=16)
LDM = dict(latent_dim=4, embedding_features=16, embedding_max_len=1, channels=8,
           multipliers=(1, 2, 2), factors=(1, 2), num_blocks=(1, 1),
           attentions=(0, 0, 1), resnet_groups=2, attention_heads=2,
           attention_features=4, attention_multiplier=2,
           attention_rel_pos_num_buckets=8, attention_rel_pos_max_distance=16)
DMAE = dict(channels=(8, 16), factors=(1, 2), items=(1, 1), linear_attentions=(0, 1),
            attention_features=4, attention_heads=2, inject_depth=1, latent_dim=4,
            resnet_groups=4, num_filters=8, window_length=32, lt_stride=16,
            enc_channels=16, enc_multipliers=(1, 1), enc_factors=(2,),
            enc_num_blocks=(1,), n_mels=16)
RAVE_MIRROR = dict(data_size=4, capacity=8, ratios=(4, 2), latent_size=8,
                   noise_ratios=(2, 2), noise_bands=3)
RAVE = dict(latent_dim=8, n_bands=4, capacity=8, strides=(4, 2), noise_ratios=(2, 2),
            noise_bands=3)


def state_dict(module) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def perturb(module, seed: int) -> None:
    """Shift every parameter so a main copy differs from its EMA twin."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))


def flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_template(module, jax_params) -> dict:
    """The port module's flax-path view, loaded from the JAX template: it
    must be the JAX template itself, path for path and bit for bit."""
    load_flax_params(module, jax_params)
    tree = {"params": to_flax_params(module)}
    assert_same_tree(tree, jax_params)
    return tree


def assert_same_tree(got, want) -> None:
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())[:8]
    unequal = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not unequal, unequal[:8]


def assert_same_pour(j_out, t_out) -> None:
    """(tree, hits, misses) from both converters: the same bits."""
    assert_same_tree(t_out[0], j_out[0])
    assert t_out[1] == j_out[1] and list(t_out[2]) == list(j_out[2])


# ----------------------------------------------------------------- DVAE ---

def test_dvae_pour_is_jax_pour():
    from audio_algebra_tpu.models.dvae import DiffusionDVAE as JaxDVAE
    from audio_algebra_torch.models.dvae import DiffusionDVAE

    torch.manual_seed(1)
    tm = mirrors.DiffusionDVAE(**DVAE)
    perturb(tm.encoder, 2)
    perturb(tm.diffusion, 3)
    sd = state_dict(tm)
    params = fast_random_params(JaxDVAE(**DVAE), 0, jnp.zeros((1, 2, 256)), jnp.zeros((1,)))
    template = port_template(DiffusionDVAE(**DVAE), params)
    j_out = j_convert_dvae(sd, params)
    t_out = t_convert_dvae(sd, template)
    assert not t_out[2] and t_out[1] == tcv._n_params(template)
    assert_same_pour(j_out, t_out)
    # the EMA copy is the one that landed
    conv0 = state_dict(tm.encoder_ema)["layers.0.weight"].transpose(2, 1, 0)
    assert np.array_equal(flat(t_out[0])["params/encoder/l000/kernel"], conv0)


@pytest.mark.parametrize("drop", [0, 2])
def test_pour_draws_the_random_init_only_for_what_it_keeps(drop, tmp_path, monkeypatch):
    """pour(..., init=) and DVAEWrapper.setup: a pour that fills every leaf
    never runs the seeded random init; one that leaves leaves at init runs
    it once. Either way the module ends bit for bit as after the random
    init and a pour over its values (the JAX package's fast_random_params,
    then the pour)."""
    from audio_algebra_torch import given_models as gm
    from audio_algebra_torch.models.dvae import DiffusionDVAE
    from audio_algebra_torch.utils import params as tparams

    torch.manual_seed(1)
    tm = mirrors.DiffusionDVAE(**DVAE)
    perturb(tm.encoder, 2)
    perturb(tm.diffusion, 3)
    sd = {k: v for k, v in tm.state_dict().items()
          if not any(f"encoder{ema}.layers.{i}.weight" == k
                     for ema in ("", "_ema") for i in range(drop))}
    want = tparams.random_init_(DiffusionDVAE(**DVAE), 0)
    tcv.pour(want, t_convert_dvae, {k: v.numpy() for k, v in sd.items()})

    calls = []
    got = DiffusionDVAE(**DVAE)
    hits, _ = tcv.pour(got, t_convert_dvae, {k: v.numpy() for k, v in sd.items()},
                       init=lambda: calls.append(tparams.random_init_(got, 0)))
    assert len(calls) == int(drop > 0)
    assert (hits == len(tcv._leaves(to_flax_params(got)))) == (drop == 0)

    path = tmp_path / "dvae.ckpt"
    torch.save({"state_dict": sd}, path)
    inits = []
    real_init = tparams.random_init_
    monkeypatch.setattr(tparams, "random_init_", lambda m, s: inits.append(s) or real_init(m, s))
    w = gm.DVAEWrapper(args_dict={"latent_dim": DVAE["latent_dim"]}, device="cpu",
                       model_kwargs={k: v for k, v in DVAE.items() if k != "latent_dim"})
    w.ckpt_info = {"ckpt_path": str(path), "ckpt_hash": "", "ckpt_url": "", "gdrive_path": ""}
    w.setup(gdrive=False)
    assert len(inits) == int(drop > 0)
    for model in (got, w.model):
        for (name, a), (_, b) in zip(want.state_dict().items(), model.state_dict().items()):
            assert torch.equal(a, b), name


# -------------------------------------------------------------- stacked ---

@pytest.fixture(scope="module")
def stacked():
    from audio_algebra_tpu.models.stacked import LatentAudioDiffusionAutoencoder as J
    from audio_algebra_torch.models.stacked import LatentAudioDiffusionAutoencoder as T

    torch.manual_seed(3)
    tm = mirrors.LatentAudioDiffusionAutoencoder(**STACKED)
    perturb(tm.latent_encoder, 4)
    perturb(tm.diffusion, 5)
    params = fast_random_params(J(**STACKED), 0, jnp.zeros((1, 2, 256)), jnp.zeros((1,)))
    return state_dict(tm), params, port_template(T(**STACKED), params)


def test_stacked_pour_with_ema_swap_is_jax_pour(stacked):
    sd, params, template = stacked
    t_out = tcv.convert_stacked_state_dict(sd, template)
    assert not t_out[2] and t_out[1] == tcv._n_params(template)
    assert_same_pour(jcv.convert_stacked_state_dict(sd, params), t_out)


def test_zero_hit_pour_warns(stacked, capsys):
    _, params, template = stacked
    sd = {"diffusion.bogus.weight": np.zeros((7, 7, 7), np.float32)}
    _, hits, misses = tcv.convert_stacked_state_dict(sd, template)
    assert hits == 0 and misses == ["diffusion.bogus.weight"]
    assert "NOT applied" in capsys.readouterr().out


# ------------------------------------------------------------------ LDM ---

@pytest.mark.parametrize("layout", ["ema_pytorch", "plain_twin"])
def test_ldm_pour_prefers_ema_and_is_jax_pour(layout):
    from audio_algebra_tpu.models.stacked import StackedAELatentDiffusionCond as J
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond as T

    torch.manual_seed(11)
    tm = mirrors.StackedAELatentDiffusionCondLDM(**LDM_MIRROR)
    perturb(tm.diffusion_ema.ema_model, 12)
    sd = state_dict(tm)
    if layout == "plain_twin":            # diffusion_ema.* a deepcopy of the model
        sd = {k.replace("diffusion_ema.ema_model.", "diffusion_ema."): v
              for k, v in sd.items() if not k.startswith("diffusion_ema.online_model.")}
    params = fast_random_params(J(**LDM), 0, jnp.zeros((1, 4, 16)), jnp.zeros((1,)))
    template = port_template(T(**LDM), params)
    t_out = tcv.convert_ldm_state_dict(sd, template)
    assert not t_out[2] and t_out[1] == tcv._n_params(template)
    assert_same_pour(jcv.convert_ldm_state_dict(sd, params), t_out)
    ema = state_dict(tm.diffusion_ema.ema_model)["fixed_embedding"]
    assert np.array_equal(flat(t_out[0])["params/diffusion/fixed_embedding"], ema)


# ----------------------------------------------------------------- DMAE ---

def test_dmae_full_pour_is_jax_pour():
    from audio_algebra_tpu.models.dmae import DiffusionAE1d as J
    from audio_algebra_torch.models.dmae import DiffusionAE1d as T

    torch.manual_seed(7)
    sd = state_dict(mirrors.TorchDMAE(**DMAE))
    mel = dict(mel_n_fft=64, mel_hop=16)
    params = fast_random_params(J(**DMAE, **mel), 0, jnp.zeros((1, 2, 256)), jnp.zeros((1,)))
    template = port_template(T(**DMAE, **mel), params)
    t_out = tcv.convert_dmae_state_dict(sd, template)
    assert not t_out[2] and t_out[1] == tcv._n_params(template)
    assert_same_pour(jcv.convert_dmae_state_dict(sd, params), t_out)


# ----------------------------------------------------------------- RAVE ---

@pytest.fixture(scope="module")
def rave():
    from audio_algebra_tpu.models.rave import RAVE as J
    from audio_algebra_torch.models.rave import RAVE as T

    torch.manual_seed(5)
    sd = state_dict(mirrors.RaveV2(**RAVE_MIRROR))
    assert any(k.endswith(".weight_g") for k in sd)
    params = fast_random_params(J(**RAVE), 0, jnp.zeros((1, 1, 256)))
    return sd, params, port_template(T(**RAVE), params)


def parametrize_naming(sd: dict) -> dict:
    """The weight-norm pairs under torch's parametrize API names."""
    return {k.replace(".weight_g", ".parametrizations.weight.original0")
            .replace(".weight_v", ".parametrizations.weight.original1"): v
            for k, v in sd.items()}


@pytest.mark.parametrize("naming", ["weight_g_v", "parametrizations"])
def test_rave_pour_fuses_weight_norm_as_jax(rave, naming):
    sd, params, template = rave
    if naming == "parametrizations":
        sd = parametrize_naming(sd)
    fused_j, fused_t = jcv.fuse_weight_norm(sd), tcv.fuse_weight_norm(sd)
    assert fused_j.keys() == fused_t.keys()
    assert all(np.array_equal(fused_j[k], fused_t[k]) for k in fused_j)
    t_out = tcv.convert_rave_state_dict(sd, template)
    assert not t_out[2] and t_out[1] == tcv._n_params(template)
    assert_same_pour(jcv.convert_rave_state_dict(sd, params), t_out)


def test_rave_torchscript_archive_pours_as_jax(rave, tmp_path):
    sd, params, template = rave
    rng = np.random.default_rng(0)
    pca = np.linalg.qr(rng.standard_normal((8, 8)))[0][:5].astype(np.float32)
    mean = rng.standard_normal(8).astype(np.float32)
    path = tmp_path / "tiny_rave.ts"
    torch.jit.save(script_state_dict({**sd, "latent_pca": pca, "latent_mean": mean}),
                   str(path))
    sd_j, sd_t = jcv.load_torchscript_state_dict(str(path)), \
        tcv.load_torchscript_state_dict(str(path))
    assert sd_j.keys() == sd_t.keys() and len(sd_t) == len(sd) + 2
    assert all(np.array_equal(sd_j[k], sd_t[k]) for k in sd_j)
    assert_same_pour(jcv.convert_rave_state_dict(sd_j, params),
                     tcv.convert_rave_state_dict(sd_t, template))
    got = tcv.extract_rave_latent_transform(sd_t)
    want = jcv.extract_rave_latent_transform(sd_j)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert np.array_equal(got[0], pca) and np.array_equal(got[1], mean)


# ----------------------------------------------------------------- CLAP ---

def _laion_sd(audio_cfg, rng) -> dict:
    """Synthetic laion_clap / timm names over a tiny tower (as
    tests/test_convert_zoo.py builds them)."""
    hid = audio_cfg.patch_embed_hidden
    f32 = np.float32
    return {
        "audio_projection.0.weight": rng.standard_normal((512, audio_cfg.num_features)).astype(f32),
        "audio_projection.0.bias": rng.standard_normal(512).astype(f32),
        "audio_projection.2.weight": rng.standard_normal((512, 512)).astype(f32),
        "text_projection.2.weight": rng.standard_normal((512, 512)).astype(f32),
        "audio_branch.bn0.running_mean": rng.standard_normal(8).astype(f32),
        "audio_branch.patch_embed.proj.weight": rng.standard_normal((hid, 1, 4, 4)).astype(f32),
        "audio_branch.layers.0.blocks.0.attn.qkv.weight":
            rng.standard_normal((3 * hid, hid)).astype(f32),
        "audio_branch.layers.0.blocks.0.attn.qkv.bias": rng.standard_normal(3 * hid).astype(f32),
        "audio_branch.layers.0.blocks.0.norm1.weight": rng.standard_normal(hid).astype(f32),
        "audio_branch.layers.0.blocks.0.mlp.fc1.weight":
            rng.standard_normal((4 * hid, hid)).astype(f32),
        "audio_branch.tscam_conv.weight": rng.standard_normal((4, 4, 3, 3)).astype(f32),
        "audio_branch.attn.relative_position_index": np.zeros((16, 16), np.int64),
    }


def _towers(audio_cfg, text_cfg, audio_params, text_params):
    """The port's towers at the JAX configs, with their flax-path views."""
    from audio_algebra_torch.models import clap as tclap

    a = tclap.ClapAudioEmbedder(tclap.ClapAudioCfg(**dataclasses.asdict(audio_cfg)))
    t = tclap.ClapTextEmbedder(tclap.ClapTextCfg(**dataclasses.asdict(text_cfg)))
    return port_template(a, audio_params), port_template(t, text_params)


def test_clap_laion_dialect_pour_is_jax_pour():
    from audio_algebra_tpu.models.clap import CLAPModule, TINY_AUDIO_CFG, TINY_TEXT_CFG

    clap = CLAPModule(audio_cfg=dict(**TINY_AUDIO_CFG), text_cfg=dict(**TINY_TEXT_CFG))
    clap._ensure_init(4096)
    a_tmpl, t_tmpl = _towers(clap.audio_cfg, clap.text_cfg, clap.audio_params,
                             clap.text_params)
    sd = _laion_sd(clap.audio_cfg, np.random.default_rng(13))
    j_a, j_t, j_hits, j_misses = jcv.convert_clap_state_dict(
        sd, clap.audio_params, clap.text_params)
    t_a, t_t, t_hits, t_misses = tcv.convert_clap_state_dict(sd, a_tmpl, t_tmpl)
    assert t_hits == j_hits >= 9 and t_misses == j_misses == []
    assert_same_tree(t_a, j_a)
    assert_same_tree(t_t, j_t)


@pytest.fixture(scope="module")
def hf_clap_sd():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.ClapConfig(
        projection_dim=24,
        audio_config=dict(
            spec_size=64, patch_size=4, patch_stride=4, num_mel_bins=16,
            patch_embeds_hidden_size=16, depths=[1, 2], num_attention_heads=[2, 2],
            window_size=4, mlp_ratio=4, hidden_size=32, enable_fusion=False,
            drop_path_rate=0.0, attention_probs_dropout_prob=0.0,
            hidden_dropout_prob=0.0, projection_dim=24),
        text_config=dict(
            vocab_size=120, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=96, max_position_embeddings=80,
            attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0, projection_dim=24))
    torch.manual_seed(7)
    model = transformers.ClapModel(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_(0.0, 0.2)
    return state_dict(model)


def test_clap_hf_dialect_cfgs_and_pour_are_jax(hf_clap_sd):
    from audio_algebra_tpu.models.clap import (ClapAudioCfg, ClapAudioEmbedder,
                                               ClapTextCfg, ClapTextEmbedder)
    from audio_algebra_torch.models import clap as tclap

    sd = hf_clap_sd
    j_a_cfg, j_t_cfg = jcv.infer_clap_cfgs(sd, ClapAudioCfg(spec_size=64), ClapTextCfg())
    t_a_cfg, t_t_cfg = tcv.infer_clap_cfgs(sd, tclap.ClapAudioCfg(spec_size=64),
                                           tclap.ClapTextCfg())
    assert dataclasses.asdict(t_a_cfg) == dataclasses.asdict(j_a_cfg)
    assert dataclasses.asdict(t_t_cfg) == dataclasses.asdict(j_t_cfg)
    a_params = fast_random_params(ClapAudioEmbedder(j_a_cfg), 0,
                                  jnp.zeros((1, 1, 256, 16), jnp.float32))
    t_params = fast_random_params(ClapTextEmbedder(j_t_cfg), 1, jnp.zeros((1, 6), jnp.int32))
    a_tmpl, t_tmpl = _towers(j_a_cfg, j_t_cfg, a_params, t_params)
    j_a, j_t, j_hits, j_misses = jcv.convert_clap_state_dict(sd, a_params, t_params)
    t_a, t_t, t_hits, t_misses = tcv.convert_clap_state_dict(sd, a_tmpl, t_tmpl)
    assert t_misses == j_misses == []
    assert t_hits == j_hits == tcv._n_params(a_tmpl) + tcv._n_params(t_tmpl)
    assert_same_tree(t_a, j_a)
    assert_same_tree(t_t, j_t)


def test_clap_module_load_ckpt_rebuilds_towers_and_pours(hf_clap_sd, tmp_path):
    """CLAPModule.load_ckpt on a HF ClapModel file: the towers take the
    checkpoint's sizes and every leaf its tensor, as JAX's load_ckpt."""
    from audio_algebra_tpu.models.clap import CLAPModule as JaxCLAP
    from audio_algebra_torch.models.clap import CLAPModule

    path = tmp_path / "clap.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in hf_clap_sd.items()}}, path)
    audio_cfg = dict(spec_size=64, num_mel_bins=16, n_fft=256, hop=64, clip_samples=4096)
    jm = JaxCLAP(enable_fusion=False, audio_cfg=dict(audio_cfg))
    jm.load_ckpt(ckpt=str(path))
    tm = CLAPModule(enable_fusion=False, audio_cfg=dict(audio_cfg), device="cpu")
    tm.load_ckpt(ckpt=str(path), verbose=True)
    assert dataclasses.asdict(tm.audio_cfg) == dataclasses.asdict(jm.audio_cfg)
    assert dataclasses.asdict(tm.text_cfg) == dataclasses.asdict(jm.text_cfg)
    assert_same_tree({"params": to_flax_params(tm.audio_model)}, jm.audio_params)
    assert_same_tree({"params": to_flax_params(tm.text_model)}, jm.text_params)


# ------------------------------------------------------- files and remap ---

@pytest.mark.parametrize("layout", ["lightning", "raw", "model_state_dict"])
def test_load_torch_checkpoint_layouts(layout, tmp_path):
    g = torch.Generator().manual_seed(0)
    sd = {"encoder.layers.0.weight": torch.randn(4, 2, 3, generator=g),
          "encoder_ema.layers.0.weight": torch.randn(4, 2, 3, generator=g),
          "diffusion.timestep_embed.weight": torch.randn(8, 1, generator=g)}
    obj = {"lightning": {"state_dict": sd, "epoch": 3, "hyper_parameters": {"lr": 1e-4}},
           "raw": sd, "model_state_dict": {"model_state_dict": sd, "step": 9}}[layout]
    path = tmp_path / "x.ckpt"
    torch.save(obj, path)
    got, want = tck.load_torch_checkpoint(str(path)), jck.load_torch_checkpoint(str(path))
    assert got.keys() == want.keys() == sd.keys()
    assert all(np.array_equal(got[k], want[k]) and got[k].dtype == np.float32 for k in sd)


def test_remap_ema_weights_is_jax():
    sd = {"diffusion.net.0.weight": np.zeros(2), "diffusion_ema.net.0.weight": np.ones(2),
          "latent_encoder_ema.l000.bias": np.full(3, 2.0), "autoencoder.x.bias": np.ones(1)}
    got, want = tck.remap_ema_weights(sd), jck.remap_ema_weights(sd)
    assert got.keys() == want.keys() == {"diffusion.net.0.weight", "latent_encoder.l000.bias",
                                         "autoencoder.x.bias"}
    assert all(np.array_equal(got[k], want[k]) for k in got)
    assert np.array_equal(got["diffusion.net.0.weight"], np.ones(2))


def test_convert_report_flags_what_jax_flags(capsys):
    """Two same-shape weights whose torch order crosses the flax slot order:
    the audit records the group and flags both pairings, as JAX's does."""
    rng = np.random.default_rng(0)
    sd = {"net.attn.weight": rng.standard_normal((8, 8, 3)).astype(np.float32),
          "net.downsample.weight": rng.standard_normal((8, 8, 3)).astype(np.float32)}
    crossed = {"params": {"down_conv": {"kernel": np.zeros((3, 8, 8), np.float32)},
                          "x_attn": {"kernel": np.zeros((3, 8, 8), np.float32)}}}
    t_out = tcv.convert_by_shape(sd, crossed, buckets={"params": ("net.",)})
    t_report = tcv.convert_report()
    j_out = jcv.convert_by_shape(sd, crossed, buckets={"params": ("net.",)})
    j_report = jcv.convert_report()
    assert_same_pour(j_out, t_out)
    assert t_report == j_report and len(t_report["suspicious"]) == 2
    assert "SUSPICIOUS" in capsys.readouterr().out
