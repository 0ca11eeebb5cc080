"""The PyTorch port's CLAP (models/clap.py, utils/bpe.py) against the JAX
package on the CPU with the same flax params poured through the bridge:
the Swin index tables and the interpolation matrices (exactly), the HTSAT
tower's short path and fusion path, the RoBERTa tower, both waveform
front ends, the tokenizer's byte-fallback ids (equal) and its validation,
CLAPModule's embeddings and CLAPDAE.embed for text and for audio.

Small configs: TINY_AUDIO_CFG with two blocks a stage (so the shifted
windows run) and one whose 11 x 11 patch grid pads to windows of 5 and
merges an odd map. Tolerance: rel 1e-4 of the output's peak, f32 (only
the order of sums differs)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu import given_models as jgm
from audio_algebra_tpu.models import clap as jclap
from audio_algebra_torch import given_models as tgm
from audio_algebra_torch.models import clap as tclap
from audio_algebra_torch.utils import bpe as tbpe
from audio_algebra_torch.utils.params import load_flax_params, to_flax_params

TOL = 1e-4
AUDIO_CFGS = {
    "tiny_shifted": dict(jclap.TINY_AUDIO_CFG, depths=(2, 2)),
    "padded_odd": dict(jclap.TINY_AUDIO_CFG, spec_size=44, num_mel_bins=11, window=5,
                       depths=(2, 2)),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def clap_tree(module, seed, *args, **kwargs):
    """A flax params tree for `module`, every leaf random: weights
    fan-in scaled, 1-D leaves around their init (variances kept positive)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if len(leaf.shape) == 1:
            noise = 0.2 * rng.standard_normal(leaf.shape)
            if name.endswith("var"):
                return (1.0 + np.abs(noise)).astype(np.float32)
            return ((1.0 if "scale" in name else 0.0) + noise).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)["params"]


def _signal(n, seed, batch=1):
    t = np.arange(n) / 48000
    x = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.random.default_rng(seed).standard_normal(
        (batch, n))
    return x.astype(np.float32)


@pytest.mark.parametrize("window", [4, 5, 8])
def test_index_tables_equal_jax(window):
    np.testing.assert_array_equal(tclap._relative_position_index(window),
                                  jclap._relative_position_index(window))
    for h, w, shift in ((2 * window, 2 * window, window // 2), (3 * window, window, 1)):
        np.testing.assert_array_equal(tclap._shift_attn_mask(h, w, window, shift),
                                      jclap._shift_attn_mask(h, w, window, shift))
    assert tclap._shift_attn_mask(8, 8, window, 0) is None


@pytest.mark.parametrize("n_in,n_out", [(65, 128), (1001, 1024), (8, 11), (188, 65)])
def test_interpolation_matrices_equal_jax(n_in, n_out):
    np.testing.assert_array_equal(tclap._bicubic_matrix(n_in, n_out),
                                  jclap._bicubic_matrix(n_in, n_out))
    np.testing.assert_array_equal(tclap._bilinear_matrix(n_in, n_out),
                                  jclap._bilinear_matrix(n_in, n_out))


@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 4), (1, 1, 12, 8, 4)])
def test_window_partition_and_reverse_match_jax(shape):
    b, _, h, w, c = shape
    x = np.random.default_rng(0).standard_normal((b, h, w, c)).astype(np.float32)
    got = tclap._window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jclap._window_partition(
        jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tclap._window_reverse(got, 4, h, w).numpy(), x)


@pytest.mark.parametrize("name", sorted(AUDIO_CFGS))
@pytest.mark.parametrize("is_longer", [False, True])
def test_htsat_embedder_matches_jax(name, is_longer):
    cfg = tclap.ClapAudioCfg(**AUDIO_CFGS[name], enable_fusion=True)
    jcfg = jclap.ClapAudioCfg(**AUDIO_CFGS[name], enable_fusion=True)
    chunk = cfg.clip_samples // cfg.hop + 1
    feats = np.random.default_rng(1).standard_normal(
        (2, 4 if is_longer else 1, chunk, cfg.num_mel_bins)).astype(np.float32) * 10 - 40
    jmod = jclap.ClapAudioEmbedder(jcfg)
    tree = clap_tree(jmod, 2, jnp.asarray(feats[:, :1]))
    want = jmod.apply({"params": tree}, jnp.asarray(feats), is_longer=is_longer)
    tmod = tclap.ClapAudioEmbedder(cfg).eval()
    load_flax_params(tmod, tree)
    with torch.no_grad():
        got = tmod(torch.from_numpy(feats), is_longer=is_longer)
    assert got.shape == (2, 512)
    assert _rel(got, want) < TOL
    # the bridge round-trips every leaf, the 2-D conv kernels included
    back = to_flax_params(tmod)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def test_text_embedder_matches_jax():
    cfg = jclap.ClapTextCfg(**jclap.TINY_TEXT_CFG)
    ids = np.array([[0, 40, 41, 42, 43, 2, 1, 1], [0, 50, 2, 1, 1, 1, 1, 1]], np.int32)
    jmod = jclap.ClapTextEmbedder(cfg)
    tree = clap_tree(jmod, 3, jnp.asarray(ids))
    want = jmod.apply({"params": tree}, jnp.asarray(ids))
    tmod = tclap.ClapTextEmbedder(tclap.ClapTextCfg(**tclap.TINY_TEXT_CFG)).eval()
    load_flax_params(tmod, tree)
    with torch.no_grad():
        got = tmod(torch.from_numpy(ids).long())
    assert _rel(got, want) < TOL
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("n", [3000, 4096, 9000])
def test_front_ends_match_jax(n):
    cfg = jclap.ClapAudioCfg(**jclap.TINY_AUDIO_CFG)
    tcfg = tclap.ClapAudioCfg(**tclap.TINY_AUDIO_CFG)
    x = _signal(n, 4, batch=2)
    got = tclap.audio_to_input_features(torch.from_numpy(x), tcfg)
    want = jclap.audio_to_input_features(jnp.asarray(x), cfg)
    assert got.shape == (2, 1, 65, 8)
    assert _rel(got, want) < TOL
    got = tclap.audio_to_fusion_features(torch.from_numpy(x), tcfg)
    want = jclap.audio_to_fusion_features(jnp.asarray(x), cfg)
    assert got.shape == (2, 4, 65, 8)
    assert _rel(got, want) < TOL
    assert tclap.fusion_crop_starts(300, 65) == jclap.fusion_crop_starts(300, 65)


@pytest.mark.parametrize("max_len", [16, 77])
def test_tokenizer_fallback_ids_equal_jax(max_len):
    texts = ["low brass", "", "ünïcødé drums, 120 bpm" * 3]
    cfg = jclap.ClapTextCfg(max_len=max_len)
    assert jclap.tokenizer_backend()[0] == "byte-fallback"
    with pytest.warns(UserWarning, match="byte-level"):
        got = tclap.tokenize(texts, tclap.ClapTextCfg(max_len=max_len))
    np.testing.assert_array_equal(got, jclap.tokenize(texts, cfg))
    assert tclap.tokenizer_backend()[0] == "byte-fallback"


def _write_assets(d, pad_id):
    """A stub vocab.json + merges.txt: RoBERTa's specials (pad at `pad_id`)
    and the byte symbols of 'ab' with one merge."""
    vocab = {"<s>": 0, "<pad>": pad_id, "</s>": 2, "<unk>": 3, "a": 4, "b": 6, "ab": 7,
             "Ġ": 8}
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\na b\n")
    return d


def test_tokenizer_backend_and_tokenize_share_one_validation(tmp_path):
    """A tokenizer whose pad id is not the text tower's is refused by both,
    so the backend reported is the one that tokenizes."""
    pytest.importorskip("regex")
    cfg = tclap.ClapTextCfg()
    good, bad = _write_assets(tmp_path / "good", 1), _write_assets(tmp_path / "bad", 5)
    assert tclap.tokenizer_backend(cfg, good) == ("bpe", None)
    np.testing.assert_array_equal(tclap.tokenize(["ab ab", "a"], cfg, good),
                                  [[0, 7, 8, 7, 2], [0, 4, 2, 1, 1]])
    backend, reason = tclap.tokenizer_backend(cfg, bad)
    assert backend == "byte-fallback" and "<pad> = 5" in reason
    with pytest.warns(UserWarning, match="<pad> = 5"):
        ids = tclap.tokenize(["ab"], cfg, bad)
    np.testing.assert_array_equal(ids, [[0, 4 + ord("a"), 4 + ord("b"), 2]])
    assert tbpe.find_assets(tmp_path) is None and tbpe.find_assets(good) == good


@pytest.fixture(scope="module")
def clap_pair():
    """JAX's CLAPModule and the port's, holding the same random weights."""
    kw = dict(audio_cfg=dict(AUDIO_CFGS["tiny_shifted"]),
              text_cfg=dict(jclap.TINY_TEXT_CFG))
    jm = jclap.CLAPModule(**kw)
    feats = jclap.audio_to_input_features(jnp.zeros((1, 256)), jm.audio_cfg)
    audio = clap_tree(jm.audio_model, 5, feats)
    text = clap_tree(jm.text_model, 6, jnp.zeros((1, 8), jnp.int32))
    jm.audio_params, jm.text_params = {"params": audio}, {"params": text}
    jm._make_jits()
    tm = tclap.CLAPModule(**kw, device="cpu")
    tm.load_flax_params(audio, text)
    return jm, tm, audio, text


@pytest.mark.parametrize("n", [3000, 12000])
def test_clap_module_audio_embedding_matches_jax(clap_pair, n):
    """3000 samples: the short path; 12000: past clip_samples with fusion."""
    jm, tm, _, _ = clap_pair
    x = _signal(n, 7, batch=2)
    got = tm.get_audio_embedding_from_data(x)
    want = jm.get_audio_embedding_from_data(jnp.asarray(x))
    assert got.shape == (2, 512) and got.dtype == torch.float32
    assert _rel(got, want) < TOL


def test_clap_module_text_embedding_matches_jax(clap_pair):
    jm, tm, _, _ = clap_pair
    texts = ["low brass", "a bright piano arpeggio"]
    with pytest.warns(UserWarning):
        got = tm.get_text_embedding(texts)
    assert _rel(got, jm.get_text_embedding(texts)) < TOL


def test_clapdae_embed_matches_jax(clap_pair):
    _, _, audio, text = clap_pair
    clap_kwargs = dict(audio_cfg=dict(AUDIO_CFGS["tiny_shifted"]),
                       text_cfg=dict(jclap.TINY_TEXT_CFG))
    jw = jgm.CLAPDAE(sample_size=4096, clap_kwargs=clap_kwargs)
    jw.clap_module._ensure_init()
    jw.clap_module.audio_params, jw.clap_module.text_params = \
        {"params": audio}, {"params": text}
    jw.clap_module._make_jits()
    tw = tgm.CLAPDAE(sample_size=4096, clap_kwargs=clap_kwargs, device="cpu")
    tw.clap_module.load_flax_params(audio, text)
    with pytest.warns(UserWarning):
        got = tw.embed("low brass")
    assert got.shape == (1, 1, 512)
    assert _rel(got, jw.embed("low brass")) < TOL
    stereo = _signal(6000, 8, batch=2)                      # (C, T), averaged to mono
    got = tw.embed(stereo)
    assert got.shape == (1, 1, 512)
    assert _rel(got, jw.embed(jnp.asarray(stereo))) < TOL
    assert _rel(tw.encode(stereo[None]), got) == 0


def test_clap_random_init_is_seeded_and_unit_norm():
    kw = dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG), text_cfg=dict(tclap.TINY_TEXT_CFG),
              device="cpu")
    a, b, c = (tclap.CLAPModule(seed=s, **kw) for s in (0, 0, 1))
    x = _signal(5000, 9)
    ea, eb, ec = (m.get_audio_embedding_from_data(x) for m in (a, b, c))
    torch.testing.assert_close(ea, eb, rtol=0, atol=0)
    assert not torch.equal(ea, ec)
    assert torch.isfinite(ea).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(ea, dim=-1).numpy(), 1.0, atol=1e-5)
