"""The port's algebra model and losses against the JAX package's, on the CPU
at a tiny size (dims 8, hidden 16): AudioAlgebra's encode, decode and
__call__ against flax `apply` over resid x use_bn x trivial, with
BatchNorm on random running statistics; the train-mode output and the
updated `batch_stats` against `apply(..., mutable=['batch_stats'])`; the
flax bridge both ways; `mseloss`, `vicreg_var_loss` (where the biased and
unbiased variances differ), `off_diagonal` and `vicreg_cov_loss` (also
against the direct (c·t)² covariance); the viz helpers of the effects
demo."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu import aa_mixer as jmixer
from audio_algebra_tpu.models.aa import AudioAlgebra as JAudioAlgebra
from audio_algebra_tpu.utils import viz as jviz
from audio_algebra_torch import aa_mixer as tmixer
from audio_algebra_torch.models.aa import AudioAlgebra
from audio_algebra_torch.utils import viz as tviz
from audio_algebra_torch.utils.params import (load_flax_params, random_init_,
                                              to_flax_batch_stats, to_flax_params)

DIMS, HIDDEN, N, B = 8, 16, 12, 3
REL = 1e-5


def aa_variables(jmod, seed):
    """flax variables for `jmod` with every leaf random: Dense kernels
    fan-in scaled, scale / bias near 1 / 0, running means near 0 and
    variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.zeros((2, jmod.dims, 4))))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if len(leaf.shape) == 1:
            base = 1.0 if name == "scale" else 0.0
            return (base + 0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def pair(seed=0, **kw):
    jmod = JAudioAlgebra(dims=DIMS, hidden_dims=HIDDEN, **kw)
    variables = aa_variables(jmod, seed)
    tmod = load_flax_params(AudioAlgebra(dims=DIMS, hidden_dims=HIDDEN, **kw), variables)
    return jmod, variables, tmod


def close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err < rel, err


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _x(seed=1, b=B):
    return np.random.default_rng(seed).standard_normal((b, DIMS, N)).astype(np.float32)


@pytest.mark.parametrize("trivial", [False, True])
@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("resid", [False, True])
def test_audio_algebra_matches_flax(resid, use_bn, trivial):
    jmod, variables, tmod = pair(resid=resid, use_bn=use_bn, trivial=trivial)
    x = _x()
    tmod.train()            # the port reads `train` from the call, not module.training
    with torch.no_grad():
        z, yrec = tmod(torch.from_numpy(x))
        enc = tmod.encode(torch.from_numpy(x))
        dec = tmod.decode(torch.from_numpy(x))
    want_z, want_yrec = jmod.apply(variables, jnp.asarray(x))
    close(z, want_z)
    close(yrec, want_yrec)
    close(enc, jmod.apply(variables, jnp.asarray(x), method=JAudioAlgebra.encode))
    close(dec, jmod.apply(variables, jnp.asarray(x), method=JAudioAlgebra.decode))
    if trivial:
        np.testing.assert_array_equal(z.numpy(), x)
        assert not list(tmod.parameters())
    # the bridge back gives the very leaves it was loaded with
    if not trivial:
        assert_trees_equal(to_flax_params(tmod), variables["params"])
    if use_bn and not trivial:
        assert_trees_equal(to_flax_batch_stats(tmod), variables["batch_stats"])


@pytest.mark.parametrize("resid", [False, True])
def test_batchnorm_train_mode_and_batch_stats_match_flax(resid):
    jmod, variables, tmod = pair(seed=3, resid=resid, use_bn=True)
    x = 0.5 + 2.0 * _x(4, b=5)          # statistics far from the running ones
    (want_z, want_yrec), updates = jmod.apply(variables, jnp.asarray(x), train=True,
                                              mutable=["batch_stats"])
    tmod.eval()
    with torch.no_grad():
        z, yrec = tmod(torch.from_numpy(x), train=True)
    close(z, want_z)
    close(yrec, want_yrec)
    got, want = dict(_leaves(to_flax_batch_stats(tmod))), \
        dict(_leaves(updates["batch_stats"]))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    # and the running statistics moved from the loaded ones
    before = dict(_leaves(variables["batch_stats"]))
    assert max(np.abs(got[k] - before[k]).max() for k in got) > 1e-3


def test_load_flax_params_refuses_mismatched_batch_stats():
    jmod, variables, _ = pair(use_bn=True)
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    stats = {**stats, "decoder": {k: v for k, v in stats["decoder"].items()
                                  if k != "EmbedBlock_3"}}
    with pytest.raises(KeyError, match="batch_stats"):
        load_flax_params(AudioAlgebra(dims=DIMS, hidden_dims=HIDDEN, use_bn=True),
                         {"params": variables["params"], "batch_stats": stats})


def test_random_init_starts_batchnorm_as_flax_init():
    tmod = random_init_(AudioAlgebra(dims=DIMS, hidden_dims=HIDDEN, use_bn=True), 0)
    init = JAudioAlgebra(dims=DIMS, hidden_dims=HIDDEN, use_bn=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, DIMS, 4)))
    assert_trees_equal(to_flax_batch_stats(tmod), init["batch_stats"])
    params = dict(_leaves(to_flax_params(tmod)))
    for k, v in _leaves(init["params"]):
        if "BatchNorm" in k or k.endswith("bias"):
            np.testing.assert_array_equal(params[k], v, err_msg=k)


def _both(fn, *arrays):
    return fn(tmixer)(*(torch.from_numpy(a) for a in arrays)), \
        fn(jmixer)(*(jnp.asarray(a) for a in arrays))


def test_mseloss_matches_jax():
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((4, DIMS, N)).astype(np.float32) for _ in range(2))
    got, want = _both(lambda m: m.mseloss, a, b)
    close(got, want)


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_vicreg_var_loss_uses_the_population_variance(gamma):
    # three rows: the unbiased variance is 3/2 the biased one, and the stds
    # sit near gamma, where the hinge is active
    z = (0.8 * gamma * np.random.default_rng(6).standard_normal((3, DIMS, N))).astype(np.float32)
    got, want = _both(lambda m: lambda x: m.vicreg_var_loss(x, gamma=gamma), z)
    close(got, want)
    unbiased = torch.relu(gamma - torch.sqrt(torch.from_numpy(z).var(dim=0) + 1e-4)).mean()
    assert abs(float(unbiased) - float(want)) > 1e-3 * abs(float(want))


def test_off_diagonal_matches_jax():
    x = np.arange(25, dtype=np.float32).reshape(5, 5)
    got, want = _both(lambda m: m.off_diagonal, x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numel() == 20 and not (got.numpy() % 6 == 0).any()
    with pytest.raises(ValueError, match="square"):
        tmixer.off_diagonal(torch.zeros(3, 4))


@pytest.mark.parametrize("b", [2, 6])
def test_vicreg_cov_loss_matches_jax_and_the_direct_form(b):
    z = np.random.default_rng(b).standard_normal((b, DIMS, N)).astype(np.float32)
    z[:, 1] += 0.7 * z[:, 0]                        # correlated features
    got, want = _both(lambda m: m.vicreg_cov_loss, z)
    close(got, want)
    flat = z.reshape(b, -1).astype(np.float64)
    zc = flat - flat.mean(axis=0)
    cov = zc.T @ zc / (b - 1)
    direct = (tmixer.off_diagonal(torch.from_numpy(cov)) ** 2).sum() / flat.shape[1]
    close(got, direct.numpy())


def test_viz_matches_jax():
    zs = [np.random.default_rng(i).standard_normal((3, DIMS, N)).astype(np.float32)
          for i in range(4)]
    assert tviz.embeddings_table([torch.from_numpy(z) for z in zs], names=list("abcd")) == \
        jviz.embeddings_table(zs, names=list("abcd"))
    cat = np.concatenate(zs)
    for mean_axis in (-1, None):
        got = tviz.pca_point_cloud(torch.from_numpy(cat), mean_axis=mean_axis)
        want = jviz.pca_point_cloud(cat, mean_axis=mean_axis)
        assert got.shape == want.shape == (cat.shape[0] * (1 if mean_axis else N), 3)
        np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tviz.tokens_spectrogram_image(torch.from_numpy(zs[0])),
                                  jviz.tokens_spectrogram_image(zs[0]))
