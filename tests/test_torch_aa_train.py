"""The port's algebra training against the JAX package's, on the CPU at a
tiny size: `make_mixer_loss_fn` and `make_effects_loss_fn` through a tiny
DVAE encoder (the flax weights carried across) — the loss, each log term
and every gradient against `jax.value_and_grad` on the same stems, faders
and clips; the one-cycle schedule against optax's; three Adam steps and
two-step accumulation against optax.adam and optax.MultiSteps; both
`train_aa_model`s against JAX's from the same weights, loader and seed;
the spectrogram models' frozen encode."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_algebra_tpu import aa_effects as jeffects
from audio_algebra_tpu import aa_mixer as jmixer
from audio_algebra_tpu.models.aa import AudioAlgebra as JAudioAlgebra
from audio_algebra_tpu.models.dvae import DiffusionDVAE as JDVAE
from audio_algebra_torch import aa_effects as teffects
from audio_algebra_torch import aa_mixer as tmixer
from audio_algebra_torch.given_models import DVAEWrapper
from audio_algebra_torch.models.aa import AudioAlgebra
from audio_algebra_torch.train_clapdae import onecycle_lr
from audio_algebra_torch.utils.params import load_flax_params, to_flax_grads, to_flax_params
from test_torch_aa import aa_variables
from test_torch_blocks import rand_tree

# the tiny DVAE of tests/test_train_cli.py
DVAE = dict(capacity=4, c_mults=(2, 4), strides=(4, 2), n_attn_layers=0,
            diffusion_c_mults=(8, 16))
LATENT, SAMPLES, DIMS, HIDDEN = 8, 2048, 8, 16
LOSS_REL, GRAD_REL_RMS = 1e-5, 1e-4
LOG_KEYS = ("train_loss", "mix_loss", "var_loss", "cov_loss", "aa_recon_loss")


@pytest.fixture(scope="module")
def encoders():
    """(JAX encode fn, the port's wrapper) holding the same DVAE weights."""
    jdvae = JDVAE(latent_dim=LATENT, **DVAE)
    tree = rand_tree(jdvae, 0, jnp.zeros((1, 2, SAMPLES)), jnp.zeros((1,)))
    wrapper = DVAEWrapper(args_dict={"latent_dim": LATENT, "sample_size": SAMPLES},
                          model_kwargs=DVAE, device="cpu")
    wrapper.load_flax_params(tree)

    def jencode(x):
        return jdvae.apply({"params": tree}, x, method=JDVAE.encode_it)
    jencode.tree = tree
    return jencode, wrapper


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _check(loss, logs, module, want_loss, want_logs, want_grads):
    assert abs(float(loss) - float(want_loss)) < LOSS_REL * abs(float(want_loss))
    for k in LOG_KEYS:
        w = float(want_logs[k])
        assert abs(float(logs[k]) - w) < LOSS_REL * max(abs(w), 1e-3 * abs(float(want_loss))), k
    got, want = dict(_leaves(to_flax_grads(module))), dict(_leaves(want_grads["params"]))
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.isfinite(got[k]).all()
        assert _rel_rms(got[k], w) < GRAD_REL_RMS, (k, _rel_rms(got[k], w))


def _models(use_bn, seed=2):
    jmod = JAudioAlgebra(dims=DIMS, hidden_dims=HIDDEN, use_bn=use_bn)
    variables = aa_variables(jmod, seed)
    return jmod, variables, load_flax_params(
        AudioAlgebra(dims=DIMS, hidden_dims=HIDDEN, use_bn=use_bn), variables)


def _audio(seed, *shape):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("use_bn", [False, True])
def test_mixer_loss_and_grads_match_jax(encoders, use_bn):
    jencode, wrapper = encoders
    jmod, variables, tmod = _models(use_bn)
    stems, batch = _audio(1, 2, 2, 2, SAMPLES), _audio(2, 2, 2, SAMPLES)
    faders = np.array([1.1, -0.8], np.float32)
    loss_fn = jmixer.make_mixer_loss_fn(jmod, jencode)
    (want_loss, want_logs), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        variables, jnp.asarray(stems), jnp.asarray(faders), jnp.asarray(batch))
    tmod.train()        # the losses run BatchNorm on its running statistics regardless
    loss, logs = tmixer.make_mixer_loss_fn(tmod, tmixer.given_model_encode_fn(wrapper))(
        *(torch.from_numpy(a) for a in (stems, faders, batch)))
    loss.backward()
    _check(loss.detach(), logs, tmod, want_loss, want_logs, want_grads)
    assert all(p.grad is None for p in wrapper.model.parameters())


@pytest.mark.parametrize("use_bn", [False, True])
def test_effects_loss_and_grads_match_jax(encoders, use_bn):
    jencode, wrapper = encoders
    jmod, variables, tmod = _models(use_bn, seed=4)
    clips = [_audio(10 + i, 2, 2, SAMPLES) for i in range(4)]
    loss_fn = jeffects.make_effects_loss_fn(jmod, jencode)
    (want_loss, want_logs), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables, *map(jnp.asarray, clips))
    loss, logs = teffects.make_effects_loss_fn(tmod, tmixer.given_model_encode_fn(wrapper))(
        *(torch.from_numpy(c) for c in clips))
    loss.backward()
    _check(loss.detach(), logs, tmod, want_loss, want_logs, want_grads)


def test_frozen_encode_is_outside_the_graph(encoders):
    _, wrapper = encoders
    y = tmixer.given_model_encode_fn(wrapper)(torch.from_numpy(_audio(3, 2, 2, SAMPLES)))
    assert y.shape == (2, LATENT, SAMPLES // 8) and y.grad_fn is None
    assert not y.requires_grad and not y.is_inference()


@pytest.mark.parametrize("total", [3, 4, 5, 100])
def test_onecycle_schedule_matches_optax(total):
    sched = optax.cosine_onecycle_schedule(total, 1e-3)
    for step in range(total + 3):
        want, got = float(sched(step)), onecycle_lr(step, total, 1e-3)
        if total < 4:                       # optax divides by a zero-length warm-up
            assert np.isnan(want) and np.isnan(got)
        else:               # optax interpolates in f32, to ~1e-7 of the peak
            assert abs(got - want) <= 1e-6 * 1e-3, (step, got, want)


def _latent_batches(n, seed=20):
    """Mixer-loss inputs in latent space (identity encoders on both sides):
    stems (2, 4, 8, 16), faders, batch (4, 8, 16)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 4, DIMS, 16)).astype(np.float32),
             rng.uniform(-1.5, 1.5, 2).astype(np.float32),
             rng.standard_normal((4, DIMS, 16)).astype(np.float32)) for _ in range(n)]


def _optax_run(variables, opt, batches):
    jmod = JAudioAlgebra(dims=DIMS, hidden_dims=HIDDEN)
    loss_fn = jmixer.make_mixer_loss_fn(jmod, lambda x: x)
    params = variables
    state = opt.init(params)

    @jax.jit
    def step(params, state, *batch):
        grads = jax.grad(lambda p: loss_fn(p, *batch)[0])(params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state
    trail = []
    for batch in batches:
        params, state = step(params, state, *map(jnp.asarray, batch))
        trail.append(params)
    return trail


def _port_run(tmod, opt, batches):
    loss_fn = tmixer.make_mixer_loss_fn(tmod, lambda x: x)
    trail = []
    for batch in batches:
        loss, _ = loss_fn(*(torch.from_numpy(a) for a in batch))
        loss.backward()
        opt.step()
        trail.append(to_flax_params(tmod))
    return trail


def _max_abs(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    return max(np.abs(got[k] - want[k]).max() for k in want)


def test_three_adam_steps_match_optax():
    _, variables, tmod = _models(False, seed=7)
    batches = _latent_batches(3)
    want = _optax_run(variables, optax.adam(optax.cosine_onecycle_schedule(10, 1e-3)),
                      batches)
    opt = tmixer.OneCycleAdam(tmod, 10, 1e-3)
    got = _port_run(tmod, opt, batches)
    for g, w in zip(got, want):
        assert _max_abs(g, w["params"]) < 1e-6
    assert opt.updates == 3 and opt.lr() == onecycle_lr(3, 10, 1e-3)
    assert _max_abs(got[-1], variables["params"]) > 1e-5        # the weights moved


def test_accumulation_matches_optax_multisteps():
    _, variables, tmod = _models(False, seed=8)
    batches = _latent_batches(4, seed=21)
    want = _optax_run(variables, optax.MultiSteps(
        optax.adam(optax.cosine_onecycle_schedule(4, 1e-3)), every_k_schedule=2), batches)
    opt = tmixer.OneCycleAdam(tmod, 4, 1e-3, accum=2)
    got = _port_run(tmod, opt, batches)
    for g, w in zip(got, want):
        assert _max_abs(g, w["params"]) < 1e-6
    # Adam steps on the second and fourth mini-batches only
    assert _max_abs(got[0], variables["params"]) == 0.0
    assert _max_abs(got[1], got[0]) > 1e-5 and _max_abs(got[2], got[1]) == 0.0
    assert opt.updates == 2 and opt.mini_step == 0


def _train_both(encoders, jax_mod, port_mod, batches, **arg_kw):
    """JAX's and the port's train_aa_model from the same algebra weights on
    the same loader (a list of batches) and seed: (JAX history and final
    params, port history and final params)."""
    from types import SimpleNamespace

    from audio_algebra_tpu.given_models import DVAEWrapper as JDVAEWrapper
    jencode, wrapper = encoders
    jwrapper = JDVAEWrapper(args_dict={"latent_dim": LATENT, "sample_size": SAMPLES},
                            model_kwargs=DVAE)
    jwrapper.params = jwrapper.params_ema = {"params": jencode.tree}
    jmod, variables, tmod = _models(False, seed=9)
    args = SimpleNamespace(max_epochs=1, steps_per_epoch=0, max_lr=1e-3, seed=3,
                           latent_dim=DIMS, hidden_dims=HIDDEN, **arg_kw)
    jbundle = jax_mod.AABundle(dims=DIMS, hidden_dims=HIDDEN)
    jbundle.params = variables
    jbundle, jhist = jax_mod.train_aa_model(jwrapper, batches, args, aa_model=jbundle)
    tbundle = port_mod.AABundle(dims=DIMS, hidden_dims=HIDDEN, device="cpu")
    load_flax_params(tbundle.module, variables)
    tbundle, thist = port_mod.train_aa_model(wrapper, batches, args, aa_model=tbundle)
    return jhist, jbundle.params["params"], thist, to_flax_params(tbundle.module)


def _assert_histories_close(jhist, thist):
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == list(range(len(jhist)))
    for j, t in zip(jhist, thist):
        assert t["learning_rate"] == pytest.approx(j["learning_rate"], rel=1e-5)
        for k in LOG_KEYS:
            assert abs(t[k] - j[k]) < LOSS_REL * max(abs(j[k]), 1e-3 * abs(j["train_loss"])), k


def test_mixer_train_aa_model_matches_jax(encoders):
    batches = [_audio(30 + i, 2, 2, SAMPLES) for i in range(4)]
    jhist, jparams, thist, tparams = _train_both(encoders, jmixer, tmixer, batches,
                                                 maxstems=2)
    _assert_histories_close(jhist, thist)
    assert _max_abs(tparams, jparams) < 1e-5


def test_effects_train_aa_model_matches_jax(encoders):
    batches = [{k: _audio(40 + 4 * i + j, 2, 2, SAMPLES) for j, k in
                enumerate(("a1", "b1", "a2", "b2"))} for i in range(4)]
    jhist, jparams, thist, tparams = _train_both(encoders, jeffects, teffects, batches)
    _assert_histories_close(jhist, thist)
    assert _max_abs(tparams, jparams) < 1e-5


def test_spectrogram_encode_fn_gives_a_tensor_a_graph_can_take():
    from audio_algebra_torch.given_models import MagSpectrogramAE
    ae = MagSpectrogramAE(n_fft=256, hop_length=64, device="cpu")
    x = torch.from_numpy(_audio(50, 2, 2, SAMPLES))
    y = tmixer.given_model_encode_fn(ae)(x)
    assert not y.is_inference() and not y.requires_grad
    torch.testing.assert_close(y, ae.encode(x), rtol=0, atol=0)
    w = torch.ones((), requires_grad=True)
    (w * y).sum().backward()                   # an inference tensor would refuse this
    assert w.grad is not None
