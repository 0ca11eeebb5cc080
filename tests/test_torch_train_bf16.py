"""The port's bf16 mixed-precision training against the JAX package's, on
the CPU at the quick widths of tools/bench_train.py: one MIRAGE training
step (`make_train_step(..., compute_dtype=torch.bfloat16)`: bf16 compute on
the f32 masters) against `jax.value_and_grad` through the tool's
`model_apply` cast (its attention level at T = 512, so both sides take the
differentiable flash path, JAX's kernels in interpret mode), with one Adam
+ EMA update; the bf16 frozen stage-1 encode and the mixer loss on the
bf16 DVAE encode (both `mixed_encode_fn`) against the tool's casts. bf16
rounds at other places in the two frameworks, so the bounds are bf16's:
loss rel 1e-2, every gradient rel-RMS 5e-2 (the port's bf16 bound for
UNetCFG1d). Those bounds would also pass the port's f32 step (2.2e-2 from
JAX's bf16 step at the worst leaf, tests/torch_bf16_report.py), so the
step is also held away from the port's own f32 step: its modules compute
in bf16 and some gradient moves by more than bf16's unit roundoff."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_algebra_tpu import aa_mixer as jmixer
from audio_algebra_tpu.models import stacked as jstacked
from audio_algebra_tpu.models.dvae import DiffusionDVAE as JDVAE
from audio_algebra_tpu.models.ema import EMASchedule as JEMASchedule
from audio_algebra_torch import aa_mixer as tmixer
from audio_algebra_torch import train_clapdae as ttrain
from audio_algebra_torch.models import stacked as tstacked
from audio_algebra_torch.models.aa import AudioAlgebra
from audio_algebra_torch.models.dvae import DiffusionDVAE
from audio_algebra_torch.utils.params import (load_flax_params, to_flax_grads,
                                              to_flax_params, to_flax_tree)
from test_torch_blocks import rand_tree
from test_torch_stacked import LDAE

# bench_clapdae_step's quick StackedAELatentDiffusionCond; latents of 1024
# put its attention level (after the factor 2) at T = 512, flash_train_ok
LDM = dict(latent_dim=8, channels=16, multipliers=(1, 2), factors=(2,), num_blocks=(1,),
           attentions=(0, 1), resnet_groups=4, attention_heads=2, attention_features=8)
LAT_SHAPE = (2, 8, 1024)
# bench_mixer_step's quick DiffusionDVAE and its sample size; AABundle(8, 8)
DVAE = dict(latent_dim=8, capacity=4, c_mults=(2, 4), strides=(4, 2), n_attn_layers=1,
            diffusion_c_mults=(8, 16, 16))
SAMPLES, DIMS = 2048, 8
LOSS_REL, GRAD_REL_RMS = 1e-2, 5e-2
# the least distance of a bf16 step's worst gradient from the f32 step's:
# bf16's unit roundoff, 2^-8 (2.9e-2 measured here; an f32 step gives 0)
BF16_FLOOR = 2.0 ** -8
BF16 = torch.bfloat16


def _bf16_tree(p):
    """The tool's cast: every floating leaf to bf16."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a, p)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v, np.float64)


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _batch(seed):
    rng = np.random.default_rng(seed)
    latents = np.tanh(rng.standard_normal(LAT_SHAPE)).astype(np.float32)
    noise = rng.standard_normal(LAT_SHAPE).astype(np.float32)
    t = rng.random(LAT_SHAPE[0]).astype(np.float32)
    emb = rng.standard_normal((LAT_SHAPE[0], 1, 512)).astype(np.float32)
    return latents, emb / np.linalg.norm(emb, axis=-1, keepdims=True), t, noise


@pytest.fixture(scope="module")
def ldm():
    jmodel = jstacked.StackedAELatentDiffusionCond(**LDM)
    tree = rand_tree(jmodel, 5, jnp.zeros((1,) + LAT_SHAPE[1:]), jnp.zeros((1,)),
                     jnp.zeros((1, 1, 512)))
    return jmodel, tree


def _jax_step(jmodel, tree, batch, proba, bf16=True):
    """The tool's step: value_and_grad through `model_apply`, optax.adam,
    the EMA; returns (loss, grads, params, opt_state, ema)."""
    latents, emb, t, noise = (jnp.asarray(a) for a in batch)

    def model_apply(p, x, tt, **kw):
        if not bf16:
            return jmodel.apply({"params": p}, x, tt, **kw)
        return jmodel.apply({"params": _bf16_tree(p)}, x.astype(jnp.bfloat16), tt,
                            **kw).astype(jnp.float32)

    def loss_fn(p):
        return jstacked.v_objective_loss(model_apply, p, latents, emb, t, noise,
                                         jax.random.PRNGKey(0), embedding_mask_proba=proba)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    return (loss, grads) + _jax_update(grads, tree)


@jax.jit
def _jax_update(grads, tree):
    """The tool's optax.adam update and the EMA after it: (params,
    opt_state, ema)."""
    sched = optax.cosine_decay_schedule(4e-5, decay_steps=500, alpha=1e-6 / 4e-5)
    opt = optax.adam(sched)
    updates, opt_state = opt.update(grads, opt.init(tree), tree)
    params = optax.apply_updates(tree, updates)
    ema = JEMASchedule(beta=0.9999, power=0.75).update(params, tree, jnp.asarray(0))
    return params, opt_state, ema


def _port_loss_and_grads(tree, args, keep, dtype):
    """The port's v-objective of one batch in `dtype` on f32 masters, its
    gradients, and the dtypes of every module's floating outputs."""
    model = load_flax_params(tstacked.StackedAELatentDiffusionCond(**LDM), tree)
    seen = set()

    def hook(module, inputs, out):
        if torch.is_tensor(out) and out.is_floating_point():
            seen.add(out.dtype)
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        loss = tstacked.v_objective_loss(ttrain.mixed_precision(model, dtype), *args,
                                         keep=keep)
    finally:
        handle.remove()
    loss.backward()
    return loss, model, seen


@pytest.mark.parametrize("proba", [0.0, 1.0])
def test_bf16_step_matches_jax(monkeypatch, ldm, proba):
    """Loss and every master gradient of the bf16 step against JAX's bf16
    step (proba 1: every row on the learned null embedding), then one Adam
    + EMA update through make_train_step."""
    jmodel, tree = ldm
    batch = _batch(1)
    monkeypatch.setenv("AA_TRAIN_FLASH", "interpret")
    want_loss, want_grads, want_params, want_opt, want_ema = _jax_step(jmodel, tree, batch,
                                                                        proba)
    args = [torch.from_numpy(a) for a in batch]
    keep = torch.full((LAT_SHAPE[0], 1, 1), proba == 0.0)

    loss, model, seen = _port_loss_and_grads(tree, args, keep, BF16)
    assert loss.dtype == torch.float32 and torch.bfloat16 in seen
    assert abs(float(loss.detach()) - float(want_loss)) < LOSS_REL * abs(float(want_loss))
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    got, want = dict(_leaves(to_flax_grads(model))), dict(_leaves(want_grads))
    assert set(got) == set(want)
    errs = {k: _rel_rms(got[k], w) for k, w in want.items() if np.abs(w).max() > 0}
    assert max(errs.values()) < GRAD_REL_RMS, sorted(errs.items(), key=lambda e: -e[1])[:5]
    assert all(np.isfinite(g).all() for g in got.values())
    # none zero where JAX's is not, and the other way round (the null
    # embedding learns only with proba 1)
    assert {k for k, g in got.items() if np.abs(g).max() == 0} == \
        {k for k, w in want.items() if np.abs(w).max() == 0}
    assert (np.abs(got["/diffusion/fixed_embedding"]).max() > 0) == (proba == 1.0)
    # the same step in f32: its modules compute in f32 only, and the bf16
    # step's worst gradient is at least bf16's roundoff away from it
    loss32, model32, seen32 = _port_loss_and_grads(tree, args, keep, torch.float32)
    assert seen32 == {torch.float32}
    got32 = dict(_leaves(to_flax_grads(model32)))
    floor = max(_rel_rms(got[k], g) for k, g in got32.items() if np.abs(g).max() > 0)
    assert floor > BF16_FLOOR and float(loss.detach()) != float(loss32.detach()), floor

    state = ttrain.make_state(load_flax_params(
        tstacked.StackedAELatentDiffusionCond(**LDM), tree))
    step = ttrain.make_train_step(state, compute_dtype=BF16)
    step_loss = step(*args, keep)
    assert state.step == 1 and float(step_loss) == float(loss.detach())
    params = dict(_leaves(to_flax_params(state.model)))
    # Adam's first update moves each weight by ~lr x sign(g): within two
    # learning rates of JAX's, and the moments as the gradients
    for k, w in dict(_leaves(want_params)).items():
        assert np.abs(params[k] - w).max() <= 2 * 4e-5 * (1 + 1e-3), k
    adam = state.opt.state_dict()["state"]
    names = [n for n, _ in state.model.named_parameters()]
    m = to_flax_tree(state.model, {n: adam[i]["exp_avg"] for i, n in enumerate(names)})
    for k, w in dict(_leaves(want_opt[0].mu)).items():
        if np.abs(w).max() > 0:
            assert _rel_rms(dict(_leaves(m))[k], w) < GRAD_REL_RMS, k
    ema = dict(_leaves(to_flax_tree(state.model, state.ema_params)))
    for k, w in dict(_leaves(want_ema)).items():
        assert np.abs(ema[k] - w).max() <= 2 * 4e-5 * (1 + 1e-3), k
    assert all(e.dtype == torch.float32 for e in state.ema_params.values())


def test_make_train_step_compute_dtypes(ldm):
    """f32 stays the default and the model itself; bf16 on an FSDP-sharded
    state and other dtypes are refused."""
    _, tree = ldm
    model = load_flax_params(tstacked.StackedAELatentDiffusionCond(**LDM), tree)
    assert ttrain.mixed_precision(model, torch.float32) is model
    state = ttrain.make_state(model)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ttrain.make_train_step(state, compute_dtype=torch.float16)
    state.sharded = True
    with pytest.raises(ValueError, match="FSDP"):
        ttrain.make_train_step(state, compute_dtype=BF16)
    ttrain.make_train_step(state)                    # f32 on a sharded state: built


def test_bf16_frozen_encode_matches_jax():
    """mixed_encode_fn on LatentAudioDiffusionAutoencoder.encode against the
    tool's bf16 frozen encode (bench_clapdae_frozen_encode: tree and input
    cast to bf16), and both bf16 encodes' distance from the f32 encode."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 2, 1024)) * 0.2).astype(np.float32)
    jm = jstacked.LatentAudioDiffusionAutoencoder(**LDAE)
    tree = rand_tree(jm, 4, jnp.zeros((1, 2, 1024)), jnp.zeros((1,)))
    encode = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, method=jstacked.LatentAudioDiffusionAutoencoder.encode))
    want = encode(_bf16_tree(tree), jnp.asarray(x).astype(jnp.bfloat16))
    want32 = np.asarray(encode(tree, jnp.asarray(x)))
    tm = load_flax_params(tstacked.LatentAudioDiffusionAutoencoder(**LDAE), tree)
    with torch.no_grad():
        got = tmixer.mixed_encode_fn(tm, "encode")(torch.from_numpy(x))
        got32 = tm.encode(torch.from_numpy(x))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.float32
    assert got.shape == want.shape and torch.isfinite(got).all()
    # two bf16 roundings of one function: held to twice JAX's own distance
    # from its f32 encode (4.1e-2 here; the port's from its f32 4.0e-2, from
    # JAX's bf16 5.6e-2)
    jax_spread = _rel_rms(np.asarray(want, np.float32), want32)
    assert 0 < jax_spread < 0.1
    assert _rel_rms(got.numpy(), np.asarray(want, np.float32)) < 2 * jax_spread
    assert 0 < _rel_rms(got.numpy(), got32.numpy()) < 2 * jax_spread
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_bf16_mixer_loss_matches_jax():
    """make_mixer_loss_fn on the bf16 DVAE encode (mixed_encode_fn) against
    the tool's bench_mixer_step loss: the loss and all AudioAlgebra
    gradients."""
    jdvae = JDVAE(**DVAE)
    tree = rand_tree(jdvae, 0, jnp.zeros((1, 2, SAMPLES)), jnp.zeros((1,)))
    aa = jmixer.AABundle(dims=DIMS, hidden_dims=DIMS)
    enc_tree = _bf16_tree(tree)

    def jencode(x):
        return jdvae.apply({"params": enc_tree}, x.astype(jnp.bfloat16),
                           method=JDVAE.encode_it).astype(jnp.float32)

    rng = np.random.default_rng(1)
    stems = (rng.standard_normal((2, 2, 2, SAMPLES)) * 0.2).astype(np.float32)
    faders = np.array([1.1, 0.8], np.float32)
    batch = (rng.standard_normal((2, 2, SAMPLES)) * 0.2).astype(np.float32)
    (want, _), want_grads = jax.jit(jax.value_and_grad(
        jmixer.make_mixer_loss_fn(aa.module, jencode), has_aux=True))(
            aa.params, *(jnp.asarray(a) for a in (stems, faders, batch)))

    dvae = load_flax_params(DiffusionDVAE(**DVAE), tree).eval()
    module = load_flax_params(AudioAlgebra(dims=DIMS, hidden_dims=DIMS), aa.params)
    encode = tmixer.mixed_encode_fn(dvae)
    y = encode(torch.from_numpy(batch))
    assert y.dtype == torch.float32 and not y.requires_grad
    loss, _ = tmixer.make_mixer_loss_fn(module, encode)(
        *(torch.from_numpy(a) for a in (stems, faders, batch)))
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) < LOSS_REL * abs(float(want))
    got = dict(_leaves(to_flax_grads(module)))
    for k, w in dict(_leaves(want_grads["params"] if "params" in want_grads
                             else want_grads)).items():
        assert _rel_rms(got[k], w) < GRAD_REL_RMS, (k, _rel_rms(got[k], w))
    assert all(p.dtype == torch.float32 for p in dvae.parameters())
