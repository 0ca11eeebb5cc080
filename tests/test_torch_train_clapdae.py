"""The port's MIRAGE trainer against the JAX one, on the CPU at a tiny size:
`v_objective_loss` and every parameter gradient of a tiny
StackedAELatentDiffusionCond (attention at T = 512: the differentiable
flash path, JAX's kernels in interpret mode) against `jax.value_and_grad`
with CFG dropout 0 and 1; the `keep` mask row by row; three `train_step`s
against three optax steps (Adam, the cosine schedule, EMASchedule); the
schedule and the EMA decay against optax's and JAX's; the Sobol draws;
`remat`; and `main` on generated WAVs: two steps, a checkpoint, a resume."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_algebra_tpu.models import clap as jclap
from audio_algebra_tpu.models import stacked as jstacked
from audio_algebra_tpu.models.ema import EMASchedule as JEMASchedule
from audio_algebra_tpu.utils.qmc import SobolSampler as JSobolSampler
from audio_algebra_torch import train_clapdae as ttrain
from audio_algebra_torch.models import stacked as tstacked
from audio_algebra_torch.models.ema import EMASchedule
from audio_algebra_torch.utils.audio_io import write_wav
from audio_algebra_torch.utils.params import (load_flax_params, to_flax_grads,
                                              to_flax_params, to_flax_tree)
from audio_algebra_torch.utils.qmc import SobolSampler
from test_torch_blocks import rand_tree

LDM = dict(latent_dim=4, channels=16, multipliers=(1, 1), factors=(1,), num_blocks=(1,),
           attentions=(0, 1), attention_heads=2, attention_features=16, resnet_groups=4)
T_LEN = 512          # the attention level's length: the training gate's minimum
GRAD_TOL = 2e-3      # per leaf, relative to the leaf's largest gradient
FIRST_STAGE = {"capacity": 4, "c_mults": [2, 4], "strides": [2, 2], "latent_dim": 8}
MODEL_KWARGS = dict(second_stage_latent_dim=4, factors=(2, 2), latent_channels=8,
                    latent_multipliers=(1, 2, 2), latent_num_blocks=(1, 1),
                    diffusion_c_mults=(8, 16), diffusion_depth=2, channels=8,
                    multipliers=(1, 2), factors2=(2,), num_blocks=(1,),
                    attentions=(0, 1), attention_heads=2, attention_features=16)


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    latents = np.tanh(rng.standard_normal((b, 4, T_LEN))).astype(np.float32)
    noise = rng.standard_normal((b, 4, T_LEN)).astype(np.float32)
    t = rng.random(b).astype(np.float32)
    emb = rng.standard_normal((b, 1, 512)).astype(np.float32)
    return latents, emb / np.linalg.norm(emb, axis=-1, keepdims=True), t, noise


@pytest.fixture(scope="module")
def pair():
    """The flax module with a random tree, and a factory of port modules
    holding the same weights."""
    jmodel = jstacked.StackedAELatentDiffusionCond(**LDM)
    tree = rand_tree(jmodel, 5, jnp.zeros((1, 4, T_LEN)), jnp.zeros((1,)),
                     jnp.zeros((1, 1, 512)))

    def port(**kw):
        return load_flax_params(tstacked.StackedAELatentDiffusionCond(**LDM, **kw), tree)

    return jmodel, tree, port


def _jax_loss_fn(jmodel, batch, proba):
    latents, emb, t, noise = (jnp.asarray(a) for a in batch)

    def apply(p, x, tt, **kw):
        return jmodel.apply({"params": p}, x, tt, **kw)

    return lambda p: jstacked.v_objective_loss(apply, p, latents, emb, t, noise,
                                               jax.random.PRNGKey(0),
                                               embedding_mask_proba=proba)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _assert_trees_close(got, want, tol, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for name, w in want.items():
        err = np.abs(got[name] - w).max() / max(np.abs(w).max(), 1e-12)
        assert err < tol, f"{what} {name}: rel err {err}"


@pytest.mark.parametrize("proba", [0.0, 1.0])
def test_loss_and_all_grads_match_jax(monkeypatch, pair, proba):
    jmodel, tree, port = pair
    batch = _batch(1)
    monkeypatch.setenv("AA_TRAIN_FLASH", "interpret")
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jmodel, batch, proba)))(tree)
    model = port()
    latents, emb, t, noise = (torch.from_numpy(a) for a in batch)
    loss = tstacked.v_objective_loss(model, latents, emb, t, noise,
                                     embedding_mask_proba=proba,
                                     generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-5 * abs(float(want_loss))
    got = to_flax_grads(model)
    _assert_trees_close(got, want_grads, GRAD_TOL, "grad")
    fixed = np.abs(got["diffusion"]["fixed_embedding"]).max()
    table = got["diffusion"]["core"]["mid_attn1_0"]["RelPosSelfAttention_0"]["rel_pos_bias"]
    # the null embedding learns only through dropped rows; the bucket table
    # through the flash backward's d(biasT)
    assert (fixed > 0) == (proba == 1.0) and np.abs(table).max() > 0


def test_keep_mask_row_by_row(pair):
    _, _, port = pair
    model = port()
    latents, emb, t, _ = (torch.from_numpy(a) for a in _batch(2))
    with torch.no_grad():
        cond = model(latents, t, embedding=emb)
        null = model(latents, t)
        mixed = model(latents, t, embedding=emb, keep=torch.tensor([True, False]))
        all_kept = model(latents, t, embedding=emb, embedding_mask_proba=0.0)
    torch.testing.assert_close(mixed[0], cond[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mixed[1], null[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(all_kept, cond, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        model(latents, t, embedding=emb, embedding_mask_proba=0.1)
    g = torch.Generator().manual_seed(3)
    drawn = torch.rand((2, 1, 1), generator=torch.Generator().manual_seed(3)) < 0.5
    with torch.no_grad():
        want = model(latents, t, embedding=emb, keep=drawn)
        got = model(latents, t, embedding=emb, embedding_mask_proba=0.5, generator=g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_three_train_steps_match_optax(monkeypatch, pair):
    jmodel, tree, port = pair
    monkeypatch.setenv("AA_TRAIN_FLASH", "interpret")
    lr, t_max = 4e-5, 500
    sched = optax.cosine_decay_schedule(lr, decay_steps=t_max, alpha=1e-6 / lr)
    opt = optax.adam(sched)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = opt.init(params)
    ema_sched = JEMASchedule(beta=0.9999, power=0.75)
    state = ttrain.make_state(port(), lr=lr, t_max=t_max)

    @jax.jit
    def loss_and_grads(p, *batch):
        return jax.value_and_grad(_jax_loss_fn(jmodel, batch, 0.0))(p)

    for step in range(3):
        batch = _batch(10 + step)
        loss, grads = loss_and_grads(params, *batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = ema_sched.update(params, ema, jnp.asarray(step))
        assert state.step == step
        got = ttrain.train_step(state, *(torch.from_numpy(a) for a in batch))
        assert abs(float(got) - float(loss)) < 1e-5 * abs(float(loss))
    assert state.step == 3
    _assert_trees_close(to_flax_params(state.model), params, 1e-5, "param")
    _assert_trees_close(to_flax_tree(state.model, state.ema_params), ema, 1e-5, "ema")
    before, after = dict(_leaves(tree)), dict(_leaves(to_flax_params(state.model)))
    moved = max(np.abs(after[k] - before[k]).max() for k in before)
    assert moved > 1e-5, "the parameters did not move"
    assert state.digest()["params"] != state.digest()["ema"]


@pytest.mark.parametrize("step", [0, 1, 2, 250, 499, 500, 501, 1000, 10 ** 6])
def test_schedule_is_optax_cosine_then_flat(step):
    sched = optax.cosine_decay_schedule(4e-5, decay_steps=500, alpha=1e-6 / 4e-5)
    got = ttrain.cosine_lr(step, 4e-5, 500)
    assert abs(got - float(sched(step))) < 1e-6 * float(sched(step))
    if step >= 500:
        assert got == pytest.approx(1e-6, rel=1e-9)


@pytest.mark.parametrize("step", [0, 1, 2, 10, 10 ** 6])
def test_ema_decay_matches_jax(step):
    want = float(JEMASchedule(beta=0.9999, power=0.75).decay(step))
    got = EMASchedule(beta=0.9999, power=0.75).decay(step)
    assert abs(got - want) <= 1e-6 * max(want, 1e-12)
    if step <= 1:
        assert got == 0.0
    if step == 10 ** 6:
        assert got == pytest.approx(0.9999, rel=1e-6)


def test_sobol_draws_are_bit_equal():
    a, b = SobolSampler(dim=1, scramble=True, seed=42), JSobolSampler(dim=1, scramble=True, seed=42)
    for n in (8, 3, 16):
        x, y = a.draw(n), b.draw(n)
        assert x.dtype == np.float32 and x.shape == (n,)
        np.testing.assert_array_equal(x, y)


def test_remat_gives_the_same_loss_and_grads(pair):
    _, _, port = pair
    batch = [torch.from_numpy(a) for a in _batch(4)]
    keep = torch.tensor([True, False])
    grads = {}
    for remat in (False, True):
        model = port(remat=remat)
        loss = tstacked.v_objective_loss(model, *batch, keep=keep)
        loss.backward()
        grads[remat] = (float(loss.detach()), to_flax_grads(model))
    assert grads[True][0] == pytest.approx(grads[False][0], rel=1e-6)
    _assert_trees_close(grads[True][1], grads[False][1], 1e-5, "remat grad")


def _write_corpus(root, n=4, samples=20000):
    rng = np.random.default_rng(0)
    t = np.arange(samples) / 48000
    root.mkdir()
    for i in range(n):
        tone = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)
        clip = np.stack([tone, tone * 0.5]) + 0.05 * rng.standard_normal((2, samples))
        write_wav(root / f"clip{i}.wav", clip.astype(np.float32), 48000)


def _argv(tmp_path, *extra):
    cfg = tmp_path / "model.json"
    if not cfg.exists():
        cfg.write_text(json.dumps({
            "first_stage_config": FIRST_STAGE, "model_kwargs": MODEL_KWARGS,
            "clap_kwargs": {"audio_cfg": dict(jclap.TINY_AUDIO_CFG),
                            "text_cfg": dict(jclap.TINY_TEXT_CFG)}}))
    return ["--device", "cpu", "--training_dir", str(tmp_path / "wavs"), "--batch_size", "2",
            "--sample_size", "16384", "--num_workers", "0", "--max_epochs", "1",
            "--load_frac", "1.0", "--num_gpus", "1", "--name", "tiny",
            "--model_config", str(cfg), *extra]


def test_main_trains_and_resumes_on_the_cpu(tmp_path, monkeypatch):
    """The slice as a whole: WAVs -> dataset -> frozen encoders -> two steps
    through the K4 twins -> checkpoint; a second run resumes at step 2."""
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path / "wavs")
    run = ttrain.main(_argv(tmp_path))
    assert (run["start_step"], run["end_step"]) == (0, 2)
    assert [r["step"] for r in run["records"]] == [0, 1]
    for r in run["records"]:
        assert np.isfinite(r["train_loss"])
        assert r["train_lr"] == pytest.approx(ttrain.cosine_lr(r["step"], 4e-5, 500))
        assert r["train_ema_decay"] == EMASchedule().decay(r["step"])
    assert run["end_digest"]["params"] != run["start_digest"]["params"]
    assert run["ckpt"].endswith("step_00000002")
    log = [json.loads(line) for line in open(f"{run['run_dir']}/log.jsonl")]
    assert log[0]["step"] == 0 and "train_loss" in log[0]
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in run["state"].model.parameters())
    again = ttrain.main(_argv(tmp_path, "--ckpt_path", f"{run['run_dir']}/ckpt"))
    assert (again["start_step"], again["end_step"]) == (2, 4)
    assert again["start_digest"] == run["end_digest"]
    assert again["records"][0]["step"] == 2
    assert again["records"][0]["train_lr"] == pytest.approx(ttrain.cosine_lr(2, 4e-5, 500))


def test_build_state_freezes_the_encoders(tmp_path):
    """What the trainer reads from CLAPDAE: the stage-1 stack and CLAP frozen
    and in eval mode, the latent diffusion model trainable in f32; latents
    and embeddings come out as ordinary tensors that may enter a graph."""
    from audio_algebra_torch.config import get_all_args
    args = get_all_args(argv=_argv(tmp_path))
    clapdae, state = ttrain.build_state(args, "cpu")
    frozen = [clapdae.latent_diffae, clapdae.clap_module.audio_model,
              clapdae.clap_module.text_model]
    assert all(not p.requires_grad for m in frozen for p in m.parameters())
    assert not any(m.training for m in frozen)
    assert set(clapdae.ldm_params) == set(state.ema_params)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in clapdae.ldm_params.values())
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2, 16384))
                             .astype(np.float32) * 0.1)
    latents = clapdae.encode_audio_latents(audio)
    emb = clapdae.embed(audio)
    assert latents.shape == (2, 4, 1024) and emb.shape == (2, 1, 512)
    assert not latents.is_inference() and not emb.is_inference()
    loss = ttrain.train_step(state, latents, emb, torch.tensor([0.3, 0.6]),
                             torch.randn(latents.shape, generator=torch.Generator().manual_seed(0)))
    assert np.isfinite(float(loss))


def test_main_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """--fsdp 1 is ported (parallel/fsdp.py); over more processes than this
    one it is refused outside a launched group, with the torchrun line."""
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 -m "
                                           "audio_algebra_torch.train_clapdae"):
        ttrain.main(_argv(tmp_path, "--fsdp", "1", "--num_gpus", "2"))
    assert "--num_gpus 2" in capsys.readouterr().out


def test_step_generator_depends_on_seed_and_step():
    draw = lambda s, i: torch.randn(4, generator=ttrain.step_generator(s, i, "cpu"))
    assert torch.equal(draw(1, 5), draw(1, 5))
    assert not torch.equal(draw(1, 5), draw(1, 6)) and not torch.equal(draw(1, 5), draw(2, 5))
