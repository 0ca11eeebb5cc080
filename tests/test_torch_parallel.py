"""The port's data parallelism (audio_algebra_torch.parallel) against the
JAX package's, on the CPU: one pair of `gloo` worker processes (this file
run as a script, rank and directory on the command line, no JAX) runs
every two-rank case once; the tests compare what the workers wrote.

  * parallel.train's step on 2 ranks against the same step in one process
    on the whole batch and against JAX's make_data_parallel_step on a
    2-device CPU mesh, for the mixer loss: its VICReg terms see the global
    batch on every side (each updated tensor within 1e-5 of its largest
    entry, the update itself within 1e-4 rel-RMS, the gradient tolerance
    of test_torch_aa_train);
  * parallel.manual's step against JAX's make_manual_ddp_step (local
    statistics), and unlike the step above, as JAX's pair differs;
  * accum_steps=2 against JAX's step with optax.MultiSteps;
  * calc_effects_pca's streaming covariance sharded over the ranks against
    one process and JAX's;
  * train_clapdae's step (make_train_step: the global batch's mean loss,
    the ranks' gradients summed) and an effects_loss step (its four
    blocks each gathered) on 2 ranks against one process on the whole
    batch, both under SGD so that a wrongly scaled gradient shows in the
    update (Adam's would hide it);
  * train_aa_mixer, train_aa_effects and train_clapdae with --num_gpus 2
    and train_aa_mixer_accel on both ranks, at tiny configs: the ranks end
    with the same bits, rank 0 alone writes checkpoints.
Each worker has 120 s. The latents go in directly (an identity encoder
on both sides), as in test_torch_aa_train's optimiser cases.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

B, S, DIMS, HIDDEN, N = 8, 2, 8, 16, 16      # global batch 8 = 2 ranks x 4
LR = 1e-2
CLAPDAE_B, CLAPDAE_LR = 4, 1.0               # the update is the gradient itself
WORKER_TIMEOUT_S = 120
UPDATED_REL, UPDATE_REL_RMS = 1e-5, 1e-4


def _mixer_inputs(seed):
    """Latent-space mixer inputs: stems batch-leading (B, S, D, N), faders
    (S,), batch (B, D, N)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, DIMS, N)).astype(np.float32),
            np.array([1.1, -0.8], np.float32),
            rng.standard_normal((B, DIMS, N)).astype(np.float32))


def _effects_inputs(seed):
    """Latent-space effects inputs: (a1, b1, a2, b2), each (B, D, N)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, DIMS, N)).astype(np.float32) for _ in range(4))


def _clapdae_batch(t_len):
    """(latents, emb, t, noise, keep) of a global batch, one row's
    embedding dropped."""
    rng = np.random.default_rng(21)
    emb = rng.standard_normal((CLAPDAE_B, 1, 512)).astype(np.float32)
    return (np.tanh(rng.standard_normal((CLAPDAE_B, 4, t_len))).astype(np.float32),
            emb / np.linalg.norm(emb, axis=-1, keepdims=True),
            rng.random(CLAPDAE_B).astype(np.float32),
            rng.standard_normal((CLAPDAE_B, 4, t_len)).astype(np.float32),
            (np.arange(CLAPDAE_B) != 1)[:, None, None])


def _clapdae_case(tmp, world) -> dict:
    """One make_train_step step of a tiny MIRAGE UNet under SGD on this
    rank's rows of _clapdae_batch; its weights, EMA and loss after."""
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
    from audio_algebra_torch.train_clapdae import TrainState, make_train_step

    cfg = json.loads((Path(tmp) / "ldm.json").read_text())
    model = StackedAELatentDiffusionCond(**cfg["kwargs"])
    model.load_state_dict(torch.load(Path(tmp) / "ldm.pt"))
    params = dict(model.named_parameters())
    state = TrainState(model=model, ema_params={k: v.detach().clone() for k, v in params.items()},
                       opt=torch.optim.SGD(params.values(), lr=CLAPDAE_LR), lr=CLAPDAE_LR)
    rows = world.rows(CLAPDAE_B)
    loss = make_train_step(state, world)(*(torch.from_numpy(a[rows])
                                           for a in _clapdae_batch(cfg["t_len"])))
    out = _flat(model, "clapdae/")
    out.update({f"clapdae_ema/{k}": v.numpy().copy() for k, v in state.ema_params.items()})
    out["clapdae_loss"] = np.asarray(float(loss))
    return out


def _cov_batches():
    rng = np.random.default_rng(7)
    return [rng.standard_normal((B, 2, 256)).astype(np.float32) for _ in range(3)]


def _cov_weight():
    return np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)


def _torch_module(tmp):
    from audio_algebra_torch.models.aa import AudioAlgebra
    module = AudioAlgebra(dims=DIMS, hidden_dims=HIDDEN)
    module.load_state_dict(torch.load(Path(tmp) / "aa.pt"))
    return module


def _mixer_loss_fn(module):
    from audio_algebra_torch.aa_mixer import make_mixer_loss_fn
    inner = make_mixer_loss_fn(module, lambda x: x)

    def loss_fn(stems_b, faders, batch, gather=None):
        return inner(stems_b.transpose(0, 1), faders, batch, gather)
    return loss_fn


def _flat(module, case: str = "") -> dict:
    return {f"{case}{k}": v.detach().numpy().copy() for k, v in module.state_dict().items()}


def run_step_cases(tmp, world) -> dict:
    """The step cases on `world` (two ranks in the workers, one process in
    the parent): {"<case>/<tensor>": the module's tensor after the case,
    "<case>_loss": its last loss, "cov": the covariance}."""
    from audio_algebra_torch.aa_effects import make_effects_loss_fn
    from audio_algebra_torch.calc_effects_pca import finalize_cov, make_streaming_cov_step
    from audio_algebra_torch.parallel.manual import make_manual_ddp_step
    from audio_algebra_torch.parallel.train import make_data_parallel_step

    out = {}
    for name, make, accum, batches in (
            ("annotated", make_data_parallel_step, 1, [_mixer_inputs(1)]),
            ("manual", make_manual_ddp_step, 1, [_mixer_inputs(1)]),
            ("accum", make_data_parallel_step, 2, [_mixer_inputs(2), _mixer_inputs(3)])):
        module = _torch_module(tmp)
        step = make(_mixer_loss_fn(module), torch.optim.SGD(module.parameters(), lr=LR),
                    world, accum_steps=accum)
        for i, args in enumerate(batches):
            logs = step(*args)
            if accum > 1 and i == 0:
                out.update(_flat(module, "accum_first/"))
        out.update(_flat(module, f"{name}/"))
        out[f"{name}_loss"] = np.asarray(float(logs["train_loss"]))
    module = _torch_module(tmp)
    step = make_data_parallel_step(make_effects_loss_fn(module, lambda x: x),
                                   torch.optim.SGD(module.parameters(), lr=LR), world)
    out["effects_loss"] = np.asarray(float(step(*_effects_inputs(4))["train_loss"]))
    out.update(_flat(module, "effects/"))
    out.update(_clapdae_case(tmp, world))
    w = torch.from_numpy(_cov_weight())
    cov_step = make_streaming_cov_step(lambda x: torch.einsum("bct,cd->bdt", x[..., ::16], w),
                                       world)
    acc = (torch.zeros((4, 4)), torch.zeros((4,)), 0)
    for b in _cov_batches():
        acc = cov_step(*acc, b)
    out["cov"] = finalize_cov(*acc)
    return out


def _trainer_argv(tmp, *extra):
    return ["--device", "cpu", "--training_dir", str(Path(tmp) / "wavs"), "--batch_size", "4",
            "--num_workers", "0", "--max_epochs", "2", "--load_frac", "1.0",
            "--num_gpus", "2", *extra]


def run_trainers(tmp) -> dict:
    """Each trainer's main with --num_gpus 2 in the launched group: the
    end digests, steps, and whether this rank wrote a checkpoint."""
    from audio_algebra_torch import (train_aa_effects, train_aa_mixer, train_aa_mixer_accel,
                                     train_clapdae)

    aa = ["--sample_size", "2048", "--model_config", str(Path(tmp) / "dvae.json"),
          "--latent_dim", "8", "--hidden_dims", "8"]
    out = {}
    for name, mod, extra in (
            ("mixer", train_aa_mixer, aa + ["--name", "mixer"]),
            ("effects", train_aa_effects, aa + ["--name", "effects"]),
            ("accel", train_aa_mixer_accel, aa + ["--name", "accel"]),
            ("clapdae", train_clapdae, ["--sample_size", "16384", "--name", "clapdae",
                                        "--model_config", str(Path(tmp) / "clapdae.json")])):
        run = mod.main(_trainer_argv(tmp, *extra))
        losses = [r.get("train_loss") for r in run["records"]]
        out[name] = {"end_digest": run["end_digest"], "start_digest": run["start_digest"],
                     "end_step": run["end_step"], "ckpt": run["ckpt"],
                     "world": [run["world"].size, run["world"].rank],
                     "losses_finite": bool(np.isfinite(losses).all())}
    return out


def worker(rank: int, tmp: str, port: int) -> None:
    import torch.distributed as dist
    from audio_algebra_torch.parallel.mesh import make_mesh
    from audio_algebra_torch.parallel.multihost import initialize_distributed

    torch.set_num_threads(2)
    os.chdir(tmp)
    assert initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        world = make_mesh(device="cpu")
        np.savez(Path(tmp) / f"steps_{rank}.npz", **run_step_cases(tmp, world))
        (Path(tmp) / f"trainers_{rank}.json").write_text(json.dumps(run_trainers(tmp)))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------- parent ---

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_inputs(tmp: Path) -> dict:
    """The flax variables of the algebra model (saved as the port's state
    dict), the tiny models' configs and the trainers' corpus."""
    import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets it)
    from audio_algebra_tpu.models.aa import AudioAlgebra as JAudioAlgebra
    from audio_algebra_torch.models.aa import AudioAlgebra
    from audio_algebra_torch.utils.audio_io import write_wav
    from audio_algebra_torch.utils.params import load_flax_params
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
    from audio_algebra_torch.utils.params import random_init_
    from test_torch_aa import aa_variables
    from test_torch_train_clapdae import FIRST_STAGE, LDM, MODEL_KWARGS, T_LEN

    jmod = JAudioAlgebra(dims=DIMS, hidden_dims=HIDDEN)
    variables = aa_variables(jmod, 5)
    torch.save(load_flax_params(AudioAlgebra(dims=DIMS, hidden_dims=HIDDEN),
                                variables).state_dict(), tmp / "aa.pt")
    torch.save(random_init_(StackedAELatentDiffusionCond(**LDM), 3).state_dict(),
               tmp / "ldm.pt")
    (tmp / "ldm.json").write_text(json.dumps({"kwargs": LDM, "t_len": T_LEN}))
    (tmp / "dvae.json").write_text(json.dumps({
        "model_kwargs": {"capacity": 4, "c_mults": [2, 4], "strides": [4, 2],
                         "n_attn_layers": 0, "diffusion_c_mults": [8, 16]},
        "args_dict": {"latent_dim": 8}}))
    from audio_algebra_tpu.models import clap as jclap
    (tmp / "clapdae.json").write_text(json.dumps({
        "first_stage_config": FIRST_STAGE, "model_kwargs": MODEL_KWARGS,
        "clap_kwargs": {"audio_cfg": dict(jclap.TINY_AUDIO_CFG),
                        "text_cfg": dict(jclap.TINY_TEXT_CFG)}}))
    (tmp / "wavs").mkdir()
    rng = np.random.default_rng(3)
    t = np.arange(20000) / 48000
    for i in range(8):
        tone = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)
        write_wav(tmp / "wavs" / f"clip{i}.wav",
                  (np.stack([tone, 0.5 * tone]) + 0.05 * rng.standard_normal((2, t.size)))
                  .astype(np.float32), 48000)
    return {"jmod": jmod, "variables": variables}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Run the two workers once; returns (their results, the inputs)."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = _write_inputs(tmp)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(root / "tests")]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(key, None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(tmp), str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-3000:]}"
    steps = [dict(np.load(tmp / f"steps_{r}.npz")) for r in range(2)]
    trainers = [json.loads((tmp / f"trainers_{r}.json").read_text()) for r in range(2)]
    return {"steps": steps, "trainers": trainers, "tmp": tmp, **inputs}


def _case(res: dict, case: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in res.items() if k.startswith(case + "/")}


@pytest.fixture(scope="module")
def one_process(pair):
    """The same step cases in this process: one rank, the whole batch."""
    from audio_algebra_torch.parallel.mesh import World
    return run_step_cases(pair["tmp"], World(1, 0, torch.device("cpu")))


def _jax_mixer_step(pair, manual: bool, accum: int, batches) -> dict:
    """JAX's step on a 2-device CPU mesh; the flax tree after it, in the
    port's state-dict names."""
    import jax
    import jax.numpy as jnp
    import optax
    from audio_algebra_tpu import aa_mixer as jmixer
    from audio_algebra_tpu.parallel import make_mesh
    from audio_algebra_tpu.parallel.manual import make_manual_ddp_step
    from audio_algebra_tpu.parallel.train import make_data_parallel_step, replicate_state
    from audio_algebra_torch.models.aa import AudioAlgebra
    from audio_algebra_torch.utils.params import load_flax_params

    mesh = make_mesh(n_devices=2)
    loss_fn = jmixer.make_mixer_loss_fn(pair["jmod"], lambda x: x)
    make = make_manual_ddp_step if manual else make_data_parallel_step
    step = make(lambda p, sb, f, b: loss_fn(p, jnp.swapaxes(sb, 0, 1), f, b),
                optax.sgd(LR), mesh, accum_steps=accum)
    params = replicate_state(pair["variables"], mesh)
    opt_state = replicate_state(step.optimizer.init(pair["variables"]), mesh)
    for args in batches:
        params, opt_state, _ = step(params, opt_state, *args)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return _flat(load_flax_params(AudioAlgebra(dims=DIMS, hidden_dims=HIDDEN), tree))


def _initial(pair) -> dict:
    return _flat(_torch_module(pair["tmp"]))


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _assert_same_update(got: dict, want: dict, start: dict, what: str):
    assert set(got) == set(want)
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= UPDATED_REL * float(np.abs(want[k]).max()), (what, k, err)
        assert _rel_rms(got[k] - start[k], want[k] - start[k]) < UPDATE_REL_RMS, (what, k)


def test_ranks_hold_the_same_bits(pair):
    a, b = pair["steps"]
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_annotated_step_is_the_global_batch_step(pair, one_process):
    """2 ranks = one process on the whole batch = JAX's annotated step."""
    start = _initial(pair)
    two = _case(pair["steps"][0], "annotated")
    _assert_same_update(two, _case(one_process, "annotated"), start, "vs one process")
    want = _jax_mixer_step(pair, manual=False, accum=1, batches=[_mixer_inputs(1)])
    _assert_same_update(two, want, start, "vs JAX")
    assert float(pair["steps"][0]["annotated_loss"]) == pytest.approx(
        float(one_process["annotated_loss"]), rel=1e-5)


def test_manual_step_is_jax_ddp_and_differs_from_annotated(pair):
    """Local statistics: JAX's shard_map step; not the annotated update."""
    start = _initial(pair)
    manual = _case(pair["steps"][0], "manual")
    _assert_same_update(manual, _jax_mixer_step(pair, manual=True, accum=1,
                                                batches=[_mixer_inputs(1)]), start, "vs JAX")
    annotated = _case(pair["steps"][0], "annotated")
    gap = max(_rel_rms(manual[k] - start[k], annotated[k] - start[k]) for k in start)
    assert gap > 1e-2, gap


def test_accum_steps_follow_multisteps(pair, one_process):
    start = _initial(pair)
    first = _case(pair["steps"][0], "accum_first")
    assert all(np.array_equal(first[k], start[k]) for k in start)   # accumulating
    got = _case(pair["steps"][0], "accum")
    want = _jax_mixer_step(pair, manual=False, accum=2,
                           batches=[_mixer_inputs(2), _mixer_inputs(3)])
    _assert_same_update(got, want, start, "vs optax.MultiSteps")
    _assert_same_update(got, _case(one_process, "accum"), start, "vs one process")


def test_sharded_covariance_is_the_single_one(pair, one_process):
    import jax.numpy as jnp
    from audio_algebra_tpu.parallel import make_mesh
    from calc_effects_pca import finalize_cov, make_streaming_cov_step

    w = jnp.asarray(_cov_weight())
    step = make_streaming_cov_step(lambda x: jnp.einsum("bct,cd->bdt", x[..., ::16], w),
                                   make_mesh(n_devices=2))
    acc = (jnp.zeros((4, 4)), jnp.zeros((4,)), jnp.zeros(()))
    for b in _cov_batches():
        acc = step(*acc, jnp.asarray(b))
    np.testing.assert_allclose(pair["steps"][0]["cov"], one_process["cov"], rtol=1e-6)
    np.testing.assert_allclose(pair["steps"][0]["cov"], finalize_cov(*acc), rtol=1e-5)


def test_effects_step_is_the_global_batch_step(pair, one_process):
    """effects_loss gathers each of its four blocks: 2 ranks = one process."""
    _assert_same_update(_case(pair["steps"][0], "effects"), _case(one_process, "effects"),
                        _initial(pair), "vs one process")
    assert float(pair["steps"][0]["effects_loss"]) == pytest.approx(
        float(one_process["effects_loss"]), rel=1e-5)


def test_clapdae_step_is_the_global_batch_step(pair, one_process):
    """make_train_step on 2 ranks = one process on the whole batch: the loss
    is the global mean, the summed gradient (the SGD update) the global
    batch's, the EMA follows."""
    start = {k: v.numpy() for k, v in torch.load(pair["tmp"] / "ldm.pt").items()}
    for case in ("clapdae", "clapdae_ema"):
        two, one = _case(pair["steps"][0], case), _case(one_process, case)
        _assert_same_update(two, one, {k: start[k] for k in one}, f"{case} vs one process")
    assert float(pair["steps"][0]["clapdae_loss"]) == pytest.approx(
        float(one_process["clapdae_loss"]), rel=1e-5)


@pytest.mark.parametrize("trainer", ["mixer", "effects", "accel", "clapdae"])
def test_trainers_run_over_two_processes(pair, trainer):
    r0, r1 = (t[trainer] for t in pair["trainers"])
    assert r0["world"] == [2, 0] and r1["world"] == [2, 1]
    assert r0["end_digest"] == r1["end_digest"] and r0["start_digest"] == r1["start_digest"]
    assert r0["end_digest"] != r0["start_digest"]
    assert r0["end_step"] == r1["end_step"] == 4     # 8 files, global batch 4, 2 epochs
    assert r0["losses_finite"] and r1["losses_finite"]
    assert r0["ckpt"] is not None and Path(r0["ckpt"]).exists() and r1["ckpt"] is None



def test_initialize_distributed_does_nothing_without_the_env(monkeypatch):
    import torch.distributed as dist
    from audio_algebra_torch.parallel.mesh import make_mesh
    from audio_algebra_torch.parallel.multihost import initialize_distributed, is_main_process

    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed("localhost:1", 1, 0) is False     # one process: no group
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert initialize_distributed(num_processes=1) is False          # the argument wins
    assert not dist.is_initialized() and is_main_process()
    world = make_mesh(device="cpu")
    assert (world.size, world.rank, world.grouped) == (1, 0, False)
    x = torch.arange(6.0).reshape(3, 2)
    assert world.gather(x) is x


def test_placement_keeps_rank1_arguments_whole():
    """Each rank's view (rank 1 of 2, no group needed to cut rows): rank >= 2
    tensors cut when their leading dim splits, rank-1 ones (the faders)
    whole unless `arg_specs` says "data", a Shard as it is."""
    from audio_algebra_torch.parallel.mesh import World
    from audio_algebra_torch.parallel.multihost import Shard, global_batch_sharding
    from audio_algebra_torch.parallel.train import place_args, shard_batch

    world = World(2, 1, torch.device("cpu"))
    x, faders, t = torch.arange(24.0).reshape(4, 3, 2), torch.tensor([1.0, -1.0]), \
        torch.arange(4.0)
    odd = torch.zeros(3, 2)
    px, pf, pt, podd, n = place_args([x, faders, t, odd, 7], world)
    assert torch.equal(px, x[2:]) and torch.equal(pf, faders) and torch.equal(pt, t)
    assert torch.equal(podd, odd) and n == 7
    (pt,) = place_args([t], world, arg_specs=["data"])
    assert torch.equal(pt, t[2:])
    (px,) = place_args([x], world, arg_specs=["replicated"], compute_dtype=torch.bfloat16)
    assert px.dtype == torch.bfloat16 and px.shape == x.shape
    local = global_batch_sharding(world, 2)(x[:2].numpy())
    assert isinstance(local, Shard)
    assert torch.equal(place_args([local], world)[0], x[:2])
    with pytest.raises(ValueError, match="per_host_batch"):
        global_batch_sharding(world, 2)(x)
    assert torch.equal(shard_batch({"a": x}, world)["a"], x[2:])


def test_clapdae_draws_are_the_global_batch_rows():
    """step_draws on rank r of 2 (no group needed to cut rows) gives rows r
    of the one-process draws: t, noise and the CFG keep mask."""
    from audio_algebra_torch.parallel.mesh import World
    from audio_algebra_torch.train_clapdae import step_draws
    from audio_algebra_torch.utils.qmc import SobolSampler

    def draws(size, rank, n_local):
        latents = torch.zeros((n_local, 3, 5))
        return step_draws(SobolSampler(dim=1, scramble=True, seed=4), 4, 9, latents,
                          World(size, rank, torch.device("cpu")), 0.5)

    whole = draws(1, 0, 8)
    halves = [draws(2, r, 4) for r in range(2)]
    for i, name in enumerate(("t", "noise", "keep")):
        assert torch.equal(torch.cat([h[i] for h in halves]), whole[i]), name
    assert 0 < int(whole[2].sum()) < 8                # some rows dropped, some kept


def test_sharded_loader_rows_make_up_the_batch():
    """DataLoader(shard=(rank, 2)): the ranks' rows of each batch, in rank
    order, are one process's batch; a batch that does not split raises."""
    from audio_algebra_torch.datasets import DataLoader

    data = [np.full((2,), i, np.float32) for i in range(10)]
    whole = [b[:, 0] for b in DataLoader(data, batch_size=4, seed=3)]
    ranks = [[b[:, 0] for b in DataLoader(data, batch_size=4, seed=3, shard=(r, 2))]
             for r in range(2)]
    assert len(whole) == 2 and all(len(b) == 2 for rank in ranks for b in rank)
    for i, batch in enumerate(whole):
        assert np.array_equal(np.concatenate([ranks[0][i], ranks[1][i]]), batch)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        list(DataLoader(data[:3], batch_size=4, shard=(0, 2)))       # one short batch of 3
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        list(DataLoader(data[:7], batch_size=4, drop_last=False, shard=(1, 2)))   # tail of 3
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        DataLoader(data, batch_size=4, shard=(0, 3))


def test_mesh_axes_beyond_data_are_not_ported(monkeypatch):
    """The `seq` axis is ported: seq=1 parses to one process, seq=2 outside
    a group of 2 raises with the torchrun line; the `model` axis (no entry
    point of the JAX package uses it) still raises."""
    from audio_algebra_torch.parallel.mesh import make_mesh, mesh_from_spec

    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert mesh_from_spec("data=1", device="cpu").size == 1
    world = mesh_from_spec("seq=1", device="cpu")
    assert (world.size, world.rank, world.axis) == (1, 0, "seq")
    assert mesh_from_spec("data=1,seq=1", device="cpu").axis == "seq"
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2 -m "
                                         "audio_algebra_torch.mirage"):
        mesh_from_spec("seq=2", device="cpu", module="mirage")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        mesh_from_spec("data=1,seq=4", device="cpu")
    with pytest.raises(NotImplementedError, match="'model' mesh axis"):
        make_mesh(axis_names=("data", "model"), shape=(1, 1), device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        mesh_from_spec("data=2", device="cpu")
    with pytest.raises(ValueError, match="bad mesh spec"):
        mesh_from_spec("data=x", device="cpu")


def test_multisteps_averages_then_steps():
    """MultiSteps(sgd, 2) against optax.MultiSteps(optax.sgd, 2) on a
    quadratic, the gradients of the two calls different."""
    import jax
    import jax.numpy as jnp
    import optax
    from audio_algebra_torch.parallel.train import MultiSteps

    xs = [np.random.default_rng(i).standard_normal((8, 4)).astype(np.float32) for i in range(4)]
    w0 = np.ones((4,), np.float32)
    multi = optax.MultiSteps(optax.sgd(0.1), every_k_schedule=2)
    params, state = jnp.asarray(w0), multi.init(jnp.asarray(w0))
    w = torch.tensor(w0, requires_grad=True)
    opt = MultiSteps(torch.optim.SGD([w], lr=0.1), 2)
    for i, x in enumerate(xs):
        g = jax.grad(lambda p: jnp.mean((jnp.asarray(x) @ p) ** 2))(params)
        upd, state = multi.update(g, state, params)
        params = optax.apply_updates(params, upd)
        torch.mean((torch.from_numpy(x) @ w) ** 2).backward()
        assert opt.step() == (i % 2 == 1)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=1e-6)


@pytest.mark.parametrize("trainer", ["train_aa_mixer", "train_aa_effects",
                                     "train_aa_mixer_accel", "calc_effects_pca"])
def test_num_gpus_outside_a_group_says_how_to_launch(trainer, tmp_path, monkeypatch, capsys):
    import importlib

    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(f"audio_algebra_torch.{trainer}").main
    with pytest.raises(RuntimeError, match=f"torchrun --nproc_per_node 2 -m "
                                           f"audio_algebra_torch.{trainer}"):
        main(["--device", "cpu", "--training_dir", str(tmp_path), "--num_gpus", "2"])
    # a sharded state is train_clapdae's alone (as in JAX); these refuse the flag
    with pytest.raises(ValueError, match="only train_clapdae shards its state"):
        main(["--device", "cpu", "--training_dir", str(tmp_path), "--fsdp", "1"])
    assert "--fsdp 1" in capsys.readouterr().out


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]))
