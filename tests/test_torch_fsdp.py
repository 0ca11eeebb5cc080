"""The port's sharded train state (audio_algebra_torch/parallel/fsdp.py,
FSDP2) against one process and the JAX package's placement rule, on the
CPU: one pair of `gloo` workers (this file run as a script, `python
tests/test_torch_fsdp.py RANK DIR PORT`, torch only) runs every two-rank
case once; the tests compare what they wrote.

  * train_clapdae.make_train_step on the tiny LDM of
    test_torch_train_clapdae, its state sharded by shard_state, for two
    steps on each rank's rows, against one process on the global batch:
    under SGD (the update is the gradient: a wrongly scaled reduce-scatter
    shows) the parameters and the EMA copies (each tensor within 1e-5 of
    its largest entry, the update within 1e-4 rel-RMS: test_torch_parallel's
    tolerances), under Adam its m and v to the same and the parameters to
    1 % of one Adam step; the losses within 1e-5;
  * the placement against JAX's `_leaf_spec` on the model's leaf shapes,
    and state_bytes_per_device against the shards each rank holds;
  * train_clapdae.main --num_gpus 2 --fsdp 1 at a tiny config: the ranks
    end with the same bits, rank 0 alone writes the checkpoint (whole
    tensors), and one process resuming from it starts from the saved bits.
Each worker has WORKER_TIMEOUT_S.
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

LDM = dict(latent_dim=4, channels=16, multipliers=(1, 1), factors=(1,), num_blocks=(1,),
           attentions=(0, 1), attention_heads=2, attention_features=16, resnet_groups=4)
T_LEN = 512
B = 4                          # the global batch: 2 ranks x 2 rows
SGD_LR, ADAM_LR = 1.0, 1e-3
STEPS = 2
WORKER_TIMEOUT_S = 150
UPDATED_REL, UPDATE_REL_RMS = 1e-5, 1e-4
ADAM_STEP_ATOL = 1e-2 * ADAM_LR    # 1 % of one Adam step


def _batch(step: int):
    """(latents, emb, t, noise, keep) of a global batch, one row's
    embedding dropped."""
    rng = np.random.default_rng(21 + step)
    emb = rng.standard_normal((B, 1, 512)).astype(np.float32)
    return (np.tanh(rng.standard_normal((B, 4, T_LEN))).astype(np.float32),
            emb / np.linalg.norm(emb, axis=-1, keepdims=True),
            rng.random(B).astype(np.float32),
            rng.standard_normal((B, 4, T_LEN)).astype(np.float32),
            (np.arange(B) != 1)[:, None, None])


def run_steps(tmp, world, opt_name: str, shard: bool) -> dict:
    """Two make_train_step steps of the tiny LDM from the saved weights on
    this rank's rows; the state's whole tensors after, and the losses."""
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
    from audio_algebra_torch.parallel.fsdp import shard_state
    from audio_algebra_torch.train_clapdae import TrainState, make_state, make_train_step

    model = StackedAELatentDiffusionCond(**LDM)
    model.load_state_dict(torch.load(Path(tmp) / "ldm.pt"))
    if opt_name == "sgd":
        params = dict(model.named_parameters())
        state = TrainState(model=model,
                           ema_params={k: v.detach().clone() for k, v in params.items()},
                           opt=torch.optim.SGD(params.values(), lr=SGD_LR), lr=SGD_LR)
    else:
        state = make_state(model, lr=ADAM_LR)
    if shard:
        shard_state(state, world)
    step = make_train_step(state, world)
    rows = world.rows(B)
    losses = [float(step(*(torch.from_numpy(a[rows]) for a in _batch(i))))
              for i in range(STEPS)]
    tree = state.tree()
    out = {f"params/{k}": v.numpy().copy() for k, v in tree["params"].items()}
    out.update({f"ema/{k}": v.numpy().copy() for k, v in tree["ema_params"].items()})
    for i, entry in tree["opt_state"]["state"].items():
        out.update({f"opt/{i}/{k}": v.numpy().copy() for k, v in entry.items()
                    if torch.is_tensor(v) and v.dim()})
    out["losses"] = np.asarray(losses)
    return out


def _trainer_argv(tmp, *extra):
    return ["--device", "cpu", "--training_dir", str(Path(tmp) / "wavs"), "--batch_size", "4",
            "--num_workers", "0", "--max_epochs", "1", "--load_frac", "1.0",
            "--sample_size", "16384", "--name", "fsdp", "--model_config",
            str(Path(tmp) / "clapdae.json"), *extra]


def worker(rank: int, tmp: str, port: int) -> None:
    import torch.distributed as dist
    from audio_algebra_torch import train_clapdae
    from audio_algebra_torch.parallel.fsdp import shard_state, state_bytes_per_device
    from audio_algebra_torch.parallel.mesh import make_mesh
    from audio_algebra_torch.parallel.multihost import initialize_distributed
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
    from audio_algebra_torch.train_clapdae import make_state

    torch.set_num_threads(2)
    os.chdir(tmp)
    assert initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        world = make_mesh(device="cpu")
        out = {}
        for opt_name in ("sgd", "adam"):
            out.update({f"{opt_name}/{k}": v for k, v in
                        run_steps(tmp, world, opt_name, shard=True).items()})
        state = make_state(StackedAELatentDiffusionCond(**LDM))
        shard_state(state, world)
        local = sum(p.to_local().numel() * p.element_size()
                    for p in state.model.parameters())
        info = {"local_param_bytes": local,
                "state_bytes_per_device": state_bytes_per_device(state.model, world),
                "placements": {k: p.placements[0].dim
                               for k, p in state.model.named_parameters()}}
        run = train_clapdae.main(_trainer_argv(tmp, "--num_gpus", "2", "--fsdp", "1"))
        info["trainer"] = {"world": [run["world"].size, run["world"].rank],
                           "sharded": run["state"].sharded, "ckpt": run["ckpt"],
                           "start_digest": run["start_digest"],
                           "end_digest": run["end_digest"], "end_step": run["end_step"],
                           "losses": [r["train_loss"] for r in run["records"]]}
    finally:
        dist.destroy_process_group()
    np.savez(Path(tmp) / f"fsdp_{rank}.npz", **out)
    (Path(tmp) / f"fsdp_{rank}.json").write_text(json.dumps(info))


# --------------------------------------------------------------- parent ---

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_inputs(tmp: Path) -> None:
    from audio_algebra_tpu.models import clap as jclap
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
    from audio_algebra_torch.utils.audio_io import write_wav
    from audio_algebra_torch.utils.params import random_init_
    from test_torch_train_clapdae import FIRST_STAGE, MODEL_KWARGS

    torch.save(random_init_(StackedAELatentDiffusionCond(**LDM), 3).state_dict(),
               tmp / "ldm.pt")
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


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Run the two workers once and the same steps in this process; returns
    (ranks' arrays, infos, one process's arrays, tmp)."""
    from audio_algebra_torch.parallel.mesh import World

    tmp = tmp_path_factory.mktemp("fsdp")
    _write_inputs(tmp)
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
        one_world = World(1, 0, torch.device("cpu"))
        one = {opt: run_steps(tmp, one_world, opt, shard=False) for opt in ("sgd", "adam")}
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    ranks = [dict(np.load(tmp / f"fsdp_{r}.npz")) for r in range(2)]
    infos = [json.loads((tmp / f"fsdp_{r}.json").read_text()) for r in range(2)]
    return {"ranks": ranks, "infos": infos, "one": one, "tmp": tmp}


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_sharded_step_is_the_global_batch_step(pair, opt):
    """2 ranks with the state sharded = one process on the whole batch,
    after two steps. SGD: parameters and EMA within UPDATED_REL of each
    tensor's largest entry and the update (the gradient itself) within
    UPDATE_REL_RMS. Adam: m and v (linear and quadratic in the gradients)
    the same; the parameters and EMA within ADAM_STEP_ATOL, since Adam's
    m / sqrt(v) lifts a gradient's rounding to the scale of the step lr
    wherever the gradient is near zero."""
    start = {k: v.numpy() for k, v in torch.load(pair["tmp"] / "ldm.pt").items()}
    got = {k.split("/", 1)[1]: v for k, v in pair["ranks"][0].items()
           if k.startswith(opt + "/")}
    want = pair["one"][opt]
    assert set(got) == set(want)
    np.testing.assert_allclose(got.pop("losses"), want["losses"], rtol=1e-5)
    for k, w in want.items():
        if k == "losses":
            continue
        err = float(np.abs(got[k] - w).max())
        name = k.split("/", 1)[1]
        if opt == "adam" and k.startswith(("params/", "ema/")):
            assert err <= ADAM_STEP_ATOL, (k, err)
            continue
        assert err <= UPDATED_REL * max(float(np.abs(w).max()), 1e-30), (k, err)
        if k.startswith(("params/", "ema/")) and name in start:
            assert _rel_rms(got[k] - start[name], w - start[name]) < UPDATE_REL_RMS, k
    moved = max(float(np.abs(want[f"params/{k}"] - v).max()) for k, v in start.items())
    assert moved > 0


def test_ranks_gather_the_same_state(pair):
    a, b = pair["ranks"]
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_placement_is_jax_leaf_spec():
    """leaf_spec is JAX's `_leaf_spec` on every leaf shape of the LDM and the
    full songs UNet's (n = 2, 4, 8, min_size 2^14), and the port's placement
    is JAX's dimension wherever JAX shards a leaf."""
    from audio_algebra_tpu.parallel.fsdp import _leaf_spec
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
    from audio_algebra_torch.parallel.fsdp import MIN_SIZE, leaf_spec, placement_dim

    with torch.device("meta"):
        shapes = {tuple(p.shape) for m in (StackedAELatentDiffusionCond(**LDM),
                                           StackedAELatentDiffusionCond())
                  for p in m.parameters()}
    shapes |= {(), (7,), (3, 5), (16384,), (16383,), (8, 2048)}
    for n in (2, 4, 8):
        for shape in shapes:
            spec = tuple(_leaf_spec(shape, n, "data", MIN_SIZE))
            want = spec.index("data") if "data" in spec else None
            assert leaf_spec(shape, n) == want, (shape, n)
            if want is not None:
                assert placement_dim(shape, n) == want


def test_state_bytes_are_the_shards_held(pair):
    """state_bytes_per_device is the bytes of rank 0's shards (the largest:
    uneven dims give the first ranks the ceiling); the two ranks hold every
    byte once, the padding aside."""
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
    from audio_algebra_torch.parallel.fsdp import fsdp_sharding
    from audio_algebra_torch.parallel.mesh import World

    r0, r1 = pair["infos"]
    assert r0["state_bytes_per_device"] == r0["local_param_bytes"]
    total = sum(p.numel() * 4 for p in StackedAELatentDiffusionCond(**LDM).parameters())
    assert r0["local_param_bytes"] + r1["local_param_bytes"] == total
    assert r0["placements"] == r1["placements"]
    assert r0["placements"] == fsdp_sharding(StackedAELatentDiffusionCond(**LDM),
                                             World(2, 0, torch.device("cpu")))
    assert any(v != 0 for v in r0["placements"].values())


def test_fsdp_trainer_ranks_agree_and_resume_into_one_process(pair, monkeypatch):
    """train_clapdae.main --num_gpus 2 --fsdp 1: both ranks sharded, the same
    bits at the end, rank 0 alone writes the checkpoint; one process resumes
    from it with the saved bits."""
    from audio_algebra_torch import train_clapdae

    t0, t1 = (i["trainer"] for i in pair["infos"])
    assert t0["world"] == [2, 0] and t1["world"] == [2, 1] and t0["sharded"] and t1["sharded"]
    assert t0["end_digest"] == t1["end_digest"] != t0["start_digest"]
    assert t0["end_step"] == t1["end_step"] == 2       # 8 files, global batch 4, 1 epoch
    assert np.isfinite(t0["losses"]).all()
    assert t0["ckpt"] is not None and Path(t0["ckpt"]).exists() and t1["ckpt"] is None
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(pair["tmp"])
    run = train_clapdae.main(_trainer_argv(pair["tmp"], "--num_gpus", "1", "--fsdp", "1",
                                           "--max_epochs", "0", "--name", "resumed",
                                           "--ckpt_path", str(Path(t0["ckpt"]).parent)))
    assert not run["state"].sharded and run["start_step"] == 2
    assert run["start_digest"] == t0["end_digest"]


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]))
