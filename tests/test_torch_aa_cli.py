"""The port's two algebra trainers end to end on the CPU, in process, at the
tiny DVAE of tests/test_train_cli.py: `train_aa_mixer.main` and
`train_aa_effects.main` read WAVs, train, log, demo, checkpoint and print
`training done.`; a second `main` resumes at the saved step with the
model's and Adam's bits as saved and the learning rate on the one-cycle
closed form; a trainer asked for the card where there is none raises."""
import json

import numpy as np
import pytest
import torch

from audio_algebra_torch import train_aa_effects, train_aa_mixer
from audio_algebra_torch.train_clapdae import onecycle_lr
from audio_algebra_torch.utils.audio_io import read_wav, write_wav

SR, FILES, SAMPLES = 48000, 8, 2048
MAINS = {"mixer": train_aa_mixer.main, "effects": train_aa_effects.main}


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    (tmp_path / "wavs").mkdir()
    for i in range(FILES):
        t = np.arange(4096) / SR
        x = 0.4 * np.sin(2 * np.pi * (200 + 100 * i) * t) + 0.05 * rng.standard_normal(4096)
        write_wav(str(tmp_path / "wavs" / f"c{i}.wav"), np.stack([x, x]).astype(np.float32), SR)
    (tmp_path / "tiny.json").write_text(json.dumps(
        {"capacity": 4, "c_mults": [2, 4], "strides": [4, 2], "n_attn_layers": 0,
         "diffusion_c_mults": [8, 16]}))
    monkeypatch.chdir(tmp_path)            # the runs/ directory is made beside the cwd
    return tmp_path


def _argv(root, *extra):
    return ["--training_dir", str(root / "wavs"), "--batch_size", "2", "--num_gpus", "1",
            "--num_workers", "0", "--sample_size", str(SAMPLES), "--latent_dim", "8",
            "--hidden_dims", "16", "--model_config", str(root / "tiny.json"),
            "--load_frac", "1.0", "--max_epochs", "1", "--demo_every", "3",
            "--demo_steps", "2", "--checkpoint_every", "2", "--seed", "1", "--name", "t",
            "--device", "cpu", *extra]


@pytest.mark.parametrize("task", ["mixer", "effects"])
def test_trainer_runs_checkpoints_and_resumes(run_dir, task, capsys):
    main = MAINS[task]
    run = main(_argv(run_dir))
    assert "training done." in capsys.readouterr().out
    assert (run["start_step"], run["end_step"], run["total_updates"]) == (0, 4, 4)
    for r in run["records"]:
        assert np.isfinite(r["train_loss"]) and r["updated"]
        assert r["lr"] == onecycle_lr(r["step"], 4, 1e-3)
        assert r["train_loss"] == pytest.approx(
            r["mix_loss"] + r["var_loss"] + r["cov_loss"] + r["aa_recon_loss"], rel=1e-5)
    assert run["end_digest"]["params"] != run["start_digest"]["params"]
    assert run["end_digest"]["updates"] == 4
    assert run["ckpt"].endswith("step_00000004")
    run_path = run_dir / run["run_dir"]
    # checkpoint_every 2: after step 2, i.e. with 3 steps taken
    assert (run_path / "ckpt" / "step_00000003").is_dir()
    log = [json.loads(line) for line in open(run_path / "log.jsonl")]
    assert log[0]["step"] == 0 and "train_loss" in log[0] and "learning_rate" in log[0]
    demo = {k: v for rec in log for k, v in rec.items() if k.startswith("demo/")}
    wavs = [v for v in demo.values() if str(v).endswith(".wav")]
    assert len(wavs) == 2 and all(open(w, "rb").read(4) == b"RIFF" for w in wavs)
    for w in wavs:
        audio, sr = read_wav(w)
        assert audio.shape == (2, SAMPLES) and sr == SR and np.isfinite(audio).all()
    assert all((run_dir / str(v)).is_file() for v in demo.values())
    assert len(run["demo_s"]) == 1 and run["demo_s"][0] > 0 and run["demo_errors"] == []
    if task == "effects":
        assert {"demo/emb_stats", "demo/pca_cloud", "demo/za2_guess", "demo/za2"} <= set(demo)
    else:
        assert {"demo/zsum", "demo/zmix"} <= set(demo)

    # the same flags again: the schedule of 4 updates, resumed past its end,
    # where it stays at its final rate, for another epoch of 4 batches
    again = main(_argv(run_dir, "--ckpt_path", f"{run['run_dir']}/ckpt", "--demo_every",
                       "0", "--name", "t2"))
    assert "Resumed from" in capsys.readouterr().out
    assert again["start_digest"] == run["end_digest"]
    assert (again["start_step"], again["end_step"]) == (4, 8)
    assert [r["step"] for r in again["records"]] == [4, 5, 6, 7]
    for r in again["records"]:
        assert r["lr"] == onecycle_lr(r["step"], 4, 1e-3) == pytest.approx(4e-9)
    assert again["end_digest"]["updates"] == 8 and again["demo_s"] == []


def test_resume_takes_params_only_from_a_checkpoint_without_opt_state(run_dir, capsys):
    run = train_aa_mixer.main(_argv(run_dir))
    ck = run["ckpt"] + "/state.pt"
    tree = torch.load(ck, weights_only=True)
    torch.save({"params": tree["params"], "step": tree["step"]}, ck)
    again = train_aa_mixer.main(_argv(run_dir, "--ckpt_path", run["ckpt"], "--name", "t2"))
    assert "params only" in capsys.readouterr().out
    assert again["start_digest"]["params"] == run["end_digest"]["params"]
    assert again["start_digest"]["updates"] == 0 and again["start_step"] == 4


@pytest.mark.parametrize("task", ["mixer", "effects"])
def test_trainer_asked_for_the_card_without_one_raises(run_dir, task, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(run_dir) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MAINS[task](argv)
    assert not (run_dir / "runs").exists()
