"""The port's checkpoints: save -> latest_checkpoint -> load round trip of
parameters, EMA, Adam's state and the step; the step-numbered directories
the JAX package's latest_checkpoint parses; and a resumed `train_step`
equal to an uninterrupted one."""
import numpy as np
import pytest
import torch

from audio_algebra_tpu import checkpoint as jckpt
from audio_algebra_torch import checkpoint as tckpt
from audio_algebra_torch import train_clapdae as ttrain
from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
from audio_algebra_torch.utils.params import random_init_

LDM = dict(latent_dim=4, channels=8, multipliers=(1, 1), factors=(1,), num_blocks=(1,),
           attentions=(0, 1), attention_heads=2, attention_features=8, resnet_groups=4)


def _state(seed=0):
    model = random_init_(StackedAELatentDiffusionCond(**LDM), seed)
    return ttrain.make_state(model)


def _batch(seed, t_len=64):
    g = torch.Generator().manual_seed(seed)
    return (torch.tanh(torch.randn((2, 4, t_len), generator=g)),
            torch.randn((2, 1, 512), generator=g), torch.rand(2, generator=g),
            torch.randn((2, 4, t_len), generator=g), torch.tensor([True, False]))


def test_round_trip_of_a_train_state(tmp_path):
    state = _state()
    for i in range(2):
        ttrain.train_step(state, *_batch(i))
    path = tckpt.save_checkpoint(tmp_path / "ckpt", state.tree(), step=state.step)
    assert path.endswith("step_00000002")
    tckpt.save_checkpoint(tmp_path / "ckpt", {"step": 1}, step=1)
    assert tckpt.latest_checkpoint(tmp_path / "ckpt") == path
    assert jckpt.latest_checkpoint(str(tmp_path / "ckpt")) == path
    assert tckpt.latest_checkpoint(tmp_path / "nothing") is None
    tree = tckpt.load_checkpoint(path)
    assert tree["step"] == 2 and set(tree) == {"params", "ema_params", "opt_state", "step"}
    for name, p in state.model.named_parameters():
        assert torch.equal(tree["params"][name], p.detach())
        assert torch.equal(tree["ema_params"][name], state.ema_params[name])
    saved = tree["opt_state"]["state"]
    for i, s in state.opt.state_dict()["state"].items():
        assert torch.equal(saved[i]["exp_avg"], s["exp_avg"])
        assert torch.equal(saved[i]["exp_avg_sq"], s["exp_avg_sq"])
        assert float(saved[i]["step"]) == 2.0


def test_resumed_step_equals_an_uninterrupted_one(tmp_path):
    straight = _state()
    for i in range(3):
        ttrain.train_step(straight, *_batch(i))
    first = _state()
    for i in range(2):
        ttrain.train_step(first, *_batch(i))
    path = tckpt.save_checkpoint(tmp_path, first.tree(), step=first.step)
    resumed = _state(seed=9)                       # other weights, then the checkpoint's
    assert resumed.digest() != first.digest()
    resumed.load_tree(tckpt.load_checkpoint(path))
    assert resumed.step == 2 and resumed.digest() == first.digest()
    assert resumed.current_lr() == first.current_lr()
    loss = ttrain.train_step(resumed, *_batch(2))
    assert np.isfinite(float(loss))
    assert resumed.digest() == straight.digest()
    for (_, a), (_, b) in zip(resumed.model.named_parameters(),
                              straight.model.named_parameters()):
        assert torch.equal(a, b)


def test_save_without_a_step_and_a_missing_file(tmp_path):
    path = tckpt.save_checkpoint(tmp_path / "plain", {"w": torch.arange(3.0), "step": 7})
    assert tckpt.load_checkpoint(path)["w"].tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(OSError):
        tckpt.load_checkpoint(tmp_path / "absent")
