"""The port's aa_toy against the JAX package's root aa_toy.py, on the CPU:
the frozen toy encoder within 1e-6; from JAX's own initial weights
(`train_toy(steps=0)`), five steps' loss history within 1e-4 rel (the
same numpy draws on both sides, optax.adam against torch's Adam); the
scientific check at the JAX test's own settings (1500 steps, seed 0: the
loss falls 20x and h beats the raw encoder's algebra error 1.5x); the
CLI's results file."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aa_toy as jtoy
from audio_algebra_torch import aa_toy as ttoy


def test_twist_and_scrunch_matches_jax():
    x = np.random.default_rng(0).uniform(-1.2, 1.2, (64, 2)).astype(np.float32)
    got = ttoy.twist_and_scrunch(torch.from_numpy(x)).numpy()
    want = np.asarray(jtoy.twist_and_scrunch(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ttoy.rand_vec_batch(np.random.default_rng(3), 5, 0.6),
                                  jtoy.rand_vec_batch(np.random.default_rng(3), 5, 0.6))


def test_five_steps_from_jax_init_track_jax():
    (_, params), _ = jtoy.train_toy(steps=0)
    _, want = jtoy.train_toy(steps=5, log_every=1)
    _, got = ttoy.train_toy(steps=5, log_every=1, init=params, device="cpu")
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(5))
    for g, w in zip(got, want):
        for key in ("loss", "mix_loss", "recon"):
            assert g[key] == pytest.approx(w[key], rel=1e-4), (g["step"], key)


def test_training_restores_the_algebra():
    """tests/test_toy_and_scripts.py::test_toy_training_restores_algebra's
    settings and bounds, on the port's own weights."""
    model, history = ttoy.train_toy(steps=1500, batch=256, log_every=500, seed=0,
                                    device="cpu")
    assert history[-1]["loss"] < history[0]["loss"] * 0.05
    err = ttoy.algebra_error(model)
    assert err["improvement"] > 1.5, err
    assert np.isfinite(ttoy.kmw_demo(model)["kmw_err"])


def test_main_writes_results(tmp_path):
    out = ttoy.main(["--steps", "3", "--out-dir", str(tmp_path), "--device", "cpu"])
    saved = json.loads((tmp_path / "results.json").read_text())
    assert set(saved) == {"history", "raw_err", "z_err", "improvement", "kmw_err"}
    assert saved["improvement"] == pytest.approx(out["improvement"])
    assert [r["step"] for r in saved["history"]] == [0, 2]


def test_main_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttoy.main(["--steps", "1", "--out-dir", str(tmp_path)])


def test_profile_three_call_loss_is_toy_loss():
    """profile_apps times toy_loss against JAX's three-call form: both
    compute the same loss and gradients (1e-6 rel)."""
    from audio_algebra_torch.profile_apps import toy_loss_three
    from audio_algebra_torch.utils.params import random_init_

    model = random_init_(ttoy.ToyAA(hidden=16), 3)
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(ttoy.rand_vec_batch(rng, 32, 0.6)) for _ in range(2))
    grads = []
    for fn in (ttoy.toy_loss, toy_loss_three):
        model.zero_grad()
        loss, _ = fn(model, a, b, 0.7, 0.9)
        loss.backward()
        grads.append((float(loss), [p.grad.clone() for p in model.parameters()]))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    for g1, g2 in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-6 * float(g2.abs().max()))
