"""The check fails a broken timed path. Each test skips the harness's look
for a card and drives the rest of a run on the CPU at tiny widths in f32
(where a sound run reads ~1e-6 against the reference), with the program
broken where it produces its answer, and sees `correct` come out false
under the cells' own limits; the unbroken run beside it is correct."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


def _dvae_run(seed=21):
    c = tiny.dvae()
    c["dtype"] = "float32"
    return harness.run_cell(harness.load_spec(), "destructo_b16", seed, 0.3, False,
                            time.perf_counter(), device="cpu", config=c, mix=tiny.dvae_mix())


def _mirage_run(clients, seed=21):
    c = tiny.mirage()
    c["dtype"] = "float32"
    return harness.run_cell(tiny.spec(), "mirage_serve_c4", seed, 0.3, False,
                            time.perf_counter(), device="cpu", config=c,
                            mix=tiny.mirage_mix(clients))


def test_sound_runs_are_correct():
    torch.set_num_threads(4)
    assert _dvae_run()["correct"] and _mirage_run(2)["correct"]


@pytest.mark.parametrize("where", ["decode", "encode"])
def test_destructo_answer_altered(monkeypatch, where):
    from audio_algebra_torch.given_models import DVAEWrapper
    inner = getattr(DVAEWrapper, where)
    factor = -1.0 if where == "decode" else 1.5

    def broken(self, *a, **kw):
        return inner(self, *a, **kw) * factor
    monkeypatch.setattr(DVAEWrapper, where, broken)
    assert not _dvae_run()["correct"]


def test_mirage_audio_altered(monkeypatch):
    from audio_algebra_torch.given_models import CLAPDAE
    inner = CLAPDAE.generate

    def broken(self, *a, **kw):
        fakes, lat = inner(self, *a, **kw)
        return -fakes, lat
    monkeypatch.setattr(CLAPDAE, "generate", broken)
    assert not _mirage_run(1)["correct"]


def test_mirage_answers_crossed(monkeypatch):
    """A shared generate hands each client another client's audio."""
    from audio_algebra_torch.given_models import CLAPDAE
    inner = CLAPDAE.generate

    def broken(self, *a, **kw):
        fakes, lat = inner(self, *a, **kw)
        return fakes.roll(1, dims=0), lat.roll(1, dims=0)
    monkeypatch.setattr(CLAPDAE, "generate", broken)
    r = _mirage_run(3)
    assert not r["correct"]


def test_a_failed_request_is_not_correct(monkeypatch):
    """Every job of the window raises (the set-up's warm-up call passes)."""
    from audio_algebra_torch.given_models import DVAEWrapper
    inner, calls = DVAEWrapper.decode, []

    def broken(self, *a, **kw):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("the card refused")
        return inner(self, *a, **kw)
    monkeypatch.setattr(DVAEWrapper, "decode", broken)
    r = _dvae_run()
    assert not r["correct"] and r["failed"] == r["attempted"] > 0
