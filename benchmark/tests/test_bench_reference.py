"""The plain reference against the measured program, both in f32 on the
CPU at tiny widths: the same inputs, noises and weights give the same
latents and audio (the program's kernels take their plain twins here)."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


def _f32(config):
    config["dtype"] = "float32"
    return config


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_destructo_reference_matches_the_program(seed):
    torch.set_num_threads(4)
    r = harness.run_cell(harness.load_spec(), "destructo_b16", seed, 0.5, False,
                         time.perf_counter(), device="cpu", config=_f32(tiny.dvae()),
                         mix=tiny.dvae_mix())
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["latents_rel_rms"]["value"] < 1e-5
    assert r["checks"]["audio_rel_rms"]["value"] < 1e-5


@pytest.mark.parametrize("clients", [1, 3])
def test_mirage_reference_matches_the_program(clients):
    """Through the service: the micro-batcher's shared generate, the
    crossfade and the WAV's 16-bit samples (their rounding, ~3e-5 of
    full scale, is the floor)."""
    torch.set_num_threads(4)
    c = _f32(tiny.mirage())
    c["inner"]["attentions"] = [1, 1]
    r = harness.run_cell(tiny.spec(), "mirage_serve_c4", 13, 0.5, False,
                         time.perf_counter(), device="cpu", config=c,
                         mix=tiny.mirage_mix(clients))
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["latents_rel_rms"]["value"] < 1e-5
    assert r["checks"]["audio_rel_rms"]["value"] < 1e-4
