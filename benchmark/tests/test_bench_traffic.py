"""The traffic generator and the seeded inputs are deterministic in the
run's seed."""
from __future__ import annotations

import threading

import torch

from benchmark.systems.common import make_audio, unit_embeddings
from benchmark.traffic import closed_loop
from benchmark.weights import draw, seed_of


class _Echo:
    """A system whose calls record the seeds they were given."""

    def __init__(self):
        self.lock = threading.Lock()

    def call(self, params, seed, client):
        return {"seed": seed, "client": client}


def _seeds(run_seed, clients=3, seconds=0.2):
    mix = {"generator": "closed_loop", "clients": clients, "request": {}}
    records, *_ = closed_loop.run(_Echo(), mix, run_seed, seconds)
    by_client = {}
    for r in records:
        by_client.setdefault(r.client, []).append((r.index, r.seed))
    return {c: sorted(v) for c, v in by_client.items()}


def test_each_client_gets_the_same_sequence_for_a_seed():
    a, b = _seeds(2 ** 31 + 17), _seeds(2 ** 31 + 17)
    assert sorted(a) == sorted(b) == [0, 1, 2]
    for c in a:
        n = min(len(a[c]), len(b[c]))
        assert n >= 1 and a[c][:n] == b[c][:n]
    other = _seeds(2 ** 31 + 18)
    assert a[0][0] != other[0][0]


def test_request_seeds_differ_across_clients_and_requests():
    seeds = [s for v in _seeds(7).values() for _, s in v]
    assert len(seeds) == len(set(seeds))


def test_inputs_and_weights_are_deterministic_in_the_seed():
    s = seed_of(2 ** 31 + 5, 3)
    assert torch.equal(make_audio(s, 2, 2, 4096, "cpu"), make_audio(s, 2, 2, 4096, "cpu"))
    assert not torch.equal(make_audio(s, 2, 2, 4096, "cpu"),
                           make_audio(s + 1, 2, 2, 4096, "cpu"))
    e = unit_embeddings(s, 3, 512, "cpu")
    assert torch.equal(e, unit_embeddings(s, 3, 512, "cpu"))
    assert torch.allclose(e.norm(dim=-1), torch.ones(3, 1))
    shapes = {"a.weight": (4, 3, 5), "a.bias": (4,), "n.weight": (4,)}
    w1, w2 = draw(shapes, s, "cpu", torch.bfloat16), draw(shapes, s, "cpu", torch.bfloat16)
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert torch.all(w1["a.bias"] == 0) and torch.all(w1["n.weight"] == 1)
    assert abs(float(w1["a.weight"].float().std()) - 15 ** -0.5) < 0.15


def test_audio_is_bounded_and_not_silent():
    a = make_audio(seed_of(9), 4, 2, 65536, "cpu")
    assert a.abs().max() < 1.0 and a.square().mean().sqrt() > 0.02
