"""Tiny configurations of the benchmark's systems, for CPU tests: the same
files' keys at widths and lengths a test process holds."""
from __future__ import annotations

import copy
import json

from benchmark.harness import BENCH_DIR, load_spec

MIRAGE_CELLS = [
    {"name": "mirage_serve_c4", "config": "mirage_22s", "traffic": "mirage_clients4", "chips": 1},
    {"name": "mirage_single", "config": "mirage_22s", "traffic": "mirage_client1", "chips": 1}]


def spec() -> dict:
    """BENCHMARK.json with the MIRAGE cells that PERF.md keeps for later
    (their configuration and mixes are files of the benchmark)."""
    s = load_spec()
    s["configs"] = s["configs"] + [{"name": "mirage_22s",
                                    "file": "benchmark/configs/mirage_22s.json"}]
    s["workloads"] = s["workloads"] + MIRAGE_CELLS
    return s


def load(name: str) -> dict:
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def mix(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def dvae() -> dict:
    c = copy.deepcopy(load("dvae_destructo"))
    c.update(demo_steps=3, sample_size=512, latent_dim=8, capacity=4, c_mults=[1, 2],
             strides=[2, 2], n_attn_layers=1, diffusion_c_mults=[16, 16, 32])
    c["check"]["rows"] = 2
    c["check"]["block"] = "stack_000.m2"
    return c


def dvae_mix() -> dict:
    m = copy.deepcopy(mix("destructo_jobs_b16"))
    m["request"].update(chunks=3, steps=3)
    return m


def mirage() -> dict:
    c = copy.deepcopy(load("mirage_22s"))
    c.update(sample_size=1024, decode_batch=2,
             first_stage={"capacity": 4, "c_mults": [1, 2], "strides": [2, 2], "latent_dim": 4},
             latent_factors=[2], latent_channels=8, latent_multipliers=[1, 2],
             latent_num_blocks=[1], outer={"c_mults": [16, 16], "depth": 2})
    c["inner"].update(channels=8, multipliers=[1, 2], factors=[2], num_blocks=[1],
                      attentions=[0, 1], attention_heads=2, attention_features=4,
                      attention_multiplier=2, attention_rel_pos_max_distance=16,
                      attention_rel_pos_num_buckets=8, resnet_groups=2)
    c["service"]["batch_window_s"] = 0.2
    return c


def mirage_mix(clients: int) -> dict:
    m = copy.deepcopy(mix("mirage_clients4" if clients > 1 else "mirage_client1"))
    m["clients"] = clients
    m["request"].update(steps=3, outer_steps=2)
    return m
