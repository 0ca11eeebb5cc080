"""BENCHMARK.json against its contract: names, units, keys, and every cell
resolving to its configuration, traffic mix, system and metric readers."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark.harness import BENCH_DIR, ROOT, load_spec, metrics_of, reader, resolve

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SPEC = load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_keys_are_the_contracts():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_texts():
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names)), kind
    for e in named:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert not c["reduced"] or all(NAME.match(k) for k in c["reduced"])
        assert PATH.match(c["file"])
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
    for p in SPEC["paths"]:
        assert PATH.match(p) and (ROOT / p).is_dir()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w, config, mix = resolve(SPEC, cell)
    importlib.import_module(f"benchmark.systems.{config['system']}")
    importlib.import_module(f"benchmark.traffic.{mix['generator']}")
    e2e = metrics_of(SPEC, cell, "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = metrics_of(SPEC, cell, "per_layer")
    assert layer
    for m in e2e + layer:
        if m["name"] != "setup_s":
            assert callable(reader(m["name"]))
    for m in layer:
        assert m["moves"] in names


def test_per_layer_moves_a_reported_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in target or cell in target["workloads"]


def test_configs_and_mixes_are_files_of_their_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
