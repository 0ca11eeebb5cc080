"""What the benchmark loads: no module under benchmark/ imports JAX, jaxlib,
flax or the JAX package (top-level names compared whole: the port's name
begins with the JAX package's), a run loads none of them, and the plain
reference imports nothing of the measured program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.harness import BENCH_DIR, FORBIDDEN, ROOT

MODULES = sorted(BENCH_DIR.rglob("*.py"))


def _imports(path: Path) -> set:
    """Top-level names of every module the file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in MODULES:
        assert not _imports(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert "audio_algebra_torch" not in _imports(path), path
        assert not _imports(path) & set(FORBIDDEN), path


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_and_a_whole_run_load_none_of_them():
    code = """
import importlib, json, sys, time
from pathlib import Path
import torch
for p in sorted(Path('benchmark').rglob('*.py')):
    if 'tests' not in p.parts and p.name != '__init__.py' and p.parent.name != 'metrics':
        importlib.import_module('.'.join(p.with_suffix('').parts))
from benchmark import harness
from benchmark.tests import tiny
spec = harness.load_spec()
for p in sorted(Path('benchmark/metrics').glob('[a-z]*.py')):
    harness.reader(p.stem)
harness.run_cell(spec, 'destructo_b16', 3, 0.3, True, time.perf_counter(), device='cpu',
                 config=tiny.dvae(), mix=tiny.dvae_mix())
harness.run_cell(tiny.spec(), 'mirage_single', 3, 0.3, True, time.perf_counter(),
                 device='cpu', config=tiny.mirage(), mix=tiny.mirage_mix(1))
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
    loaded = _loaded_after(code)
    assert "audio_algebra_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_alone_loads_no_program():
    code = """
import importlib, json, sys
from pathlib import Path
for p in sorted(Path('benchmark/reference').glob('*.py')):
    importlib.import_module('.'.join(p.with_suffix('').parts))
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
    loaded = _loaded_after(code)
    assert "audio_algebra_torch" not in loaded and not loaded & set(FORBIDDEN)


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "destructo_b16",
                          "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "memory_peak_bytes" not in out.stdout and '"metrics"' not in out.stdout


def test_without_the_program_a_run_fails(tmp_path):
    (tmp_path / "benchmark").mkdir()
    subprocess.run(["cp", "-r", str(BENCH_DIR), str(tmp_path)], check=True)
    subprocess.run(["cp", str(ROOT / "BENCHMARK.json"), str(tmp_path)], check=True)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "mirage_single",
                          "--seed", "5", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and '"metrics"' not in out.stdout
