"""The PyTorch port stands alone: no file of audio_algebra_torch/, and not
chip_smoke.py, imports JAX, its libraries or the JAX package."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "audio_algebra_tpu"}
FILES = sorted((ROOT / "audio_algebra_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists()
    assert not imported_roots(path) & FORBIDDEN


def test_scan_catches_a_jax_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from audio_algebra_tpu.ops import resample\n"
                   "    import jax.numpy as jnp\n")
    assert imported_roots(bad) == {"audio_algebra_tpu", "jax"}
