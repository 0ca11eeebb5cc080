"""Build and load the port's CUDA kernels.

Each source under `audio_algebra_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface, at first use,
into `audio_algebra_torch/_build/` (listed in .gitignore), and loaded with
ctypes. The library's file name carries a hash of its source and of the
shared headers (`csrc/*.cuh`), so an edited source is rebuilt. Nothing is
built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _lib_path(source: str) -> Path:
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def _start(source: str):
    """Start nvcc for `source` unless its library exists; return
    (library path, process or None, temporary path)."""
    out = _lib_path(source)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def build(sources: list[str]) -> dict[str, str]:
    """Compile every source that has no library yet, all nvcc processes
    started together. Returns {source: compiler output} for the ones
    built; raises with the compiler's output if one fails."""
    started = [(s, *_start(s)) for s in sources]
    logs = {}
    for source, out, proc, tmp in started:
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, out)        # atomic: concurrent builders agree
        logs[source] = log
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(_lib_path(source)))
        _LIBS[source] = lib
    return lib
