"""Build and load the hand-written CUDA kernels of the port.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/`` beside
this file (listed in ``.gitignore``) and loaded with :mod:`ctypes`. A library
is rebuilt when its source is newer.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load", "nvcc_path"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "build"

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>.so`` unless the
    library is newer than its source. Returns the library's path."""
    src, lib = _CSRC / f"{name}.cu", _BUILD / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    out = subprocess.run([nvcc_path(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {out.returncode}):\n{out.stdout}{out.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if stale."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
