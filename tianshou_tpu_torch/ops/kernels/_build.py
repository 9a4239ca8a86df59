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


def build(*names: str) -> list[Path]:
    """Compile each ``csrc/<name>.cu`` (all of them when no name is given)
    into ``build/lib<name>.so`` unless the library is newer than its source:
    one ``nvcc`` per stale source, all started together. Returns the
    libraries' paths in the order of ``names``."""
    names = names or tuple(sorted(src.stem for src in _CSRC.glob("*.cu")))
    libs = [_BUILD / f"lib{name}.so" for name in names]
    running = []
    for name, lib in zip(names, libs):
        src = _CSRC / f"{name}.cu"
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc_path(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in running:  # wait for every compiler before raising
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if stale."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)[0]))
    return _loaded[name]
