"""Build and load the hand-written CUDA kernels of the port.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/`` beside
this file (listed in ``.gitignore``) and loaded with :mod:`ctypes`. A library
is rebuilt when its source is newer.

A build target is a source's name, or ``(name, defines)`` for a source whose
sizes are compile-time constants: ``defines`` is a tuple of ``(macro, int)``
pairs passed as ``-D`` flags, and the library's file name carries them
(``libphysics_fused_nq9_nb7_....so``), so one source builds one library per
model signature.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "default_targets", "load", "nvcc_path"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "build"

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[Path, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # library file name -> what its compiler printed


def _resolve(target) -> tuple[Path, Path, list[str]]:
    """(source, library, -D flags) of a build target."""
    name, defines = (target, ()) if isinstance(target, str) else target
    suffix = "".join(f"_{macro.lower()}{int(value)}" for macro, value in defines)
    flags = [f"-D{macro}={int(value)}" for macro, value in defines]
    return _CSRC / f"{name}.cu", _BUILD / f"lib{name}{suffix}.so", flags


def default_targets() -> list:
    """Every kernel the port can launch: each size-free ``csrc/*.cu`` and the
    fused physics step once per signature of the packaged MuJoCo models."""
    from tianshou_tpu_torch.ops.kernels import physics_fused

    sized = {"physics_fused"}
    return [*sorted(src.stem for src in _CSRC.glob("*.cu") if src.stem not in sized), *physics_fused.task_targets()]


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


def build(*targets) -> list[Path]:
    """Compile each target (:func:`default_targets` when none is given) into
    its library under ``build/`` unless the library is newer than its source:
    one ``nvcc`` per stale target, all started together. Returns the
    libraries' paths in the order of ``targets``."""
    resolved = [_resolve(t) for t in (targets or default_targets())]
    running = []
    for src, lib, flags in resolved:
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc_path(), *_NVCC_FLAGS, *flags, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:  # wait for every compiler before raising
        out, _ = proc.communicate()
        build_logs[lib.name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {src.name} -> {lib.name} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return [lib for _, lib, _ in resolved]


def load(target) -> ctypes.CDLL:
    """The loaded library of ``target``, built first if stale."""
    lib = _resolve(target)[1]
    if lib not in _loaded:
        _loaded[lib] = ctypes.CDLL(str(build(target)[0]))
    return _loaded[lib]
