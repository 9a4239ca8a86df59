"""Replay row gather: ``out[b] = src[clamp(idx[b], 0, N-1)]``.

Replaces the TPU kernel ``tianshou_tpu/ops/pallas/gather.py:gather_rows``
(a ring of HBM->HBM row DMAs) with the CUDA C++ kernel in
``csrc/gather.cu``. Where the row width and both base pointers are 16-byte
aligned, a row is spread over the grid and every thread starts all its
16-byte loads before its first store, so that every byte of the launch is
asked for in one trip to device memory after the index. Anything else is
copied byte by byte. It is a pure copy, bit-identical to indexing for every dtype, and takes rows of
any width in bytes (the frame rows of the replay ring are 7056 B).

The kernel is bound by bytes: it moves ``2 * rows * row_bytes``. At the main
path's shape (128 rows of 7056 B) that is 0.54 us at an H100's 3.35 TB/s, so
the launch and the two dependent trips (index, row) dominate; measured times
beside those of an empty launch are in ``PERF.md``.

:func:`gather_rows` launches the kernel for a CUDA tensor and takes the
plain version, :func:`gather_rows_reference`, only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from tianshou_tpu_torch.ops.kernels import counters

__all__ = ["gather_rows", "gather_rows_reference", "launch_count", "reset_launch_count"]

_fn = None  # the loaded C entry point
_noop = None  # and the empty kernel's


def launch_count() -> int:
    """Number of kernel launches since the last :func:`reset_launch_count`."""
    return counters.get("gather_rows")


def reset_launch_count() -> None:
    counters.reset("gather_rows")


def gather_rows_reference(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``src[idx]`` with indices clamped to
    ``[0, N-1]``, as the reference's ``src[idx]`` clamps."""
    return src[idx.clamp(0, src.shape[0] - 1)]


def _check(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() != 2:
        raise ValueError(f"gather_rows takes a 2-D src [N, F], got shape {tuple(src.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"gather_rows takes a 1-D idx [B], got shape {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_rows takes int32 or int64 indices, got {idx.dtype}")
    if src.device != idx.device:
        raise ValueError(f"src on {src.device} but idx on {idx.device}")
    if src.shape[0] == 0:
        raise ValueError("gather_rows needs a non-empty src")


def _kernel():
    global _fn, _noop
    if _fn is None:
        from tianshou_tpu_torch.ops.kernels._build import load

        lib = load("gather")
        fn = lib.tt_gather_rows
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.tt_gather_noop.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.tt_gather_noop.restype = ctypes.c_int
        _fn, _noop = fn, lib.tt_gather_noop
    return _fn


def launch_noop(blocks: int, threads: int, device="cuda") -> None:
    """Launch an empty kernel of that shape on the current stream: the yardstick for what a launch
    costs with nothing to copy. Not counted by :func:`launch_count`."""
    _kernel()
    device = torch.device(device)
    with torch.cuda.device(device):
        err = _noop(blocks, threads, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` for a 2-D ``src [N, F]`` of any dtype and a 1-D int32 or
    int64 ``idx [B]``; indices are clamped to ``[0, N-1]``. Returns ``[B, F]``.

    On a CUDA tensor this launches the hand-written kernel on the current
    stream or raises; it never falls back to indexing. On a CPU tensor it
    runs :func:`gather_rows_reference`.
    """
    _check(src, idx)
    if src.device.type == "cpu":
        return gather_rows_reference(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, got {src.device}")
    if not src.is_contiguous() or not idx.is_contiguous():
        raise ValueError("gather_rows needs contiguous src and idx")
    fn = _kernel()
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype, device=src.device)
    if idx.shape[0] == 0 or src.shape[1] == 0:
        return out
    row_bytes = src.shape[1] * src.element_size()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(
            src.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), out.data_ptr(),
            src.shape[0], row_bytes, idx.shape[0], stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {err}")
    counters.add("gather_rows")
    return out
