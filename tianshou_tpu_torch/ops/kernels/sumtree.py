"""Sum-tree prefix-sum descent: for each value the largest leaf ``i`` with
``prefix_sum(i) <= value``, the sampler of prioritized replay.

Replaces the TPU kernel ``tianshou_tpu/ops/pallas/sumtree.py:pallas_prefix_sum_idx``
(a masked reduction over the whole VMEM-resident tree per level, for
``bound <= 16384``) with the CUDA C++ kernel in ``csrc/sumtree.cu``: one
thread per query walks the tree from the root, loading ``tree[2 * idx]`` at
each of ``depth`` levels. It takes a tree of any ``bound`` and returns int64
indices, as the port's buffers use.

The kernel moves a few KB (4 B per value, 8 B per result, 4 B per tree node
touched), so neither bytes nor operations bound it: the launch and the chain
of ``depth`` dependent loads do. Measured times are in ``PERF.md``.

:func:`prefix_sum_idx` launches the kernel for a CUDA tree and takes the
plain version, :func:`prefix_sum_idx_reference`, only for a CPU tree.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["launch_count", "prefix_sum_idx", "prefix_sum_idx_reference", "reset_launch_count"]

_launches = 0
_fn = None  # the loaded C entry point


def launch_count() -> int:
    """Number of kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def prefix_sum_idx_reference(tree: torch.Tensor, values: torch.Tensor, bound: int, depth: int,
                             size: int) -> torch.Tensor:
    """The plain PyTorch version: the level loop of the descent. At each level
    go right where ``tree[2 * idx] < value`` (strict), subtracting the left
    sum; returns ``min(idx - bound, size - 1)`` as int64."""
    values = values.to(torch.float32)
    idx = torch.ones(values.shape, dtype=torch.int64, device=values.device)
    for _ in range(depth):
        left = tree[2 * idx]
        go_right = left < values
        values = torch.where(go_right, values - left, values)
        idx = 2 * idx + go_right.to(torch.int64)
    return torch.clamp(idx - bound, max=size - 1)


def _check(tree: torch.Tensor, values: torch.Tensor, bound: int, depth: int, size: int) -> None:
    if depth < 0 or bound != 1 << depth:
        raise ValueError(f"bound must be 2**depth, got bound {bound} and depth {depth}")
    if not 1 <= size <= bound:
        raise ValueError(f"size must lie in [1, bound], got size {size} and bound {bound}")
    if tree.dim() != 1 or tree.shape[0] != 2 * bound:
        raise ValueError(f"prefix_sum_idx takes a 1-D tree of 2*bound = {2 * bound} nodes, got shape {tuple(tree.shape)}")
    if values.dim() != 1:
        raise ValueError(f"prefix_sum_idx takes 1-D values [B], got shape {tuple(values.shape)}")
    if tree.dtype != torch.float32 or values.dtype != torch.float32:
        raise TypeError(f"prefix_sum_idx takes a float32 tree and float32 values, got {tree.dtype} and {values.dtype}")
    if tree.device != values.device:
        raise ValueError(f"tree on {tree.device} but values on {values.device}")


def _kernel():
    global _fn
    if _fn is None:
        from tianshou_tpu_torch.ops.kernels._build import load

        fn = load("sumtree").tt_prefix_sum_idx
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def prefix_sum_idx(tree: torch.Tensor, values: torch.Tensor, bound: int, depth: int, size: int) -> torch.Tensor:
    """Descend the sum tree ``tree [2 * bound]`` (float32, root at node 1,
    leaves at ``[bound, 2 * bound)``, ``bound = 2**depth``) for each of the
    float32 ``values [B]``. Returns int64 ``[B]`` leaf indices in
    ``[0, size - 1]``.

    On a CUDA tree this launches the hand-written kernel on the current
    stream or raises; it never falls back to the plain loop. On a CPU tree it
    runs :func:`prefix_sum_idx_reference`.
    """
    global _launches
    _check(tree, values, bound, depth, size)
    if tree.device.type == "cpu":
        return prefix_sum_idx_reference(tree, values, bound, depth, size)
    if tree.device.type != "cuda":
        raise ValueError(f"prefix_sum_idx runs on cuda or cpu, got {tree.device}")
    if not tree.is_contiguous() or not values.is_contiguous():
        raise ValueError("prefix_sum_idx needs a contiguous tree and contiguous values")
    fn = _kernel()
    out = torch.empty(values.shape, dtype=torch.int64, device=tree.device)
    if values.shape[0] == 0:
        return out
    with torch.cuda.device(tree.device):
        stream = torch.cuda.current_stream(tree.device).cuda_stream
        err = fn(tree.data_ptr(), values.data_ptr(), out.data_ptr(),
                 values.shape[0], depth, bound, size, stream)
    if err != 0:
        raise RuntimeError(f"prefix_sum_idx kernel launch failed: CUDA error {err}")
    _launches += 1
    return out
