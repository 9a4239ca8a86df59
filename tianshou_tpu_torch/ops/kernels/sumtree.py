"""The sum tree of prioritized replay: its descent (for each value the
largest leaf ``i`` with ``prefix_sum(i) <= value``, the sampler) and its
update (new leaf priorities and their ancestors, the writeback).

Both are CUDA C++ kernels in ``csrc/sumtree.cu``:

- :func:`prefix_sum_idx` replaces the TPU kernel
  ``tianshou_tpu/ops/pallas/sumtree.py:pallas_prefix_sum_idx`` (a masked
  reduction over the whole VMEM-resident tree per level, for
  ``bound <= 16384``). A team of lanes per query covers several levels per
  trip to L2: its lanes split the paths down those levels, load the left
  children along them all at once (where a path turns does not depend on
  the value), walk them in registers, and a ballot picks the one path whose
  every turn is the compare it makes. So 17 levels cost 2-3 dependent trips
  instead of 17. Any ``bound``; int64 indices, as the port's buffers use.
- :func:`update` replaces the JAX package's XLA code
  ``tianshou_tpu/ops/segtree.py:SegmentTree.update``: one launch of one
  block per chunk of up to 1,024 entries, in input order (entry ``e`` is
  thread ``e``; it keeps its leaf unless a later entry of its chunk has the
  same index, then writes its ancestors a level at a time between block
  barriers). The training path's updates are one chunk; more entries
  (building a tree) take one launch per chunk, and a later chunk's write
  wins as in the plain version.

Neither moves more than a few KB at the main path's shapes: the launch and
the chain of dependent trips to memory bound them. Measured times are in
``PERF.md``.

Each wrapper launches its kernel for a CUDA tree and takes the plain
version, :func:`prefix_sum_idx_reference` or :func:`update_reference`, only
for a CPU tree. Both kernels give the plain versions' bits exactly.
"""

from __future__ import annotations

import ctypes

import torch

from tianshou_tpu_torch.ops.kernels import counters

__all__ = [
    "ONE_BLOCK", "launch_count", "prefix_sum_idx", "prefix_sum_idx_reference", "reset_launch_count", "update",
    "update_launch_count", "update_reference",
]

ONE_BLOCK = 1024  # entries per launch of the update (kOneBlock in csrc/sumtree.cu)

_fns: dict[str, object] = {}  # the loaded C entry points


def launch_count() -> int:
    """Descent kernel launches since the last :func:`reset_launch_count`."""
    return counters.get("prefix_sum_idx")


def update_launch_count() -> int:
    """Update kernel launches since the last :func:`reset_launch_count`."""
    return counters.get("tree_update")


def reset_launch_count() -> None:
    """Zero both counters."""
    counters.reset("prefix_sum_idx", "tree_update")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
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


def update_reference(tree: torch.Tensor, index: torch.Tensor, value: torch.Tensor, bound: int, depth: int,
                     size: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`update`, in place: duplicates
    resolved with a stable sort (the last write wins; ``tensor[pos] = val``
    with duplicates is undefined on CUDA), dropped and out-of-range indices
    redirected to node 0, which is cleared at the end, then a gather, an add
    and a scatter per level, with no host sync."""
    # resolve duplicates: stable-sort by index, keep only the last
    order = torch.argsort(index, stable=True)
    s_idx = index[order]
    is_last = torch.ones_like(s_idx, dtype=torch.bool)
    is_last[:-1] = s_idx[1:] != s_idx[:-1]
    valid = is_last & (s_idx >= 0) & (s_idx < size)
    # dropped writes all land on the unused node 0, which is cleared at the end
    pos = torch.where(valid, s_idx + bound, 0)
    tree[pos] = value[order]

    # repair ancestors level by level: row p of the pair view is (tree[2p], tree[2p+1]),
    # and siblings write the same sum. Node 0's row holds node 0 itself, so what the
    # dropped entries write there is read by no other node.
    pairs = tree.view(bound, 2)
    for _ in range(depth):
        pos = pos // 2
        children = pairs[pos]
        tree[pos] = children[:, 0] + children[:, 1]
    tree[0] = 0.0
    return tree


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _check_tree(tree: torch.Tensor, bound: int, depth: int, size: int, what: str) -> None:
    if depth < 0 or bound != 1 << depth:
        raise ValueError(f"bound must be 2**depth, got bound {bound} and depth {depth}")
    if not 1 <= size <= bound:
        raise ValueError(f"size must lie in [1, bound], got size {size} and bound {bound}")
    if tree.dim() != 1 or tree.shape[0] != 2 * bound:
        raise ValueError(f"{what} takes a 1-D tree of 2*bound = {2 * bound} nodes, got shape {tuple(tree.shape)}")
    if tree.dtype != torch.float32:
        raise TypeError(f"{what} takes a float32 tree, got {tree.dtype}")


def _device_of(tree: torch.Tensor, what: str, *others: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``; raises on another device or on inputs apart."""
    for other in others:
        if other.device != tree.device:
            raise ValueError(f"{what}: tree on {tree.device} but an input on {other.device}")
    if tree.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {tree.device}")
    if tree.device.type == "cuda" and not tree.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tree")
    return tree.device.type


def _kernel(name: str, argtypes: list):
    fn = _fns.get(name)
    if fn is None:
        from tianshou_tpu_torch.ops.kernels._build import load

        fn = getattr(load("sumtree"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _descent_shape(n_queries: int) -> tuple[int, int, int]:
    """(log2 of the lanes per query, levels per trip, warps per block). A small batch takes a warp per query
    and 7 levels per trip (3 trips for 17 levels); a large one 8 lanes per query and 6 levels per trip, which
    ask L1 for a quarter of the addresses (the fastest shapes at 32 and 4096 values on an H100, PERF.md)."""
    return (5, 7, 4) if n_queries <= 256 else (3, 6, 4)


def prefix_sum_idx(tree: torch.Tensor, values: torch.Tensor, bound: int, depth: int, size: int) -> torch.Tensor:
    """Descend the sum tree ``tree [2 * bound]`` (float32, root at node 1,
    leaves at ``[bound, 2 * bound)``, ``bound = 2**depth``) for each of the
    float32 ``values [B]``. Returns int64 ``[B]`` leaf indices in
    ``[0, size - 1]``.

    On a CUDA tree this launches the hand-written kernel on the current
    stream or raises; it never falls back to the plain loop. On a CPU tree it
    runs :func:`prefix_sum_idx_reference`.
    """
    _check_tree(tree, bound, depth, size, "prefix_sum_idx")
    if values.dim() != 1:
        raise ValueError(f"prefix_sum_idx takes 1-D values [B], got shape {tuple(values.shape)}")
    if values.dtype != torch.float32:
        raise TypeError(f"prefix_sum_idx takes float32 values, got {values.dtype}")
    if _device_of(tree, "prefix_sum_idx", values) == "cpu":
        return prefix_sum_idx_reference(tree, values, bound, depth, size)
    if not values.is_contiguous():
        raise ValueError("prefix_sum_idx needs contiguous values")
    return _descent(tree, values, bound, depth, size, _descent_shape(values.shape[0]))


def _descent(tree: torch.Tensor, values: torch.Tensor, bound: int, depth: int, size: int,
             shape: tuple[int, int, int]) -> torch.Tensor:
    """The descent kernel's launch on checked CUDA inputs, in the launch shape ``shape`` (see
    :func:`_descent_shape`); any shape gives the same leaves."""
    fn = _kernel("tt_prefix_sum_idx", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    out = torch.empty(values.shape, dtype=torch.int64, device=tree.device)
    if values.shape[0] == 0:
        return out
    lanes_log2, per_trip, warps = shape
    with torch.cuda.device(tree.device):
        stream = torch.cuda.current_stream(tree.device).cuda_stream
        err = fn(tree.data_ptr(), values.data_ptr(), out.data_ptr(), values.shape[0], depth, bound, size,
                 lanes_log2, per_trip, warps, stream)
    if err != 0:
        raise RuntimeError(f"prefix_sum_idx kernel launch failed: CUDA error {err}")
    counters.add("prefix_sum_idx")
    return out


def update(tree: torch.Tensor, index: torch.Tensor, value: torch.Tensor, bound: int, depth: int,
           size: int) -> torch.Tensor:
    """Set the leaves ``index [k]`` (int64) of ``tree`` to ``value [k]``
    (float32) and recompute their ancestors as ``tree[2p] + tree[2p+1]``, in
    place; returns ``tree``. The last of duplicate indices wins; indices
    outside ``[0, size)`` are dropped. ``index`` and ``value`` may be strided
    (an expanded scalar priority is read with stride 0, without a copy).

    On a CUDA tree this launches the hand-written kernel on the current
    stream or raises: one launch per chunk of ``ONE_BLOCK`` entries, so one
    for ``k <= ONE_BLOCK``; :func:`update_launch_count` counts every launch.
    No host sync and no allocation. On a CPU tree it runs
    :func:`update_reference`.
    """
    _check_tree(tree, bound, depth, size, "update")
    if index.dim() != 1 or value.dim() != 1 or index.shape[0] != value.shape[0]:
        raise ValueError(f"update takes index [k] and value [k], got {tuple(index.shape)} and {tuple(value.shape)}")
    if index.dtype != torch.int64 or value.dtype != torch.float32:
        raise TypeError(f"update takes int64 indices and float32 values, got {index.dtype} and {value.dtype}")
    if _device_of(tree, "update", index, value) == "cpu":
        return update_reference(tree, index, value, bound, depth, size)
    k = index.shape[0]
    if k == 0:
        return tree
    fn = _kernel("tt_tree_update", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ])
    launched = ctypes.c_int(0)
    with torch.cuda.device(tree.device):
        stream = torch.cuda.current_stream(tree.device).cuda_stream
        err = fn(tree.data_ptr(), index.data_ptr(), index.stride(0), value.data_ptr(), value.stride(0), k, depth,
                 bound, size, ctypes.byref(launched), stream)
    counters.add("tree_update", launched.value)
    if err != 0:
        raise RuntimeError(f"update kernel launch failed: CUDA error {err}")
    return tree
