#!/usr/bin/env python3
"""Drive the PyTorch port (``tianshou_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. Require CUDA; print the card's name and power limit and the TF32 settings.
2. Build every hand-written kernel from the sources in the checkout.
3. Kernel phase: hold each kernel bit-exact against its plain PyTorch
   version on the card, and time the kernel, the plain version and one
   PyTorch library call with CUDA events: device time per call from a
   replayed CUDA graph of 20 calls, and eager time of single calls, each the
   median of 60 runs after a warm-up. The gather is timed beside an empty
   launch of the same shape. The sum tree has two kernels, the descent
   (``prefix_sum_idx``) and the update (``tree_update``): both are held
   bit-exact on whole trees (builds from 131072 and 300000 indices with
   duplicates and dropped ones, the training path's 32 and 256 leaves, the
   one-block edge at 1024/1025 entries) and timed at B = 32 and 4096 values
   and k = 32 and 256 leaves.
4. Graph phase: the trainer's programs as CUDA graphs against the eager
   loop, for the DQN and the Rainbow pipelines of phases 5 and 6 at full
   width (``graph_phase``): from one prefilled state and one generator state,
   three collect chunks and three bursts of 8 updates through the graphs
   against the same run eagerly, each on a deep copy. Sampled indices, rings, collect state
   and output and the sum tree bit-identical; losses, TD errors and
   parameters within ``GRAPH_ATOL`` (expected exact, cuDNN held to
   deterministic algorithms); the same kernel launches. Then the pipeline's
   Adam as the trainer builds it on the card (``capturable=True``, step and
   bias corrections on the device), ``ADAM_STEPS`` steps as one replayed
   graph, against the same factory's Adam on CPU copies of the trained
   parameters, with the same gradients (``adam_check``), held to the JAX
   one-update test's tolerance: ``ADAM_ATOL``, and ``ADAM_SHARE`` of the
   values within ``ADAM_CLOSE``.
5. DQN path: the DQN-on-pixels pipeline of ``bench.py``
   (``_build_atari_pipeline`` / ``bench_atari_cnn``) at its widths:
   ``FrameStack(SyntheticAtari(), 4)`` over 256 envs, a uint8 replay of
   256*512 frames per ring with ``stack_num=4`` and ``save_only_last_obs``,
   and ``DQN(DQNet(6))`` with n=3, gamma 0.99, target sync every 500 steps,
   eps 0.05 and Adam at lr 1e-4, trained by ``OffPolicyTrainer`` (its collect
   chunk and update burst are CUDA graphs) for a random prefill chunk plus
   three chunks of T=16 steps with update_per_step 0.1 and batch 32 (410
   updates a chunk), the first of each program's chunks its eager warm-up and
   the second its capture, then a second ``run`` of three chunks that only
   replays, which is timed. Launch counters are zeroed just before and read
   just after both runs; the gather kernel must run exactly twice per update.
   The same DQN path then runs with ``fused_megastep=True``: one graph per chunk.
6. Rainbow path: the same pixel pipeline with the two parts of the
   ``examples/atari/atari_rainbow.py`` configuration exchanged: a
   prioritized replay (``PrioritizedVectorReplayBuffer``, alpha 0.6, beta
   0.4, a sum tree of 131072 leaves) and ``RainbowDQN`` over the noisy
   dueling ``RainbowAtariNet(6, 51 atoms)`` with Adam at lr 6.25e-5, at the
   same depth. Counters are zeroed and read around it in the same way: the
   descent kernel must run once and the gather kernel twice per update, the
   update kernel once per update (the priority writeback) and once per
   collect step (the new rows' max priority), prefill included; the final
   tree must hold ``node = left + right`` exactly at every internal node,
   with zero leaves at never-written slots.

7. Physics kernel phase: for each of the six MuJoCo tasks at E = 2048 (HalfCheetah also at
   E = 6 and 2053) hold the fused step kernel against its plain version
   (``dynamics.step``): near-home states, every env within ``q`` rtol = atol = 2e-4 and ``qd``
   rtol = atol = 5e-3; states from the kernel's own random-action rollout at steps 16, 32 and
   64, at least 99.5% of envs within the same tolerances (a contact that sits on its activation
   threshold may differ) and every output finite; for Ant also rotation vectors beyond pi, so
   that the re-chart runs. Times: the kernel's device time from a replayed CUDA graph and its
   eager time, at E = 2048 and, from the graph, at E = 32 and 8448 (is it bound by latency or by
   throughput); the plain version's eager time (its Cholesky calls are not captured in a graph);
   the bound by float32 operations counted for this run's active contact and limit rows.
8. Physics paths (``bench.py:bench_physics_step``): ``VectorDeviceEnv(HalfCheetah(), 2048)``,
   reset, 64 vector steps with actions from ``action_space.sample`` as one program, the
   counterpart of the scan, called three times (eager warm-up, capture and replay of one CUDA
   graph, replay); then Ant, 16 steps. One kernel launch per step exactly (and none of the other
   kernels), every state, observation and reward finite, Ant's termination rule.

Every path prints its env-steps/s, ms per update, graph replays per chunk, capture time and the
device memory of its graph pool.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and the one before that the per-kernel
JSON record.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # float32 outside the tensor cores, same sheet

# the main path's widths and depth (bench.py's pixel pipeline)
E = 256        # envs
SLOTS = 512    # ring slots per env
CHUNKS = 3     # training chunks after the prefill chunk
T = 16         # env steps per chunk
BATCH = 32
SEED = 0

# the physics paths (bench.py:bench_physics_step) and the kernel phase
PHYS_E = 2048
PHYS_PATHS = (("HalfCheetah", 64), ("Ant", 16))  # (task, vector steps)
PHYS_TASKS = ("HalfCheetah", "Hopper", "Walker2d", "Ant", "Swimmer", "Reacher")
ROLLOUT_CHECKS = (16, 32, 64)

# the graph phase: program calls per side (eager warm-up, capture and replay, replay) and updates per burst
GRAPH_CALLS, GRAPH_K = 3, 8
GRAPH_ATOL = 1e-6  # losses, TD errors and parameters of graph against eager; expected 0
# capturable Adam on the card against Adam on the CPU: tests/test_torch_dqn.py's one-update tolerance
ADAM_STEPS, ADAM_ATOL, ADAM_CLOSE, ADAM_SHARE = 8, 2e-5, 2e-6, 0.999
Q_TOL, QD_TOL = 2e-4, 5e-3     # rtol = atol, as the JAX package holds its fused step
MIN_SHARE_INSIDE = 0.995       # of envs, on rollout states


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, warmup: int = 10, runs: int = 60, per_graph: int = 20) -> tuple[float, float]:
    """(device ms, eager ms) of one call of ``fn``, each a median over ``runs``.

    Device time: ``per_graph`` calls captured in a CUDA graph, replayed
    between two CUDA events, so that no host launch gap is counted (NaN for
    ``per_graph=0``, a function that cannot be captured). Eager time: CUDA
    events around one ordinary call, which includes the gap when the host
    launches slower than the device runs.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    eager = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        eager.append(a.elapsed_time(b))
    if per_graph == 0:  # a function that a CUDA graph cannot capture: eager time only
        return float("nan"), statistics.median(eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b) / per_graph)
    del graph
    return statistics.median(device), statistics.median(eager)


# ---------------------------------------------------------------------------
# the bench.py pixel env, batched (bench.py:86-117)
# ---------------------------------------------------------------------------
def make_synthetic_atari():
    from typing import NamedTuple

    import torch

    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.env.core import Box, Discrete, Env, EnvStep

    class PixState(NamedTuple):
        pos: torch.Tensor  # [E] int32
        t: torch.Tensor    # [E] int32

    class SyntheticAtari(Env):
        """84x84 uint8 frames from a cheap position-dependent pattern, ~500-step
        episodes; obs synthesis is negligible next to the CNN and the replay."""

        max_episode_steps = 108_000

        def __init__(self) -> None:
            self.observation_space = Box(low=0, high=255, shape=(84, 84, 1))
            self.action_space = Discrete(6)

        @staticmethod
        def _obs(s: PixState) -> torch.Tensor:
            row = torch.arange(84, dtype=torch.int32, device=s.pos.device)[:, None]
            col = torch.arange(84, dtype=torch.int32, device=s.pos.device)[None, :]
            img = (row * 7 + col * 13)[None] + s.pos[:, None, None]
            return (img % 251).to(torch.uint8)[..., None]

        def reset(self, num_envs, generator, device):
            z = torch.zeros(num_envs, dtype=torch.int32, device=device)
            s = PixState(z, z.clone())
            return s, self._obs(s)

        def step(self, state, action, generator):
            pos = state.pos + action.to(torch.int32) + 1
            t = state.t + 1
            terminated = torch.rand(pos.shape, generator=generator, device=pos.device) < 0.002
            s = PixState(pos, t)
            return EnvStep(
                state=s, obs=self._obs(s),
                reward=(action == pos % 6).to(torch.float32),
                terminated=terminated,
                truncated=(t >= self.max_episode_steps) & ~terminated,
                info=Batch(),
            )

    return SyntheticAtari()


# ---------------------------------------------------------------------------
def gather_phase(torch, gather) -> tuple[list[dict], list[str]]:
    """Bit-exactness on the card at the main path's and edge-case shapes, timing at the
    main path's shape. Returns ([JSON record without launches], report lines)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    lines = []
    n, row = 131072, 7056  # the main path's obs ring: 256 envs x 512 slots of 84*84*1 B
    src = torch.randint(0, 256, (n, row), dtype=torch.uint8, device="cuda", generator=g)
    cases = []
    for rows in (128, 4096):
        idx = torch.randint(0, n, (rows,), device="cuda", generator=g)
        cases += [(f"uint8[{n},{row}] x {rows} rows int64", src, idx),
                  (f"uint8[{n},{row}] x {rows} rows int32", src, idx.to(torch.int32))]
    f32 = torch.randn(1024, 5, device="cuda", generator=g)
    cases.append(("float32[1024,5] x 300 rows", f32, torch.randint(0, 1024, (300,), device="cuda", generator=g)))
    rag = torch.randint(0, 256, (513, 3), dtype=torch.uint8, device="cuda", generator=g)
    cases.append(("uint8[513,3] x 1000 rows", rag, torch.randint(0, 513, (1000,), device="cuda", generator=g)))
    rep = torch.tensor([5, 5, 5, 0, 512, 512, 7, 5, -4, 10_000], device="cuda")
    cases.append(("uint8[513,3] repeated and out-of-range indices", rag, rep))
    cases.append(("uint8 main ring, repeated indices", src, torch.full((128,), 77, device="cuda")))
    for width in (16, 2032, 2064, 7057):  # around the 16-byte chunk and the block's edge
        edge = torch.randint(0, 256, (300, width), dtype=torch.uint8, device="cuda", generator=g)
        cases.append((f"uint8[300,{width}] x 200 rows", edge, torch.randint(-2, 302, (200,), device="cuda", generator=g)))
    max_err = 0.0
    for name, s, i in cases:
        out = gather.gather_rows(s, i)
        ref = gather.gather_rows_reference(s, i)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"gather_rows differs from its plain version: {name}")
        max_err = max(max_err, float((out.double() - ref.double()).abs().max()))
        lines.append(f"gather_rows bit-exact: {name}")

    timings = {}
    count = gather.launch_count()  # timing launches are not the main path's
    for rows in (128, 4096):
        idx = torch.randint(0, n, (rows,), device="cuda", generator=g)
        kern, kern_e = _time_ms(lambda: gather.gather_rows(src, idx))
        plain, plain_e = _time_ms(lambda: gather.gather_rows_reference(src, idx))
        lib, lib_e = _time_ms(lambda: src[idx])
        noop, _ = _time_ms(lambda: gather.launch_noop(rows, 256))
        again, _ = _time_ms(lambda: gather.gather_rows(src, idx))  # the drift within the call
        bound = (2 * rows * row + idx.numel() * idx.element_size()) / H100_HBM_BYTES_PER_S * 1e3
        timings[rows] = (kern, plain, lib, bound)
        lines.append(
            f"gather_rows {rows} rows x {row} B, device us (CUDA graph): kernel {kern * 1e3:.3f} (again {again * 1e3:.3f}) "
            f"plain {plain * 1e3:.3f} library(src[idx]) {lib * 1e3:.3f} empty launch of {rows} x 256 threads {noop * 1e3:.3f} "
            f"bound {bound * 1e3:.3f} (kernel at {bound / kern:.3f} of the bound's rate, {kern / lib:.3f} of the library's time); "
            f"eager us per call: kernel {kern_e * 1e3:.2f} plain {plain_e * 1e3:.2f} library {lib_e * 1e3:.2f}"
        )
    if gather.launch_count() == count:
        raise AssertionError("the timed gather_rows calls did not launch the kernel")
    kern, plain, lib, bound = timings[128]  # 32 samples x 4 frames on the main path
    record = {
        "name": "gather_rows", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/gather.cu",
        "replaces": "tianshou_tpu/ops/pallas/gather.py:79",
        "max_abs_err": max_err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": lib,
    }
    return [record], lines


def _touched_nodes(tree, values, depth: int) -> int:
    """Number of distinct tree nodes the descents of ``values`` read."""
    import torch

    idx = torch.ones(values.shape, dtype=torch.int64, device=values.device)
    read = []
    for _ in range(depth):
        left = tree[2 * idx]
        go_right = left < values
        read.append(2 * idx)
        values = torch.where(go_right, values - left, values)
        idx = 2 * idx + go_right.to(torch.int64)
    return int(torch.unique(torch.cat(read)).numel()) if read else 0


def sumtree_phase(torch, sumtree) -> tuple[list[dict], list[str]]:
    """Both sum-tree kernels on the card. The descent: exact equality with its plain version at the
    main path's and edge-case shapes, timing at the main path's shape (131072 leaves, 32 stratified
    queries) and at 4096 queries. The update: see :func:`_tree_update_checks`. Returns (the two JSON
    records without launches, report lines)."""
    from tianshou_tpu_torch.ops.segtree import SegmentTree

    g = torch.Generator(device="cuda").manual_seed(2)
    lines = []

    def rand(n):
        return torch.rand(n, device="cuda", generator=g)

    def filled(size, zero_share=0.0):
        st = SegmentTree(size)
        vals = rand(size) + 1e-3
        if zero_share:
            vals = torch.where(rand(size) < zero_share, 0.0, vals)
        return st, st.update(st.init("cuda"), torch.arange(size, device="cuda"), vals)

    def edge_values(st, tree):
        """Every prefix sum of the first leaves (a value equal to one goes left), 0, the total,
        values above it and a negative one."""
        total = st.total(tree)
        cum = torch.cumsum(tree[st.bound:st.bound + min(st.size, 256)], 0)
        return torch.cat([cum, torch.stack([total * 0, total, total * 1.5, total + 1e9, -total - 1])])

    cases = []
    for size, batches in ((131072, (32, 4096)), (100000, (32,)), (16384, (257,)), (1, (5,))):
        st, tree = filled(size)
        for b in batches:
            cases.append((f"size {size} (bound {st.bound}) x {b} uniform values", st, tree, rand(b) * st.total(tree)))
        cases.append((f"size {size}: prefix sums, 0, total and beyond", st, tree, edge_values(st, tree)))
    st, tree = filled(100000, zero_share=0.5)
    cases.append(("size 100000, half the leaves at priority 0", st, tree,
                  torch.cat([rand(4096) * st.total(tree), edge_values(st, tree)])))
    st = SegmentTree(131072)
    cases.append(("size 131072, all-zero tree", st, st.init("cuda"), torch.cat([rand(32), torch.zeros(3, device="cuda")])))
    # a tree built by update with duplicate (the last write wins) and -1 / out-of-range indices
    st = SegmentTree(131072)
    idx = torch.randint(-1, 131072, (300000,), device="cuda", generator=g)
    idx[::1000] = 131072 + 5
    tree = st.update(st.init("cuda"), idx, rand(300000) * 3)
    tree = st.update(tree, torch.tensor([7, 7, -1, 7], device="cuda"), torch.tensor([1.0, 2.0, 9.0, 4.0], device="cuda"))
    if tree[st.bound + 7].item() != 4.0 or tree[0].item() != 0.0:
        raise AssertionError("SegmentTree.update: the last write did not win or node 0 was written")
    if not torch.equal(tree[1:st.bound], tree[2::2] + tree[3::2]):
        raise AssertionError("SegmentTree.update: an internal node is not the sum of its children")
    cases.append(("size 131072, tree from update with duplicate and dropped indices", st, tree,
                  torch.cat([rand(4096) * st.total(tree), edge_values(st, tree)])))
    cases.append(("size 131072, no values", st, tree, torch.zeros(0, device="cuda")))

    max_err = 0.0
    for name, st, tree, values in cases:
        out = st.get_prefix_sum_idx(tree, values)
        ref = sumtree.prefix_sum_idx_reference(tree, values, st.bound, st.depth, st.size)
        torch.cuda.synchronize()
        if out.dtype != torch.int64 or not torch.equal(out, ref):
            raise AssertionError(f"prefix_sum_idx differs from its plain version: {name}")
        if values.numel():
            max_err = max(max_err, float((out - ref).abs().max()))
        lines.append(f"prefix_sum_idx exact: {name}")

    # timing at the main path's tree: every leaf holds a priority, values are stratified
    st, tree = filled(131072)
    timings = {}
    count = sumtree.launch_count()  # timing launches are not the main path's
    for b in (32, 4096):
        values = ((rand(b) + torch.arange(b, device="cuda")) / b * st.total(tree)).contiguous()
        kern, kern_e = _time_ms(lambda: sumtree.prefix_sum_idx(tree, values, st.bound, st.depth, st.size))
        plain, plain_e = _time_ms(lambda: sumtree.prefix_sum_idx_reference(tree, values, st.bound, st.depth, st.size))
        # no single PyTorch call computes this function (a cumsum rounds differently); for information only
        two, _ = _time_ms(lambda: torch.searchsorted(torch.cumsum(tree[st.bound:], 0), values))
        nodes = _touched_nodes(tree, values, st.depth)
        by_bytes = (b * 4 + b * 8 + 4 * nodes) / H100_HBM_BYTES_PER_S * 1e3
        by_ops = 2 * b * st.depth / H100_FP32_OPS_PER_S * 1e3  # one compare and one subtract per level
        timings[b] = (kern, plain, max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations")
        lines.append(
            f"prefix_sum_idx bound {st.bound} x {b} values, device us (CUDA graph): kernel {kern * 1e3:.3f} "
            f"plain {plain * 1e3:.3f} bound {max(by_bytes, by_ops) * 1e3:.5f} ({nodes} distinct nodes read; by bytes "
            f"{by_bytes * 1e3:.5f}, by operations {by_ops * 1e3:.5f}); eager us per call: kernel {kern_e * 1e3:.2f} "
            f"plain {plain_e * 1e3:.2f}; cumsum+searchsorted (another rounding, no yardstick) {two * 1e3:.3f}"
        )
    if sumtree.launch_count() == count:
        raise AssertionError("the timed prefix_sum_idx calls did not launch the kernel")
    lines.append(f"prefix_sum_idx launch shape (log2 lanes per query, levels per trip, warps per block): "
                 f"B=32 {sumtree._descent_shape(32)}, B=4096 {sumtree._descent_shape(4096)}")
    kern, plain, bound, bound_by = timings[32]  # batch 32 on the main path
    record = {
        "name": "prefix_sum_idx", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/sumtree.cu",
        "replaces": "tianshou_tpu/ops/pallas/sumtree.py:63",
        "max_abs_err": max_err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None,
    }
    update_record, update_lines = _tree_update_checks(torch, sumtree)
    return [record, update_record], lines + update_lines


def _update_nodes(torch, index, bound: int, depth: int, size: int) -> tuple[int, int]:
    """(nodes an update of leaves ``index`` writes, nodes it reads without writing them): the kept
    distinct leaves and all their ancestors; the ancestors' children outside that set."""
    node = torch.unique(index[(index >= 0) & (index < size)]) + bound
    written, ancestors = [node], []
    for _ in range(depth):
        node = torch.unique(node // 2)
        written.append(node)
        ancestors.append(node)
    written = torch.cat(written)
    if not ancestors:
        return int(written.numel()), 0
    children = torch.cat([2 * torch.cat(ancestors), 2 * torch.cat(ancestors) + 1])
    return int(written.numel()), int((~torch.isin(children, written)).sum())


def _tree_update_checks(torch, sumtree) -> tuple[dict, list[str]]:
    """Exact equality of the sum-tree update kernel and its plain version on whole trees on the card,
    timing at the training path's 32 leaves (priority writeback) and 256 leaves (the collector's add)
    on the main path's tree. Returns (JSON record without launches, report lines)."""
    from tianshou_tpu_torch.ops.segtree import SegmentTree

    g = torch.Generator(device="cuda").manual_seed(4)
    lines = []

    def rand(n):
        return torch.rand(n, device="cuda", generator=g)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), device="cuda", generator=g)

    def filled(size):
        st = SegmentTree(size)
        return sumtree.update_reference(st.init("cuda"), torch.arange(size, device="cuda"), rand(size) + 1e-3,
                                        st.bound, st.depth, st.size)

    cases = []  # (name, size, tree before, index, value)
    for size in (131072, 100000, 16384, 1):  # whole trees from nothing
        st = SegmentTree(size)
        cases.append((f"size {size}: every leaf from an empty tree", size, st.init("cuda"),
                      torch.arange(size, device="cuda"), rand(size) + 1e-3))
    idx = randint(-1, 131072, 300000)
    idx[::1000] = 131072 + 5
    cases.append(("size 131072: 300000 indices with duplicates, -1 and beyond size", 131072,
                  SegmentTree(131072).init("cuda"), idx, rand(300000) * 3))
    main = filled(131072)
    cases.append(("main tree: [7, 7, -1, 7]", 131072, main, torch.tensor([7, 7, -1, 7], device="cuda"),
                  torch.tensor([1.0, 2.0, 9.0, 4.0], device="cuda")))
    for k in (32, 256, 1024, 1025):
        value = rand(k) * 2
        value[: k // 8] = 0.0  # zero priorities
        cases.append((f"main tree: {k} leaves, duplicates and -1", 131072, main, randint(-1, 131072, k), value))
    cases.append(("main tree: 256 leaves of one expanded priority", 131072, main,
                  torch.arange(256, device="cuda") * 512 + 17, torch.tensor(0.3, device="cuda").expand(256)))
    cases.append(("main tree: only dropped indices", 131072, main, torch.tensor([-1, 131072, -1], device="cuda"),
                  torch.ones(3, device="cuda")))
    cases.append(("size 100000: 700 leaves", 100000, filled(100000), randint(0, 100000, 700), rand(700)))

    max_err = 0.0
    for name, size, before, index, value in cases:
        st = SegmentTree(size)
        want = sumtree.update_reference(before.clone(), index, value, st.bound, st.depth, st.size)
        got = sumtree.update(before.clone(), index, value, st.bound, st.depth, st.size)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got.double() - want.double()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"tree_update differs from its plain version: {name}")
        if not torch.equal(got[1:st.bound], got[2::2] + got[3::2]) or got[0].item() != 0.0:
            raise AssertionError(f"tree_update: the tree's invariant does not hold: {name}")
        lines.append(f"tree_update bit-exact: {name}")
    # through SegmentTree.update, as the buffer calls it: the last write wins, node 0 stays 0
    st = SegmentTree(131072)
    tree = st.update(main.clone(), torch.tensor([7, 7, -1, 7], device="cuda"), torch.tensor([1.0, 2.0, 9.0, 4.0], device="cuda"))
    if tree[st.bound + 7].item() != 4.0 or tree[0].item() != 0.0:
        raise AssertionError("SegmentTree.update: the last write did not win or node 0 was written")

    # timing on the main path's tree: the writeback's sampled leaves, the collector's one leaf per env
    st, tree = SegmentTree(131072), main
    timings = {}
    count = sumtree.update_launch_count()  # timing launches are not the main path's
    for k, index in ((32, sumtree.prefix_sum_idx(tree, rand(32) * st.total(tree), st.bound, st.depth, st.size)),
                     (256, torch.arange(256, device="cuda") * 512 + 100)):
        value = rand(k) + 0.5
        kern, kern_e = _time_ms(lambda: sumtree.update(tree, index, value, st.bound, st.depth, st.size))
        # the plain version clears node 0 from a host scalar, which a CUDA graph cannot capture: eager time
        _, plain = _time_ms(lambda: sumtree.update_reference(tree, index, value, st.bound, st.depth, st.size), per_graph=0)
        written, read = _update_nodes(torch, index, st.bound, st.depth, st.size)
        by_bytes = (12 * k + 4 * written + 4 * read) / H100_HBM_BYTES_PER_S * 1e3
        by_ops = (written - int(torch.unique(index).numel())) / H100_FP32_OPS_PER_S * 1e3  # one add per ancestor
        timings[k] = (kern, plain, max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations")
        lines.append(
            f"tree_update bound {st.bound} x {k} leaves: kernel {kern * 1e3:.3f} us device (CUDA graph), "
            f"{kern_e * 1e3:.2f} eager; plain {plain * 1e3:.2f} eager; bound {max(by_bytes, by_ops) * 1e3:.5f} "
            f"({written} nodes written, {read} read beside them; by bytes {by_bytes * 1e3:.5f}, by operations "
            f"{by_ops * 1e3:.5f})"
        )
    if sumtree.update_launch_count() == count:
        raise AssertionError("the timed tree_update calls did not launch the kernel")
    kern, plain, bound, bound_by = timings[32]  # the priority writeback, once per update
    record = {
        "name": "tree_update", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/sumtree.cu",
        "replaces": "tianshou_tpu/ops/segtree.py:45",
        "max_abs_err": max_err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None, "plain_timing": "eager", "ms_256": timings[256][0],
        "plain_ms_256": timings[256][1], "bound_ms_256": timings[256][2],
    }
    return record, lines


def _launches(gather, sumtree, physics_fused) -> dict[str, int]:
    return {"gather_rows": gather.launch_count(), "prefix_sum_idx": sumtree.launch_count(),
            "tree_update": sumtree.update_launch_count(), "physics_fused": physics_fused.launch_count()}


def build_pipeline(torch, kind: str = "dqn"):
    """The bench.py pipeline (``_build_atari_pipeline``) in the port, with DQN over a uniform
    replay (``kind="dqn"``) or RainbowDQN over a prioritized one (``kind="rainbow"``,
    examples/atari/atari_rainbow.py): returns (algo, train state, buffer, buffer state, collector)."""
    from tianshou_tpu_torch.algorithm.modelfree.c51 import RainbowDQN
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.wrappers import FrameStack
    from tianshou_tpu_torch.models.atari import DQNet, RainbowAtariNet

    device = "cuda"
    torch.manual_seed(SEED)
    env = FrameStack(make_synthetic_atari(), 4)
    common = dict(action_space=env.action_space, gamma=0.99, n_step_return_horizon=3,
                  target_update_freq=500, eps_training=0.05)
    ring = dict(total_size=E * SLOTS, buffer_num=E, stack_num=4, save_only_last_obs=True)
    if kind == "dqn":
        algo = DQN(model=DQNet(action_dim=6), optim=AdamOptimizerFactory(lr=1e-4), **common)
        buffer = VectorReplayBuffer(**ring)
    else:
        algo = RainbowDQN(model=RainbowAtariNet(action_dim=6, num_atoms=51), optim=AdamOptimizerFactory(lr=6.25e-5),
                          num_atoms=51, v_min=-10.0, v_max=10.0, **common)
        buffer = PrioritizedVectorReplayBuffer(alpha=0.6, beta=0.4, **ring)
    ts = algo.init(device)
    buf_state = buffer.init(Batch(
        obs=torch.zeros((84, 84, 1), dtype=torch.uint8), act=torch.tensor(0), rew=torch.tensor(0.0),
        terminated=torch.tensor(False), truncated=torch.tensor(False),
        obs_next=torch.zeros((84, 84, 1), dtype=torch.uint8),
    ), device=device)
    coll = DeviceCollector(VectorDeviceEnv(env, E, device=device), algo, buffer)
    return algo, ts, buffer, buf_state, coll


def _check_tree(torch, buffer, state, gen) -> str:
    """The prioritized state after training: the tree's invariant, where its mass lies, the
    priority range and a fresh batch's weights. Returns a report line."""
    tree, bound = state.tree, buffer.segtree.bound
    if not torch.equal(tree[1:bound], tree[2::2] + tree[3::2]):
        raise AssertionError("an internal node of the sum tree is not the sum of its two children")
    if tree[0].item() != 0.0:
        raise AssertionError("node 0 of the sum tree was written")
    leaves = tree[bound:bound + E * SLOTS].reshape(E, SLOTS)
    stored = torch.arange(SLOTS, device=tree.device)[None, :] < state.base.size[:, None]
    if not bool((leaves[stored] > 0).all()) or not bool((leaves[~stored] == 0).all()):
        raise AssertionError("stored rows must carry priority and never-written slots none")
    lo, hi = state.min_prio.item(), state.max_prio.item()
    if not 0 < lo <= hi:
        raise AssertionError(f"priority range [{lo}, {hi}] is off")
    batch, idx = buffer.sample(state, gen, BATCH)
    w = batch.weight
    if not bool(((w > 0) & (w <= 1)).all()) or not bool(stored.reshape(-1)[idx].all()):
        raise AssertionError("a sampled batch's weights must lie in (0, 1] and its rows be stored ones")
    return (f"sum tree: {2 * bound} nodes, invariant holds exactly, total {tree[1].item():.3f}, "
            f"{int(stored.sum())} leaves with priority, min_prio {lo:.6f} max_prio {hi:.6f}, "
            f"batch weights in [{w.min().item():.4f}, {w.max().item():.4f}]")


def _graph_report(pool, replays_per_chunk: float) -> str:
    """Capture time, graph replays per chunk and pool memory of a trainer's or a rollout's graphs."""
    captures = ", ".join(f"{g.name} {g.capture_s:.2f} s" for g in pool.graphs if g.capture_s is not None)
    return (f"graph launches per chunk {replays_per_chunk:g}, capture time {captures}, "
            f"graph pool {pool.memory_bytes() / 2**20:.1f} MiB of device memory")


def main_path(torch, kind: str, fused: bool = False):
    """Train the pipeline of ``kind`` through the graphed trainer (with ``fused`` as ONE graph per
    chunk): a first ``run`` of the random prefill and ``CHUNKS`` chunks (the first chunk of each
    program its eager warm-up, the second its capture), then a second ``run`` of ``CHUNKS`` chunks
    that only replays, and that is timed. Returns (second result, {kernel: launches} over both runs,
    report lines)."""
    from tianshou_tpu_torch.data.buffer.prio import PrioState
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    name = f"{kind}{' fused_megastep' if fused else ''}"
    algo, ts, buffer, buf_state, coll = build_pipeline(torch, kind)
    init_params = [p.detach().clone() for p in ts.model.parameters()]
    params = OffPolicyTrainerParams(
        max_epochs=1, epoch_num_steps=CHUNKS * T * E, batch_size=BATCH,
        collection_step_num_env_steps=T, update_per_step=0.1, start_steps=T * E, verbose=False,
        fused_megastep=fused,
    )
    trainer = OffPolicyTrainer(algo, coll, None, buffer, params)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    first = trainer.run(ts, buf_state, gen)
    graphs = list(trainer.graph_pool.graphs)
    replays = sum(g.replays for g in graphs)
    trainer.params.start_steps = 0  # the second run only replays
    res = trainer.run(first.train_state, first.buf_state, gen)
    launches = _launches(gather, sumtree, physics_fused)

    lines = []
    if trainer.graph_pool.graphs != graphs or any(g.graph is None for g in graphs):
        raise AssertionError(f"{name} path: the second run built programs anew")
    if len(graphs) != (1 if fused else 2):
        raise AssertionError(f"{name} path: programs {[g.name for g in graphs]}")
    replays_per_chunk = (sum(g.replays for g in graphs) - replays) / CHUNKS
    if replays_per_chunk != len(graphs):
        raise AssertionError(f"{name} path: {replays_per_chunk} graph replays per chunk of the second run")
    ts, state = res.train_state, res.buf_state
    bs = state.base if isinstance(state, PrioState) else state
    tensors = [*ts.model.parameters(), *ts.target.parameters(), ts.step, *ts.hparams.values(), bs.cursor, bs.size,
               bs.last_idx, *bs.data.values()]
    if isinstance(state, PrioState):
        tensors += [state.tree, state.max_prio, state.min_prio]
    if not all(t.device.type == "cuda" for t in tensors):
        raise AssertionError(f"{name} path: a tensor left the device")
    loss = res.last_chunk_stats.loss
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"{name} path: non-finite loss in the last chunk: {loss}")
    if not all(bool(torch.isfinite(p).all()) for p in ts.model.parameters()):
        raise AssertionError(f"{name} path: non-finite parameters after training")
    if all(torch.equal(a, b) for a, b in zip(init_params, ts.model.parameters())):
        raise AssertionError(f"{name} path: training left the parameters unchanged")
    n_updates = max(1, round(0.1 * T * E))
    expect_updates = 2 * CHUNKS * n_updates
    if res.gradient_step != expect_updates or int(ts.step) != expect_updates:
        raise AssertionError(f"{name} path: {res.gradient_step} updates ({int(ts.step)} on the device), "
                             f"expected {expect_updates}")
    collect_steps = (2 * CHUNKS + 1) * T  # the prefill chunk and the training chunks, one add per step
    if bs.size.min().item() != min(SLOTS, collect_steps):
        raise AssertionError(f"{name} path: ring sizes {bs.size.min().item()}..{bs.size.max().item()} are off")
    prio = isinstance(state, PrioState)
    expect = {"gather_rows": 2 * res.gradient_step, "prefix_sum_idx": res.gradient_step if prio else 0,
              "tree_update": res.gradient_step + collect_steps if prio else 0, "physics_fused": 0}
    if launches != expect:
        raise AssertionError(f"{name} path: kernel launches {launches} for {res.gradient_step} updates, expected {expect}")
    train_s = res.timing["collect"] + res.timing["update"]
    lines.append(
        f"{name} path: E={E} T={T} chunks={CHUNKS}+{CHUNKS} updates={res.gradient_step} batch={BATCH} "
        f"ring uint8 {tuple(bs.data.obs.shape)} x2 ({bs.data.obs.numel() / 1e9:.3f} GB each)"
    )
    lines.append(
        f"{name} path, first run (prefill, then the eager warm-up chunk and the capture chunk): "
        f"{(first.timing['collect'] + first.timing['update']) / CHUNKS * 1e3:.1f} ms per chunk, "
        f"prefill {first.timing['prefill'] * 1e3:.1f} ms"
    )
    what = "collect + update as one graph" if fused else (
        f"collect {res.timing['collect'] / CHUNKS * 1e3:.1f} ms, update {res.timing['update'] / CHUNKS * 1e3:.1f} ms")
    lines.append(
        f"{name} path, second run (graph replays only): env_steps_per_s {CHUNKS * T * E / train_s:.1f} "
        f"ms_per_chunk {train_s / CHUNKS * 1e3:.1f} ({what}) = {train_s / (CHUNKS * n_updates) * 1e3:.3f} ms per update "
        f"(collect included); {_graph_report(trainer.graph_pool, replays_per_chunk)}; "
        f"loss_last_chunk_mean {float(loss.mean()):.5f} gather_launches {launches['gather_rows']} "
        f"sumtree_launches {launches['prefix_sum_idx']} tree_update_launches {launches['tree_update']}"
    )
    if isinstance(state, PrioState):
        lines.append(f"{name} path: " + _check_tree(torch, buffer, state, gen))
    return res, launches, lines


def graph_phase(torch, kind: str) -> list[str]:
    """The trainer's programs as CUDA graphs against the eager loop, on the pipeline of ``kind``.

    From one prefilled state and one generator state, two sides run on deep copies: the trainer's
    programs (the collect chunk and the whole burst, each one graph) and the plain eager loop
    (``collector.collect`` and ``algo.update`` on the card). Each side runs ``GRAPH_CALLS`` collect chunks of T steps and then ``GRAPH_CALLS``
    bursts of ``GRAPH_K`` updates; a program's first call is its eager warm-up, the second its
    capture and first replay, the third a replay. Sampled indices, rings, the collect state, the
    collect output and the sum tree must be bit-identical; losses, TD errors and parameters within
    ``GRAPH_ATOL`` (expected exact: cuDNN is held to deterministic algorithms here, and both sides
    run the same kernels in the same order); the kernel launches the same."""
    import copy

    from tianshou_tpu_torch.data.buffer.prio import PrioState
    from tianshou_tpu_torch.ops.kernels import counters
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    algo, ts, buffer, bs, coll = build_pipeline(torch, kind)
    prio = isinstance(bs, PrioState)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    coll.collect(ts, cstate, bs, gen, T, random=True)  # a prefill chunk: 16 rows per env to sample from
    sample_indices = buffer.sample_indices
    sides = {}
    for side in ("graph", "eager"):
        s_ts, s_bs, s_cs = copy.deepcopy((ts, bs, cstate))
        s_gen = torch.Generator(device="cuda")
        s_gen.set_state(gen.get_state())
        sides[side] = dict(ts=s_ts, bs=s_bs, cstate=s_cs, gen=s_gen, outs=[], stats=[])
    del ts, bs, cstate
    for side, sd in sides.items():
        # the sampled indices, logged on the device in order: a replay writes the next rows too
        log = torch.full((GRAPH_CALLS * GRAPH_K, BATCH), -1, dtype=torch.int64, device="cuda")
        row = torch.zeros((), dtype=torch.int64, device="cuda")

        def logging_sampler(*args, log=log, row=row):
            idx = sample_indices(*args)
            log.index_copy_(0, row.view(1), idx.unsqueeze(0))
            row.add_(1)
            return idx

        buffer.sample_indices = logging_sampler
        trainer = None
        if side == "graph":
            trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(
                batch_size=BATCH, collection_step_num_env_steps=T, verbose=False))
        before = counters.snapshot()
        for _ in range(GRAPH_CALLS):
            if trainer is None:
                out = coll.collect(sd["ts"], sd["cstate"], sd["bs"], sd["gen"], T)[2]
            else:
                out = trainer.collect_chunk(sd["ts"], sd["cstate"], sd["bs"], sd["gen"], T)
            sd["outs"].append(out.map(torch.clone))
        for _ in range(GRAPH_CALLS):
            if trainer is None:
                stats = [algo.update(sd["ts"], buffer, sd["bs"], sd["gen"], BATCH)[2] for _ in range(GRAPH_K)]
                stats = {k: torch.stack([s[k] for s in stats]) for k in stats[0].keys()}
            else:
                stats = trainer.update_burst(sd["ts"], sd["bs"], sd["gen"], GRAPH_K)
            sd["stats"].append({k: v.clone() for k, v in stats.items()})
        torch.cuda.synchronize()
        after = counters.snapshot()
        sd["launches"] = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        sd["idx"] = log
        if trainer is not None:
            sd["graphs"] = {g.name.split()[0]: (g.replays, g.capture_s) for g in trainer.graph_pool.graphs}
            sd["pool_mib"] = trainer.graph_pool.memory_bytes() / 2**20
    buffer.sample_indices = sample_indices
    torch.backends.cudnn.deterministic = deterministic

    eager = sides["eager"]
    if int((eager["idx"] < 0).sum()) != 0:
        raise AssertionError(f"graph phase {kind}: the eager loop sampled {int(eager['idx'][:, 0].ge(0).sum())} batches")
    sd, worst = sides["graph"], 0.0
    replays = {name: n for name, (n, _) in sd["graphs"].items()}
    expect = {"collect_chunk": GRAPH_CALLS - 1, "update_burst": GRAPH_CALLS - 1}
    if replays != expect:
        raise AssertionError(f"graph phase {kind}: replays {replays}, expected {expect}")
    if not torch.equal(sd["idx"], eager["idx"]):
        raise AssertionError(f"graph phase {kind}: sampled indices differ from eager")
    if torch.equal(sd["idx"][GRAPH_K:2 * GRAPH_K], sd["idx"][2 * GRAPH_K:]):
        raise AssertionError(f"graph phase {kind}: two replays drew the same indices")
    for call in range(GRAPH_CALLS):
        for k, v in eager["outs"][call].items():
            if not torch.equal(sd["outs"][call][k], v):
                raise AssertionError(f"graph phase {kind}: collect output {k} of call {call} differs")
        for k, v in eager["stats"][call].items():
            worst = max(worst, float((sd["stats"][call][k] - v).abs().max()))
    for a, b in ((sd["ts"].model, eager["ts"].model), (sd["ts"].target, eager["ts"].target)):
        for x, y in zip(a.state_dict().values(), b.state_dict().values()):
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    if not int(sd["ts"].step) == int(eager["ts"].step) == GRAPH_CALLS * GRAPH_K:
        raise AssertionError(f"graph phase {kind}: step {int(sd['ts'].step)}, eager {int(eager['ts'].step)}")
    sb, eb = sd["bs"], eager["bs"]
    pairs = [(sb.tree, eb.tree), (sb.max_prio, eb.max_prio), (sb.min_prio, eb.min_prio)] if prio else []
    sb, eb = (sb.base, eb.base) if prio else (sb, eb)
    pairs += [(sb.cursor, eb.cursor), (sb.size, eb.size), (sb.last_idx, eb.last_idx),
              *zip(sb.data.values(), eb.data.values()), *zip(_leaves(sd["cstate"]), _leaves(eager["cstate"]))]
    if not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f"graph phase {kind}: rings, sum tree or collect state differ from eager")
    if worst > GRAPH_ATOL:
        raise AssertionError(f"graph phase {kind}: losses or parameters differ by {worst:.3e} > {GRAPH_ATOL}")
    if sd["launches"] != eager["launches"]:
        raise AssertionError(f"graph phase {kind}: launches {sd['launches']}, eager {eager['launches']}")
    return [
        f"graph phase {kind}: " + adam_check(torch, algo.optim, list(sd["ts"].model.parameters())),
        f"graph phase {kind}, graphs against eager: {GRAPH_CALLS} collect chunks of T={T} and "
        f"{GRAPH_CALLS} x {GRAPH_K} updates; sampled indices, rings, collect state and output"
        f"{' and the sum tree' if prio else ''} bit-identical; losses, TD errors and parameters max |diff| "
        f"{worst:.3e} (tolerance {GRAPH_ATOL}); launches {sd['launches']} as eager; replays and capture s "
        f"{ {n: (r, round(c, 3)) for n, (r, c) in sd['graphs'].items()} }; pool {sd['pool_mib']:.1f} MiB"
    ]


def adam_check(torch, factory, params) -> str:
    """The optimizer ``factory`` builds for parameters on the card (capturable Adam), stepped
    ``ADAM_STEPS`` times through one CUDA graph (its first call eager, its second the capture),
    against what it builds for CPU copies of ``params`` (Adam as before the graphs), with the same
    gradients drawn from ``SEED``. Raises unless every parameter is within ``ADAM_ATOL`` and
    ``ADAM_SHARE`` of them within ``ADAM_CLOSE``; returns a report line."""
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    cuda = [torch.nn.Parameter(p.detach().float().clone()) for p in params]
    cpu = [torch.nn.Parameter(p.detach().float().cpu().clone()) for p in params]
    opt_cuda, opt_cpu = factory.create(cuda), factory.create(cpu)
    if not opt_cuda.defaults.get("capturable") or opt_cpu.defaults.get("capturable"):
        raise AssertionError("Adam: capturable must hold on the card's parameters and only there")
    gen = torch.Generator().manual_seed(SEED)
    for p in cuda:
        p.grad = torch.zeros_like(p)
    program = Graphed(lambda: factory.step(opt_cuda), GraphPool("cuda"), name="adam")
    for _ in range(ADAM_STEPS):
        grads = [torch.randn(p.shape, generator=gen) * 1e-2 for p in cpu]
        for p, g in zip(cuda, grads):
            p.grad.copy_(g)
        program()
        for p, g in zip(cpu, grads):
            p.grad = g
        factory.step(opt_cpu)
    diff = torch.cat([(a.detach().cpu() - b.detach()).abs().flatten() for a, b in zip(cuda, cpu)])
    moved = max(float((a.detach().cpu() - p.detach().float().cpu()).abs().max()) for a, p in zip(cpu, params))
    worst, close = float(diff.max()), float((diff <= ADAM_CLOSE).double().mean())
    if program.replays != ADAM_STEPS - 1 or moved == 0.0:
        raise AssertionError(f"Adam: {program.replays} replays, parameters moved by {moved}")
    if worst > ADAM_ATOL or close < ADAM_SHARE:
        raise AssertionError(f"Adam: capturable on the card against the CPU: max |diff| {worst:.3e} "
                             f"(tolerance {ADAM_ATOL}), {close:.5f} within {ADAM_CLOSE} (need {ADAM_SHARE})")
    return (f"capturable Adam on the card (one graph, {ADAM_STEPS} steps) against Adam on the CPU, "
            f"{diff.numel()} parameters: max |diff| {worst:.3e} (tolerance {ADAM_ATOL}), {close:.6f} within "
            f"{ADAM_CLOSE} (need {ADAM_SHARE}); largest move {moved:.3e}")


def _leaves(tree) -> list:
    from tianshou_tpu_torch.utils.tree import tree_map

    out = []
    tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# physics: the fused step kernel and the bench_physics_step paths
# ---------------------------------------------------------------------------
def physics_flops(model, contacts, limits, n_substeps: int) -> float:
    """Float32 operations (a multiply and an add count one each) of ``n_substeps`` substeps of
    the algorithm as ``csrc/physics_fused.cu`` writes it, summed over envs, with ``contacts`` and
    ``limits`` the per-env counts of active contact spheres and joint limits: recursive body
    kinematics, each body's composite inertia and wrench over its subtree, the mass matrix an
    entry at a time from them (where one dof lies below the other), two Cholesky factorizations
    with their right-hand sides (the first only with an active row),
    and the QP over the active rows (with its matrix up to 16 rows, without beyond). A sum that
    every lane repeats for itself (a column's pivot) is counted once."""
    from tianshou_tpu_torch.env.physics.model import FREE, SLIDE

    nq, nb, nl = model.nq, model.nbody, len(model.limit_q_idx)
    iters = int(model.contact_iterations)
    cross, point_accel, mv, mm = 9, 33, 15, 45

    below = [{b} for b in range(nb)]  # bodies of each body's subtree
    for b in range(nb - 1, 0, -1):
        if model.parent[b] >= 0:
            below[model.parent[b]] |= below[b]
    kin = 0.0
    sub = {}  # dof -> the bodies it moves
    for b in range(nb):
        joints = model.joints_of(b)
        if joints and joints[0].jtype == FREE:
            kin += 650 + 700 + 5 * mm  # second-order jet and first-order duals of the exp map, five vee(A B^T)
            for m in range(6):
                sub[joints[0].q_idx + m] = below[b]
        else:
            if model.parent[b] >= 0:
                kin += mv + mm + cross + point_accel + 9
            for j in joints:
                sub[j.q_idx] = below[b]
                kin += (mv + cross + point_accel + 33) if j.jtype == SLIDE else (
                    3 * mv + 3 * cross + 2 * point_accel + 2 * mm + 36 + 40 + 27)  # two products, Rodrigues, sincos
        kin += mv + cross + point_accel + 6  # origin -> centre of mass
    wrench = nb * (2 * mm + 2 * mv + 24 + (80 if model.fluid_density > 0 or model.fluid_viscosity > 0 else 0))
    composite = 48 * sum(len(v) for v in below)
    related = sum(1 for i in range(nq) for k in range(i + 1) if sub[i] <= sub[k] or sub[k] <= sub[i])
    mass_and_force = 70 * related + 24 * nq  # two twists, a momentum and a pairing per entry
    chol, solve = nq ** 3 / 3, nq * nq
    factor = chol + solve
    fixed = kin + wrench + composite + mass_and_force + factor + 2 * nq * nq + 2 * nq + solve + 2 * nq
    c, l = contacts.double(), limits.double()
    na = 4 * c + l
    fixed = fixed + (na > 0).double() * (factor + 2 * nq + nl * (solve + 5 * nq + 60))  # skipped when no row is active
    rows = c * (3 * (8 * nq + solve) + 2 * mv + 140 + 2 * nq + 8 * nq)
    per_iteration = na * (2 * na + 8) * (na <= 16).double() + na * (4 * nq + 8) * (na > 16).double()
    qp = na * na * 2 * nq + na * 2 * nq + iters * per_iteration + na * 2 * nq + solve
    per_env = fixed + rows + qp
    return float(per_env.sum()) * n_substeps


def _inside(torch, got, want):
    """Per env: both q and qd within the tolerances."""
    (q, qd), (rq, rqd) = got, want
    ok_q = (q - rq).abs() <= Q_TOL + Q_TOL * rq.abs()
    ok_qd = (qd - rqd).abs() <= QD_TOL + QD_TOL * rqd.abs()
    return ok_q.all(1) & ok_qd.all(1)


def _eager_ms(torch, fn, runs: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def physics_phase(torch, pf) -> tuple[list[dict], list[str]]:
    """The fused step kernel against the plain version on the card for every task, and its
    times beside the bound. Returns ([JSON record without launches], report lines); the record's
    numbers are HalfCheetah's at E = 2048 on a rollout state, the main path's shape."""
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.env.physics import dynamics

    lines, by_task = [], {}
    max_err = 0.0
    for task in PHYS_TASKS:
        env = make(task)
        model, fs = env.model, env.frame_skip
        n_sub = fs * dynamics.resolve_substeps(model, env.substeps)
        nu = len(model.actuators)
        g = torch.Generator(device="cuda").manual_seed(3)
        home = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")

        def near_home(E):
            q = home + 0.03 * torch.randn(E, model.nq, device="cuda", generator=g)
            qd = 0.05 * torch.randn(E, model.nq, device="cuda", generator=g)
            return q, qd, torch.rand(E, nu, device="cuda", generator=g) * 2 - 1

        def both(q, qd, ctrl):
            got = pf.fused_step(model, q, qd, ctrl, frame_skip=fs)
            want = pf.fused_step_reference(model, q, qd, ctrl, frame_skip=fs)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(x).all()) for x in (*got, *want)):
                raise AssertionError(f"physics_fused {task}: a non-finite output")
            return got, want, _inside(torch, got, want)

        # (a) near home: every env inside
        for E in ((PHYS_E, 6, PHYS_E + 5) if task == "HalfCheetah" else (PHYS_E,)):
            q, qd, ctrl = near_home(E)
            got, want, ok = both(q, qd, ctrl)
            err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
            max_err = max(max_err, err) if task == "HalfCheetah" else max_err
            if not bool(ok.all()):
                raise AssertionError(f"physics_fused {task} E={E} near home: {int((~ok).sum())} envs outside the tolerance")
            lines.append(f"physics_fused {task} E={E} near home: all envs inside q {Q_TOL} qd {QD_TOL}, "
                         f"max |dq| {float((got[0] - want[0]).abs().max()):.3e} max |dqd| {float((got[1] - want[1]).abs().max()):.3e}")
        if task == "Ant":  # rotation vectors beyond pi: the re-chart runs inside the kernel
            q, qd, ctrl = near_home(PHYS_E)
            axis = torch.randn(PHYS_E, 3, device="cuda", generator=g)
            norm = 3.0 + 0.6 * torch.rand(PHYS_E, 1, device="cuda", generator=g)
            q[:, 3:6] = axis / axis.norm(dim=1, keepdim=True) * norm
            q[:, 2] += 0.5
            got, want, ok = both(q.contiguous(), qd, ctrl)
            n_rechart = int(((got[0][:, 3:6] * q[:, 3:6]).sum(1) < 0).sum())  # r -> r (1 - 2 pi / |r|) flips r
            if not bool(ok.all()) or n_rechart == 0:
                raise AssertionError(f"physics_fused Ant re-chart: {int((~ok).sum())} envs outside, {n_rechart} re-charted")
            lines.append(f"physics_fused Ant E={PHYS_E} rotation vectors of norm 3.0-3.6: {n_rechart} envs re-charted, all inside")

        # (b) the kernel's own random-action rollout: one further step by both at some steps
        q, qd, ctrl = near_home(PHYS_E)
        timing_state = None
        for step in range(1, max(ROLLOUT_CHECKS) + 1):
            q, qd = pf.fused_step(model, q, qd, ctrl, frame_skip=fs)
            ctrl = torch.rand(PHYS_E, nu, device="cuda", generator=g) * 2 - 1
            if step in ROLLOUT_CHECKS:
                got, want, ok = both(q, qd, ctrl)
                share = float(ok.double().mean())
                contacts, limits = dynamics.active_rows(model, q)
                lines.append(
                    f"physics_fused {task} rollout step {step}: {int((~ok).sum())} of {PHYS_E} envs outside "
                    f"(share inside {share:.5f}), worst |dq| {float((got[0] - want[0]).abs().max()):.3e} "
                    f"|dqd| {float((got[1] - want[1]).abs().max()):.3e}, active contacts per env "
                    f"{float(contacts.double().mean()):.2f} limits {float(limits.double().mean()):.2f}")
                if share < MIN_SHARE_INSIDE:
                    raise AssertionError(f"physics_fused {task} rollout step {step}: only {share:.5f} of envs inside")
                if task == "HalfCheetah":
                    max_err = max(max_err, float((got[0] - want[0])[ok].abs().max()), float((got[1] - want[1])[ok].abs().max()))
                if step == 32:
                    timing_state = (q.clone(), qd.clone(), ctrl.clone())

        # times at the rollout state of step 32, beside the bound for that state's active rows
        tq, tqd, tc = timing_state
        count = pf.launch_count()
        runs = 30
        kern, kern_e = _time_ms(lambda: pf.fused_step(model, tq, tqd, tc, frame_skip=fs), warmup=2, runs=runs, per_graph=3)
        if pf.launch_count() == count:
            raise AssertionError("the timed fused_step calls did not launch the kernel")
        by_envs = {PHYS_E: kern}  # latency-bound if 32 envs cost what 2048 do, throughput-bound if 8448 cost 4x
        for n_envs in (32, 8448):
            reps = -(-n_envs // PHYS_E)
            sq, sqd, sc = (t.repeat(reps, 1)[:n_envs].contiguous() for t in (tq, tqd, tc))
            by_envs[n_envs] = _time_ms(lambda: pf.fused_step(model, sq, sqd, sc, frame_skip=fs), warmup=2, runs=8, per_graph=3)[0]
        plain_e = _eager_ms(torch, lambda: pf.fused_step_reference(model, tq, tqd, tc, frame_skip=fs))
        contacts, limits = dynamics.active_rows(model, tq)
        flops = physics_flops(model, contacts, limits, n_sub)
        by_ops = flops / H100_FP32_OPS_PER_S * 1e3
        by_bytes = PHYS_E * (4 * model.nq + nu) * 4 / H100_HBM_BYTES_PER_S * 1e3
        by_task[task] = {"ms": kern, "eager_ms": kern_e, "plain_ms": plain_e, "bound_ms": max(by_ops, by_bytes),
                         "bound_by": "operations" if by_ops >= by_bytes else "bytes", "gflop": flops / 1e9,
                         "substeps": n_sub, "ms_by_envs": {str(k): v for k, v in sorted(by_envs.items())},
                         **pf.kernel_info(model)}
        lines.append(
            f"physics_fused {task} E={PHYS_E} x {n_sub} substeps, ms per vector step: kernel {kern:.4f} (CUDA graph) "
            f"{kern_e:.4f} (eager); plain {plain_e:.2f} (eager); bound {max(by_ops, by_bytes):.5f} "
            f"({flops / 1e9:.3f} GFLOP at {H100_FP32_OPS_PER_S / 1e12:.0f} TFLOP/s; by bytes {by_bytes:.6f}); "
            f"kernel at {max(by_ops, by_bytes) / kern:.4f} of the bound's rate; kernel (CUDA graph) at E=32 "
            f"{by_envs[32]:.4f}, E=8448 {by_envs[8448]:.4f}")

    main = by_task["HalfCheetah"]
    record = {
        "name": "physics_fused", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/physics_fused.cu",
        "replaces": "tianshou_tpu/ops/pallas/physics_fused.py:67",
        "max_abs_err": max_err, "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None, "plain_timing": "eager", "by_task": by_task,
    }
    return [record], lines


def rollout_program(torch, venv, steps: int, gen, healthy_z: tuple[float, float] | None = None, checks: bool = False):
    """``bench.py:bench_physics_step`` in the port: ``(state, program, sums)``, where ``program()`` runs
    ``steps`` vector steps of ``venv`` from ``state`` (its reset state) with actions from
    ``action_space.sample`` and writes the last state back into ``state``, as ONE program, the
    counterpart of the bench's jitted scan, through the graph helper: its first call is its eager
    warm-up, the second its capture and first replay, later calls replay. With ``checks`` the program
    also accumulates on the device, in ``sums``: ``finite`` (every state, observation and reward so
    far), ``terminated`` (the count of terminated reports) and, with ``healthy_z``, ``wrong_term``
    (envs whose terminated flag disagrees with lo < z < hi). Without, ``sums`` is empty."""
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool
    from tianshou_tpu_torch.utils.tree import tree_map

    state, obs = tree_map(torch.clone, venv.reset(gen))
    sums = {}
    if checks:
        zero = torch.zeros((), dtype=torch.int64, device=obs.device)
        sums = {"finite": torch.isfinite(obs).all(), "terminated": zero.clone(), "wrong_term": zero.clone()}

    def rollout():
        s = state
        for _ in range(steps):
            out = venv.step(s, venv.action_space.sample(venv.num_envs, gen, venv.device), gen)
            s = out.state
            if checks:
                sums["finite"].logical_and_(torch.isfinite(s.q).all() & torch.isfinite(s.qd).all()
                                            & torch.isfinite(out.obs).all() & torch.isfinite(out.reward).all())
                sums["terminated"].add_(out.terminated.sum())
                if healthy_z is not None:
                    z = s.q[:, 2]
                    sums["wrong_term"].add_((out.terminated != ~((z > healthy_z[0]) & (z < healthy_z[1]))).sum())
        tree_map(torch.Tensor.copy_, state, s)
        return out

    return state, Graphed(rollout, GraphPool(venv.device), (gen,), name="rollout"), sums


def physics_path(torch, task: str, steps: int):
    """The physics path of ``task``: ``rollout_program`` called three times (eager warm-up, capture
    and first replay, replay, which is timed). Returns ({kernel: launches} over the three calls,
    report lines)."""
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree

    venv = VectorDeviceEnv(make(task), PHYS_E, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    # Ant-v4's healthy range: a terminated env is one outside 0.2 < z < 1.0
    state, program, sums = rollout_program(torch, venv, steps, gen, (0.2, 1.0) if task == "Ant" else None, checks=True)
    pool = program.pool
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = program()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = _launches(gather, sumtree, physics_fused)
    total = 3 * steps
    if launches != {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": total}:
        raise AssertionError(f"{task} physics path: kernel launches {launches} for {total} steps")
    if program.replays != 2 or program.launches != {"physics_fused": steps}:
        raise AssertionError(f"{task} physics path: {program.replays} replays of {program.launches}")
    if not bool(sums["finite"]):
        raise AssertionError(f"{task} physics path: a non-finite state, observation or reward")
    obs_dim = venv.observation_space.shape[0]
    if out.obs.shape != (PHYS_E, obs_dim) or out.obs.device.type != "cuda" or out.reward.shape != (PHYS_E,):
        raise AssertionError(f"{task} physics path: observation {tuple(out.obs.shape)} reward {tuple(out.reward.shape)}")
    if state.t.min().item() != total or state.t.max().item() != total:
        raise AssertionError(f"{task} physics path: t is {state.t.min().item()}..{state.t.max().item()}, expected {total}")
    if int(sums["wrong_term"]) != 0:
        raise AssertionError(f"{task} physics path: {int(sums['wrong_term'])} envs' terminated flag disagrees with 0.2 < z < 1.0")
    lines = [
        f"{task} physics path: E={PHYS_E} T={steps} x 3 calls (eager warm-up, capture + replay, replay) obs "
        f"{tuple(out.obs.shape)} physics_fused launches {launches['physics_fused']} (1 per vector step); graph replay: "
        f"env_steps_per_s {steps * PHYS_E / walls[2]:.1f} us_per_vector_step {walls[2] / steps * 1e6:.1f} (eager warm-up "
        f"{walls[0] / steps * 1e6:.1f}); {_graph_report(pool, 1)}; terminated reports {int(sums['terminated'])} mean reward last "
        f"step {float(out.reward.mean()):.4f}"
    ]
    return launches, lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 1
    from tianshou_tpu_torch.ops.kernels import _build, gather, physics_fused, sumtree

    # float32 matmuls and convolutions in full precision (the net computes in bf16)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    smi = _smi()
    print(f"device: {smi} ({torch.cuda.get_device_name(0)})", flush=True)
    t0 = time.perf_counter()
    libs = _build.build()  # every kernel and every model signature, one nvcc each, started together
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(libs)} libraries: {', '.join(lib.name for lib in libs)}", flush=True)
    # what ptxas says of each fused step kernel (registers, static shared memory, per-thread local memory:
    # its stack frame and spills), beside what the library says of its launch (lanes per env, dynamic shared memory)
    from tianshou_tpu_torch.env.mujoco import make
    models = {}  # library file name -> a model it steps
    for task in PHYS_TASKS:
        model = make(task).model
        models[_build._resolve(physics_fused.build_target(model))[1].name] = model
    for lib in libs:
        found = re.search(r"fused_step_kernel\S*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
                          r"\nptxas info\s*: Used (\d+) registers([^\n]*)", _build.build_logs.get(lib.name, ""))
        if found and lib.name in models:
            info = physics_fused.kernel_info(models[lib.name])
            static = re.search(r"(\d+) bytes smem", found[5])
            print(f"build: {lib.name}: TEAM {info['team']} lanes per env, {found[4]} registers, static shared memory "
                  f"{static[1] if static else 0} B, dynamic shared memory {info['shared_bytes_per_env']} B per env x "
                  f"{info['envs_per_block']} envs per block ({info['rows_in_shared']} QP rows in it, "
                  f"{info['scratch_floats_per_env'] * 4} B of global scratch per env for the rest), local memory per thread: "
                  f"{found[1]} B stack frame, {found[2]} B spill stores, {found[3]} B spill loads")

    records = []
    for phase, module in ((gather_phase, gather), (sumtree_phase, sumtree), (physics_phase, physics_fused)):
        t0 = time.perf_counter()
        recs, lines = phase(torch, module)
        names = " and ".join(r["name"] for r in recs)
        print("\n".join(lines), f"\n{names} kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)
        records += recs

    for kind in ("dqn", "rainbow"):
        t0 = time.perf_counter()
        lines = graph_phase(torch, kind)  # raises unless graphs and the eager loop agree
        print("\n".join(lines), f"\n{kind} graph phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)

    by_path = {}
    for kind, fused in (("dqn", False), ("rainbow", False), ("dqn", True)):
        t0 = time.perf_counter()
        name = f"{kind}_megastep" if fused else kind
        # raises unless every kernel ran as often as it must
        _, by_path[name], lines = main_path(torch, kind, fused)
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for task, steps in PHYS_PATHS:
        t0 = time.perf_counter()
        by_path[task.lower()], lines = physics_path(torch, task, steps)  # raises unless one launch per step
        print("\n".join(lines), f"\n{task} physics path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for record in records:
        record["launches_by_path"] = {kind: n[record["name"]] for kind, n in by_path.items()}
        record["launches"] = sum(record["launches_by_path"].values())
        if record["launches"] == 0:
            raise AssertionError(f"no path launched {record['name']}")

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
