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
   median of 60 runs after a warm-up.
4. DQN path: the DQN-on-pixels pipeline of ``bench.py``
   (``_build_atari_pipeline`` / ``bench_atari_cnn``) at its widths:
   ``FrameStack(SyntheticAtari(), 4)`` over 256 envs, a uint8 replay of
   256*512 frames per ring with ``stack_num=4`` and ``save_only_last_obs``,
   and ``DQN(DQNet(6))`` with n=3, gamma 0.99, target sync every 500 steps,
   eps 0.05 and Adam at lr 1e-4, trained by ``OffPolicyTrainer`` for a random
   prefill chunk plus three chunks of T=16 steps with update_per_step 0.1 and
   batch 32 (410 updates a chunk). Launch counters are zeroed just before
   and read just after; the gather kernel must run exactly twice per update.
5. Rainbow path: the same pixel pipeline with the two parts of the
   ``examples/atari/atari_rainbow.py`` configuration exchanged: a
   prioritized replay (``PrioritizedVectorReplayBuffer``, alpha 0.6, beta
   0.4, a sum tree of 131072 leaves) and ``RainbowDQN`` over the noisy
   dueling ``RainbowAtariNet(6, 51 atoms)`` with Adam at lr 6.25e-5, at the
   same depth. Counters are zeroed and read around it in the same way: the
   sum-tree kernel must run once and the gather kernel twice per update, the
   final tree must hold ``node = left + right`` exactly at every internal
   node, with zero leaves at never-written slots.

6. Physics kernel phase: for each of the six MuJoCo tasks at E = 2048 (HalfCheetah also at
   E = 6 and 2053) hold the fused step kernel against its plain version
   (``dynamics.step``): near-home states, every env within ``q`` rtol = atol = 2e-4 and ``qd``
   rtol = atol = 5e-3; states from the kernel's own random-action rollout at steps 16, 32 and
   64, at least 99.5% of envs within the same tolerances (a contact that sits on its activation
   threshold may differ) and every output finite; for Ant also rotation vectors beyond pi, so
   that the re-chart runs. Times: the kernel's device time from a replayed CUDA graph and its
   eager time; the plain version's eager time (its Cholesky calls are not captured in a graph);
   the bound by float32 operations counted for this run's active contact and limit rows.
7. Physics paths (``bench.py:bench_physics_step``): ``VectorDeviceEnv(HalfCheetah(), 2048)``,
   reset, 64 vector steps with actions from ``action_space.sample``; then Ant, 16 steps. One
   kernel launch per step exactly, every state, observation and reward finite.

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
    between two CUDA events, so that no host launch gap is counted. Eager
    time: CUDA events around one ordinary call, which includes the gap when
    the host launches slower than the device runs.
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
def gather_phase(torch, gather) -> tuple[dict, list[str]]:
    """Bit-exactness on the card at the main path's and edge-case shapes, timing at the
    main path's shape. Returns (JSON record without launches, report lines)."""
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
        bound = (2 * rows * row + idx.numel() * idx.element_size()) / H100_HBM_BYTES_PER_S * 1e3
        timings[rows] = (kern, plain, lib, bound)
        lines.append(
            f"gather_rows {rows} rows x {row} B, device us (CUDA graph): kernel {kern * 1e3:.3f} "
            f"plain {plain * 1e3:.3f} library(src[idx]) {lib * 1e3:.3f} bound {bound * 1e3:.3f}; "
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
    return record, lines


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


def sumtree_phase(torch, sumtree) -> tuple[dict, list[str]]:
    """Exact equality of the sum-tree descent kernel and its plain version on the card at the
    main path's and edge-case shapes, timing at the main path's shape (131072 leaves, 32
    stratified queries) and at 4096 queries. Returns (JSON record without launches, lines)."""
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
    kern, plain, bound, bound_by = timings[32]  # batch 32 on the main path
    record = {
        "name": "prefix_sum_idx", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/sumtree.cu",
        "replaces": "tianshou_tpu/ops/pallas/sumtree.py:63",
        "max_abs_err": max_err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None,
    }
    return record, lines


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


def main_path(torch, kind: str):
    """Train the pipeline of ``kind``; returns (result, {kernel: launches}, report lines)."""
    from tianshou_tpu_torch.data.buffer.prio import PrioState
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    algo, ts, buffer, buf_state, coll = build_pipeline(torch, kind)
    init_params = [p.detach().clone() for p in ts.model.parameters()]
    params = OffPolicyTrainerParams(
        max_epochs=1, epoch_num_steps=CHUNKS * T * E, batch_size=BATCH,
        collection_step_num_env_steps=T, update_per_step=0.1, start_steps=T * E, verbose=False,
    )
    trainer = OffPolicyTrainer(algo, coll, None, buffer, params)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res = trainer.run(ts, buf_state, gen)
    launches = {"gather_rows": gather.launch_count(), "prefix_sum_idx": sumtree.launch_count(),
                "physics_fused": physics_fused.launch_count()}

    lines = []
    ts, state = res.train_state, res.buf_state
    bs = state.base if isinstance(state, PrioState) else state
    tensors = [*ts.model.parameters(), *ts.target.parameters(), bs.cursor, bs.size, bs.last_idx,
               *bs.data.values()]
    if isinstance(state, PrioState):
        tensors += [state.tree, state.max_prio, state.min_prio]
    if not all(t.device.type == "cuda" for t in tensors):
        raise AssertionError(f"{kind} path: a tensor left the device")
    loss = res.last_chunk_stats.loss
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"{kind} path: non-finite loss in the last chunk: {loss}")
    if not all(bool(torch.isfinite(p).all()) for p in ts.model.parameters()):
        raise AssertionError(f"{kind} path: non-finite parameters after training")
    if all(torch.equal(a, b) for a, b in zip(init_params, ts.model.parameters())):
        raise AssertionError(f"{kind} path: training left the parameters unchanged")
    expect_updates = CHUNKS * max(1, round(0.1 * T * E))
    if res.gradient_step != expect_updates:
        raise AssertionError(f"{kind} path: {res.gradient_step} updates, expected {expect_updates}")
    if bs.size.min().item() != min(SLOTS, (CHUNKS + 1) * T):
        raise AssertionError(f"{kind} path: ring sizes {bs.size.min().item()}..{bs.size.max().item()} are off")
    expect = {"gather_rows": 2 * res.gradient_step,
              "prefix_sum_idx": res.gradient_step if isinstance(state, PrioState) else 0, "physics_fused": 0}
    if launches != expect:
        raise AssertionError(f"{kind} path: kernel launches {launches} for {res.gradient_step} updates, expected {expect}")
    train_s = res.timing["collect"] + res.timing["update"]
    lines.append(
        f"{kind} path: E={E} T={T} chunks={CHUNKS} updates={res.gradient_step} batch={BATCH} "
        f"ring uint8 {tuple(bs.data.obs.shape)} x2 ({bs.data.obs.numel() / 1e9:.3f} GB each)"
    )
    lines.append(
        f"{kind} path: env_steps_per_s {CHUNKS * T * E / train_s:.1f} ms_per_chunk {train_s / CHUNKS * 1e3:.1f} "
        f"(collect {res.timing['collect'] / CHUNKS * 1e3:.1f} ms, update {res.timing['update'] / CHUNKS * 1e3:.1f} ms "
        f"= {res.timing['update'] / res.gradient_step * 1e3:.3f} ms/update; prefill {res.timing['prefill'] * 1e3:.1f} ms) "
        f"loss_last_chunk_mean {float(loss.mean()):.5f} gather_launches {launches['gather_rows']} "
        f"sumtree_launches {launches['prefix_sum_idx']}"
    )
    if isinstance(state, PrioState):
        lines.append(f"{kind} path: " + _check_tree(torch, buffer, state, gen))
    return res, launches, lines



# ---------------------------------------------------------------------------
# physics: the fused step kernel and the bench_physics_step paths
# ---------------------------------------------------------------------------
def physics_flops(model, contacts, limits, n_substeps: int) -> float:
    """Float32 operations (a multiply and an add count one each) of ``n_substeps`` substeps of
    the algorithm as ``csrc/physics_fused.cu`` writes it, summed over envs, with ``contacts`` and
    ``limits`` the per-env counts of active contact spheres and joint limits."""
    from tianshou_tpu_torch.env.physics.model import FREE, SLIDE

    nq, nb, nl = model.nq, model.nbody, len(model.limit_q_idx)
    iters = int(model.contact_iterations)

    def fk(mul, add, mulc):  # cost of the FK template for a scalar type with these op costs
        total = 0.0
        for b in range(nb):
            joints = model.joints_of(b)
            if joints and joints[0].jtype == FREE:
                total += 50 * mul + 40 * add + 10 * mulc
            else:
                if model.parent[b] >= 0:
                    total += 36 * mulc + 27 * add
                for j in joints:
                    total += (9 * mulc + 9 * add + 3 * mul) if j.jtype == SLIDE else (36 * mul + 32 * mulc + 54 * add)
            total += 9 * mulc + 9 * add  # origin -> centre of mass
        return total

    fk_ops = fk(1 + 3 * nq, 1 + nq, 1 + nq) + fk(10, 3, 3)          # dual numbers, second-order jets
    body = nb * (51 * nq + 90 + 15 * nq + 13 * nq * (nq + 1) / 2 + 155 + 11 * nq)
    if model.fluid_density > 0 or model.fluid_viscosity > 0:
        body += 80 * nb
    chol, solve = nq ** 3 / 3, nq * nq
    integrate = 2 * nq * nq + chol + 2 * solve
    fixed = fk_ops + body + integrate + chol + solve + nl * (solve + 2 * nq + 40)
    c, l = contacts.double(), limits.double()
    na = 4 * c + l
    rows = c * (24 * nq + 3 * solve + 24 * nq + 40 + 40 + 2 * nq) + l * 3 * nq
    qp = na * (na + 1) / 2 * (2 * nq + 2) + iters * na * (4 * nq + 8) + na * 2 * nq + solve
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


def physics_phase(torch, pf) -> tuple[dict, list[str]]:
    """The fused step kernel against the plain version on the card for every task, and its
    times beside the bound. Returns (JSON record without launches, report lines); the record's
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
        runs = 8 if task == "Ant" else 30
        kern, kern_e = _time_ms(lambda: pf.fused_step(model, tq, tqd, tc, frame_skip=fs), warmup=2, runs=runs, per_graph=3)
        if pf.launch_count() == count:
            raise AssertionError("the timed fused_step calls did not launch the kernel")
        plain_e = _eager_ms(torch, lambda: pf.fused_step_reference(model, tq, tqd, tc, frame_skip=fs))
        contacts, limits = dynamics.active_rows(model, tq)
        flops = physics_flops(model, contacts, limits, n_sub)
        by_ops = flops / H100_FP32_OPS_PER_S * 1e3
        by_bytes = PHYS_E * (4 * model.nq + nu) * 4 / H100_HBM_BYTES_PER_S * 1e3
        by_task[task] = {"ms": kern, "eager_ms": kern_e, "plain_ms": plain_e, "bound_ms": max(by_ops, by_bytes),
                         "bound_by": "operations" if by_ops >= by_bytes else "bytes", "gflop": flops / 1e9,
                         "substeps": n_sub}
        lines.append(
            f"physics_fused {task} E={PHYS_E} x {n_sub} substeps, ms per vector step: kernel {kern:.4f} (CUDA graph) "
            f"{kern_e:.4f} (eager); plain {plain_e:.2f} (eager); bound {max(by_ops, by_bytes):.5f} "
            f"({flops / 1e9:.3f} GFLOP at {H100_FP32_OPS_PER_S / 1e12:.0f} TFLOP/s; by bytes {by_bytes:.6f}); "
            f"kernel at {max(by_ops, by_bytes) / kern:.4f} of the bound's rate")

    main = by_task["HalfCheetah"]
    record = {
        "name": "physics_fused", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/physics_fused.cu",
        "replaces": "tianshou_tpu/ops/pallas/physics_fused.py:67",
        "max_abs_err": max_err, "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None, "plain_timing": "eager", "by_task": by_task,
    }
    return record, lines


def physics_path(torch, task: str, steps: int):
    """``bench.py:bench_physics_step`` in the port: returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree

    venv = VectorDeviceEnv(make(task), PHYS_E, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    state, obs = venv.reset(gen)
    finite = torch.isfinite(obs).all()
    n_term = torch.zeros((), dtype=torch.int64, device="cuda")
    wrong_term = torch.zeros((), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        act = venv.action_space.sample(PHYS_E, gen, venv.device)
        out = venv.step(state, act, gen)
        state = out.state
        finite = finite & torch.isfinite(state.q).all() & torch.isfinite(state.qd).all() \
            & torch.isfinite(out.obs).all() & torch.isfinite(out.reward).all()
        n_term += out.terminated.sum()
        if task == "Ant":  # Ant-v4's healthy range: a terminated env is one outside 0.2 < z < 1.0
            z = state.q[:, 2]
            wrong_term += (out.terminated != ~((z > 0.2) & (z < 1.0))).sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gather_rows": gather.launch_count(), "prefix_sum_idx": sumtree.launch_count(),
                "physics_fused": physics_fused.launch_count()}
    if launches != {"gather_rows": 0, "prefix_sum_idx": 0, "physics_fused": steps}:
        raise AssertionError(f"{task} physics path: kernel launches {launches} for {steps} steps")
    if not bool(finite):
        raise AssertionError(f"{task} physics path: a non-finite state, observation or reward")
    obs_dim = venv.observation_space.shape[0]
    if out.obs.shape != (PHYS_E, obs_dim) or out.obs.device.type != "cuda" or out.reward.shape != (PHYS_E,):
        raise AssertionError(f"{task} physics path: observation {tuple(out.obs.shape)} reward {tuple(out.reward.shape)}")
    if state.t.min().item() != steps or state.t.max().item() != steps:
        raise AssertionError(f"{task} physics path: t is {state.t.min().item()}..{state.t.max().item()}, expected {steps}")
    if int(wrong_term) != 0:
        raise AssertionError(f"{task} physics path: {int(wrong_term)} envs' terminated flag disagrees with 0.2 < z < 1.0")
    lines = [
        f"{task} physics path: E={PHYS_E} T={steps} obs {tuple(out.obs.shape)} physics_fused launches {launches['physics_fused']} "
        f"(1 per vector step) env_steps_per_s {steps * PHYS_E / wall:.1f} us_per_vector_step {wall / steps * 1e6:.1f} "
        f"terminated reports {int(n_term)} mean reward last step {float(out.reward.mean()):.4f}"
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
    for lib in libs:  # what ptxas says of each fused step kernel: its registers and per-thread local memory
        found = re.search(r"fused_step_kernel\S*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
                          r"\nptxas info\s*: Used (\d+) registers", _build.build_logs.get(lib.name, ""))
        if found:
            print(f"build: {lib.name}: {found[4]} registers, {found[1]} bytes of local memory per thread (stack frame), "
                  f"{found[2]} bytes spill stores, {found[3]} bytes spill loads")

    records = []
    for phase, module in ((gather_phase, gather), (sumtree_phase, sumtree), (physics_phase, physics_fused)):
        t0 = time.perf_counter()
        record, lines = phase(torch, module)
        print("\n".join(lines), f"\n{record['name']} kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)
        records.append(record)

    by_path = {}
    for kind in ("dqn", "rainbow"):
        t0 = time.perf_counter()
        _, by_path[kind], lines = main_path(torch, kind)  # raises unless every kernel ran as often as it must
        print("\n".join(lines), f"\n{kind} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
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
