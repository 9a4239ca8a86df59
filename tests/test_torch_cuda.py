"""Tests of the port's CUDA kernels that need the card; they skip without one.

This file imports only torch and the port (no JAX), so that it also runs on a
GPU machine without JAX, where the repo's ``tests/conftest.py`` (which imports
JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tianshou_tpu_torch.ops.kernels import gather as tg
from tianshou_tpu_torch.ops.kernels import sumtree as tsum
from tianshou_tpu_torch.ops.segtree import SegmentTree


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape,dtype,rows", [((4096, 7056), torch.uint8, 128), ((1024, 5), torch.float32, 300),
                                              ((513, 3), torch.uint8, 1000)])
def test_gather_rows_kernel_bit_exact_on_cuda(shape, dtype, rows, idx_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    if dtype == torch.uint8:
        src = torch.randint(0, 256, shape, dtype=dtype, device="cuda", generator=g)
    else:
        src = torch.randn(shape, dtype=dtype, device="cuda", generator=g)
    idx = torch.randint(-2, shape[0] + 2, (rows,), device="cuda", generator=g).to(idx_dtype)
    before = tg.launch_count()
    out = tg.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert tg.launch_count() == before + 1
    assert torch.equal(out, tg.gather_rows_reference(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("width", [16, 2032, 2064, 7056, 7057, 8192, 8208, 65536])
def test_gather_rows_widths_around_chunk_and_block_edges_on_cuda(width, idx_dtype):
    """Row widths around the 16-byte chunk, one chunk per thread (up to 4096 B) and two, the block's
    512 chunks, the main path's 7056 B, an unaligned width (byte path) and several blocks per row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(width)
    src = torch.randint(0, 256, (300, width), dtype=torch.uint8, device="cuda", generator=g)
    for rows in (1, 200, 3000):
        idx = torch.randint(-2, 302, (rows,), device="cuda", generator=g).to(idx_dtype)
        out = tg.gather_rows(src, idx)
        torch.cuda.synchronize()
        assert torch.equal(out, tg.gather_rows_reference(src, idx))
    off = src.reshape(-1)[1:1 + 299 * width].reshape(299, width)  # a base pointer off the 16-byte grid
    idx = torch.randint(0, 299, (64,), device="cuda", generator=g)
    assert torch.equal(tg.gather_rows(off, idx), off[idx])


@pytest.mark.cuda
@pytest.mark.parametrize("size,batch", [(131072, 32), (131072, 4096), (100000, 32), (16384, 257), (5, 64), (1, 7)])
def test_prefix_sum_idx_kernel_exact_on_cuda(size, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    st = SegmentTree(size)
    vals = torch.rand(size, device="cuda", generator=g)
    vals[torch.randint(0, size, (size // 4,), device="cuda", generator=g)] = 0.0  # zero-priority leaves
    # duplicate and dropped indices go through update's last-write-wins path
    idx = torch.cat([torch.arange(size, device="cuda"), torch.tensor([0, -1, size, 0], device="cuda")])
    tree = st.update(st.init("cuda"), idx, torch.cat([vals, torch.tensor([9.0, 9.0, 9.0, 0.5], device="cuda")]))
    total = st.total(tree)
    cum = torch.cumsum(tree[st.bound:st.bound + min(size, 64)], 0)  # values equal to a prefix sum go left
    q = torch.cat([torch.rand(batch, device="cuda", generator=g) * total, cum,
                   torch.stack([total, total * 2, total * 0, -total])])
    before = tsum.launch_count()
    out = st.get_prefix_sum_idx(tree, q)
    torch.cuda.synchronize()
    assert tsum.launch_count() == before + 1
    assert out.dtype == torch.int64 and out.device.type == "cuda"
    assert torch.equal(out, tsum.prefix_sum_idx_reference(tree, q, st.bound, st.depth, st.size))
    assert int(out.min()) >= 0 and int(out.max()) <= size - 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 1, 1), (0, 4, 3), (1, 3, 4), (2, 2, 4), (2, 6, 1), (3, 5, 7), (4, 8, 4),
                                   (5, 5, 4), (5, 7, 4), (5, 9, 32)])
def test_prefix_sum_idx_kernel_exact_for_any_launch_shape_on_cuda(shape):
    """(log2 lanes per query, levels per trip, warps per block): every split of the descent gives the same
    leaves, with ragged last warps and blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    for size in (131072, 100000, 5, 1):
        st = SegmentTree(size)
        tree = tsum.update_reference(st.init("cuda"), torch.arange(size, device="cuda"),
                                     torch.rand(size, device="cuda", generator=g), st.bound, st.depth, st.size)
        total = st.total(tree)
        cum = torch.cumsum(tree[st.bound:st.bound + min(size, 64)], 0)
        q = torch.cat([torch.rand(4099, device="cuda", generator=g) * total, cum, torch.stack([total, -total, total * 0])])
        out = tsum._descent(tree, q.contiguous(), st.bound, st.depth, st.size, shape)
        torch.cuda.synchronize()
        assert torch.equal(out, tsum.prefix_sum_idx_reference(tree, q, st.bound, st.depth, st.size)), size


def _update_cases_on_cuda(g):
    """(name, size, index, value) on the card: duplicates, -1 and out-of-range indices, k around the one-block
    size and above it (duplicates across chunks), zero priorities, an expanded (stride-0) value."""
    cases = [("[7, 7, -1, 7]", 131072, torch.tensor([7, 7, -1, 7]), torch.tensor([1.0, 2.0, 9.0, 4.0])),
             ("adjacent duplicates", 10, torch.tensor([4, 9, 9, 4, 4, 2, 2]), torch.arange(1.0, 8.0)),
             ("size 1", 1, torch.tensor([0, -1, 0, 1]), torch.tensor([1.0, 9.0, 2.5, 9.0]))]
    cases = [(n, s, i.cuda(), v.cuda()) for n, s, i, v in cases]
    for size, k in ((131072, 32), (131072, 256), (131072, 1024), (131072, 1025), (100000, 300000), (5, 40)):
        idx = torch.randint(-3, size + 3, (k,), device="cuda", generator=g)
        val = torch.rand(k, device="cuda", generator=g) * 5
        val[torch.rand(k, device="cuda", generator=g) < 0.2] = 0.0
        cases.append((f"size {size}, k {k}", size, idx, val))
    cases.append(("across chunks: a later chunk's write wins", 50, torch.arange(2100, device="cuda") % 50,
                  torch.rand(2100, device="cuda", generator=g)))
    cases.append(("expanded value", 131072, torch.randint(-1, 131072, (256,), device="cuda", generator=g),
                  torch.tensor(0.7, device="cuda").expand(256)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["empty", "filled"])
def test_tree_update_kernel_bit_exact_on_cuda(start):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    for name, size, index, value in _update_cases_on_cuda(g):
        st = SegmentTree(size)
        base = st.init("cuda")
        if start == "filled":
            tsum.update_reference(base, torch.arange(size, device="cuda"), torch.rand(size, device="cuda", generator=g),
                                  st.bound, st.depth, st.size)
        want = tsum.update_reference(base.clone(), index, value, st.bound, st.depth, st.size)
        before = tsum.update_launch_count()
        got = tsum.update(base.clone(), index, value, st.bound, st.depth, st.size)
        torch.cuda.synchronize()
        assert tsum.update_launch_count() == before + -(-index.shape[0] // tsum.ONE_BLOCK), name
        assert torch.equal(got, want), name
        assert torch.equal(got[1:st.bound], got[2::2] + got[3::2]) and got[0].item() == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 256, 1024])
def test_segtree_update_launches_the_kernel_once_on_cuda(k):
    """The training path's updates (32 and 256 leaves) are one launch and read nothing back to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(k)
    st = SegmentTree(131072)
    tree = st.init("cuda")
    index = torch.randint(-1, 131072, (k,), device="cuda", generator=g)
    value = torch.rand(k, device="cuda", generator=g)
    want = tsum.update_reference(tree.clone(), index, value, st.bound, st.depth, st.size)
    tsum.reset_launch_count()
    torch.cuda.set_sync_debug_mode("error")  # a host sync would raise
    try:
        out = st.update(tree, index, value)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out is tree
    assert (tsum.update_launch_count(), tsum.launch_count()) == (1, 0)
    assert torch.equal(tree, want)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["HalfCheetah", "Ant", "Hopper"])
@pytest.mark.parametrize("num_envs", [1, 6, 31, 33, 2053])  # a lone team, ragged warps and a ragged last block
def test_fused_step_kernel_matches_plain_version_on_cuda(task, num_envs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    env = make(task)
    model = env.model
    g = torch.Generator(device="cuda").manual_seed(0)
    home = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")
    q = home + 0.03 * torch.randn(num_envs, model.nq, device="cuda", generator=g)
    qd = 0.05 * torch.randn(num_envs, model.nq, device="cuda", generator=g)
    ctrl = torch.rand(num_envs, len(model.actuators), device="cuda", generator=g) * 2 - 1
    before = pf.launch_count()
    q_new, qd_new = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    torch.cuda.synchronize()
    assert pf.launch_count() == before + 1
    q_ref, qd_ref = pf.fused_step_reference(model, q, qd, ctrl, frame_skip=env.frame_skip)
    assert pf.launch_count() == before + 1  # the plain version launches nothing
    # the tolerances the JAX package holds its fused step to; near home every env is inside
    torch.testing.assert_close(q_new, q_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd_new, qd_ref, rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
def test_mujoco_env_step_launches_the_kernel_once_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    g = torch.Generator(device="cuda").manual_seed(0)
    outs = {}
    for mode in ("auto", "fused", "plain"):
        venv = VectorDeviceEnv(make("Hopper", physics_mode=mode), 64, device="cuda")
        g.manual_seed(0)
        state, _ = venv.reset(g)
        before = pf.launch_count()
        outs[mode] = venv.step(state, venv.action_space.sample(64, g, venv.device), g)
        assert pf.launch_count() == before + (mode != "plain")
    assert torch.equal(outs["auto"].state.q, outs["fused"].state.q)
    torch.testing.assert_close(outs["auto"].state.q, outs["plain"].state.q, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(outs["auto"].reward, outs["plain"].reward, rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("team", [4, 32])
def test_fused_step_kernel_gives_the_same_bits_for_any_team_size_on_cuda(team, monkeypatch):
    """Each element of each sum belongs to one lane in a fixed order, so the lanes per env do not show."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    env = make("Walker2d")
    model = env.model
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda") + 0.03 * torch.randn(257, model.nq, device="cuda", generator=g)
    qd = 0.05 * torch.randn(257, model.nq, device="cuda", generator=g)
    for _ in range(12):  # roll on until contacts and limits are active
        ctrl = torch.rand(257, len(model.actuators), device="cuda", generator=g) * 2 - 1
        q, qd = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    want = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    monkeypatch.setattr(pf, "_TEAM", team)
    got = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the trainer's programs as CUDA graphs (tianshou_tpu_torch/utils/graph.py)
# ---------------------------------------------------------------------------
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")


def _pixel_pipeline(kind: str, eps: float = 0.1):
    """A small pixel pipeline on the card: (algo, train state, buffer, buffer state, collector)."""
    from tianshou_tpu_torch.algorithm.modelfree.c51 import RainbowDQN
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env import core
    from tianshou_tpu_torch.env.wrappers import FrameStack
    from tianshou_tpu_torch.models.atari import DQNet, RainbowAtariNet

    hw, n_envs = 36, 8

    class Pix(core.Env):
        def __init__(self):
            self.observation_space = core.Box(0, 255, (hw, hw, 1))
            self.action_space = core.Discrete(4)

        def _obs(self, pos):
            row = torch.arange(hw, device=pos.device)[:, None]
            col = torch.arange(hw, device=pos.device)[None, :]
            return ((row * 7 + col * 13 + pos[:, None, None] * 3) % 251).to(torch.uint8)[..., None]

        def reset(self, num_envs, generator, device):
            z = torch.zeros(num_envs, dtype=torch.int32, device=device)
            return z, self._obs(z)

        def step(self, pos, a, generator):
            pos = pos + a.to(torch.int32) + 1
            done = torch.rand(pos.shape, generator=generator, device=pos.device) < 0.1
            return core.EnvStep(state=pos, obs=self._obs(pos), reward=(a == pos % 4).to(torch.float32),
                                terminated=done, truncated=torch.zeros_like(done), info=Batch())

    torch.manual_seed(0)
    kw = dict(action_space=core.Discrete(4), optim=AdamOptimizerFactory(lr=1e-3), gamma=0.9, n_step_return_horizon=3,
              target_update_freq=3, eps_training=eps)
    ring = dict(total_size=n_envs * 64, buffer_num=n_envs, stack_num=4, save_only_last_obs=True)
    if kind == "dqn":
        algo = DQN(model=DQNet(4, features=64, input_hw=(hw, hw)), **kw)
        buffer = VectorReplayBuffer(**ring)
    else:
        algo = RainbowDQN(model=RainbowAtariNet(4, 11, 64, input_hw=(hw, hw)), num_atoms=11, v_min=-2.0, v_max=2.0,
                          **kw)
        buffer = PrioritizedVectorReplayBuffer(alpha=0.6, beta=0.4, **ring)
    ts = algo.init("cuda")
    bs = buffer.init(Batch(obs=torch.zeros((hw, hw, 1), dtype=torch.uint8), act=torch.tensor(0), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False),
                           obs_next=torch.zeros((hw, hw, 1), dtype=torch.uint8)), device="cuda")
    coll = DeviceCollector(core.VectorDeviceEnv(FrameStack(Pix(), 4), n_envs, device="cuda"), algo, buffer)
    return algo, ts, buffer, bs, coll


def _trainer(algo, coll, buffer, **kw):
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    params = dict(max_epochs=1, epoch_num_steps=3 * 4 * 8, batch_size=16, collection_step_num_env_steps=4,
                  update_per_step=0.25, start_steps=4 * 8, verbose=False)
    params.update(kw)
    return OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(**params))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dqn", "rainbow"])
def test_graphed_programs_match_the_eager_loop_on_cuda(kind, monkeypatch):
    """Three collect chunks and three updates through the trainer's programs (eager warm-up,
    capture and replay, replay) against the same on a deep copy, eagerly: the same bits."""
    import copy

    _needs_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    algo, ts, buffer, bs, coll = _pixel_pipeline(kind)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cstate = coll.reset(gen)
    coll.collect(ts, cstate, bs, gen, 8, random=True)
    ets, ebs, ecs = copy.deepcopy((ts, bs, cstate))
    egen = torch.Generator(device="cuda")
    egen.set_state(gen.get_state())
    trainer = _trainer(algo, coll, buffer)
    for _ in range(3):
        out = trainer.collect_chunk(ts, cstate, bs, gen, 4).map(torch.clone)
        eout = coll.collect(ets, ecs, ebs, egen, 4)[2]
        assert all(torch.equal(out[k], eout[k]) for k in eout.keys())
    for _ in range(3):
        stats = trainer.update_burst(ts, bs, gen, 1).map(torch.clone)
        estats = algo.update(ets, buffer, ebs, egen, 16)[2]
        assert torch.equal(stats.loss[0], estats.loss) and torch.equal(stats.td_error[0], estats.td_error)
    torch.cuda.synchronize()
    assert all(g.replays == 2 for g in trainer.graph_pool.graphs)
    for a, b in zip(ts.model.state_dict().values(), ets.model.state_dict().values()):
        assert torch.equal(a, b)
    base, ebase = (bs.base, ebs.base) if kind == "rainbow" else (bs, ebs)
    assert all(torch.equal(x, y) for x, y in zip(base.data.values(), ebase.data.values()))
    assert torch.equal(base.cursor, ebase.cursor) and int(ts.step) == int(ets.step) == 3
    if kind == "rainbow":
        assert torch.equal(bs.tree, ebs.tree) and torch.equal(bs.max_prio, ebs.max_prio)


@pytest.mark.cuda
def test_launch_counters_count_device_launches_under_replay_on_cuda():
    _needs_cuda()
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    src = torch.arange(64 * 16, dtype=torch.float32, device="cuda").reshape(64, 16)
    idx = torch.tensor([3, 5, 7], device="cuda")
    out = torch.zeros(3, 16, device="cuda")

    def fn():
        out.copy_(tg.gather_rows(src, idx) + tg.gather_rows(src, idx.flip(0)))

    program = Graphed(fn, GraphPool("cuda"), name="two gathers")
    before = tg.launch_count()
    program()  # eager warm-up: two launches
    assert tg.launch_count() == before + 2 and program.graph is None
    program()  # capture (nothing launches) and one replay
    assert tg.launch_count() == before + 4 and program.launches == {"gather_rows": 2}
    out.zero_()
    program()
    torch.cuda.synchronize()
    assert tg.launch_count() == before + 6 and program.replays == 2
    assert torch.equal(out, src[idx] + src[idx.flip(0)])


_FAILING_CAPTURE = """
import torch
from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

x = torch.zeros(4, device="cuda")
capturing = []  # per call of fn: whether a capture traced it (else it ran eagerly)

def fn():
    capturing.append(torch.cuda.is_current_stream_capturing())
    x.add_(1)
    return float(x.sum())  # a host sync, which a capture refuses

program = Graphed(fn, GraphPool("cuda"), name="syncing")
assert program() == 4.0 and capturing == [False]  # the eager warm-up, where a host sync is allowed
for attempt in (1, 2):
    try:
        program()
    except RuntimeError as exc:
        assert "capturing syncing into a CUDA graph failed" in str(exc), exc
        print(f"attempt {attempt} raised: {str(exc).splitlines()[0]}")
    else:
        raise SystemExit("the capture did not raise")
    # after the warm-up fn ran only under a capture: nothing ran eagerly after the failure
    assert len(capturing) >= 2 and all(capturing[1:]), (attempt, capturing)
    assert program.graph is None and program.replays == 0, attempt
print("raised twice, ran nothing")
"""


@pytest.mark.cuda
def test_a_failing_capture_raises_and_never_runs_eagerly_on_cuda():
    """In a process of its own: a refused capture may leave the CUDA context unusable."""
    import os
    import subprocess
    import sys

    _needs_cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", _FAILING_CAPTURE], capture_output=True, text=True, timeout=300,
                          cwd=root, env={**os.environ, "PYTHONPATH": root})
    assert done.returncode == 0 and "raised twice, ran nothing" in done.stdout, done.stdout + done.stderr
    assert "attempt 2 raised" in done.stdout, done.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_a_second_run_replays_without_capturing_again_on_cuda(fused):
    _needs_cuda()
    algo, ts, buffer, bs, coll = _pixel_pipeline("rainbow")
    trainer = _trainer(algo, coll, buffer, fused_megastep=fused)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = trainer.run(ts, bs, gen)
    graphs = [(g, g.graph, g.capture_s, g.replays) for g in trainer.graph_pool.graphs]
    assert len(graphs) == (1 if fused else 2) and all(graph is not None for _, graph, _, _ in graphs)
    trainer.params.start_steps = 0
    res = trainer.run(res.train_state, res.buf_state, gen)
    assert [g for g, *_ in graphs] == trainer.graph_pool.graphs
    for g, graph, capture_s, replays in graphs:
        assert g.graph is graph and g.capture_s == capture_s and g.replays == replays + 3
    assert res.gradient_step == int(ts.step) == 6 * 8 and trainer.graph_pool.memory_bytes() > 0


@pytest.mark.cuda
def test_eps_schedule_reaches_the_graphed_collect_on_cuda():
    """eps is read from its device scalar by the captured collect: eps 1 after two greedy chunks
    makes the actions of later chunks differ from a greedy run's."""
    _needs_cuda()
    acts = []
    for schedule in (lambda epoch, step: {"eps_training": 0.0 if step < 3 * 4 * 8 else 1.0}, None):
        algo, ts, buffer, bs, coll = _pixel_pipeline("dqn", eps=0.0)
        trainer = _trainer(algo, coll, buffer, epoch_num_steps=4 * 4 * 8, train_fn=schedule, update_per_step=0.0)
        trainer.run(ts, bs, torch.Generator(device="cuda").manual_seed(0))
        assert trainer.graph_pool.graphs[0].replays == 3  # chunk 1 eager, then capture and replays
        acts.append(bs.data.act.clone())
    # slots 0-3 prefill, 4-11 the greedy chunks, 12-19 the chunks with eps 1 in the first run
    assert torch.equal(acts[0][:, :12], acts[1][:, :12]) and not torch.equal(acts[0][:, 12:20], acts[1][:, 12:20])


@pytest.mark.cuda
def test_sample_avail_route_replays_the_eager_draws_under_a_cuda_graph_on_cuda():
    """``sample_indices``' ``torch.multinomial`` route (``sample_avail`` with a frame stack) captures,
    and each replay draws what the eager calls draw."""
    _needs_cuda()
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    buf = VectorReplayBuffer(64 * 8, 8, stack_num=4, sample_avail=True)
    bs = buf.init(Batch(obs=torch.zeros(3), act=torch.tensor(0), rew=torch.tensor(0.0), terminated=torch.tensor(False),
                        truncated=torch.tensor(False)), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for t in range(20):
        buf.add(bs, Batch(obs=torch.full((8, 3), float(t), device="cuda"),
                          act=torch.zeros(8, dtype=torch.int64, device="cuda"), rew=torch.zeros(8, device="cuda"),
                          terminated=torch.rand(8, device="cuda", generator=g) < 0.2,
                          truncated=torch.zeros(8, dtype=torch.bool, device="cuda")))
    graphed, eager = torch.Generator(device="cuda").manual_seed(1), torch.Generator(device="cuda").manual_seed(1)
    program = Graphed(lambda: buf.sample_indices(bs, graphed, 32), GraphPool("cuda"), (graphed,), name="multinomial")
    got = [program().clone() for _ in range(3)]
    want = [buf.sample_indices(bs, eager, 32) for _ in range(3)]
    assert program.replays == 2 and not torch.equal(got[1], got[2])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(buf._avail_mask(bs)[got[2]].all())


@pytest.mark.cuda
@pytest.mark.parametrize("max_grad_norm", [None, 1.0])
def test_capturable_adam_under_a_graph_matches_the_cpu_adam_on_cuda(max_grad_norm):
    """The Adam that ``AdamOptimizerFactory`` builds for the card's parameters (``capturable``: step
    count and bias corrections on the device), eight steps through one CUDA graph, against the one
    it builds for the same parameters on the CPU, with the same gradients: within the tolerance of
    ``tests/test_torch_dqn.py::test_one_dqn_update_matches_jax`` (atol 2e-5, 99.9% within 2e-6)."""
    _needs_cuda()
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.atari import DQNet
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    torch.manual_seed(0)
    net = DQNet(4, features=64, input_hw=(36, 36))
    factory = AdamOptimizerFactory(lr=1e-3, max_grad_norm=max_grad_norm)
    cuda = [torch.nn.Parameter(p.detach().cuda()) for p in net.parameters()]
    cpu = [torch.nn.Parameter(p.detach().clone()) for p in net.parameters()]
    opt_cuda, opt_cpu = factory.create(cuda), factory.create(cpu)
    assert opt_cuda.defaults["capturable"] and not opt_cpu.defaults["capturable"]
    for p in cuda:
        p.grad = torch.zeros_like(p)
    program = Graphed(lambda: factory.step(opt_cuda), GraphPool("cuda"), name="adam")
    rng = np.random.default_rng(0)
    for _ in range(8):
        grads = [torch.from_numpy(rng.normal(0.0, 0.05, p.shape).astype(np.float32)) for p in cpu]
        for p, g in zip(cuda, grads):
            p.grad.copy_(g)
        program()
        for p, g in zip(cpu, grads):
            p.grad = g
        factory.step(opt_cpu)
    assert program.replays == 7
    for got, want, init in zip(cuda, cpu, net.parameters()):
        got, want = got.detach().cpu().numpy(), want.detach().numpy()
        assert not np.array_equal(want, init.detach().numpy())
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        assert np.mean(np.abs(got - want) <= 2e-6) >= 0.999
