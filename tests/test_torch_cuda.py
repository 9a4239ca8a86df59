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
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


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
    buffer = VectorReplayBuffer(**ring)
    if kind == "dqn":
        algo = DQN(model=DQNet(4, features=64, input_hw=(hw, hw)), **kw)
    elif kind == "rainbow":
        algo = RainbowDQN(model=RainbowAtariNet(4, 11, 64, input_hw=(hw, hw)), num_atoms=11, v_min=-2.0, v_max=2.0,
                          **kw)
        buffer = PrioritizedVectorReplayBuffer(alpha=0.6, beta=0.4, **ring)
    elif kind == "iqn":
        from tianshou_tpu_torch.algorithm.modelfree.iqn import IQN
        from tianshou_tpu_torch.models.atari import ImplicitQuantileAtariNet

        algo = IQN(model=ImplicitQuantileAtariNet(4, 64, num_cosines=16, input_hw=(hw, hw)), sample_size=8,
                   online_sample_size=4, target_sample_size=6, **kw)
    else:
        from tianshou_tpu_torch.algorithm.modelfree.fqf import FQF
        from tianshou_tpu_torch.algorithm.optim import RMSpropOptimizerFactory
        from tianshou_tpu_torch.models.atari import ImplicitQuantileAtariNet

        algo = FQF(model=ImplicitQuantileAtariNet(4, 64, num_cosines=16, input_hw=(hw, hw)), num_fractions=8,
                   fraction_optim=RMSpropOptimizerFactory(lr=1e-3, alpha=0.9), **kw)
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
@pytest.mark.parametrize("kind", ["iqn", "fqf"])
def test_captured_quantile_update_matches_the_eager_update_on_cuda(kind, monkeypatch):
    """IQN's fractions (acting, target and loss) drawn from the generator the graphs registered, and FQF's two
    optimizers, through three collect chunks and three bursts of two updates: the same bits as eagerly."""
    import copy

    from tianshou_tpu_torch.algorithm.base import optimizer_tensors

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
        stats = trainer.update_burst(ts, bs, gen, 2).map(torch.clone)
        for i in range(2):
            estats = algo.update(ets, buffer, ebs, egen, 16)[2]
            assert all(torch.equal(stats[k][i], estats[k]) for k in estats.keys())
    torch.cuda.synchronize()
    assert all(g.replays == 2 for g in trainer.graph_pool.graphs)
    for a, b in zip(ts.model.state_dict().values(), ets.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(ts.target.state_dict().values(), ets.target.state_dict().values()):
        assert torch.equal(a, b)
    opts, eopts = (ts.optim, ets.optim) if kind == "fqf" else ({"model": ts.optim}, {"model": ets.optim})
    for k in opts:
        assert all(torch.equal(a, b) for a, b in zip(optimizer_tensors(opts[k]), optimizer_tensors(eopts[k])))
    assert int(ts.step) == int(ets.step) == 6


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


def _cartpole_trainer(**kw):
    """DQN over Net on CartPole on the card, with a test collector (the configuration of
    tests/test_dqn.py at a small depth)."""
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.mlp import Net
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    torch.manual_seed(0)
    env = CartPole()
    algo = DQN(model=Net((64, 64), 2, input_dim=4), action_space=env.action_space,
               optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=3, target_update_freq=320,
               eps_training=0.3, eps_inference=0.05)
    buffer = VectorReplayBuffer(2000, 10)
    bs = buffer.init(Batch(obs=torch.zeros(4), act=torch.tensor(0), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False), obs_next=torch.zeros(4)),
                     device="cuda")
    hooked = []
    train_c = DeviceCollector(VectorDeviceEnv(env, 10, device="cuda"), algo, buffer,
                              on_episode_done_hook=lambda s: hooked.append(s.n_collected_episodes))
    test_c = DeviceCollector(VectorDeviceEnv(env, 10, device="cuda"), algo, None)
    params = dict(max_epochs=2, epoch_num_steps=500, test_step_num_episodes=10, batch_size=64,
                  collection_step_num_env_steps=10, update_per_step=0.1, start_steps=200, verbose=False)
    params.update(kw)
    trainer = OffPolicyTrainer(algo, train_c, test_c, buffer, OffPolicyTrainerParams(**params))
    return trainer, algo.init("cuda"), bs, hooked


@pytest.mark.cuda
def test_test_chunk_graph_matches_the_eager_chunk_on_cuda():
    """The test collector's chunk through the trainer's program (eager warm-up, capture and replay,
    replay) against the same chunk eagerly, from one generator state and one reset: the same bits."""
    _needs_cuda()
    trainer, ts, _, _ = _cartpole_trainer()
    tc = trainer.test_collector
    sides = []
    for graphed in (True, False):
        gen = torch.Generator(device="cuda").manual_seed(3)
        state = tc.reset_episodes(gen, 10)
        calls = []
        for _ in range(3):
            out = trainer.test_chunk(ts, state, gen, 32) if graphed else tc.episode_chunk(ts, state, gen, 32)
            calls.append((out.map(torch.clone), state.active.clone(), state.n_done.clone()))
        sides.append(calls)
    torch.cuda.synchronize()
    for (out, active, n_done), (eout, eactive, en_done) in zip(*sides):
        assert all(torch.equal(out[k], eout[k]) for k in ("done", "ep_ret", "ep_len"))
        assert torch.equal(active, eactive) and torch.equal(n_done, en_done)
    assert int(sides[0][-1][2]) > 0 and trainer.graph_pool.graphs[0].replays == 2


@pytest.mark.cuda
def test_test_phase_hooks_and_test_fn_under_graphs_on_cuda():
    """Under the graphs: the train collector's hook once per collect chunk, ten test episodes per
    epoch, and test_fn's overrides gone after each test phase."""
    _needs_cuda()
    tests = []
    trainer, ts, bs, hooked = _cartpole_trainer(
        train_fn=lambda epoch, step: {"eps_training": 0.2},
        test_fn=lambda epoch, step: {"eps_training": 0.9, "eps_inference": 0.5},
        compute_score_fn=lambda s: (tests.append(s), float(s.returns.mean()))[1])
    res = trainer.run(ts, bs, torch.Generator(device="cuda").manual_seed(0))
    assert len(hooked) == res.env_step // 100 == 12
    assert [s.n_collected_episodes for s in tests] == [10, 10]
    names = sorted(g.name.split()[0] for g in trainer.graph_pool.graphs)
    assert names == ["collect_chunk", "test_chunk", "update_burst"]
    assert float(ts.hparams["eps_training"]) == pytest.approx(0.2)
    assert float(ts.hparams["eps_inference"]) == pytest.approx(0.05)
    assert np.isfinite(res.best_reward) and res.timing["test"] > 0


# ---------------------------------------------------------------------------
# the on-policy family under CUDA graphs
# ---------------------------------------------------------------------------
def _ppo_cartpole(**kw):
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, linear_lr_schedule
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.wrappers import NormObs
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic

    torch.manual_seed(0)
    algo = PPO(actor=DiscreteActor((32, 32), 2, input_dim=4), critic=DiscreteCritic((32, 32), input_dim=4),
               action_space=CartPole().action_space,
               optim=AdamOptimizerFactory(lr=linear_lr_schedule(1e-3, 50), max_grad_norm=0.5), **kw)
    coll = DeviceCollector(VectorDeviceEnv(NormObs(CartPole()), 8, device="cuda"), algo, None)
    return algo, algo.init("cuda"), coll


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"target_kl": 1e-6, "recompute_advantage": True, "return_standardization": True}],
                         ids=["ppo", "ppo_kl_guard_recompute"])
def test_onpolicy_programs_match_the_eager_calls_on_cuda(kw):
    """Three rollouts and their updates through ``OnPolicyTrainer``'s programs (the collect chunk:
    eager, capture and replay, replay; the update: eager twice, as the collect's capture replaces its
    output, then capture and replay) against ``collector.rollout`` and ``algo.update_rollout`` on a
    deep copy: rollouts, statistics and step counters bit-identical, weights within 1e-6."""
    import copy

    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    _needs_cuda()
    algo, ts, coll = _ppo_cartpole(**kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cstate = coll.reset(gen)
    ets, ecs = copy.deepcopy((ts, cstate))
    egen = torch.Generator(device="cuda")
    egen.set_state(gen.get_state())
    trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(
        batch_size=32, collection_step_num_env_steps=16, update_step_num_repetitions=2, verbose=False))
    for _ in range(3):
        out = trainer.collect_chunk(ts, cstate, None, gen, 16, keep_rollout=True)
        stats = trainer.update_rollout(ts, out.rollout, gen).map(torch.clone)
        eout = coll.rollout(ets, ecs, None, egen, 16, keep_rollout=True)
        estats = algo.update_rollout(ets, eout.rollout, egen, 2, 32)[1]
        for k in ("obs", "act", "rew", "terminated", "truncated", "obs_next"):
            assert torch.equal(out.rollout[k], eout.rollout[k]), k
        assert torch.equal(stats.loss, estats.loss) and int(ts.step) == int(ets.step)
    torch.cuda.synchronize()
    assert {g.name.split()[0]: g.replays for g in trainer.graph_pool.graphs} == {"collect_chunk": 2, "update_rollout": 1}
    assert all(torch.equal(a, b) for a, b in zip(cstate.env_state.rms, ecs.env_state.rms))
    for a, b in zip(ts.model.parameters(), ets.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    lr = ts.optim.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and lr.is_cuda and torch.equal(lr, ets.optim.param_groups[0]["lr"])
    if "target_kl" in kw:
        assert 0 < int(ts.step) < 3 * 2 * 4 and float(stats.kl_stop) > 0


@pytest.mark.cuda
def test_scheduled_adam_under_a_graph_matches_the_cpu_adam_on_cuda():
    """Capturable Adam with ``linear_lr_schedule`` on the card, six steps through one graph, against
    the CPU's: the rate (a 0-d device tensor rewritten in place) equal to the schedule's at each
    count, and the weights within 2e-6."""
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, linear_lr_schedule
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    _needs_cuda()
    sched = linear_lr_schedule(0.01, 4)
    factory = AdamOptimizerFactory(lr=sched, max_grad_norm=1.0)
    w = torch.randn(7, 5, generator=torch.Generator().manual_seed(0))
    cuda, cpu = torch.nn.Parameter(w.cuda()), torch.nn.Parameter(w.clone())
    opt_cuda, opt_cpu = factory.create([cuda]), factory.create([cpu])
    cuda.grad = torch.zeros_like(cuda)
    program = Graphed(lambda: factory.step(opt_cuda), GraphPool("cuda"), name="adam")
    rates = []
    for i in range(6):
        g = torch.randn(7, 5, generator=torch.Generator().manual_seed(i + 1))
        cuda.grad.copy_(g)
        program()
        rates.append(opt_cuda.param_groups[0]["lr"].item())
        cpu.grad = g
        factory.step(opt_cpu)
    assert program.replays == 5
    assert rates == [float(sched(torch.tensor(float(c)))) for c in range(6)]
    torch.testing.assert_close(cuda.detach().cpu(), cpu.detach(), rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_policy_draws_under_a_graph_replay_the_eager_draws_on_cuda():
    """``Categorical.sample``, ``Normal.sample`` and ``minibatch_indices`` captured and replayed draw
    what the same eager calls draw from a generator in the same state."""
    from tianshou_tpu_torch.models.distributions import Categorical, Normal
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    _needs_cuda()
    algo = _ppo_cartpole()[0]
    logits = torch.randn(256, 5, device="cuda")
    loc, scale = torch.randn(256, 6, device="cuda"), torch.rand(256, 6, device="cuda") + 0.1

    def draws(gen):
        return (Categorical(logits).sample(gen), Normal(loc, scale).sample(gen),
                algo.minibatch_indices(1000, 3, 64, gen, torch.device("cuda")))

    graphed, eager = torch.Generator(device="cuda").manual_seed(3), torch.Generator(device="cuda").manual_seed(3)
    program = Graphed(lambda: draws(graphed), GraphPool("cuda"), (graphed,), name="draws")
    got = [tuple(x.clone() for x in program()) for _ in range(3)]
    want = [draws(eager) for _ in range(3)]
    assert program.replays == 2 and not torch.equal(got[1][2], got[2][2])
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    perm = got[2][2]
    assert perm.shape == (3, 15, 66) and all(len(set(perm[r].flatten().tolist())) == 990 for r in range(3))


@pytest.mark.cuda
def test_ppo_physics_megastep_launches_the_kernel_once_per_step_on_cuda():
    """A PPO megastep on ``NormObs(HalfCheetah())`` (collect with ``keep_rollout`` and then
    ``update_rollout``) as one graph: one ``physics_fused`` launch per vector step under replay,
    each env's count advanced by one per step, finite weights."""
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.env.wrappers import NormObs
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
    from tianshou_tpu_torch.ops.kernels import physics_fused
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    _needs_cuda()
    env = NormObs(make("HalfCheetah"))
    algo = PPO(actor=ContinuousActorProbabilistic((64, 64), 6, input_dim=17),
               critic=ContinuousCritic((64, 64), use_action=False, input_dim=17), action_space=env.action_space,
               return_standardization=True, value_clip=True)
    ts = algo.init("cuda")
    coll = DeviceCollector(VectorDeviceEnv(env, 128, device="cuda"), algo, None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cstate = coll.reset(gen)

    def megastep():
        out = coll.rollout(ts, cstate, None, gen, 8, keep_rollout=True)
        return algo.update_rollout(ts, out.rollout, gen, 2, 256)[1]

    program = Graphed(megastep, GraphPool("cuda"), (gen,), name="ppo")
    program()
    physics_fused.reset_launch_count()
    program(), program()
    torch.cuda.synchronize()
    assert physics_fused.launch_count() == 16 and program.launches == {"physics_fused": 8}
    count = torch.full((128,), 1e-4, device="cuda") + 1.0  # the reset's observation, then one per step
    for _ in range(24):
        count = count + 1.0
    assert torch.equal(cstate.env_state.rms.count, count)
    assert int(ts.step) == 3 * 2 * 4
    assert all(bool(torch.isfinite(p).all()) for p in ts.model.parameters())


# ---------------------------------------------------------------------------
# continuous off-policy: delayed updates and draws under a graph
# ---------------------------------------------------------------------------
def _pendulum_offpolicy(kind: str, prio: bool = False):
    """TD3 or REDQ on Pendulum on the card, small nets, a buffer after a random prefill:
    (algo, train state, buffer, buffer state, generator)."""
    from tianshou_tpu_torch.algorithm.modelfree.redq import REDQ
    from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.pendulum import Pendulum
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.continuous import (
        ContinuousActorDeterministic,
        ContinuousActorProbabilistic,
        ContinuousCritic,
        EnsembleCritic,
    )

    torch.manual_seed(0)
    env = Pendulum()
    if kind == "td3":
        algo = TD3(actor=ContinuousActorDeterministic((32, 32), 1, input_dim=3),
                   critic=ContinuousCritic((32, 32), input_dim=3, action_dim=1), action_space=env.action_space)
    else:
        algo = REDQ(actor=ContinuousActorProbabilistic((32, 32), 1, conditioned_sigma=True, input_dim=3),
                    critic=EnsembleCritic(10, (32, 32), input_dim=3, action_dim=1), action_space=env.action_space,
                    actor_delay=2)
    buffer = (PrioritizedVectorReplayBuffer(256, 8) if prio else VectorReplayBuffer(256, 8))
    bs = buffer.init(Batch(obs=torch.zeros(3), act=torch.zeros(1), rew=torch.tensor(0.0), terminated=torch.tensor(False),
                           truncated=torch.tensor(False), obs_next=torch.zeros(3)), device="cuda")
    ts = algo.init("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    coll = DeviceCollector(VectorDeviceEnv(env, 8, device="cuda"), algo, buffer)
    coll.collect(ts, coll.reset(gen), bs, gen, 16, random=True)
    return algo, ts, buffer, bs, gen


def _offpolicy_tensors(ts, bs) -> list:
    from tianshou_tpu_torch.algorithm.base import optimizer_tensors

    out = [*ts.model.parameters(), *ts.target.parameters(), ts.step]
    for opt in ts.optim.values():
        out += optimizer_tensors(opt)
    if hasattr(bs, "tree"):
        out += [bs.tree, bs.max_prio, bs.min_prio]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind,prio", [("td3", True), ("redq", False)])
def test_delayed_actor_updates_under_a_graph_match_eager_on_both_branches_on_cuda(kind, prio):
    """Four updates as one captured program (eager warm-up, capture and replay, two replays: steps
    0-3, both sides of TD3's delay of 2 and REDQ's ``actor_delay`` 2) against the same four updates
    eagerly on a deep copy: every weight, target, Adam state and (PER) the sum tree bit-identical
    after each update; the actor and its Adam state (REDQ: and ``log_alpha``) unchanged by each
    delayed step and changed by the others."""
    import copy

    from tianshou_tpu_torch.algorithm.base import optimizer_tensors
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    _needs_cuda()
    algo, ts, buffer, bs, gen = _pendulum_offpolicy(kind, prio)
    ets, ebs = copy.deepcopy((ts, bs))
    egen = torch.Generator(device="cuda")
    egen.set_state(gen.get_state())
    program = Graphed(lambda: algo.update(ts, buffer, bs, gen, 32)[2], GraphPool("cuda"), (gen,), name="update")
    delayed = ["actor", "log_alpha"] if kind == "redq" else ["actor"]
    for step in range(4):
        before = [t.clone() for k in delayed for t in optimizer_tensors(ets.optim[k])]
        stats = program()
        estats = algo.update(ets, buffer, ebs, egen, 32)[2]
        torch.cuda.synchronize()
        assert all(torch.equal(stats[k], estats[k]) for k in estats.keys()), step
        assert all(torch.equal(a, b) for a, b in zip(_offpolicy_tensors(ts, bs), _offpolicy_tensors(ets, ebs))), step
        after = [t for k in delayed for t in optimizer_tensors(ets.optim[k])]
        unchanged = all(torch.equal(a, b) for a, b in zip(before, after))
        assert unchanged == (step % 2 == 1), step
    assert program.replays == 3 and int(ts.step) == 4


@pytest.mark.cuda
def test_redq_subset_is_drawn_fresh_on_every_replay_as_eager_on_cuda(monkeypatch):
    """REDQ's target subset, captured in a graph, is drawn anew by every replay, and each is the
    subset that the same updates run eagerly (a deep copy, a generator in the same state) draw."""
    import copy

    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    _needs_cuda()
    algo, ts, buffer, bs, gen = _pendulum_offpolicy("redq")
    ets, ebs = copy.deepcopy((ts, bs))
    egen = torch.Generator(device="cuda")
    egen.set_state(gen.get_state())
    draw = algo._subset
    logs = {side: torch.full((6, 2), -1, dtype=torch.int64, device="cuda") for side in ("graph", "eager")}
    rows = {side: torch.zeros((), dtype=torch.int64, device="cuda") for side in logs}
    side = ["graph"]

    def logged(*args):
        out = draw(*args)
        logs[side[0]].index_copy_(0, rows[side[0]].view(1), out.unsqueeze(0))
        rows[side[0]].add_(1)
        return out

    monkeypatch.setattr(algo, "_subset", logged)
    program = Graphed(lambda: algo.update(ts, buffer, bs, gen, 32)[2], GraphPool("cuda"), (gen,), name="update")
    for _ in range(6):
        program()
    side[0] = "eager"
    for _ in range(6):
        algo.update(ets, buffer, ebs, egen, 32)
    torch.cuda.synchronize()
    graphed = logs["graph"].tolist()
    assert program.replays == 5 and int(rows["graph"]) == int(rows["eager"]) == 6
    assert torch.equal(logs["graph"], logs["eager"])
    assert len({tuple(r) for r in graphed[1:]}) > 1  # the replays drew different subsets
    assert all(len(set(r)) == 2 and all(0 <= i < 10 for i in r) for r in graphed)


@pytest.mark.cuda
def test_capturable_adam_on_the_0d_log_alpha_matches_the_cpu_adam_on_cuda():
    """SAC's alpha optimizer on a 0-d ``log_alpha`` on the card (capturable Adam), eight steps
    through one graph, against the same factory's Adam on the CPU with the same gradients: within
    2e-5 (the one-update rule of ``tests/test_torch_dqn.py``)."""
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, init_adam_state
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    _needs_cuda()
    factory = AdamOptimizerFactory(lr=3e-4)
    cuda, cpu = torch.nn.Parameter(torch.zeros((), device="cuda")), torch.nn.Parameter(torch.zeros(()))
    opt_cuda, opt_cpu = factory.create([cuda]), factory.create([cpu])
    init_adam_state(opt_cuda)
    assert opt_cuda.defaults["capturable"] and opt_cuda.state[cuda]["step"].device.type == "cuda"
    cuda.grad = torch.zeros_like(cuda)
    program = Graphed(lambda: factory.step(opt_cuda), GraphPool("cuda"), name="alpha_adam")
    rng = np.random.default_rng(0)
    for _ in range(8):
        g = float(rng.normal(0.0, 2.0))
        cuda.grad.fill_(g)
        program()
        cpu.grad = torch.tensor(g)
        factory.step(opt_cpu)
    assert program.replays == 7 and cuda.shape == ()
    assert float(cpu.detach()) != 0.0
    assert abs(float(cuda.detach().cpu()) - float(cpu.detach())) <= 2e-5
    assert int(opt_cuda.state[cuda]["step"]) == int(opt_cpu.state[cpu]["step"]) == 8


def _pendulum_onpolicy(kind: str, n_envs: int = 8):
    """(algo, train state, collector) of NPG, TRPO or PPO+gSDE on Pendulum at small widths on the card."""
    from tianshou_tpu_torch.algorithm.modelfree.npg import NPG
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.modelfree.trpo import TRPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.pendulum import Pendulum
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    torch.manual_seed(0)
    env = Pendulum()
    sde = kind == "ppo_sde"
    actor = ContinuousActorProbabilistic((32, 32), 1, ppo_init=True, sde=sde, sigma_init=-1.0, input_dim=3)
    critic = ContinuousCritic((32, 32), use_action=False, ppo_init=True, input_dim=3)
    # NPG's fixed step at 0.1 (its default 0.5 can leave the KL's quadratic region on 256 Pendulum rows)
    cls, kw = {"npg": (NPG, dict(optim_critic_iters=4, trust_region_size=0.1)),
               "trpo": (TRPO, dict(optim_critic_iters=4, max_kl=0.01)),
               "ppo_sde": (PPO, dict(sde_sample_freq=3))}[kind]
    algo = cls(actor=actor, critic=critic, action_space=env.action_space, optim=AdamOptimizerFactory(lr=1e-3), **kw)
    return algo, algo.init("cuda"), DeviceCollector(VectorDeviceEnv(env, n_envs, device="cuda"), algo, None)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["npg", "trpo"])
def test_trust_region_update_graph_matches_eager_on_cuda(kind):
    """``update_rollout`` of NPG and TRPO (conjugate gradient by double backward, TRPO's line search
    by select) as a CUDA graph, replayed on three rollouts of 256 rows (two minibatches each), against
    the eager call on a deep copy: weights, the critic's Adam state and count and the stats
    (``step_frac`` and ``accepted`` too) finite and bit-identical."""
    import copy

    from tianshou_tpu_torch.algorithm.base import optimizer_tensors
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    _needs_cuda()
    algo, ts, coll = _pendulum_onpolicy(kind)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cstate = coll.reset(gen)
    rollouts = [coll.rollout(ts, cstate, None, gen, 32, keep_rollout=True).rollout.map(torch.clone) for _ in range(3)]
    ets = copy.deepcopy(ts)
    held = rollouts[0].map(torch.clone)
    ggen, egen = torch.Generator(device="cuda").manual_seed(1), torch.Generator(device="cuda").manual_seed(1)
    program = Graphed(lambda: algo.update_rollout(ts, held, ggen, 1, 128)[1], GraphPool("cuda"), (ggen,), name=kind)
    for roll in rollouts:
        for k in roll.keys():
            held[k].copy_(roll[k])
        stats = program().map(torch.clone)
        estats = algo.update_rollout(ets, roll, egen, 1, 128)[1]
        for k in estats.keys():
            assert bool(torch.isfinite(estats[k]).all()) and torch.equal(stats[k], estats[k]), k
    torch.cuda.synchronize()
    assert program.replays == 2
    for a, b in zip(optimizer_tensors(ts.optim), optimizer_tensors(ets.optim)):
        assert torch.equal(a, b)
    assert int(ts.step) == int(ets.step) == 3 * 2
    if kind == "trpo":
        assert 0.0 < float(stats.step_frac) <= 1.0 and float(stats.accepted) == 1.0


@pytest.mark.cuda
def test_sde_collect_chunk_graph_matches_eager_on_cuda():
    """A PPO+gSDE collect chunk (the per-chunk refresh, fresh noise every step, the reset where an
    episode ends) as a CUDA graph against the eager chunk on a deep copy: rollouts, the carried noise
    and counts bit-identical over three chunks of 250 steps (Pendulum ends its episodes at 200)."""
    import copy

    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    _needs_cuda()
    algo, ts, coll = _pendulum_onpolicy("ppo_sde")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cstate = coll.reset(gen)
    ecs = copy.deepcopy(cstate)
    egen = torch.Generator(device="cuda")
    egen.set_state(gen.get_state())
    program = Graphed(lambda: coll.rollout(ts, cstate, None, gen, 250, keep_rollout=True), GraphPool("cuda"), (gen,),
                      name="sde_collect")
    for _ in range(3):
        out = program().map(torch.clone)
        eout = coll.rollout(ts, ecs, None, egen, 250, keep_rollout=True)
        for k in ("obs", "act", "rew", "terminated", "truncated", "obs_next"):
            assert torch.equal(out.rollout[k], eout.rollout[k]), k
        assert torch.equal(out.done, eout.done) and bool(out.done.any())
        assert torch.equal(cstate.policy_state.eps, ecs.policy_state.eps)
        assert torch.equal(cstate.policy_state.count, ecs.policy_state.count)
        assert torch.equal(cstate.policy_state.count == 0, out.done[-1])
    assert program.replays == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rmsprop", "sgd", "sgd_momentum"])
def test_rmsprop_and_sgd_under_a_graph_match_the_cpu_steps_on_cuda(kind):
    """The port's RMSprop and SGD with the clip and the linear schedule on the card, six steps through
    one graph, against the same factory's steps on the CPU: weights within 2e-6, the rate the schedule's."""
    from tianshou_tpu_torch.algorithm.optim import RMSpropOptimizerFactory, SGDOptimizerFactory, linear_lr_schedule
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    _needs_cuda()
    sched = linear_lr_schedule(0.01, 4)
    factory = {"rmsprop": lambda: RMSpropOptimizerFactory(lr=sched, alpha=0.9, max_grad_norm=1.0),
               "sgd": lambda: SGDOptimizerFactory(lr=sched, max_grad_norm=1.0),
               "sgd_momentum": lambda: SGDOptimizerFactory(lr=sched, momentum=0.9, max_grad_norm=1.0)}[kind]()
    w = torch.randn(7, 5, generator=torch.Generator().manual_seed(0))
    cuda, cpu = torch.nn.Parameter(w.cuda()), torch.nn.Parameter(w.clone())
    opt_cuda, opt_cpu = factory.create([cuda]), factory.create([cpu])
    cuda.grad = torch.zeros_like(cuda)
    program = Graphed(lambda: factory.step(opt_cuda), GraphPool("cuda"), name=kind)
    for i in range(6):
        g = torch.randn(7, 5, generator=torch.Generator().manual_seed(i + 1))
        cuda.grad.copy_(g)
        program()
        cpu.grad = g
        factory.step(opt_cpu)
        torch.testing.assert_close(cuda.detach().cpu(), cpu.detach(), rtol=0, atol=2e-6)
    assert program.replays == 5
    assert float(opt_cuda.param_groups[0]["lr"]) == float(opt_cpu.param_groups[0]["lr"]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["HalfCheetah", "Hopper", "Ant"])
@pytest.mark.parametrize("num_envs", [1, 33, 2053])
def test_penalty_fused_step_kernel_matches_plain_version_on_cuda(task, num_envs):
    """The penalty branch (contact_model set after construction) launches its own library and holds the
    plain version at the fused step's tolerances on states in the floor and past joint limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    env = make(task)
    model = env.model
    g = torch.Generator(device="cuda").manual_seed(1)
    home = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")
    q = home + 0.3 * torch.randn(num_envs, model.nq, device="cuda", generator=g)
    q[:, 2 if task == "Ant" else 1] -= 0.2 if task == "Ant" else 0.1
    qd = 0.5 * torch.randn(num_envs, model.nq, device="cuda", generator=g)
    ctrl = torch.rand(num_envs, len(model.actuators), device="cuda", generator=g) * 2 - 1
    constraint = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    model.contact_model = "penalty"
    before = pf.launch_count()
    q_new, qd_new = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    torch.cuda.synchronize()
    assert pf.launch_count() == before + 1
    q_ref, qd_ref = pf.fused_step_reference(model, q, qd, ctrl, frame_skip=env.frame_skip)
    torch.testing.assert_close(q_new, q_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd_new, qd_ref, rtol=5e-3, atol=5e-3)
    if num_envs > 1:  # another library than the constraint model's: other results on these states
        assert not torch.equal(constraint[1], qd_new)


@pytest.mark.cuda
def test_humanoid_plain_route_graph_matches_eager_with_no_kernel_launch_on_cuda():
    """Humanoid's pair rows step through dynamics.step; a CUDA graph of two steps replays the eager steps'
    bits and launches no hand-written kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool
    from tianshou_tpu_torch.utils.tree import tree_map

    venv = VectorDeviceEnv(make("Humanoid"), 64, device="cuda")
    assert venv.env.physics_route == "plain"
    g = torch.Generator(device="cuda").manual_seed(0)
    start, _ = venv.reset(g)
    acts = [venv.action_space.sample(64, g, venv.device) for _ in range(2)]
    st = tree_map(torch.clone, start)

    def two_steps():
        s = st
        for a in acts:
            s = venv.step(s, a, g).state
        tree_map(torch.Tensor.copy_, st, s)

    before = pf.launch_count()
    program = Graphed(two_steps, GraphPool(venv.device), (g,), name="humanoid")
    program()
    eager = tree_map(torch.clone, st)
    tree_map(torch.Tensor.copy_, st, start)
    program()
    torch.cuda.synchronize()
    assert program.replays == 1 and pf.launch_count() == before
    assert torch.equal(st.q, eager.q) and torch.equal(st.qd, eager.qd)
    assert bool(torch.isfinite(st.q).all())


@pytest.mark.cuda
@pytest.mark.parametrize("recompute", [False, True])
def test_step_graphs_match_the_eager_update_on_cuda(recompute, monkeypatch):
    """Two PPO rollout updates on the trainer's step route (each minibatch step a replayed graph of one step)
    against ``algo.update_rollout`` run eagerly on a deep copy: stats, weights, Adam's state and the step bit for
    bit. A step is captured once per update, or once per pass with recomputed advantages (the batch's advantage
    tensors change between passes), and no graph outlives its update."""
    import copy

    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams
    from tianshou_tpu_torch.utils import graph

    _needs_cuda()
    captures = []
    capture = graph.Graphed._capture
    monkeypatch.setattr(graph.Graphed, "_capture", lambda self: captures.append(self.name) or capture(self))
    torch.manual_seed(0)
    algo = PPO(actor=DiscreteActor((64, 64), 2, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
               action_space=CartPole().action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5),
               recompute_advantage=recompute, target_kl=0.01 if recompute else None)
    coll = DeviceCollector(VectorDeviceEnv(CartPole(), 8, device="cuda"), algo, None)
    ts = algo.init("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rollout = coll.collect(ts, coll.reset(gen), None, gen, 32, keep_rollout=True)[2].rollout
    ets = copy.deepcopy(ts)
    egen = torch.Generator(device="cuda")
    egen.set_state(gen.get_state())
    trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(batch_size=32, update_step_num_repetitions=3,
                                                                      verbose=False))
    trainer.STEP_GRAPHS_ABOVE = 0
    for _ in range(2):
        stats = trainer.update_rollout(ts, rollout, gen).map(torch.clone)
        estats = algo.update_rollout(ets, rollout, egen, 3, 32)[1]
        assert stats.keys() == estats.keys() and all(torch.equal(stats[k], estats[k]) for k in estats.keys())
    torch.cuda.synchronize()
    assert captures == ["PPO step"] * (6 if recompute else 2) and trainer.graph_pool is None
    assert trainer.step_graphs.captures == (3 if recompute else 1) and not trainer.step_graphs._held
    for a, b in zip(ts.model.state_dict().values(), ets.model.state_dict().values()):
        assert torch.equal(a, b)
    for st, est in zip(ts.optim.state_dict()["state"].values(), ets.optim.state_dict()["state"].values()):
        assert all(torch.equal(st[k], est[k]) for k in st)
    # the KL guard (with recomputed advantages here) takes back the step of a minibatch past its bound
    assert int(ts.step) == int(ets.step) and (recompute or int(ts.step) == 2 * 3 * 8)


@pytest.mark.cuda
def test_mesh_offpolicy_step_at_world_size_1_matches_the_trainer_megastep_on_cuda():
    """``make_dp_offpolicy_train_step`` on a one-rank NCCL group (``make_mesh(1)`` in a process that never joined a
    group) over CartPole DQN: two chunks of 10 steps and 10 updates from copies of one prefilled state and one
    generator state give the bits of ``OffPolicyTrainer.megastep`` (eager warm-up, then capture and replay)."""
    import copy

    import torch.distributed as dist

    from tianshou_tpu_torch.parallel.mesh import make_dp_offpolicy_train_step, make_mesh
    from tianshou_tpu_torch.utils.tree import tree_leaves

    _needs_cuda()
    trainer, ts, bs, _ = _cartpole_trainer()
    coll = trainer.train_collector
    gen = torch.Generator(device="cuda").manual_seed(0)
    cstate = coll.reset(gen)
    coll.collect(ts, cstate, bs, gen, 10, random=True)
    sides = []
    for _ in range(2):
        s_gen = torch.Generator(device="cuda")
        s_gen.set_state(gen.get_state())
        sides.append((*copy.deepcopy((ts, bs, cstate)), s_gen))
    (t_ts, t_bs, t_cs, t_gen), (m_ts, m_bs, m_cs, m_gen) = sides
    t_stats = [trainer.megastep(t_ts, t_cs, t_bs, t_gen, 10, 10)[1].map(torch.clone) for _ in range(2)]
    mesh = make_mesh(1)
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        step = make_dp_offpolicy_train_step(trainer.algo, coll, trainer.buffer, mesh, 10, 10, 64)
        m_stats = [step(m_ts, m_cs, m_bs, m_gen)[4].map(torch.clone) for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for a, b in zip(t_stats, m_stats):
        assert all(torch.equal(a[k], b[k]) for k in a.keys())
    pairs = list(zip(t_ts.model.state_dict().values(), m_ts.model.state_dict().values()))
    pairs += list(zip(t_ts.target.state_dict().values(), m_ts.target.state_dict().values()))
    pairs += [(t_ts.step, m_ts.step), (t_bs.cursor, m_bs.cursor), (t_bs.size, m_bs.size),
              *zip(t_bs.data.values(), m_bs.data.values()), (t_gen.get_state(), m_gen.get_state())]
    pairs += list(zip(tree_leaves(t_cs), tree_leaves(m_cs)))
    assert all(torch.equal(a, b) for a, b in pairs) and int(m_ts.step) == 20
