"""What capturing the port's programs in CUDA graphs needs, held on the CPU,
and the trainer's programs against the JAX package.

- Storage: every tensor of ``TrainState``, ``BufferState``, ``PrioState`` and
  ``CollectState`` keeps its storage (``data_ptr``) across an ``add``, an
  update, ``update_weight`` and a collect step. A graph replays on the
  addresses it captured, so a tensor that is rebound instead of written in
  place would go stale under replay.
- ``fused_megastep=True`` and ``False`` give bit-identical parameters, rings
  and stats from one seed (the same operations in the same order).
- An eps schedule set through ``train_fn`` changes the collector's actions
  after the first chunk: eps is a device scalar written in place.
- Three updates with ``target_update_freq=2`` on given indices match three
  ``algo.update`` steps of the JAX package (the target syncs on step 2 by a
  device select) at the one-update test's tolerance: atol 2e-5 for every
  weight, 2e-6 for 99.9% of each tensor; losses rtol 1e-4 / atol 1e-5.
- The graph helper on the CPU runs its function eagerly on every call, and
  the launch counters' snapshot / restore / add keep what they count.
"""

from typing import NamedTuple

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.dqn import DQN as JDQN
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models.atari import NatureCNN as JNatureCNN
from tianshou_tpu_torch.algorithm.base import TrainState
from tianshou_tpu_torch.algorithm.modelfree.c51 import RainbowDQN
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import BufferState, VectorReplayBuffer
from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer, PrioState
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.env.wrappers import FrameStack
from tianshou_tpu_torch.models.atari import DQNet, RainbowAtariNet
from tianshou_tpu_torch.models.convert import dqnet_params_from_flax
from tianshou_tpu_torch.ops.kernels import counters
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams
from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

A, HW, FEAT, E, STACK, ATOMS, CAP = 4, 36, 32, 3, 4, 11, 16
TOL = dict(rtol=1e-4, atol=1e-5)


class PixState(NamedTuple):
    pos: torch.Tensor
    t: torch.Tensor


class TPix(tcore.Env):
    """Pixels from a position pattern; an env terminates with probability 0.2 a step."""

    def __init__(self):
        self.observation_space = tcore.Box(0, 255, (HW, HW, 1))
        self.action_space = tcore.Discrete(A)

    def _obs(self, pos):
        row, col = torch.arange(HW)[:, None], torch.arange(HW)[None, :]
        return ((row * 7 + col * 13 + pos[:, None, None] * 3) % 251).to(torch.uint8)[..., None]

    def reset(self, num_envs, generator, device):
        z = torch.zeros(num_envs, dtype=torch.int32, device=device)
        return PixState(z, z.clone()), self._obs(z)

    def step(self, s, a, generator):
        pos, t = s.pos + a.to(torch.int32) + 1, s.t + 1
        terminated = torch.rand(pos.shape, generator=generator) < 0.2
        return tcore.EnvStep(state=PixState(pos, t), obs=self._obs(pos), reward=(a == pos % A).to(torch.float32),
                             terminated=terminated, truncated=torch.zeros_like(terminated), info=Batch())


def _example():
    return Batch(obs=torch.zeros((HW, HW, 1), dtype=torch.uint8), act=torch.tensor(0), rew=torch.tensor(0.0),
                 terminated=torch.tensor(False), truncated=torch.tensor(False),
                 obs_next=torch.zeros((HW, HW, 1), dtype=torch.uint8))


def _pipeline(kind: str, eps: float = 0.1):
    """(algo, train state, buffer, buffer state, collector) at a small width on the CPU."""
    torch.manual_seed(0)
    kw = dict(action_space=tcore.Discrete(A), optim=AdamOptimizerFactory(lr=1e-3), gamma=0.9,
              n_step_return_horizon=3, target_update_freq=3, eps_training=eps)
    ring = dict(total_size=E * CAP, buffer_num=E, stack_num=STACK, save_only_last_obs=True)
    if kind == "dqn":
        algo = DQN(model=DQNet(A, features=FEAT, compute_dtype=torch.float32, input_hw=(HW, HW)), **kw)
        buffer = VectorReplayBuffer(**ring)
    else:
        algo = RainbowDQN(model=RainbowAtariNet(A, ATOMS, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW)),
                          num_atoms=ATOMS, v_min=-2.0, v_max=2.0, **kw)
        buffer = PrioritizedVectorReplayBuffer(alpha=0.6, beta=0.4, **ring)
    ts = algo.init("cpu")
    bs = buffer.init(_example(), device="cpu")
    coll = DeviceCollector(tcore.VectorDeviceEnv(FrameStack(TPix(), STACK), E, device="cpu"), algo, buffer)
    return algo, ts, buffer, bs, coll


def _ptrs(x, prefix: str = "") -> dict[str, int]:
    """``data_ptr`` of every tensor in a train, buffer or collect state, by path."""
    out: dict[str, int] = {}
    if isinstance(x, torch.Tensor):
        out[prefix] = x.data_ptr()
    elif isinstance(x, TrainState):
        for name in ("model", "target"):
            for k, v in getattr(x, name).state_dict(keep_vars=True).items():
                out[f"{prefix}{name}.{k}"] = v.data_ptr()
        for i, st in enumerate(x.optim.state.values()):
            out.update(_ptrs(st, f"{prefix}optim.{i}."))
        out.update(_ptrs(x.hparams, f"{prefix}hparams."))
        out[f"{prefix}step"] = x.step.data_ptr()
    elif isinstance(x, (BufferState, PrioState)):
        for k, v in vars(x).items():
            out.update(_ptrs(v, f"{prefix}{k}."))
    elif isinstance(x, (Batch, dict)):
        for k, v in x.items():
            out.update(_ptrs(v, f"{prefix}{k}."))
    elif isinstance(x, tuple):
        names = getattr(x, "_fields", range(len(x)))
        for k, v in zip(names, x):
            out.update(_ptrs(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("kind,op", [
    ("dqn", "add"), ("dqn", "update"), ("dqn", "collect_step"),
    ("rainbow", "add"), ("rainbow", "update"), ("rainbow", "update_weight"), ("rainbow", "collect_step"),
])
def test_every_state_tensor_keeps_its_storage(kind, op):
    algo, ts, buffer, bs, coll = _pipeline(kind)
    gen = torch.Generator().manual_seed(0)
    cstate = coll.reset(gen)
    coll.collect(ts, cstate, bs, gen, 5, random=True)
    algo.update(ts, buffer, bs, gen, 8)  # Adam's moments exist from here on
    before = {**_ptrs(ts, "ts."), **_ptrs(bs, "buf."), **_ptrs(cstate, "collect.")}
    base = bs.base if kind == "rainbow" else bs
    cursor, step = base.cursor.clone(), ts.step.clone()
    tree = bs.tree.clone() if kind == "rainbow" else None
    if op == "add":
        coll_out = coll._step_fn(ts, cstate, bs, gen, True, False, True)[2]
        assert buffer.add(bs, coll_out.rollout)[0] is bs
    elif op == "update":
        assert algo.update(ts, buffer, bs, gen, 8)[:2] == (ts, bs)
    elif op == "update_weight":
        idx = buffer.sample_indices(bs, gen, 8)
        assert buffer.update_weight(bs, idx, torch.rand(8, generator=gen) * 5) is bs
    else:
        assert coll.collect(ts, cstate, bs, gen, 1)[:2] == (cstate, bs)
    after = {**_ptrs(ts, "ts."), **_ptrs(bs, "buf."), **_ptrs(cstate, "collect.")}
    assert after == before
    # and the operation did write them
    if op in ("add", "collect_step"):
        assert torch.equal(base.cursor, (cursor + 1) % CAP)
    if op == "update":
        assert int(ts.step) == int(step) + 1
    if op in ("update", "update_weight") and kind == "rainbow":
        assert not torch.equal(bs.tree, tree)


def _train(kind: str, fused: bool, train_fn=None, eps: float = 0.1, chunks: int = 3):
    algo, ts, buffer, bs, coll = _pipeline(kind, eps)
    params = OffPolicyTrainerParams(max_epochs=1, epoch_num_steps=chunks * 4 * E, batch_size=8,
                                    collection_step_num_env_steps=4, update_per_step=0.5, start_steps=4 * E,
                                    fused_megastep=fused, train_fn=train_fn, verbose=False)
    trainer = OffPolicyTrainer(algo, coll, None, buffer, params)
    return trainer, trainer.run(ts, bs, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kind", ["dqn", "rainbow"])
def test_fused_megastep_is_bit_identical_to_collect_then_burst(kind):
    (_, a), (tb, b) = _train(kind, False), _train(kind, True)
    assert a.gradient_step == b.gradient_step == 3 * round(0.5 * 4 * E) and a.env_step == b.env_step
    assert sorted(key[0] for key in tb._programs) == ["megastep"]
    for (k, x), (_, y) in zip(a.train_state.model.state_dict().items(), b.train_state.model.state_dict().items()):
        assert torch.equal(x, y), k
    for (k, x), (_, y) in zip(a.train_state.target.state_dict().items(), b.train_state.target.state_dict().items()):
        assert torch.equal(x, y), k
    pa, pb = _ptrs(a.buf_state), _ptrs(b.buf_state)
    assert pa.keys() == pb.keys()
    sa, sb = a.buf_state, b.buf_state
    for name in ("base", "tree", "max_prio", "min_prio") if kind == "rainbow" else ("data", "cursor", "size", "last_idx"):
        x, y = getattr(sa, name), getattr(sb, name)
        if isinstance(x, BufferState):
            for f in ("cursor", "size", "last_idx"):
                assert torch.equal(getattr(x, f), getattr(y, f)), f
            x, y = x.data, y.data
        if isinstance(x, Batch):
            for k in x.keys():
                assert torch.equal(x[k], y[k]), k
        else:
            assert torch.equal(x, y), name
    for k in a.last_chunk_stats.keys():
        assert torch.equal(a.last_chunk_stats[k], b.last_chunk_stats[k]), k
    assert a.update_stats == b.update_stats


def test_eps_schedule_through_train_fn_changes_the_actions_after_the_first_chunk():
    """A greedy first chunk in both runs; then eps 1 in one of them: the
    collector's actions of the first chunk agree, those after it do not."""
    def greedy_then_random(epoch, env_step):
        return {"eps_training": 0.0 if env_step < 2 * 4 * E else 1.0}

    _, sched = _train("dqn", False, greedy_then_random, eps=0.0)
    _, greedy = _train("dqn", False, None, eps=0.0)
    assert float(sched.train_state.hparams["eps_training"]) == 1.0
    act_s, act_g = sched.buf_state.data.act, greedy.buf_state.data.act  # [E, CAP]: prefill 0-3, chunks 4-7, 8-11, 12-15
    assert torch.equal(act_s[:, :8], act_g[:, :8])
    assert not torch.equal(act_s[:, 8:], act_g[:, 8:])


# ---------------------------------------------------------------------------
# three updates with target sync every 2 steps, against the JAX package
# ---------------------------------------------------------------------------
class JNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(A)(JNatureCNN(FEAT, jnp.float32)(x))


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def test_three_updates_with_target_sync_match_jax():
    kw = dict(gamma=0.9, n_step_return_horizon=3, target_update_freq=2)
    jalgo = JDQN(model=JNet(), action_space=jcore.Discrete(A), optim=JAdam(lr=1e-3), **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((STACK, HW, HW, 1), jnp.uint8))
    net = DQNet(A, features=FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))
    net.load_state_dict(dqnet_params_from_flax(_np_tree(jts.params["model"])))
    talgo = DQN(model=net, action_space=tcore.Discrete(A), optim=AdamOptimizerFactory(lr=1e-3), **kw)
    tts = talgo.init("cpu")

    rng = np.random.default_rng(0)
    jex = JBatch(obs=jnp.zeros((HW, HW, 1), jnp.uint8), act=jnp.int32(0), rew=jnp.float32(0),
                 terminated=jnp.bool_(False), truncated=jnp.bool_(False), obs_next=jnp.zeros((HW, HW, 1), jnp.uint8))
    jb, tb = JVRB(E * 8, E, stack_num=STACK, save_only_last_obs=True), VectorReplayBuffer(
        E * 8, E, stack_num=STACK, save_only_last_obs=True)
    js, ts = jb.init(jex), tb.init(_example(), device="cpu")
    for _ in range(13):
        step = dict(obs=rng.integers(0, 256, (E, STACK, HW, HW, 1), dtype=np.uint8),
                    act=rng.integers(0, A, E).astype(np.int32), rew=rng.standard_normal(E).astype(np.float32),
                    terminated=rng.random(E) < 0.15, truncated=rng.random(E) < 0.05,
                    obs_next=rng.integers(0, 256, (E, STACK, HW, HW, 1), dtype=np.uint8))
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    indices = [rng.integers(0, E * 8, 16) for _ in range(3)]
    # both samplers hand out the given indices, in order
    jidx, tidx = iter(indices), iter(indices)
    jb.sample_indices = lambda state, key, batch_size: jnp.asarray(next(jidx))
    tb.sample_indices = lambda state, generator, batch_size: torch.from_numpy(next(tidx))

    synced = []
    for k in range(3):
        jts, js, jstats = jalgo.update(jts, jb, js, jax.random.key(k), 16)
        tts, ts, tstats = talgo.update(tts, tb, ts, torch.Generator(), 16)
        np.testing.assert_allclose(tstats.loss.item(), float(jstats.loss), **TOL)
        np.testing.assert_allclose(tstats.td_error.numpy(), np.asarray(jstats.td_error), **TOL)
        synced.append(all(torch.equal(t, o) for t, o in zip(tts.target.parameters(), tts.model.parameters())))
    assert synced == [False, True, False]
    assert int(tts.step) == int(jts.step) == 3
    for tree, module in ((jts.params["model"], tts.model), (jts.target_params["model"], tts.target)):
        want = dqnet_params_from_flax(_np_tree(tree))
        got = {k: v.detach().numpy() for k, v in module.state_dict().items()}
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w.numpy(), rtol=0, atol=2e-5, err_msg=k)
            assert np.mean(np.abs(got[k] - w.numpy()) <= 2e-6) >= 0.999, k


# ---------------------------------------------------------------------------
# the graph helper and the launch counters on the CPU
# ---------------------------------------------------------------------------
def test_graphed_runs_its_function_eagerly_on_every_cpu_call():
    x = torch.zeros(3)
    calls = []

    def fn():
        calls.append(1)
        return x.add_(1)

    pool = GraphPool("cpu")
    g = Graphed(fn, pool, name="add one")
    outs = [g() for _ in range(4)]
    assert len(calls) == 4 and torch.equal(x, torch.full((3,), 4.0))
    assert all(o is x for o in outs)
    assert g.graph is None and g.replays == 0 and pool.graphs == [g] and pool.memory_bytes() == 0


def test_launch_counters_snapshot_restore_and_add():
    saved = counters.snapshot()
    try:
        counters.reset("gather_rows", "tree_update")
        counters.add("gather_rows", 2)
        before = counters.snapshot()
        counters.add("gather_rows")
        counters.add("tree_update", 3)
        assert (counters.get("gather_rows"), counters.get("tree_update")) == (3, 3)
        counters.restore(before)
        assert (counters.get("gather_rows"), counters.get("tree_update")) == (2, 0)
        counters.add_all({"gather_rows": 2, "tree_update": 1})
        assert (counters.get("gather_rows"), counters.get("tree_update")) == (4, 1)
    finally:
        counters.restore(saved)


def test_trainer_builds_each_program_once_per_state():
    algo, ts, buffer, bs, coll = _pipeline("dqn")
    params = OffPolicyTrainerParams(max_epochs=1, epoch_num_steps=2 * 4 * E, batch_size=8,
                                    collection_step_num_env_steps=4, update_per_step=0.5, start_steps=4 * E,
                                    verbose=False)
    trainer, gen = OffPolicyTrainer(algo, coll, None, buffer, params), torch.Generator().manual_seed(0)
    res = trainer.run(ts, bs, gen)
    programs = dict(trainer._programs)
    assert sorted(key[0] for key in programs) == ["collect_chunk", "update_burst"]
    trainer.params.start_steps = 0
    res2 = trainer.run(res.train_state, res.buf_state, gen)  # the same states: the same programs
    assert {k: v[1] for k, v in trainer._programs.items()} == {k: v[1] for k, v in programs.items()}
    assert res2.gradient_step == 4 * round(0.5 * 4 * E)
    # another train state is another program, in the same pool
    key = ("update_burst", 6, 8)
    ts = _pipeline("dqn")[1]
    trainer.update_burst(ts, res.buf_state, torch.Generator(), 6)
    assert trainer._programs[key][1] is not programs[key][1] and trainer._programs[key][0][0] is ts
    assert len(trainer.graph_pool.graphs) == 2 and trainer.graph_pool.graphs[-1].name == "update_burst 6 8"
