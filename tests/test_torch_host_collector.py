"""The host collectors and trainers in the port (tianshou_tpu_torch/data/
{host,pipelined,async}_collector.py, ``HostOffPolicyTrainer`` and
``HostOnPolicyTrainer``) against the JAX package.

- The rings against the JAX package's ``HostCollector`` on Gymnasium
  CartPole-v1, the actions handed over by a policy that computes them from
  the observation with one comparison in both packages: the same seeds give
  the same rings (every key, cursors and sizes), episode returns and lengths,
  bit for bit, in ``n_step`` mode and in ``n_episode`` mode with surplus envs
  masked, over Dummy and Subproc envs; the pipelined collector's rings equal
  the sequential collector's.
- The battery of ``tests/test_collector_battery.py`` (its host and async
  cases) on the port: exact ring contents over variable-length
  deterministic episodes, surplus masking, repeated cycles, corner cases,
  dict observations, partial-wait async collection.
- The pipelined collector's cases of ``tests/test_host_env.py:175-347``, the
  host trainers' cadence with and without ``overlap_updates``, and the
  overlap mode acting on the chunk-start parameters (its first chunk's
  transitions equal the sequential chunk's).
- DQN on Gymnasium CartPole through the host path to 195 (``slow``).

Every Subproc test bounds its waits with ``recv_timeout`` and closes its venv
in ``finally``.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.base import ActOut as JActOut
from tianshou_tpu.algorithm.base import Algorithm as JAlgorithm
from tianshou_tpu.algorithm.base import TrainState as JTrainState
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.data.host_collector import HostCollector as JHostCollector
from tianshou_tpu.env import core as jcore
from tianshou_tpu.env.venvs import DummyVectorEnv as JDummyVectorEnv
from tianshou_tpu_torch.algorithm.base import ActOut, Algorithm
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.async_collector import AsyncHostCollector
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.host_collector import HostCollector
from tianshou_tpu_torch.data.pipelined_collector import PipelinedHostCollector
from tianshou_tpu_torch.env.core import Discrete
from tianshou_tpu_torch.env.venvs import DummyVectorEnv, SubprocVectorEnv, VectorEnvNormObs
from tianshou_tpu_torch.models.mlp import Net
from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer, HostOnPolicyTrainer, OffPolicyTrainerParams
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

WAIT = 60.0


def make_cp():
    return gym.make("CartPole-v1")


def _example(xp, B, obs_shape, act_dtype):
    return B(obs=xp.zeros(obs_shape, dtype=xp.float32), act=xp.zeros((), dtype=act_dtype),
             rew=xp.zeros((), dtype=xp.float32), terminated=xp.zeros((), dtype=bool),
             truncated=xp.zeros((), dtype=bool), obs_next=xp.zeros(obs_shape, dtype=xp.float32))


def cp_example():
    return _example(torch, Batch, (4,), torch.int64)


# ---------------------------------------------------------------------------
# rings against the JAX package's HostCollector
# ---------------------------------------------------------------------------
class JAngleAlgo(JAlgorithm):
    """Push toward the pole's lean, unless the cart is right of 0.02."""

    def __init__(self):
        super().__init__(action_space=jcore.Discrete(2))

    def init(self, key, obs_example):
        return JTrainState(params={}, target_params={}, opt_state={}, hparams=JBatch(), extra=JBatch(),
                           step=jnp.int32(0))

    def forward(self, ts, obs, key, state=None, deterministic=False):
        return JActOut(act=((obs[:, 2] > 0) ^ (obs[:, 0] > 0.02)).astype(jnp.int32), state=state, info=JBatch())

    def update_step(self, ts, batch, key):
        return ts, JBatch()


class AngleAlgo(Algorithm):
    def __init__(self):
        super().__init__(action_space=Discrete(2))

    def forward(self, ts, obs, generator=None, state=None, deterministic=False):
        return ActOut(act=((obs[:, 2] > 0) ^ (obs[:, 0] > 0.02)).to(torch.int64), state=state, info=Batch())


def _pair(E, total, venv_cls=DummyVectorEnv, collector_cls=HostCollector, **kw):
    jb, tb = JVRB(total, E), VectorReplayBuffer(total, E)
    jalgo = JAngleAlgo()
    jc = JHostCollector(JDummyVectorEnv([make_cp] * E), jalgo, jb)
    tc = collector_cls(venv_cls([make_cp] * E, **kw), AngleAlgo(), tb, device="cpu")
    jc.reset(seed=11)
    tc.reset(seed=11)
    jc.reset_buffer(_example(jnp, JBatch, (4,), jnp.int32))
    tc.reset_buffer(cp_example())
    return jc, jalgo.init(None, None), tc


def _assert_rings_equal(tc, jc):
    for k, v in jc.buf_state.data.items():
        np.testing.assert_array_equal(tc.buf_state.data[k].numpy(), np.asarray(v), err_msg=k)
    for name in ("cursor", "size", "last_idx"):
        np.testing.assert_array_equal(getattr(tc.buf_state, name).numpy(), np.asarray(getattr(jc.buf_state, name)))


def _assert_stats_equal(s, j):
    assert (s.n_collected_steps, s.n_collected_episodes) == (j.n_collected_steps, j.n_collected_episodes)
    np.testing.assert_array_equal(s.returns, j.returns)
    np.testing.assert_array_equal(s.lens, j.lens)


@pytest.mark.parametrize("venv_cls", [DummyVectorEnv, SubprocVectorEnv])
def test_rings_match_jax_host_collector(venv_cls):
    """n_step collects across episode ends (CartPole's episodes end within
    ~100 steps under this policy), then n_episode with surplus masking, then
    n_step again: rings, stats and the carried observations bit for bit."""
    kw = {"recv_timeout": WAIT} if venv_cls is SubprocVectorEnv else {}
    jc, jts, tc = _pair(4, 4 * 200, venv_cls, **kw)
    g = torch.Generator()
    try:
        for i, mode in enumerate([dict(n_step=150), dict(n_step=37), dict(n_episode=3), dict(n_episode=6),
                                  dict(n_step=90)]):
            j = jc.collect(jts, jax.random.key(i), **mode)
            s = tc.collect(None, g, **mode)
            _assert_stats_equal(s, j)
            _assert_rings_equal(tc, jc)
            np.testing.assert_array_equal(tc._obs, np.asarray(jc._obs))
            np.testing.assert_array_equal(tc._obs_dev.numpy(), np.asarray(jc._obs))
        assert int(tc.buf_state.data.done.sum()) >= 6
    finally:
        tc.venv.close()
        jc.venv.close()


def test_pipelined_rings_match_the_sequential_collector():
    """The two halves out of phase store what the sequential collector stores."""
    jc, jts, tc = _pair(4, 4 * 100, collector_cls=PipelinedHostCollector)
    seq = HostCollector(DummyVectorEnv([make_cp] * 4), AngleAlgo(), VectorReplayBuffer(4 * 100, 4), device="cpu")
    seq.reset(seed=11)
    seq.reset_buffer(cp_example())
    g = torch.Generator()
    for n in (60, 120):
        a, b = tc.collect(None, g, n_step=n), seq.collect(None, g, n_step=n)
        _assert_stats_equal(a, b)
        for k, v in seq.buf_state.data.items():
            np.testing.assert_array_equal(tc.buf_state.data[k].numpy(), v.numpy(), err_msg=k)
        np.testing.assert_array_equal(tc.buf_state.size.numpy(), seq.buf_state.size.numpy())
    jc.venv.close()


# ---------------------------------------------------------------------------
# tests/test_collector_battery.py on the port
# ---------------------------------------------------------------------------
class MoveToRightGymEnv(gym.Env):
    """obs == position, action 1 moves right, reward 1 at the terminal step, episode length == size."""

    def __init__(self, size, sleep=0.0, random_sleep=False):
        self.size, self.sleep, self.random_sleep = size, sleep, random_sleep
        self.observation_space = gym.spaces.Box(low=0.0, high=float(size), shape=(1,))
        self.action_space = gym.spaces.Discrete(2)
        self.pos = 0

    def reset(self, seed=None, options=None):
        super().reset(seed=seed)
        self.pos = 0
        return np.array([0.0], np.float32), {"key": 1}

    def step(self, action):
        if self.sleep > 0:
            import time

            time.sleep(self.sleep * (np.random.rand() if self.random_sleep else 1.0))
        self.pos = min(self.pos + int(action), self.size)
        done = self.pos == self.size
        return np.array([float(self.pos)], np.float32), 1.0 if done else 0.0, done, False, {"key": 1}


class MaxActionAlgo(Algorithm):
    """Action 1 for every env (reference MaxActionPolicy)."""

    def __init__(self):
        super().__init__(action_space=Discrete(2))

    def forward(self, ts, obs, generator=None, state=None, deterministic=False):
        n = obs["index"].shape[0] if isinstance(obs, Batch) else obs.shape[0]
        return ActOut(act=torch.ones(n, dtype=torch.int64), state=state, info=Batch())


def _collector(venv, total_size=100):
    coll = HostCollector(venv, MaxActionAlgo(), VectorReplayBuffer(total_size, len(venv)), device="cpu")
    coll.reset(seed=0)
    coll.reset_buffer(_example(torch, Batch, (1,), torch.int64))
    return coll


def _ring(coll, key, env):
    n = int(coll.buf_state.size[env])
    a = coll.buf_state.data[key][env][:n].numpy()
    return a[..., 0] if a.ndim == 2 else a


G = torch.Generator()


def test_single_env_exact_ring_contents():
    venv = DummyVectorEnv([lambda: MoveToRightGymEnv(size=2)])
    coll = _collector(venv)
    stats = coll.collect(None, G, n_step=3)
    assert stats.n_collected_steps == 3 and stats.n_collected_episodes == 1
    np.testing.assert_allclose(_ring(coll, "obs", 0), [0, 1, 0])
    np.testing.assert_allclose(_ring(coll, "obs_next", 0), [1, 2, 1])
    np.testing.assert_allclose(_ring(coll, "rew", 0), [0, 1, 0])
    np.testing.assert_array_equal(_ring(coll, "done", 0), [False, True, False])
    np.testing.assert_allclose(stats.returns, [1.0])
    np.testing.assert_array_equal(stats.lens, [2])
    stats2 = coll.collect(None, G, n_episode=3)
    assert stats2.n_collected_episodes == 3
    np.testing.assert_array_equal(stats2.lens, [2, 2, 2])
    np.testing.assert_allclose(_ring(coll, "obs", 0), [0, 1, 0, 1, 0, 1, 0, 1])
    np.testing.assert_allclose(_ring(coll, "obs_next", 0), [1, 2, 1, 2, 1, 2, 1, 2])


@pytest.mark.parametrize("venv_cls", [DummyVectorEnv, SubprocVectorEnv])
def test_four_envs_variable_sizes(venv_cls):
    sizes = [2, 3, 4, 5]
    kw = {"recv_timeout": WAIT} if venv_cls is SubprocVectorEnv else {}
    venv = venv_cls([lambda s=s: MoveToRightGymEnv(size=s) for s in sizes], **kw)
    try:
        coll = _collector(venv)
        stats = coll.collect(None, G, n_step=8)
        assert stats.n_collected_steps == 8 and stats.n_collected_episodes == 1
        for e in range(4):
            np.testing.assert_allclose(_ring(coll, "obs", e), [0, 1])
        stats2 = coll.collect(None, G, n_episode=4)
        assert stats2.n_collected_episodes == 4 and sorted(stats2.lens.tolist()) == [2, 3, 4, 5]
        assert stats2.n_collected_steps == 8
        np.testing.assert_allclose(_ring(coll, "obs", 0), [0, 1, 0, 1])
        np.testing.assert_allclose(_ring(coll, "obs", 3), [0, 1, 2, 3, 4])
        for e, size in enumerate(sizes):
            np.testing.assert_allclose(_ring(coll, "obs_next", e)[-size:], np.arange(1, size + 1))
            rew = _ring(coll, "rew", e)
            assert rew[-1] == 1.0 and rew[:-1].sum() == (1.0 if e == 0 else 0.0)
    finally:
        venv.close()


def test_n_episode_exceeding_env_count():
    venv = DummyVectorEnv([lambda: MoveToRightGymEnv(size=3) for _ in range(4)])
    stats = _collector(venv).collect(None, G, n_episode=7)
    assert stats.n_collected_episodes == 7 and stats.n_collected_steps == 21
    np.testing.assert_array_equal(stats.lens, 3)


def test_n_episode_fewer_than_env_count_masks_surplus():
    venv = DummyVectorEnv([lambda: MoveToRightGymEnv(size=3) for _ in range(4)])
    coll = _collector(venv)
    stats = coll.collect(None, G, n_episode=2)
    assert stats.n_collected_episodes == 2 and stats.n_collected_steps == 6
    assert coll.buf_state.size.tolist() == [3, 3, 0, 0]


def test_repeated_collect_cycles_keep_rings_pure():
    sizes = [2, 3, 4, 5]
    coll = _collector(DummyVectorEnv([lambda s=s: MoveToRightGymEnv(size=s) for s in sizes]), total_size=400)
    for n_episode in range(1, 8):
        assert coll.collect(None, G, n_episode=n_episode).n_collected_episodes == n_episode
    for n_step in range(1, 12):
        assert coll.collect(None, G, n_step=n_step).n_collected_steps >= n_step
    for e, size in enumerate(sizes):
        obs, obs_next, done = _ring(coll, "obs", e), _ring(coll, "obs_next", e), _ring(coll, "done", e)
        np.testing.assert_allclose(obs_next, obs + 1)
        steps = np.diff(obs)
        np.testing.assert_allclose(obs[np.where(steps != 1)[0] + 1], 0)
        np.testing.assert_array_equal(done[:-1][steps != 1], True)
        np.testing.assert_allclose(obs[done], size - 1)


def test_collector_corner_cases():
    venv = DummyVectorEnv([lambda: MoveToRightGymEnv(size=3) for _ in range(4)])
    with pytest.raises(ValueError):
        HostCollector(venv, MaxActionAlgo(), VectorReplayBuffer(100, 1), device="cpu")
    coll = _collector(venv)
    with pytest.raises(ValueError):
        coll.collect(None, G)
    with pytest.raises(ValueError):
        coll.collect(None, G, n_step=3, n_episode=2)
    with pytest.raises(ValueError):
        HostCollector(venv, MaxActionAlgo(), None, device="cpu").reset_buffer(cp_example())


def test_reset_before_collect_restarts_episodes():
    coll = _collector(DummyVectorEnv([lambda: MoveToRightGymEnv(size=4) for _ in range(2)]))
    coll.collect(None, G, n_step=3)
    np.testing.assert_array_equal(coll.collect(None, G, n_episode=2, reset_before_collect=True).lens, 4)


def test_collect_random_uses_action_space():
    coll = _collector(DummyVectorEnv([lambda: MoveToRightGymEnv(size=3) for _ in range(2)]))
    assert coll.collect(None, G, n_step=10, random=True).n_collected_steps >= 10
    acts = np.concatenate([_ring(coll, "act", e) for e in range(2)])
    assert set(np.unique(acts)) <= {0, 1}


class DictObsEnv(gym.Env):
    def __init__(self, size=3):
        self.size = size
        self.observation_space = gym.spaces.Dict({"index": gym.spaces.Box(0.0, float(size), shape=(1,)),
                                                  "rank": gym.spaces.Box(0.0, 10.0, shape=(2,))})
        self.action_space = gym.spaces.Discrete(2)
        self.pos = 0

    def _obs(self):
        return {"index": np.array([float(self.pos)], np.float32), "rank": np.full(2, float(self.pos), np.float32)}

    def reset(self, seed=None, options=None):
        self.pos = 0
        return self._obs(), {}

    def step(self, action):
        self.pos = min(self.pos + int(action), self.size)
        done = self.pos == self.size
        return self._obs(), float(done), done, False, {}


def test_collector_with_dict_state_host():
    venv = DummyVectorEnv([lambda: DictObsEnv(size=3) for _ in range(2)])
    coll = HostCollector(venv, MaxActionAlgo(), VectorReplayBuffer(100, 2), device="cpu")
    coll.reset(seed=0)
    ob = Batch(index=torch.zeros(1), rank=torch.zeros(2))
    coll.reset_buffer(Batch(obs=ob, act=torch.zeros((), dtype=torch.int64), rew=torch.zeros(()),
                            terminated=torch.zeros((), dtype=bool), truncated=torch.zeros((), dtype=bool),
                            obs_next=ob.map(torch.clone)))
    stats = coll.collect(None, G, n_episode=3)
    assert stats.n_collected_episodes == 3
    np.testing.assert_array_equal(stats.lens, 3)
    obs_idx = coll.buf_state.data.obs.index[0, :3, 0].numpy()
    np.testing.assert_allclose(obs_idx, [0, 1, 2])
    np.testing.assert_allclose(coll.buf_state.data.obs.rank[0, :3, 0].numpy(), obs_idx)
    np.testing.assert_allclose(coll.buf_state.data.obs_next.index[0, :3, 0].numpy(), [1, 2, 3])


def _async_collector(sizes, wait_num):
    venv = SubprocVectorEnv([lambda s=s: MoveToRightGymEnv(size=s, sleep=0.002, random_sleep=True) for s in sizes],
                            wait_num=wait_num, recv_timeout=WAIT)
    coll = AsyncHostCollector(venv, MaxActionAlgo(), VectorReplayBuffer(60 * len(sizes), len(sizes)), device="cpu")
    coll.reset(seed=0)
    coll.reset_buffer(_example(torch, Batch, (1,), torch.int64))
    return venv, coll


def _check_async_rings(coll, sizes):
    for e, size in enumerate(sizes):
        n = int(coll.buf_state.size[e])
        if n == 0:
            continue
        obs, obs_next = _ring(coll, "obs", e), _ring(coll, "obs_next", e)
        np.testing.assert_allclose(obs, np.arange(n) % size)
        np.testing.assert_allclose(obs_next, obs + 1)
        np.testing.assert_array_equal(_ring(coll, "done", e), obs == size - 1)
        np.testing.assert_allclose(_ring(coll, "rew", e), (obs == size - 1).astype(float))


def test_async_collector_n_step_cycles():
    sizes = [2, 3, 4, 5]
    venv, coll = _async_collector(sizes, wait_num=3)
    try:
        total = 0
        for n_step in range(1, 10):
            stats = coll.collect(None, G, n_step=n_step)
            assert stats.n_collected_steps >= n_step
            total += stats.n_collected_steps
            _check_async_rings(coll, sizes)
        assert int(coll.buf_state.size.sum()) == total
    finally:
        venv.close()


def test_async_collector_n_episode_cycles():
    sizes = [2, 3, 4, 5]
    venv, coll = _async_collector(sizes, wait_num=3)
    try:
        for n_episode in range(1, 6):
            stats = coll.collect(None, G, n_episode=n_episode)
            assert stats.n_collected_episodes >= n_episode
            assert set(stats.lens.tolist()) <= set(sizes)
            np.testing.assert_allclose(stats.returns, 1.0)
            _check_async_rings(coll, sizes)
    finally:
        venv.close()


def test_async_collector_argument_errors():
    venv, coll = _async_collector([2, 3], wait_num=1)
    try:
        with pytest.raises(ValueError):
            coll.collect(None, G)
        with pytest.raises(ValueError):
            AsyncHostCollector(DummyVectorEnv([make_cp]), MaxActionAlgo(), None, device="cpu")
    finally:
        venv.close()


# ---------------------------------------------------------------------------
# the pipelined collector and the host trainers (tests/test_host_env.py:175-347)
# ---------------------------------------------------------------------------
def _dqn(eps=0.2, lr=1e-3):
    torch.manual_seed(0)
    return DQN(model=Net((32, 32), 2, input_dim=4), action_space=Discrete(2), optim=AdamOptimizerFactory(lr=lr),
               gamma=0.97, n_step_return_horizon=1, target_update_freq=16, eps_training=eps)


def test_pipelined_collector_matches_sequential_semantics():
    algo = _dqn()
    ts = algo.init("cpu")
    E, T = 4, 15
    venv = DummyVectorEnv([make_cp for _ in range(E)])
    col = PipelinedHostCollector(venv, algo, VectorReplayBuffer(400, E), device="cpu")
    col.reset(seed=3)
    col.reset_buffer(cp_example())
    stats = col.collect(ts, torch.Generator().manual_seed(1), n_step=E * T)
    assert stats.n_collected_steps == E * T
    bs = col.buf_state
    np.testing.assert_array_equal(bs.size.numpy(), [T] * E)
    obs, obs_next, done = bs.data.obs.numpy(), bs.data.obs_next.numpy(), bs.data.done.numpy()
    for e in range(E):
        for k in range(T - 1):
            if not done[e, k]:
                np.testing.assert_array_equal(obs_next[e, k], obs[e, k + 1])
    assert bs.data.act.dtype == torch.int64
    assert stats.n_collected_episodes == len(stats.returns) == len(stats.lens)


def test_pipelined_collector_on_subproc_trains():
    algo = _dqn(eps=1.0)
    ts = algo.init("cpu")
    E = 4
    buffer = VectorReplayBuffer(2000, E)
    venv = SubprocVectorEnv([make_cp for _ in range(E)], recv_timeout=WAIT)
    try:
        col = PipelinedHostCollector(venv, algo, buffer, device="cpu")
        col.reset(seed=11)
        col.reset_buffer(cp_example())
        g = torch.Generator().manual_seed(1)
        stats = col.collect(ts, g, n_step=200)
        assert stats.n_collected_steps >= 200 and stats.n_collected_episodes > 0 and (stats.lens > 0).all()
        for _ in range(8):
            algo.update(ts, buffer, col.buf_state, g, 32)
        assert int(ts.step) == 8
    finally:
        venv.close()


def _host_trainer_run(overlap, collector_cls=PipelinedHostCollector, update_per_step=0.3, **kw):
    algo = _dqn()
    E = 4
    buffer = VectorReplayBuffer(2000, E)
    bs = buffer.init(cp_example(), device="cpu")
    tc = collector_cls(DummyVectorEnv([make_cp for _ in range(E)]), algo, buffer, device="cpu")
    ec = HostCollector(DummyVectorEnv([make_cp for _ in range(2)]), algo, None, device="cpu")
    params = OffPolicyTrainerParams(**{**dict(
        max_epochs=2, epoch_num_steps=120, test_step_num_episodes=2, batch_size=32, collection_step_num_env_steps=10,
        update_per_step=update_per_step, start_steps=64, start_random=True, verbose=False, seed=5,
        overlap_updates=overlap), **kw})
    trainer = HostOffPolicyTrainer(algo, tc, ec, buffer, params)
    res = trainer.run(algo.init("cpu"), bs, torch.Generator().manual_seed(0))
    tc.venv.close()
    ec.venv.close()
    return res, tc


def test_pipelined_collector_drives_host_offpolicy_trainer():
    res, tc = _host_trainer_run(False, update_per_step=0.2)
    assert res.env_step >= 64 + 2 * 120 and res.gradient_step > 0
    assert res.timing["collect"] > 0 and res.timing["update"] > 0
    assert res.buf_state is tc.buf_state


def test_pipelined_collector_falls_back_for_wrapped_venv():
    algo = _dqn()
    venv = VectorEnvNormObs(DummyVectorEnv([make_cp for _ in range(2)]))
    col = PipelinedHostCollector(venv, algo, VectorReplayBuffer(400, 2), device="cpu")
    col.reset(seed=3)
    col.reset_buffer(cp_example())
    assert col.collect(algo.init("cpu"), torch.Generator(), n_step=40).n_collected_steps >= 40
    obs = col.buf_state.data.obs.reshape(-1, 4)[: int(col.buf_state.size.sum())].numpy()
    assert obs.std() > 0.3  # normalized; the raw angle's spread is ~0.05


def test_host_trainer_overlap_updates_matches_cadence():
    seq, _ = _host_trainer_run(False)
    ovl, tc = _host_trainer_run(True)
    assert ovl.gradient_step == seq.gradient_step == int(ovl.train_state.step) == int(seq.train_state.step)
    assert ovl.env_step >= 64 + 2 * 120 and ovl.timing["collect"] > 0
    assert tc.step_hook is None


def test_overlap_acts_on_the_chunk_start_parameters():
    """eps 0 and no prefill: the first chunk's transitions depend on the
    parameters only, so acting on a copy of the chunk-start parameters stores
    what the sequential loop stores, while the interleaved updates (at lr 0.1)
    move the live parameters."""
    kw = dict(max_epochs=1, epoch_num_steps=40, start_steps=0, update_per_step=1.0, test_step_num_episodes=1)
    rings = []
    for overlap in (False, True):
        algo = _dqn(eps=0.0, lr=0.1)
        E = 4
        buffer = VectorReplayBuffer(400, E)
        bs = buffer.init(cp_example(), device="cpu")
        tc = HostCollector(DummyVectorEnv([make_cp] * E), algo, buffer, device="cpu")
        ec = HostCollector(DummyVectorEnv([make_cp]), algo, None, device="cpu")
        ts = algo.init("cpu")
        start = [p.detach().clone() for p in ts.model.parameters()]
        params = OffPolicyTrainerParams(batch_size=8, collection_step_num_env_steps=10, verbose=False, seed=5,
                                        overlap_updates=overlap, **kw)
        res = HostOffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, bs, torch.Generator().manual_seed(0))
        assert res.gradient_step == 40
        assert not all(torch.equal(a, b) for a, b in zip(start, res.train_state.model.parameters()))
        rings.append({k: v.clone() for k, v in tc.buf_state.data.items()})
        tc.venv.close()
        ec.venv.close()
    for k in rings[0]:
        assert torch.equal(rings[0][k], rings[1][k]), k


def test_host_onpolicy_trainer_runs_and_counts():
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainerParams

    torch.manual_seed(0)
    algo = PPO(actor=DiscreteActor((16, 16), 2, input_dim=4), critic=DiscreteCritic((16, 16), input_dim=4),
               action_space=Discrete(2), optim=AdamOptimizerFactory(lr=3e-4))
    train = VectorEnvNormObs(DummyVectorEnv([make_cp] * 4))
    test = VectorEnvNormObs(DummyVectorEnv([make_cp] * 2), update_obs_rms=False)
    test.set_obs_rms(train.get_obs_rms())
    tc = HostCollector(train, algo, None, device="cpu")
    ec = HostCollector(test, algo, None, device="cpu")
    params = OnPolicyTrainerParams(max_epochs=2, epoch_num_steps=64, test_step_num_episodes=2, batch_size=32,
                                   collection_step_num_env_steps=16, update_step_num_repetitions=2, verbose=False, seed=1)
    trainer = HostOnPolicyTrainer(algo, tc, ec, params)
    res = trainer.run(algo.init("cpu"), torch.Generator().manual_seed(0))
    assert res.env_step == 2 * 64 and res.gradient_step == 2 * 1 * 2 * 2 == int(res.train_state.step)
    # the train venv's statistics: the first reset, every step, every reset of a finished env; the test venv
    # reads them frozen
    count = train.get_obs_rms().count
    assert np.isfinite(res.best_reward) and count > 4 + 128
    ec.collect(res.train_state, torch.Generator(), n_episode=2)
    assert train.get_obs_rms().count == count
    assert trainer._rollout.obs.shape == (16, 4, 4)
    rollout, stats = tc.collect_rollout(res.train_state, torch.Generator(), 5)
    assert rollout.obs.shape == (5, 4, 4) and rollout.act.dtype == torch.int64
    assert stats.n_collected_steps == 20


@pytest.mark.slow
def test_dqn_on_gymnasium_cartpole():
    """``tests/test_host_env.py::test_dqn_on_gymnasium_cartpole`` on the port:
    the host path on the real Gymnasium env to 195."""
    torch.manual_seed(0)
    algo = DQN(model=Net((64, 64), 2, input_dim=4), action_space=Discrete(2), optim=AdamOptimizerFactory(lr=1e-3),
               gamma=0.97, n_step_return_horizon=3, target_update_freq=320, eps_training=0.3)
    ts = algo.init("cpu")
    venv, test_venv = DummyVectorEnv([make_cp] * 10), DummyVectorEnv([make_cp] * 10)
    buffer = VectorReplayBuffer(20000, 10)
    coll = HostCollector(venv, algo, buffer, device="cpu")
    coll.reset(seed=0)
    coll.reset_buffer(cp_example())
    test_coll = HostCollector(test_venv, algo, None, device="cpu")
    g = torch.Generator().manual_seed(0)
    coll.collect(ts, g, n_step=1000, random=True)
    env_step, best = 1000, -np.inf
    for it in range(400):
        ts.hparams["eps_training"].fill_(max(0.1, 0.3 * (1 - env_step / 20000)))
        coll.collect(ts, g, n_step=100)
        env_step += 100
        for _ in range(10):
            algo.update(ts, buffer, coll.buf_state, g, 64)
        if it % 25 == 24:
            test_coll.reset(seed=it)
            best = max(best, test_coll.collect(ts, g, n_episode=10, training=False).returns.mean())
            if best >= 195:
                break
    venv.close()
    test_venv.close()
    assert best >= 195, f"best {best}"
