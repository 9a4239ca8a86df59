"""The port's test-phase collection and collector hooks against the JAX
package.

- ``collect_episodes`` on ``MoveToRightEnv`` with an always-right policy, in
  both frameworks: ``n_collected_episodes``, ``n_collected_steps``,
  ``returns`` and ``lens`` exactly, for 7 episodes over 3 envs in chunks of 6
  (``tests/test_collector.py:64``), 2 and 4 over 4 envs, and 10 over 4 envs
  with a chunk that does not divide the episode.
- ``deactivate_surplus`` against a numpy restatement of
  ``tianshou_tpu/data/collector.py:253-259`` on 200 random done matrices,
  step by step: counted episodes, the active mask and the count, exactly.
- ``on_step_hook`` runs inside the step and what it adds lands in the buffer;
  ``on_episode_done_hook`` and the ``collector`` trace line run once per
  collect, also when the trainer's ``collect_chunk`` is a program whose
  function runs only twice (a stand-in for a CUDA graph: eager warm-up,
  capture, then replays that run no Python).
- ``RandomActionPolicy`` samples int64 actions in range, on the
  observation's device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.base import ActOut as JActOut
from tianshou_tpu.algorithm.base import Algorithm as JAlgorithm
from tianshou_tpu.algorithm.base import TrainState as JTrainState
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.collector import DeviceCollector as JCollector
from tianshou_tpu.env.core import VectorDeviceEnv as JVenv
from tianshou_tpu.env.testing import MoveToRightEnv as JMoveToRightEnv
from tianshou_tpu_torch.algorithm.base import ActOut, Algorithm, TrainState
from tianshou_tpu_torch.algorithm.random_policy import RandomActionPolicy
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector, deactivate_surplus
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.env.testing import MoveToRightEnv
from tianshou_tpu_torch.trainer import trainer as trainer_module
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams
from tianshou_tpu_torch.utils.determinism import TraceLoggerContext
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


class JAlwaysRight(JAlgorithm):
    def init(self, key, obs_example):
        return JTrainState(params={}, target_params={}, opt_state={}, hparams=JBatch(), extra=JBatch(),
                           step=jnp.int32(0))

    def forward(self, ts, obs, key, state=None, deterministic=False):
        return JActOut(act=jnp.ones(obs.shape[0], jnp.int32), state=state, info=JBatch())

    def update_step(self, ts, batch, key):
        return ts, JBatch()


class AlwaysRight(Algorithm):
    def init(self, device=None):
        return TrainState(model=torch.nn.Module(), target=None, optim=None, hparams={},
                          step=torch.zeros((), dtype=torch.int64))

    def forward(self, ts, obs, generator=None, state=None, deterministic=False):
        return ActOut(act=torch.ones(obs.shape[0], dtype=torch.int64, device=obs.device), state=state, info=Batch())

    def update_step(self, ts, batch, generator=None):
        return ts, Batch(loss=torch.zeros(()))


def _transition_example(dim=1, **extra):
    ex = dict(obs=torch.zeros(dim), act=torch.tensor(0), rew=torch.tensor(0.0), terminated=torch.tensor(False),
              truncated=torch.tensor(False), obs_next=torch.zeros(dim), **extra)
    return Batch(ex)


@pytest.mark.parametrize("n,envs,chunk,size", [(7, 3, 6, 5), (2, 4, 6, 5), (4, 4, 6, 5), (10, 4, 3, 5)],
                         ids=["7_over_3", "2_over_4", "4_over_4", "10_over_4_chunk_3"])
def test_collect_episodes_matches_jax(n, envs, chunk, size):
    jenv = JMoveToRightEnv(size=size)
    jalgo = JAlwaysRight(jenv.action_space)
    jcoll = JCollector(JVenv(jenv, envs), jalgo, None)
    want = jcoll.collect_episodes(jalgo.init(jax.random.key(0), jnp.zeros(1)), jax.random.key(1), n_episodes=n,
                                  chunk_steps=chunk)
    env = MoveToRightEnv(size=size)
    algo = AlwaysRight(env.action_space)
    coll = DeviceCollector(VectorDeviceEnv(env, envs, device="cpu"), algo, None)
    for _ in range(2):  # the second call resets the collector's episode state in place
        got = coll.collect_episodes(algo.init("cpu"), torch.Generator(), n_episodes=n, chunk_steps=chunk)
        assert got.n_collected_episodes == want.n_collected_episodes == n
        assert got.n_collected_steps == want.n_collected_steps
        np.testing.assert_array_equal(got.returns, np.asarray(want.returns))
        np.testing.assert_array_equal(got.lens, np.asarray(want.lens))
    assert got.returns_stat == want.returns_stat and got.lens_stat == want.lens_stat


def test_collect_episodes_refuses_obs_statistics():
    """Observation statistics handed to envs without ``NormObs`` change
    nothing (``inject_rms`` leaves such a state as it is); the handoff itself
    is ``tests/test_torch_normobs.py``'s."""
    env = MoveToRightEnv()
    coll = DeviceCollector(VectorDeviceEnv(env, 2, device="cpu"), AlwaysRight(env.action_space), None)
    plain = coll.collect_episodes(None, torch.Generator(), 3)
    handed = coll.collect_episodes(None, torch.Generator(), 3, rms=object())
    np.testing.assert_array_equal(handed.returns, plain.returns)
    np.testing.assert_array_equal(handed.lens, plain.lens)
    assert handed.n_collected_steps == plain.n_collected_steps


def _deactivate_numpy(done, active, n_done, n_target):
    """tianshou_tpu/data/collector.py:253-259, in numpy."""
    done = done & active
    n_done = n_done + done.sum()
    remaining = max(n_target - n_done, 0)
    k_deact = max(active.sum() - remaining, 0)
    rank = np.cumsum(done.astype(np.int32))
    return done, active & ~(done & (rank <= k_deact)), n_done


def test_deactivate_surplus_matches_the_jax_rule():
    rng = np.random.default_rng(0)
    for _ in range(200):
        T, E = rng.integers(1, 12), rng.integers(1, 17)
        dones = rng.random((T, E)) < rng.uniform(0.05, 0.9)
        n_target = int(rng.integers(1, 3 * E))
        active = np.arange(E) < max(min(n_target, E), 1)
        t_active, t_n = torch.from_numpy(active), torch.zeros((), dtype=torch.int64)
        n_done = 0
        for d in dones:
            want = _deactivate_numpy(d, active, n_done, n_target)
            got = deactivate_surplus(torch.from_numpy(d), t_active, t_n, torch.tensor(n_target))
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            np.testing.assert_array_equal(got[1].numpy(), want[1])
            assert int(got[2]) == want[2]
            _, active, n_done = want
            _, t_active, t_n = got
            assert active.sum() <= max(n_target - n_done, 0) or not want[0].any()


def test_on_step_hook_lands_in_the_buffer():
    env = MoveToRightEnv(size=5)
    algo = AlwaysRight(env.action_space)
    buf = VectorReplayBuffer(40, 2)
    bs = buf.init(_transition_example(twice=torch.zeros(1)), device="cpu")

    def hook(tr):
        tr.twice = tr.obs * 2
        return tr

    coll = DeviceCollector(VectorDeviceEnv(env, 2, device="cpu"), algo, buf, on_step_hook=hook)
    coll.collect(algo.init("cpu"), coll.reset(torch.Generator()), bs, torch.Generator(), 12)
    np.testing.assert_array_equal(bs.data.twice[0, :12, 0].numpy(), [0, 2, 4, 6, 8] * 2 + [0, 2])
    np.testing.assert_array_equal(bs.data.twice.numpy(), 2 * bs.data.obs.numpy())


def test_on_episode_done_hook_once_per_collect():
    env = MoveToRightEnv(size=3)
    algo = AlwaysRight(env.action_space)
    seen = []
    coll = DeviceCollector(VectorDeviceEnv(env, 2, device="cpu"), algo, None,
                           on_episode_done_hook=lambda s: seen.append(s.n_collected_episodes))
    cstate = coll.reset(torch.Generator())
    with TraceLoggerContext() as tl:
        for _ in range(5):
            coll.collect(algo.init("cpu"), cstate, None, torch.Generator(), 6)
    assert seen == [4] * 5  # 2 envs x 2 episodes of 3 steps per collect
    assert [line.split(":")[0] for line in tl.get_trace()] == ["collector"] * 5
    assert tl.get_trace()[0] == "collector: n_steps=6 training=True episodes=4 ep_ret_sum=4.000000"


class TwiceGraphed:
    """Runs its function on the first two calls only (as a CUDA graph's eager
    warm-up and capture do) and returns the last output afterwards."""

    def __init__(self, fn, pool, generators=(), name="graph"):
        self.fn, self.calls, self.out = fn, 0, None
        pool.graphs.append(self)

    def __call__(self):
        self.calls += 1
        if self.calls <= 2:
            self.out = self.fn()
        return self.out


def test_hook_and_trace_once_per_chunk_under_a_program(monkeypatch):
    monkeypatch.setattr(trainer_module, "Graphed", TwiceGraphed)
    env = MoveToRightEnv(size=3)
    algo = AlwaysRight(env.action_space)
    buf = VectorReplayBuffer(64, 2)
    bs = buf.init(_transition_example(), device="cpu")
    seen = []
    coll = DeviceCollector(VectorDeviceEnv(env, 2, device="cpu"), algo, buf,
                           on_episode_done_hook=lambda s: seen.append(s.n_collected_episodes))
    params = OffPolicyTrainerParams(max_epochs=1, epoch_num_steps=5 * 6 * 2, collection_step_num_env_steps=6,
                                    batch_size=4, update_per_step=0.1, verbose=False)
    trainer = OffPolicyTrainer(algo, coll, None, buf, params)
    with TraceLoggerContext() as tl:
        res = trainer.run(algo.init("cpu"), bs, torch.Generator())
    programs = {g.fn.__qualname__: g.calls for g in trainer.graph_pool.graphs}
    assert sorted(programs.values()) == [5, 5]  # collect_chunk and update_burst, 5 calls each
    assert seen == [4] * 5
    lines = [line.split(":")[0] for line in tl.get_trace()]
    assert lines == ["collector", "trainer/collect", "trainer/update"] * 5
    assert res.env_step == 60 and int(bs.size.sum()) == 4 * 6  # only 2 chunks stepped the envs


def test_random_action_policy():
    env = MoveToRightEnv()
    policy = RandomActionPolicy(env.action_space)
    ts = policy.init("cpu")
    out = policy.forward(ts, torch.zeros(500, 1), torch.Generator().manual_seed(0))
    assert out.act.dtype == torch.int64 and out.act.shape == (500,)
    assert set(out.act.tolist()) == {0, 1}
    coll = DeviceCollector(VectorDeviceEnv(env, 3, device="cpu"), policy, None)
    stats = coll.collect_episodes(ts, torch.Generator().manual_seed(1), 5, chunk_steps=50)
    assert stats.n_collected_episodes == 5 and np.all(stats.lens >= 5)
