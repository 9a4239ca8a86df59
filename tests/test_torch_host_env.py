"""The host env layer in the port (tianshou_tpu_torch/env/{venvs,shmem,finite}.py
and utils/statistics.py:RunningMeanStd) against the JAX package.

- Dummy, Subproc and Shmem vector envs over Gymnasium CartPole-v1: the same
  seeds and actions give the same observations, rewards and flags in all
  three and in the JAX package's Dummy env, exactly; ``id=`` subsets, the
  ``env_id`` tag, attribute access, async ``wait_num``.
- ``RunningMeanStd`` and ``VectorEnvNormObs`` against JAX's over the same
  batches, exactly (host numpy in both); the frozen test venv sharing the
  train venv's statistics.
- The finite envs of ``tests/test_env_finite.py``: every sample of a sharded
  dataset visited once per epoch, ``StopIteration`` at exhaustion, through
  the port's ``HostCollector``, in Dummy and Subproc form.
- A worker that hangs fails its caller with ``TimeoutError`` after
  ``recv_timeout``, and closing the venv still returns.

Every Subproc and Shmem test bounds its waits with ``recv_timeout`` and
closes its venv in ``finally``.
"""

import time
from collections import Counter

import gymnasium as gym
import numpy as np
import pytest
import torch

from tianshou_tpu.env.venvs import DummyVectorEnv as JDummyVectorEnv
from tianshou_tpu.env.venvs import VectorEnvNormObs as JVectorEnvNormObs
from tianshou_tpu.utils.statistics import RunningMeanStd as JRunningMeanStd
from tianshou_tpu_torch.algorithm.base import ActOut
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.host_collector import HostCollector
from tianshou_tpu_torch.env.finite import FiniteDummyVectorEnv, FiniteSubprocVectorEnv
from tianshou_tpu_torch.env.shmem import ShmemVectorEnv
from tianshou_tpu_torch.env.venvs import DummyVectorEnv, SubprocVectorEnv, VectorEnvNormObs
from tianshou_tpu_torch.utils.statistics import RunningMeanStd
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

WAIT = 60.0  # seconds any test waits for one worker's reply


def make_cp():
    return gym.make("CartPole-v1")


def _close(*venvs):
    for v in venvs:
        v.close()


def test_dummy_vector_env_basics():
    venv = DummyVectorEnv([make_cp for _ in range(4)])
    try:
        assert len(venv) == 4
        obs, _ = venv.reset(seed=0)
        assert obs.shape == (4, 4)
        obs, rew, term, trunc, infos = venv.step(np.zeros(4, np.int64))
        assert obs.shape == (4, 4) and rew.shape == (4,) and rew.dtype == np.float32
        assert [i["env_id"] for i in infos] == [0, 1, 2, 3]
        obs2, *_, infos2 = venv.step(np.ones(2, np.int64), id=[1, 3])
        assert obs2.shape == (2, 4) and [i["env_id"] for i in infos2] == [1, 3]
        assert venv.get_env_attr("action_space")[0].n == 2
        assert venv.action_space.n == 2
        with pytest.raises(ValueError):
            venv.step(np.zeros(3, np.int64))
    finally:
        venv.close()


@pytest.mark.parametrize("kind", ["subproc", "shmem"])
def test_process_venvs_match_dummy_and_jax(kind):
    """Seeded resets and the same actions: the port's Dummy, Subproc / Shmem
    and the JAX package's Dummy agree bit for bit, auto-resets included."""
    E = 3
    cls = {"subproc": SubprocVectorEnv, "shmem": ShmemVectorEnv}[kind]
    d, j = DummyVectorEnv([make_cp] * E), JDummyVectorEnv([make_cp] * E)
    s = cls([make_cp] * E, recv_timeout=WAIT)
    try:
        outs = [v.reset(seed=7)[0] for v in (d, s, j)]
        for o in outs[1:]:
            np.testing.assert_array_equal(outs[0], o)
        rng = np.random.default_rng(0)
        for _ in range(60):
            a = rng.integers(0, 2, E)
            rd, rs, rj = d.step(a), s.step(a), j.step(a)
            for r in (rs, rj):
                for k in range(4):
                    np.testing.assert_array_equal(rd[k], r[k])
            done = np.where(rd[2] | rd[3])[0]
            if len(done):
                ro = [v.reset(id=done.tolist())[0] for v in (d, s, j)]
                for o in ro[1:]:
                    np.testing.assert_array_equal(ro[0], o)
        assert s.get_env_attr("action_space")[0].n == 2
    finally:
        _close(d, s)


def test_async_wait_num():
    venv = SubprocVectorEnv([make_cp for _ in range(4)], wait_num=2, recv_timeout=WAIT)
    try:
        assert venv.is_async
        venv.reset(seed=0)
        obs, rew, term, trunc, infos = venv.step(np.zeros(4, np.int64), id=[0, 1, 2, 3])
        ids = [i["env_id"] for i in infos]
        assert len(rew) >= 2 and len(set(ids)) == len(ids)
        assert sorted(venv.ready_id) == sorted(ids)
    finally:
        venv.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_running_mean_std_matches_jax(seed):
    rng = np.random.default_rng(seed)
    t, j = RunningMeanStd(), JRunningMeanStd()
    for n in (1, 5, 17, 3):
        x = rng.standard_normal((n, 4)) * 3 + 1
        t.update(x)
        j.update(x)
        np.testing.assert_array_equal(t.mean, j.mean)
        np.testing.assert_array_equal(t.var, j.var)
        assert t.count == j.count
        y = rng.standard_normal((6, 4)) * 40
        np.testing.assert_array_equal(t.norm(y), j.norm(y))
    t2 = RunningMeanStd(clip_max=None)
    t2.update(np.array([[0.0], [1e3]]))
    assert np.abs(t2.norm(np.array([[1e6]]))).max() > 10


def test_vector_env_norm_obs_matches_jax_and_freezes_the_test_venv():
    tv, jv = VectorEnvNormObs(DummyVectorEnv([make_cp] * 3)), JVectorEnvNormObs(JDummyVectorEnv([make_cp] * 3))
    test = VectorEnvNormObs(DummyVectorEnv([make_cp] * 2), update_obs_rms=False)
    test.set_obs_rms(tv.get_obs_rms())  # shared, frozen on test (examples/mujoco/_runner.py:242-246)
    try:
        np.testing.assert_array_equal(tv.reset(seed=1)[0], jv.reset(seed=1)[0])
        rng = np.random.default_rng(1)
        for _ in range(30):
            a = rng.integers(0, 2, 3)
            rt, rj = tv.step(a), jv.step(a)
            assert rt[0].dtype == np.float32
            for k in range(4):
                np.testing.assert_array_equal(rt[k], rj[k])
            done = np.where(rt[2] | rt[3])[0]
            if len(done):
                np.testing.assert_array_equal(tv.reset(id=done.tolist())[0], jv.reset(id=done.tolist())[0])
        count = tv.get_obs_rms().count
        test.reset(seed=3)
        test.step(np.zeros(2, np.int64))
        assert test.get_obs_rms() is tv.get_obs_rms() and tv.get_obs_rms().count == count
        assert len(tv) == 3 and tv.action_space.n == 2
    finally:
        _close(tv, jv, test)


# ---------------------------------------------------------------------------
# tests/test_env_finite.py
# ---------------------------------------------------------------------------
class DummyDataset:
    """100 samples; sample i runs for (3*i % 5 + 1) env steps."""

    def __init__(self, length):
        self.length = length
        self.episodes = [3 * i % 5 + 1 for i in range(length)]

    def __getitem__(self, index):
        return index, self.episodes[index]

    def __len__(self):
        return self.length


class FiniteEnv:
    """One shard of the dataset; ``reset`` gives ``(None, {})`` once it is exhausted."""

    def __init__(self, dataset, num_replicas, rank):
        self.dataset = dataset
        self.indices = list(range(rank, len(dataset), num_replicas))
        self.iterator = None

    def reset(self, seed=None, **kwargs):
        if self.iterator is None:
            self.iterator = iter(self.indices)
        try:
            idx = next(self.iterator)
            self.current_sample, self.step_count = self.dataset[idx]
            self.current_step = 0
            return np.float32(self.current_sample), {}
        except StopIteration:
            self.iterator = None
            return None, {}

    def step(self, action):
        self.current_step += 1
        assert self.current_step <= self.step_count
        return (np.float32(0), 1.0, self.current_step >= self.step_count, False,
                {"sample": self.current_sample, "action": action, "metric": 2.0})

    def close(self):
        pass


class MetricTracker:
    """Every sample finishes exactly once, after its own number of steps."""

    def __init__(self):
        self.counter = Counter()
        self.finished = set()

    def log(self, obs, rew, terminated, truncated, info):
        if info is None:
            return
        assert rew == 1.0
        index = int(info["sample"])
        if terminated or truncated:
            assert index not in self.finished
            self.finished.add(index)
        self.counter[index] += 1

    def validate(self):
        assert len(self.finished) == 100
        for k, v in self.counter.items():
            assert v == k * 3 % 5 + 1


class ConstantAlgo:
    """Action 1 for every env, on the collector's device."""

    def forward(self, ts, obs, generator=None, state=None, deterministic=False):
        return ActOut(act=torch.ones(obs.shape[0], dtype=torch.int64, device=obs.device), state=state, info=Batch())

    def exploration_noise(self, ts, act, obs, generator, training=True):
        return act

    def map_action(self, act):
        return act


def run_finite(env_cls, epochs=3, **kw):
    """Collect ``epochs`` epochs of the sharded dataset; returns the steps counted per epoch."""
    dataset = DummyDataset(100)
    envs = env_cls([(lambda r=r: FiniteEnv(dataset, 5, r)) for r in range(5)], **kw)
    steps = []
    try:
        coll = HostCollector(envs, ConstantAlgo(), None, device="cpu")
        coll.reset()  # once: at exhaustion the venv rearms itself
        for _ in range(epochs):
            envs.tracker = MetricTracker()
            with pytest.raises(StopIteration):
                coll.collect(None, torch.Generator(), n_step=10**9)
            envs.tracker.validate()
            steps.append(sum(envs.tracker.counter.values()))
    finally:
        envs.close()
    return steps


def test_finite_dummy_vector_env():
    assert run_finite(FiniteDummyVectorEnv) == [sum(3 * i % 5 + 1 for i in range(100))] * 3


def test_finite_subproc_vector_env():
    assert run_finite(FiniteSubprocVectorEnv, recv_timeout=WAIT) == run_finite(FiniteDummyVectorEnv)


def test_finite_env_matches_jax_host_collector():
    """The JAX package's finite venv driven by its own HostCollector visits the
    same samples in the same numbers of steps."""
    import jax
    import jax.numpy as jnp

    from tianshou_tpu.data.batch import Batch as JBatch
    from tianshou_tpu.data.host_collector import HostCollector as JHostCollector
    from tianshou_tpu.env.finite import FiniteDummyVectorEnv as JFinite

    class JConstant:
        def forward(self, ts, obs, key, deterministic=False):
            return JBatch(act=jnp.ones(obs.shape[0], jnp.int32))

        def exploration_noise(self, ts, act, obs, key, training=True):
            return act

        def map_action(self, act):
            return act

    dataset = DummyDataset(100)
    envs = JFinite([(lambda r=r: FiniteEnv(dataset, 5, r)) for r in range(5)])
    coll = JHostCollector(envs, JConstant(), None)
    coll.reset()
    envs.tracker = MetricTracker()
    with pytest.raises(StopIteration):
        coll.collect(None, jax.random.key(0), n_step=10**9)
    envs.close()
    assert run_finite(FiniteDummyVectorEnv, epochs=1) == [sum(envs.tracker.counter.values())]


# ---------------------------------------------------------------------------
# a hung worker fails its caller instead of stalling it
# ---------------------------------------------------------------------------
class HangingEnv:
    def reset(self, seed=None, **kw):
        return np.zeros(2, np.float32), {}

    def step(self, action):
        time.sleep(3600)

    def close(self):
        pass


@pytest.mark.parametrize("cls", [SubprocVectorEnv, ShmemVectorEnv])
def test_hung_worker_times_out(cls):
    venv = cls([HangingEnv, HangingEnv], recv_timeout=0.5)
    try:
        venv.reset()
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            venv.step(np.zeros(2, np.int64))
        assert time.monotonic() - t0 < 30
    finally:
        t0 = time.monotonic()
        venv.close()
        assert time.monotonic() - t0 < 30
        assert not any(w.process.is_alive() for w in venv.workers)
