"""The cached buffer's battery on the port
(tianshou_tpu_torch/data/buffer/cached.py) against the JAX package's
``CachedReplayBuffer``: every case of ``tests/test_cached_buffer.py`` and
``tests/test_her.py::test_cached_buffer_moves_finished_episodes``. Each case
runs the same adds on both packages and holds the port's main ring and caches
(data, cursors, sizes, newest rows) and its stacked gets equal to JAX's,
exactly (copies and index arithmetic), plus the case's own assertions.
Sampling draws from each package's own generator, so sampled rows are held
to the case's property, not to JAX's draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.cached import CachedReplayBuffer as JCached
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.cached import CachedReplayBuffer
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _example(B, xp, shape=()):
    return B(obs=xp.zeros(shape, dtype=xp.float32), act=xp.asarray(0, dtype=xp.int32),
             rew=xp.asarray(0.0, dtype=xp.float32), terminated=xp.asarray(False), truncated=xp.asarray(False),
             obs_next=xp.zeros(shape, dtype=xp.float32))


def _tr(B, xp, obs, done):
    obs = xp.asarray(np.asarray(obs, np.float32))
    E = obs.shape[0]
    return B(obs=obs, act=xp.zeros(E, dtype=xp.int32), rew=obs * 0.1 if obs.ndim == 1 else xp.ones(E),
             terminated=xp.asarray(np.asarray(done, bool)), truncated=xp.zeros(E, dtype=bool), obs_next=obs + 1)


class Pair:
    """One cached buffer in each package, driven by the same adds."""

    def __init__(self, shape=(), **kw):
        self.t, self.j = CachedReplayBuffer(**kw), JCached(**kw)
        self.ts = self.t.init(_example(Batch, torch, shape), device="cpu")
        self.js = self.j.init(_example(JBatch, jnp, shape))
        self.add_j = jax.jit(self.j.add)

    def add(self, obs, done):
        _, info = self.t.add(self.ts, _tr(Batch, torch, obs, done))
        self.js, jinfo = self.add_j(self.js, _tr(JBatch, jnp, obs, done))
        np.testing.assert_array_equal(info.done.numpy(), np.asarray(jinfo.done))
        self.assert_same()
        return info

    def assert_same(self):
        for part in ("main", "cache"):
            t, j = getattr(self.ts, part), getattr(self.js, part)
            for k, v in j.data.items():
                np.testing.assert_array_equal(t.data[k].numpy(), np.asarray(v), err_msg=f"{part}.{k}")
            for name in ("cursor", "size", "last_idx"):
                np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                              err_msg=f"{part}.{name}")

    def get(self, idx):
        t = self.t.get(self.ts, torch.as_tensor(np.asarray(idx)))
        j = self.j.get(self.js, jnp.asarray(idx))
        for k in j.keys():
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
        return t


def test_exact_max_length_episode_is_not_lost():
    p = Pair(main_size=16, num_envs=1, max_episode_len=4)
    for i, done in [(0, False), (1, False), (2, False), (3, True)]:
        p.add([float(i)], [done])
    assert int(p.ts.main.size[0]) == 4
    np.testing.assert_allclose(p.ts.main.data.obs[0, :4].numpy(), [0, 1, 2, 3])
    assert int(p.ts.cache.cursor[0]) == 0 and int(p.ts.cache.size[0]) == 0


def test_unfinished_episodes_never_sampled():
    p = Pair(main_size=16, num_envs=2, max_episode_len=8)
    for i, done in [(0, False), (1, True)]:
        p.add([float(i), 100.0 + i], [done, False])
    g = torch.Generator().manual_seed(0)
    idx = p.t.sample_indices(p.ts, g, 256)
    batch, _ = p.t.sample(p.ts, g, 256)
    assert set(np.unique(batch.obs.numpy())) <= {0.0, 1.0}
    assert int(idx.max()) < 2


def test_simultaneous_finish_packs_both_episodes():
    p = Pair(main_size=16, num_envs=2, max_episode_len=8)
    for i, done in [(0, False), (1, False), (2, True)]:
        p.add([float(i), 10.0 + i], [done, done])
    assert int(p.ts.main.size[0]) == 6
    assert p.ts.main.data.obs[0, :6].tolist() == [0, 1, 2, 10, 11, 12]


def test_main_ring_wraps_at_episode_granularity():
    p = Pair(main_size=4, num_envs=1, max_episode_len=4)
    for base in (0.0, 10.0, 20.0):
        for j, done in [(0, False), (1, True)]:
            p.add([base + j], [done])
    assert int(p.ts.main.size[0]) == 4
    np.testing.assert_allclose(p.ts.main.data.obs[0].numpy(), [20, 21, 10, 11])


def test_cache_isolation_across_envs():
    p = Pair(main_size=16, num_envs=3, max_episode_len=8)
    p.add([1.0, 2.0, 3.0], [False, True, False])
    assert int(p.ts.main.size[0]) == 1 and float(p.ts.main.data.obs[0, 0]) == 2.0
    np.testing.assert_array_equal(p.ts.cache.cursor.numpy(), [1, 0, 1])


def test_done_flag_reported_on_done():
    p = Pair(main_size=16, num_envs=1, max_episode_len=8)
    infos = [p.add([float(i)], [done]) for i, done in [(0, False), (1, False), (2, True)]]
    assert [bool(i.done[0]) for i in infos] == [False, False, True]


def test_rewards_and_done_flags_move_with_episode():
    p = Pair(main_size=8, num_envs=1, max_episode_len=4)
    for i, done in [(5, False), (6, True)]:
        p.add([float(i)], [done])
    np.testing.assert_allclose(p.ts.main.data.rew[0, :2].numpy(), [0.5, 0.6])
    np.testing.assert_array_equal(p.ts.main.data.terminated[0, :2].numpy(), [False, True])
    np.testing.assert_allclose(p.ts.main.data.obs_next[0, :2].numpy(), [6, 7])


def test_stack_through_cached_main_respects_episode_boundaries():
    p = Pair(main_size=8, num_envs=2, max_episode_len=4, stack_num=2)
    p.add([0.0, 50.0], [False, False])
    p.add([1.0, 51.0], [False, True])
    p.add([2.0, 60.0], [True, False])
    np.testing.assert_array_equal(p.ts.main.data.obs[0, :5].numpy(), [50, 51, 0, 1, 2])
    got = p.get(np.arange(5))
    np.testing.assert_array_equal(got.obs.numpy(), [[50, 50], [50, 51], [0, 0], [0, 1], [1, 2]])


def test_cached_sampled_stack_never_crosses_episodes():
    p = Pair(main_size=16, num_envs=2, max_episode_len=4, stack_num=3)
    for step in range(12):
        p.add([float(step), 100.0 + step], [step % 3 == 2, step % 4 == 3])
    batch, idx = p.t.sample(p.ts, torch.Generator().manual_seed(0), 64)
    stacks = batch.obs.numpy()
    assert stacks.shape == (64, 3)
    blocks = stacks // 100
    assert (blocks == blocks[:, :1]).all()
    assert np.isin(np.diff(stacks, axis=1), (0, 1)).all()
    p.get(idx.numpy())  # the same stacks from JAX's get


def test_cached_buffer_moves_finished_episodes():
    """``tests/test_her.py::test_cached_buffer_moves_finished_episodes``: 2-D
    observations, env 0 finishes a 3-step episode, env 1 keeps going."""
    p = Pair(shape=(2,), main_size=32, num_envs=2, max_episode_len=8)
    for i, done in [(0, False), (1, False), (2, True)]:
        p.add([[float(i), 0.0], [i + 100.0, 0.0]], [done, False])
    assert int(p.ts.main.size[0]) == 3
    np.testing.assert_allclose(p.ts.main.data.obs[0, :3, 0].numpy(), [0, 1, 2])
    assert p.ts.cache.cursor.tolist() == [0, 3]
    idx = p.t.sample_indices(p.ts, torch.Generator().manual_seed(0), 64)
    assert set(np.unique(idx.numpy())) <= {0, 1, 2}
    assert int(p.t.num_stored(p.ts)) == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_episodes_match_jax(seed):
    """Random episode ends over 3 envs, 40 adds, wrapping a 24-slot main ring
    and 5-slot caches (episodes of exactly 5 steps included): rings and caches
    equal to JAX's after every add, and stacked gets of every main row."""
    rng = np.random.default_rng(seed)
    p = Pair(main_size=24, num_envs=3, max_episode_len=5, stack_num=2)
    length = np.zeros(3, int)
    for t in range(40):
        done = (rng.random(3) < 0.3) | (length == 4)
        p.add(rng.standard_normal(3).astype(np.float32), done)
        length = np.where(done, 0, length + 1)
    p.get(np.arange(24))


def test_max_episode_len_beyond_the_main_ring_is_refused():
    with pytest.raises(ValueError):
        CachedReplayBuffer(main_size=4, num_envs=1, max_episode_len=8)
