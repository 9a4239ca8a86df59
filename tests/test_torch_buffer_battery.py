"""The replay battery's storage cases run on the port's buffer
(tianshou_tpu_torch/data/buffer/base.py): the 4 cases of
``tests/test_save_only_last_obs.py`` and the ring, episode-link and
frame-stacking cases of ``tests/test_buffer_battery.py:50-178``. Each case
runs the same adds on both packages and holds the port's rings, links and
gathered rows equal to JAX's (exactly: copies and index arithmetic), plus the
case's own assertions. Sampling draws from each package's own generator, so
sampled indices are held to the case's property, not to JAX's draw. The HDF5
cases wait for ``utils/persistence.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import ReplayBuffer as JReplayBuffer
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVectorReplayBuffer
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import ReplayBuffer, VectorReplayBuffer
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _tr(B, xp, obs, act, rew, term, trunc=False, obs_next=None):
    f32 = xp.float32
    return B(obs=xp.asarray(obs, dtype=f32), act=xp.asarray(act, dtype=xp.int32), rew=xp.asarray(rew, dtype=f32),
             terminated=xp.asarray(term), truncated=xp.asarray(trunc),
             obs_next=xp.asarray(obs + 1 if obs_next is None else obs_next, dtype=f32))


def tr(*args, **kw):
    """One transition for each package: (port, JAX)."""
    return _tr(Batch, torch, *args, **kw), _tr(JBatch, jnp, *args, **kw)


class Pair:
    """The same buffer in both packages, driven by the same adds."""

    def __init__(self, make_t, make_j, example):
        self.t, self.j = make_t(), make_j()
        self.ts, self.js = self.t.init(example[0], device="cpu"), self.j.init(example[1])

    def add1(self, pair):
        self.t.add(self.ts, pair[0].map(lambda x: x[None]))
        self.js, _ = self.j.add(self.js, jax.tree.map(lambda x: jnp.asarray(x)[None], pair[1]))

    def add(self, pairs, mask=None):
        self.t.add(self.ts, Batch.stack([p[0] for p in pairs]), mask=None if mask is None else torch.tensor(mask))
        self.js, _ = self.j.add(self.js, JBatch.stack([p[1] for p in pairs]),
                                mask=None if mask is None else jnp.asarray(mask))

    def assert_same_state(self):
        for k, v in self.js.data.items():
            np.testing.assert_array_equal(self.ts.data[k].numpy(), np.asarray(v), err_msg=k)
        for name in ("cursor", "size", "last_idx"):
            np.testing.assert_array_equal(getattr(self.ts, name).numpy(), np.asarray(getattr(self.js, name)))

    def get(self, idx, **kw):
        t = self.t.get(self.ts, torch.as_tensor(np.asarray(idx)), **kw)
        j = self.j.get(self.js, jnp.asarray(idx), **kw)
        for k in j.keys():
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
        return t

    def link(self, fn, idx):
        t = getattr(self.t, fn)(self.ts, torch.as_tensor(np.asarray(idx)))
        j = getattr(self.j, fn)(self.js, jnp.asarray(idx))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        return t


# ---------------------------------------------------------------------------
# tests/test_save_only_last_obs.py
# ---------------------------------------------------------------------------
def _stacked(B, xp, frame_stack, term=False):
    """One env, obs arrives frame-stacked ``[1, L]`` (1-D frames for clarity)."""
    return B(obs=xp.asarray(frame_stack, dtype=xp.float32)[None], act=xp.zeros(1, dtype=xp.int32),
             rew=xp.zeros(1, dtype=xp.float32), terminated=xp.asarray([term]), truncated=xp.asarray([False]))


def _scalar_example(B, xp):
    return B(obs=xp.zeros((), dtype=xp.float32), act=xp.asarray(0, dtype=xp.int32), rew=xp.asarray(0.0, dtype=xp.float32),
             terminated=xp.asarray(False), truncated=xp.asarray(False))


def _lean(size, stack):
    kw = dict(size=size, stack_num=stack, save_only_last_obs=True, ignore_obs_next=True)
    return Pair(lambda: ReplayBuffer(**kw), lambda: JReplayBuffer(**kw),
                (_scalar_example(Batch, torch), _scalar_example(JBatch, jnp)))


def _add_stacked(p, stacked, term=False):
    p.t.add(p.ts, _stacked(Batch, torch, stacked, term))
    p.js, _ = p.j.add(p.js, _stacked(JBatch, jnp, stacked, term))


def test_only_newest_frame_is_stored():
    p = _lean(8, 3)
    for t in range(4):
        _add_stacked(p, [max(t - 2, 0), max(t - 1, 0), t])
    np.testing.assert_array_equal(p.ts.data.obs[0, :4].numpy(), [0, 1, 2, 3])
    assert "obs_next" not in p.ts.data
    p.assert_same_state()


def test_get_restacks_from_single_frames():
    p = _lean(8, 3)
    for t in range(5):
        _add_stacked(p, [max(t - 2, 0), max(t - 1, 0), t], term=(t == 4))
    got = p.get([0, 2, 4])
    np.testing.assert_array_equal(got.obs.numpy(), [[0, 0, 0], [0, 1, 2], [2, 3, 4]])
    np.testing.assert_array_equal(got.obs_next.numpy(), [[0, 0, 1], [1, 2, 3], [2, 3, 4]])


def test_reconstruction_matches_full_storage():
    """The memory-optimized mode samples bit-identically to a buffer that
    stores the full stacked obs."""
    lean = _lean(16, 3)
    full_t = ReplayBuffer(size=16, stack_num=1)
    fs = full_t.init(Batch(obs=torch.zeros(3), act=torch.tensor(0, dtype=torch.int32), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False), obs_next=torch.zeros(3)),
                     device="cpu")
    frames = [0]
    for t in range(10):
        term = t % 5 == 4
        stacked = [frames[max(len(frames) - 3, 0)], frames[max(len(frames) - 2, 0)], frames[-1]]
        nxt_stacked = stacked[1:] + [float(t + 1)] if not term else [0.0, 0.0, 0.0]
        _add_stacked(lean, stacked, term)
        full_t.add(fs, Batch(obs=torch.tensor(stacked, dtype=torch.float32)[None], act=torch.zeros(1, dtype=torch.int32),
                             rew=torch.zeros(1), terminated=torch.tensor([term]), truncated=torch.tensor([False]),
                             obs_next=torch.tensor(nxt_stacked, dtype=torch.float32)[None]))
        frames = [0.0] if term else frames + [float(t + 1)]
    idx = np.arange(10)
    lean_got = lean.get(idx)
    full_got = full_t.get(fs, torch.as_tensor(idx), stack_num=1)
    np.testing.assert_array_equal(lean_got.obs.numpy(), full_got.obs.numpy())


def test_memory_footprint_is_single_frame():
    p = _lean(4, 4)
    assert p.ts.data.obs.shape == (1, 4) == p.js.data.obs.shape  # [E=1, C=4] scalars, not [E, C, stack]


# ---------------------------------------------------------------------------
# tests/test_buffer_battery.py:50-178: ring, episode links, frame stacking
# ---------------------------------------------------------------------------
def _single(size, **kw):
    return Pair(lambda: ReplayBuffer(size=size, **kw), lambda: JReplayBuffer(size=size, **kw), tr(0, 0, 0, False))


def _vector(total, n, **kw):
    return Pair(lambda: VectorReplayBuffer(total_size=total, buffer_num=n, **kw),
                lambda: JVectorReplayBuffer(total_size=total, buffer_num=n, **kw), tr(0, 0, 0, False))


def test_overwrite_breaks_prev_link_to_evicted():
    p = _single(4)
    for i in range(6):  # an episode of 6 steps in a 4-ring: slots hold obs 2..5
        p.add1(tr(i, 0, 0.0, i == 5))
    p.assert_same_state()
    oldest = int(p.t.chronological_indices(p.ts, 0)[0])
    assert oldest == int(np.asarray(p.j.chronological_indices(p.js, 0))[0])
    assert float(p.ts.data.obs[0, oldest % p.t.capacity]) == 2.0
    assert int(p.link("prev", [oldest])[0]) == oldest


def test_done_column_matches_term_or_trunc():
    p = _single(8)
    p.add1(tr(0, 0, 0.0, term=False, trunc=True))
    p.add1(tr(1, 0, 0.0, term=True, trunc=False))
    p.add1(tr(2, 0, 0.0, term=False, trunc=False))
    np.testing.assert_array_equal(p.ts.data.done[0, :3].numpy(), [True, True, False])
    p.assert_same_state()


def test_truncated_and_terminated_stored_separately():
    p = _single(4)
    p.add1(tr(0, 0, 0.0, term=False, trunc=True))
    assert bool(p.ts.data.truncated[0, 0]) and not bool(p.ts.data.terminated[0, 0])
    p.assert_same_state()


def test_add_info_and_links_of_one_episode():
    p = _single(16)
    for i, r in enumerate([1.0, 2.0, 3.0]):
        p.add1(tr(i, 0, r, term=i == 2))
    assert int(p.link("next", [0])[0]) == 1
    assert int(p.link("next", [2])[0]) == 2  # done stops the chain
    p.assert_same_state()


def test_vector_rings_are_isolated():
    p = _vector(8, 2)  # capacity 4 per env
    for i in range(4):
        p.add([tr(i, 0, 0.0, False), tr(10 + i, 0, 0.0, False)])
    assert int(p.link("next", [3])[0]) == 3  # env 0's newest: next clamps, never jumps to 4
    assert int(p.link("prev", [4])[0]) == 4  # env 1's oldest: prev clamps, never jumps to 3
    p.assert_same_state()


def test_vector_ragged_fill_sampling_validity():
    p = _vector(12, 3)  # capacity 4
    steps = [([True, True, False], [tr(1, 0, 0, False), tr(21, 0, 0, False), tr(0, 0, 0, False)]),
             ([False, True, False], [tr(0, 0, 0, False), tr(22, 0, 0, False), tr(0, 0, 0, False)]),
             ([False, True, False], [tr(0, 0, 0, False), tr(23, 0, 0, False), tr(0, 0, 0, False)])]
    for m, pairs in steps:
        p.add(pairs, mask=m)
    p.assert_same_state()
    idx = p.t.sample_indices(p.ts, torch.Generator().manual_seed(0), 256).numpy()
    env, slot = idx // p.t.capacity, idx % p.t.capacity
    sizes = p.ts.size.numpy()
    assert (env != 2).all()  # the empty env is never sampled
    assert all(s < sizes[e] for e, s in zip(env, slot))
    assert set(np.unique(p.ts.data.obs[env, slot].numpy())).issubset({1.0, 21.0, 22.0, 23.0})


def test_stack_num_repeats_episode_head():
    p = _single(8, stack_num=3)
    for obs, done in [(0, False), (1, True), (10, False), (11, False)]:
        p.add1(tr(obs, 0, 0.0, done))
    got = p.get([2, 3])  # episode B
    np.testing.assert_array_equal(got.obs[0].numpy(), [10, 10, 10])
    np.testing.assert_array_equal(got.obs[1].numpy(), [10, 10, 11])
    assert 1.0 not in got.obs.numpy()  # stacking never leaks across the done boundary


def test_sample_avail_excludes_incomplete_history_vector():
    p = _vector(16, 2, stack_num=3, sample_avail=True)
    for i in range(4):
        p.add([tr(i, 0, 0, False), tr(10 + i, 0, 0, False)])
    idx = p.t.sample_indices(p.ts, torch.Generator().manual_seed(1), 512).numpy()
    assert (idx % p.t.capacity >= 2).all()  # slots 0 and 1 lack a full 3-frame history
    np.testing.assert_array_equal(p.t._avail_mask(p.ts).numpy(), np.asarray(p.j._avail_mask(p.js)))


def test_stack_with_wraparound_does_not_leak_newest_into_oldest():
    p = _single(4, stack_num=2)
    for i in range(6):  # one long episode, wraps: the ring holds obs 2..5
        p.add1(tr(i, 0, 0.0, False))
    chron = p.t.chronological_indices(p.ts, 0)
    np.testing.assert_array_equal(chron, np.asarray(p.j.chronological_indices(p.js, 0)))
    got = p.get(chron)
    np.testing.assert_array_equal(got.obs[0].numpy(), [2, 2])
    np.testing.assert_array_equal(got.obs[1].numpy(), [2, 3])
    np.testing.assert_array_equal(got.obs[3].numpy(), [4, 5])
